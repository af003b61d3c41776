"""The port's camera refinement (models/cam_opt.py) and physics dense grid
(ops/phygrid.py) against the JAX package's, on the CPU.

Tolerances: exp_map_so3xr3 and the composed pose within 1e-6, gradients
within 1e-5 (float32 sums in another order). At a tangent of exactly zero
JAX's rotation gradient is NaN (its cosine branch divides by the unguarded
theta^2); the port's is finite and is held to JAX's at tangents of 1e-8,
in the same small-angle branch, where JAX's is finite. The grid: sample
within 1e-6, the scatter-max bitwise, the smoothing within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401

from holoscene_tpu.models import cam_opt as jcam
from holoscene_tpu.ops import phygrid as jpg
from holoscene_tpu_torch.convert import cam_opt_from_jax, dense_grid_from_jax
from holoscene_tpu_torch.models import cam_opt as tcam
from holoscene_tpu_torch.ops import phygrid as tpg


def _tangents(n=64, seed=0, scale=0.5):
    rng = np.random.default_rng(seed)
    t = rng.normal(0, scale, (n, 6)).astype(np.float32)
    t[:8, 3:] *= 1e-7                                 # small-angle branch
    return t


def _jax_grad(w):
    """jax.grad of sum(exp_map_so3xr3(x) * w), jitted (one compile instead
    of one a primitive)."""
    return jax.jit(jax.grad(lambda x: jnp.sum(jcam.exp_map_so3xr3(x) * w)))


def _loss_weights(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_exp_map_and_its_gradient_match_jax():
    t = _tangents()
    w = _loss_weights((t.shape[0], 3, 4))
    want = np.asarray(jax.jit(jcam.exp_map_so3xr3)(jnp.asarray(t)))
    jgrad = np.asarray(_jax_grad(w)(jnp.asarray(t)))
    x = torch.tensor(t, requires_grad=True)
    got = tcam.exp_map_so3xr3(x)
    (got * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), jgrad, rtol=0, atol=1e-5)


def test_gradient_at_zero_is_finite_and_matches_the_small_angle_branch():
    w = _loss_weights((3, 3, 4), seed=2)
    x = torch.zeros(3, 6, requires_grad=True)
    (tcam.exp_map_so3xr3(x) * torch.tensor(w)).sum().backward()
    assert torch.isfinite(x.grad).all()
    grad = _jax_grad(w)
    jgrad_zero = np.asarray(grad(jnp.zeros((3, 6))))
    assert np.isnan(jgrad_zero[:, 3:]).all(), "JAX's reference changed"
    jgrad = np.asarray(grad(jnp.full((3, 6), 1e-8, jnp.float32)))
    assert np.isfinite(jgrad).all()
    np.testing.assert_allclose(x.grad.numpy(), jgrad, rtol=0, atol=1e-5)


def test_camera_optimizer_apply_and_regularizer_match_jax():
    rng = np.random.default_rng(3)
    jparams = jcam.init_camera_optimizer(5)
    jparams["pose_deltas"] = jnp.asarray(
        rng.normal(0, 0.1, (5, 6)).astype(np.float32))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.asarray(jcam.exp_map_so3xr3(
        jnp.asarray([0, 0, 0, 0.3, -0.2, 0.5], jnp.float32)))[:3, :3]
    pose[:3, 3] = [0.4, -1.0, 2.0]
    cam = tcam.CameraOptimizer(5)
    assert torch.equal(cam.pose_deltas, torch.zeros(5, 6))
    cam.load_state_dict(cam_opt_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams)))
    apply = jax.jit(jcam.apply_camera_optimizer)
    grad = jax.jit(jax.grad(lambda p, c, i: jnp.sum(
        jcam.apply_camera_optimizer(p, c, i) ** 2)))
    for idx in (0, 3):
        want = np.asarray(apply(jparams, jnp.asarray(pose), idx))
        got = cam.apply(torch.tensor(pose), idx)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-6)
        jg = np.asarray(grad(jparams, jnp.asarray(pose), idx)["pose_deltas"])
        cam.zero_grad()
        (cam.apply(torch.tensor(pose), idx) ** 2).sum().backward()
        np.testing.assert_allclose(cam.pose_deltas.grad.numpy(), jg, rtol=0,
                                   atol=1e-5)
    np.testing.assert_allclose(
        float(cam.pose_delta_regularizer().detach()),
        float(jcam.pose_delta_regularizer(jparams)), rtol=1e-6)


@pytest.fixture(scope="module")
def grids():
    rng = np.random.default_rng(4)
    res = 24
    jg = jpg.init_dense_grid(res, bound=1.5)
    pts = rng.uniform(-1.6, 1.6, (3000, 3)).astype(np.float32)
    pts[:200] = pts[200:400]                         # repeated cells
    vals = rng.uniform(0, 1, 3000).astype(np.float32)
    jg = jpg.grid_splat_max(jg, jnp.asarray(pts), jnp.asarray(vals))
    tg = tpg.grid_splat_max(tpg.init_dense_grid(res, bound=1.5),
                            torch.tensor(pts), torch.tensor(vals))
    return jg, tg, rng


def test_splat_max_is_bitwise(grids):
    jg, tg, rng = grids
    np.testing.assert_array_equal(tg["values"].numpy(),
                                  np.asarray(jg["values"]))
    assert tg["bound"] == 1.5
    conv = dense_grid_from_jax(jax.tree_util.tree_map(np.asarray, jg))
    assert torch.equal(conv["values"], tg["values"])
    # a second splat keeps the larger of the old and the new values
    pts = rng.uniform(-1.5, 1.5, (500, 3)).astype(np.float32)
    vals = rng.uniform(0, 0.5, 500).astype(np.float32)
    np.testing.assert_array_equal(
        tpg.grid_splat_max(tg, torch.tensor(pts),
                           torch.tensor(vals))["values"].numpy(),
        np.asarray(jpg.grid_splat_max(jg, jnp.asarray(pts),
                                      jnp.asarray(vals))["values"]))


def test_sample_and_smooth_match_jax(grids):
    jg, tg, rng = grids
    pts = rng.uniform(-1.7, 1.7, (4000, 3)).astype(np.float32)
    pts[:3] = [[1.5, 1.5, 1.5], [-1.5, -1.5, -1.5], [1.5, -1.5, 0.0]]
    np.testing.assert_allclose(
        tpg.grid_sample(tg, torch.tensor(pts)).numpy(),
        np.asarray(jpg.grid_sample(jg, jnp.asarray(pts))), rtol=0, atol=1e-6)
    sm_t = tpg.grid_smooth(tg)
    sm_j = jpg.grid_smooth(jg)
    np.testing.assert_allclose(sm_t["values"].numpy(),
                               np.asarray(sm_j["values"]), rtol=0, atol=1e-6)
    assert float(sm_t["values"].max()) < float(tg["values"].max())
