"""Gaussian math and SSIM of the port against the JAX reference: quaternion
helpers, the SH DC colour maps, the fused EWA projection (pinhole and ortho, values and
gradients), spherical harmonics up to degree 3, and SSIM."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holoscene_tpu.ops import gaussians as jg
from holoscene_tpu.ops import ssim as jssim
from holoscene_tpu_torch.ops import gaussians as tg
from holoscene_tpu_torch.ops import ssim as tssim
from test_torch_threads import few_torch_threads  # noqa: F401

ATOL = 1e-5


def _t(x):
    return torch.as_tensor(np.array(x))


def _gaussians(n=300, seed=0):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-0.8, 0.8, n), rng.uniform(-0.8, 0.8, n),
                      rng.uniform(-0.5, 3.0, n)], -1).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    scales = rng.uniform(0.005, 0.1, (n, 3)).astype(np.float32)
    view = np.eye(4, dtype=np.float32)
    ang = 0.3
    view[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                    [-np.sin(ang), 0, np.cos(ang)]]
    view[:3, 3] = [0.1, -0.05, 0.4]
    intr = np.array([[40.0, 0, 24], [0, 42.0, 20], [0, 0, 1]], np.float32)
    return means, q, scales, view, intr


def test_quaternion_helpers_match_jax():
    rng = np.random.default_rng(1)
    q1 = rng.normal(size=(50, 4)).astype(np.float32)
    q2 = rng.normal(size=(50, 4)).astype(np.float32)
    aa = rng.normal(size=(50, 3)).astype(np.float32)
    aa[:5] = 0.0   # the zero-rotation branch (GoM init state)
    rot = np.asarray(jg.quat_to_rotmat(jnp.asarray(q1)))
    pairs = [
        (tg.quat_multiply(_t(q1), _t(q2)), jg.quat_multiply(q1, q2)),
        (tg.axis_angle_to_quat(_t(aa)), jg.axis_angle_to_quat(aa)),
        (tg.quat_to_rotmat(_t(q1)), rot),
        (tg.rotmat_to_quat(_t(rot)), jg.rotmat_to_quat(jnp.asarray(rot))),
        (tg.rgb_to_sh(_t(q1[:, :3])), jg.rgb_to_sh(q1[:, :3])),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert tg.num_sh_bases(3) == jg.num_sh_bases(3) == 16


def test_sh_dc_colour_maps_match_jax():
    """sh_to_rgb (and its inverse rgb_to_sh) against JAX's: atol 1e-6, and
    the round trip returns the colours."""
    rgb = np.random.default_rng(3).uniform(-0.2, 1.2, (64, 3)).astype(
        np.float32)
    sh = tg.rgb_to_sh(_t(rgb))
    np.testing.assert_allclose(sh.numpy(), np.asarray(jg.rgb_to_sh(rgb)),
                               atol=1e-6)
    back = tg.sh_to_rgb(sh)
    np.testing.assert_allclose(back.numpy(), np.asarray(jg.sh_to_rgb(
        jg.rgb_to_sh(rgb))), atol=1e-6)
    np.testing.assert_allclose(back.numpy(), rgb, atol=1e-6)


@pytest.mark.parametrize("ortho", [False, True])
def test_project_gaussians_fused_matches_jax(ortho):
    means, q, scales, view, intr = _gaussians()
    w, h = 48, 40
    j = jg.project_gaussians_fused(jnp.asarray(means), jnp.asarray(q),
                                   jnp.asarray(scales), jnp.asarray(view),
                                   jnp.asarray(intr), w, h, ortho=ortho)
    t = tg.project_gaussians_fused(_t(means), _t(q), _t(scales), _t(view),
                                   _t(intr), w, h, ortho=ortho)
    for name, a, b in zip(("xy", "depth", "conic", "radius"), t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=1e-6, err_msg=name)
    np.testing.assert_array_equal(t[4].numpy(), np.asarray(j[4]))
    assert 0 < int(t[4].sum()) < len(means)  # both valid and culled present


def test_project_gaussians_fused_grad_matches_jax():
    means, q, scales, view, intr = _gaussians(n=120, seed=4)
    rng = np.random.default_rng(5)
    wxy = rng.normal(size=(120, 2)).astype(np.float32)
    wcon = rng.normal(size=(120, 3)).astype(np.float32)

    def jloss(m, qq, s):
        xy, d, con, _, _ = jg.project_gaussians_fused(
            m, qq, s, jnp.asarray(view), jnp.asarray(intr), 48, 40)
        return jnp.sum(xy * wxy) + jnp.sum(con * wcon) + jnp.sum(d)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(means), jnp.asarray(q), jnp.asarray(scales))
    targs = [_t(x).requires_grad_(True) for x in (means, q, scales)]
    xy, d, con, _, _ = tg.project_gaussians_fused(
        *targs, _t(view), _t(intr), 48, 40)
    (torch.sum(xy * _t(wxy)) + torch.sum(con * _t(wcon))
     + torch.sum(d)).backward()
    for a, b, name in zip(targs, jgrads, ("means", "quats", "scales")):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-3, err_msg=name)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh_matches_jax(degree):
    rng = np.random.default_rng(degree)
    n = 64
    coeffs = rng.normal(size=(n, tg.num_sh_bases(degree), 3)).astype(
        np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    np.testing.assert_allclose(
        tg.eval_sh(_t(coeffs), _t(dirs), degree).numpy(),
        np.asarray(jg.eval_sh(jnp.asarray(coeffs), jnp.asarray(dirs),
                              degree)), atol=ATOL)


def test_ssim_matches_jax():
    rng = np.random.default_rng(7)
    a = rng.uniform(0, 1, (3, 40, 36)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    np.testing.assert_allclose(
        float(tssim.ssim_chw(_t(a), _t(b))),
        float(jssim.ssim_chw(jnp.asarray(a), jnp.asarray(b))), atol=ATOL)
    hwc_a, hwc_b = a.transpose(1, 2, 0), b.transpose(1, 2, 0)
    np.testing.assert_allclose(
        float(tssim.ssim(_t(hwc_a), _t(hwc_b))),
        float(jssim.ssim(jnp.asarray(hwc_a), jnp.asarray(hwc_b))), atol=ATOL)
