"""The port's unscented-transform projection and camera models
(ops/gaussians.py::{camera_project, project_gaussians_ut}) and the renderer
on non-pinhole cameras (ops/splat.py::render_gaussians with camera_model /
dist / viewmat_end, flat and top-K paths) against the JAX package's on the
same numpy-seeded gaussians.

Tolerances: projections 1e-5 relative (the same float32 formulas; arctan
and the polynomial of the fisheye model round differently in the two
libraries); conics rtol 1e-4 (a 2x2 inverse of a near-singular covariance
amplifies the last bit); renders 2e-4 (the compositors'); gradients 1e-4
of their largest value."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401

from holoscene_tpu.ops import gaussians as jg
from holoscene_tpu.ops import splat as jsplat
from holoscene_tpu.ops import splat_flat as jflat
from holoscene_tpu_torch.ops import gaussians as tg
from holoscene_tpu_torch.ops import splat as tsplat
from holoscene_tpu_torch.ops import splat_flat as tflat

W, H = 48, 32
INTR = np.array([[40.0, 0, 24], [0, 40.0, 16], [0, 0, 1]], np.float32)
CAMERAS = [("pinhole", None), ("opencv", (0.1, -0.02, 0.003, -0.002, 0.01)),
           ("opencv", (0.05, 0.01)), ("fisheye", (0.03, 0.001, 0.0, 0.0)),
           ("fisheye", None)]


def _gaussians(n=40, seed=0, scale=0.05):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    means[:, 2] += 2.0
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    s = rng.uniform(0.3 * scale, scale, (n, 3)).astype(np.float32)
    return means, q, s


def _viewmats():
    vm = np.eye(4, dtype=np.float32)
    vm_end = vm.copy()
    vm_end[0, 3] = -0.2
    return vm, vm_end


@pytest.mark.parametrize("camera, dist", CAMERAS)
def test_camera_project_matches_jax(camera, dist):
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) + 0.5
    pts[0, 2] = 0.001                       # clamped at near
    ref = jg.camera_project(jnp.asarray(pts), jnp.asarray(INTR), camera,
                            dist)
    got = tg.camera_project(torch.tensor(pts), torch.tensor(INTR), camera,
                            dist)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("shutter", [False, True])
@pytest.mark.parametrize("camera, dist", CAMERAS[:4])
def test_project_gaussians_ut_matches_jax(camera, dist, shutter):
    means, q, s = _gaussians()
    vm, vm_end = _viewmats()
    jsq = jg.quat_to_rotmat(jnp.asarray(q)) * jnp.asarray(s)[..., None, :]
    ref = jg.project_gaussians_ut(
        jnp.asarray(means), jsq, jnp.asarray(vm), jnp.asarray(INTR), W, H,
        camera_model=camera, dist=dist,
        viewmat_end=jnp.asarray(vm_end) if shutter else None)
    tsq = tg.quat_to_rotmat(torch.tensor(q)) * torch.tensor(s)[..., None, :]
    got = tg.project_gaussians_ut(
        torch.tensor(means), tsq, torch.tensor(vm), torch.tensor(INTR), W, H,
        camera_model=camera, dist=dist,
        viewmat_end=torch.tensor(vm_end) if shutter else None)
    xy, z, conic, radius, valid = (x.numpy() for x in got)
    np.testing.assert_allclose(xy, np.asarray(ref[0]), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(z, np.asarray(ref[1]), rtol=1e-6)
    np.testing.assert_allclose(conic, np.asarray(ref[2]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(radius, np.asarray(ref[3]))
    np.testing.assert_array_equal(valid, np.asarray(ref[4]))
    assert valid.sum() > 20


@pytest.mark.parametrize("flat", [False, True], ids=["topk", "flat"])
def test_render_through_the_ut_matches_jax(flat):
    """A fisheye camera with a rolling shutter on the top-K path and an
    opencv camera on the flat path (bins from the UT projection): forward
    and the means / opacity gradients of the same loss."""
    means, q, s = _gaussians(64, seed=2, scale=0.08)
    rng = np.random.default_rng(3)
    opac = rng.uniform(0.3, 0.9, 64).astype(np.float32)
    cols = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    vm, vm_end = _viewmats()
    vm_end[0, 3] = -0.05
    camera, dist = (("opencv", CAMERAS[1][1]) if flat
                    else ("fisheye", CAMERAS[3][1]))
    end = None if flat else vm_end
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    j_plan = j_bins = t_plan = t_bins = None
    if flat:
        jsq = jg.quat_to_rotmat(jnp.asarray(q)) * jnp.asarray(s)[..., None, :]
        xy, d, con, _r, ok = jg.project_gaussians_ut(
            jnp.asarray(means), jsq, jnp.asarray(vm), jnp.asarray(INTR), W,
            H, camera_model=camera, dist=dist)
        j_plan = jflat.plan_flat(xy, con, jnp.asarray(opac), ok, 3, 2, 16)
        j_bins = jflat.build_flat_bins(xy, d, con, jnp.asarray(opac), ok,
                                       tiles_x=3, tiles_y=2, tile_size=16,
                                       plan=j_plan)
        tsq = tg.quat_to_rotmat(torch.tensor(q)) * torch.tensor(s)[..., None,
                                                                   :]
        xy, d, con, _r, ok = tg.project_gaussians_ut(
            torch.tensor(means), tsq, torch.tensor(vm), torch.tensor(INTR),
            W, H, camera_model=camera, dist=dist)
        t_plan = tflat.plan_flat(xy, con, torch.tensor(opac), ok, 3, 2, 16)
        t_bins = tflat.build_flat_bins(xy, d, con, torch.tensor(opac), ok,
                                       tiles_x=3, tiles_y=2, tile_size=16,
                                       plan=t_plan)
        assert (t_plan.span_x, t_plan.span_y, t_plan.c_max) == (
            j_plan.span_x, j_plan.span_y, j_plan.c_max)

    def jloss(m, o):
        out = jsplat.render_gaussians(
            m, jnp.asarray(q), jnp.asarray(s), o, jnp.asarray(cols),
            jnp.asarray(vm), jnp.asarray(INTR), width=W, height=H,
            max_per_tile=64, background=jnp.asarray(bg), use_pallas=False,
            camera_model=camera, dist=dist,
            viewmat_end=None if end is None else jnp.asarray(end),
            flat_plan=j_plan, flat_bins=j_bins)
        return (out["rgb"] ** 2).mean(), out

    (jl, jout), (jgm, jgo) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(means),
                                             jnp.asarray(opac))
    m = torch.tensor(means, requires_grad=True)
    o = torch.tensor(opac, requires_grad=True)
    out = tsplat.render_gaussians(
        m, torch.tensor(q), torch.tensor(s), o, torch.tensor(cols),
        torch.tensor(vm), torch.tensor(INTR), W, H, max_per_tile=64,
        background=torch.tensor(bg), camera_model=camera, dist=dist,
        viewmat_end=None if end is None else torch.tensor(end),
        flat_plan=t_plan, flat_bins=t_bins)
    loss = (out["rgb"] ** 2).mean()
    loss.backward()
    for k in ("rgb", "alpha", "depth"):
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(jout[k]), atol=2e-4,
                                   err_msg=k)
    assert float(out["alpha"].detach().max()) > 0.3
    for got, ref in ((m.grad, jgm), (o.grad, jgo)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref,
                                   atol=1e-4 * np.abs(ref).max())
    with pytest.raises(ValueError, match="perspective"):
        tsplat.render_gaussians(
            m, torch.tensor(q), torch.tensor(s), o, torch.tensor(cols),
            torch.tensor(vm), torch.tensor(INTR), W, H, ortho=True,
            camera_model="fisheye")
