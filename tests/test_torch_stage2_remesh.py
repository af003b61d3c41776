"""Stage 2's coarse remeshing in the port (holoscene_tpu_torch/stage2/
remesh.py) against the JAX package on the CPU: the target resize against
jax.image.resize (one downsampling and one upsampling size), one view's
vertex gradient against jax.grad of JAX's coarse_recon view_grad (written
out below as holoscene_tpu/stage2/remesh.py:280-318 defines it), the
vertices after 10 iterations of coarse_recon, the host edge operations,
and the rasterizer's differentiable pix_verts with and without the
screen-size split.

Tolerances. Resize: 1e-6 absolute (both compute the same triangle-kernel
weights in float32). Vertex gradient: 1e-5 of its largest component
(float32 sums in another order). 10 iterations: 1e-5 absolute on vertices
of a 0.3-radius sphere (measured ~1e-7); the SGD with momentum compounds
the gradient's rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401

from holoscene_tpu.ops.rasterizer import rasterize_mesh as jrasterize
from holoscene_tpu.stage2 import remesh as jrm
from holoscene_tpu_torch.ops.rasterizer import rasterize_mesh
from holoscene_tpu_torch.stage2 import remesh as trm
from holoscene_tpu_torch.stage2.views import wonder3d_camera_rig

RES = 32


def _views(res: int, n: int = 3):
    """Orthographic mask + camera-frame normal targets of a 0.3-radius
    sphere from the first n Wonder3D rig poses, at res^2."""
    gt = trm.icosphere(radius=0.3, subdivisions=2)
    views = []
    for pose in wonder3d_camera_rig(np.zeros(3), 1.5)[:n]:
        out = rasterize_mesh(gt.vertices, gt.faces, pose, None, (res, res),
                             ortho_half_extent=0.5, device="cpu")
        tri = out["pix_verts"].numpy()
        nrm = np.cross(tri[..., 1, :] - tri[..., 0, :],
                       tri[..., 2, :] - tri[..., 0, :])
        nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
        views.append({"pose": pose.astype(np.float32), "half_extent": 0.5,
                      "normal": (nrm @ pose[:3, :3]).astype(np.float32),
                      "mask": out["mask"].numpy()})
    return views


def _jax_view_grad(cfg, verts, faces, view):
    """JAX's coarse_recon view_grad (remesh.py:280-318), jitted as JAX
    runs it (a traced call skips the screen-size split)."""

    @jax.jit
    def view_grad(verts_j, faces_j, pose, half_extent, tgt_normal, tgt_mask):
        def loss_fn(v):
            out = jrasterize(v, faces_j, pose, None, (cfg.img_res, cfg.img_res),
                             ortho_half_extent=half_extent)
            mask = out["mask"].astype(jnp.float32)
            mask_l = jnp.mean((mask - tgt_mask) ** 2)
            tri = out["pix_verts"]
            n = jnp.cross(tri[..., 1, :] - tri[..., 0, :],
                          tri[..., 2, :] - tri[..., 0, :])
            n = n / jnp.sqrt(jnp.sum(n * n, -1, keepdims=True) + 1e-12)
            n_cam = n @ pose[:3, :3]
            both = (mask * tgt_mask)[..., None]
            normal_l = jnp.sum(both * (n_cam - tgt_normal) ** 2) / (
                jnp.maximum(both.sum() * 3, 1.0))
            e0, e1, e2 = (v[faces_j[:, k]] for k in range(3))
            lap = ((e0 - e1) ** 2 + (e1 - e2) ** 2 + (e2 - e0) ** 2).mean()
            return (cfg.mask_weight * mask_l + cfg.normal_weight * normal_l
                    + cfg.laplacian_weight * lap)

        return jax.grad(loss_fn)(verts_j)

    return np.asarray(view_grad(
        jnp.asarray(verts, jnp.float32), jnp.asarray(faces, jnp.int32),
        jnp.asarray(view["pose"]), jnp.asarray(float(view["half_extent"])),
        jnp.asarray(view["normal"]), jnp.asarray(view["mask"], jnp.float32)))


@pytest.mark.parametrize("src", [128, 32])
def test_resize_matches_jax_image_resize(src):
    rng = np.random.default_rng(src)
    img = rng.uniform(-1, 1, (src, src, 3)).astype(np.float32)
    mask = (rng.uniform(size=(src, src)) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        trm.resize_bilinear(img, 64),
        np.asarray(jax.image.resize(img, (64, 64, 3), "bilinear")),
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        trm.resize_bilinear(mask, 64),
        np.asarray(jax.image.resize(mask, (64, 64), "bilinear")),
        rtol=0, atol=1e-6)


def test_view_grad_matches_jax():
    cfg = trm.CoarseReconConfig(img_res=RES)
    mesh = trm.icosphere(0.25, (0.02, -0.01, 0.0), subdivisions=1)
    view = _views(RES)[1]
    want = _jax_view_grad(cfg, mesh.vertices, mesh.faces, view)
    got = trm.view_grad(mesh.vertices, mesh.faces, view, cfg, "cpu")
    scale = float(np.abs(want).max())
    assert scale > 0 and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


def test_coarse_recon_ten_iterations_match_jax():
    """10 iterations (no remesh round yet) from views at 48^2, resampled to
    the recon's 32^2."""
    views = _views(48)
    cfg = jrm.CoarseReconConfig(iters=10, img_res=RES)
    want = jrm.coarse_recon(views, np.zeros(3), 0.35, cfg, seed=3)
    got = trm.coarse_recon(views, np.zeros(3), 0.35,
                           trm.CoarseReconConfig(iters=10, img_res=RES),
                           seed=3, device="cpu")
    np.testing.assert_array_equal(got.faces, want.faces)
    np.testing.assert_allclose(got.vertices, want.vertices, rtol=0,
                               atol=1e-5)
    assert np.abs(got.vertices - trm.icosphere(
        0.35 * 0.7, subdivisions=1).vertices).max() > 1e-3


def test_remesh_step_matches_jax():
    m = trm.icosphere(0.5, subdivisions=2)
    v = m.vertices * np.array([1.6, 1.0, 0.7])
    for target in (0.05, 0.2):
        tv_, tf_ = trm.remesh_step(v, m.faces, target)
        jv_, jf_ = jrm.remesh_step(v, m.faces, target)
        np.testing.assert_array_equal(tf_, jf_)
        np.testing.assert_array_equal(tv_, jv_)


@pytest.mark.parametrize("split", [False, True])
def test_pix_verts_gradient_reaches_the_callers_vertices(split):
    """One screen-filling triangle (split into many when the screen-size
    guard runs): every pixel's pix_verts are the caller's face 0 (an empty
    pixel's too, as JAX's faces[max(face_id, 0)]), so d sum(c * pix_verts)
    / d vertices[faces[0, k]] is c[..., k, :] summed over the image — with
    and without the split, through the caller's own tensor."""
    v = torch.tensor([[-0.9, -0.9, 1.0], [0.9, -0.9, 1.0], [0.0, 0.9, 1.0]],
                     requires_grad=True)
    faces = torch.tensor([[0, 2, 1]])
    out = rasterize_mesh(v, faces, np.eye(4), None, (16, 16),
                         ortho_half_extent=1.0, device="cpu",
                         auto_subdivide=split)
    c = torch.randn(16, 16, 3, 3, generator=torch.Generator().manual_seed(0))
    (out["pix_verts"] * c).sum().backward()
    # without the split the fragment grid's 21 samples leave holes
    covered = int(out["mask"].sum())
    assert (40 < covered < 256) if split else (0 < covered <= 21)
    want = c.sum((0, 1))[[0, 2, 1]]       # corner k is vertex faces[0, k]
    torch.testing.assert_close(v.grad, want)
