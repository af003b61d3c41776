"""The port's gaussian ray tracer (ops/gs_trace.py) against the JAX
package's on the same numpy-seeded gaussians and rays.

  * Hit selection (plain T1 on the CPU) against JAX's streaming top-K scan,
    rebuilt here from JAX's own `_ray_hits` and `approx_max_k` (exact on the
    CPU), across several gaussian blocks: the hit sets and counts exactly,
    indices past a ray's count 0 in both.
  * Composite (rgb, depth, alpha, normal) against JAX's trace_gaussians:
    atol 1e-4 and rtol 3e-4 for kernel degrees 2 / 4 / 8 (the gray
    distance |gro|^2 - t_proj^2 cancels two terms of ~10^3 for a particle
    of scale 0.05 three units away, so one last-bit difference between
    the libraries' sums moves a response by ~1e-4 of itself); atol 2e-3
    for degree 1, whose sqrt(gray distance) makes that ~3e-4 absolute near
    a particle's axis.
  * Gradients of one loss through the composite: 1e-4 of their largest.
  * Pinhole / fisheye rays (1e-6) and trace_image (1e-4), and the tracer
    against the port's own rasterizer (PSNR > 24 dB, as JAX's test).
T1 itself (the CUDA kernel) is held against plain on the card in
tests/test_torch_cuda_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401

from holoscene_tpu.ops import gs_trace as jt
from holoscene_tpu.ops.gaussians import quat_to_rotmat as jrot
from holoscene_tpu_torch.ops import gs_trace as tt
from holoscene_tpu_torch.ops.splat import render_gaussians

SH_C0 = 0.28209479177387814
MIN_KERNEL, MIN_ALPHA, NEAR = 0.0113, 1.0 / 255.0, 1e-4


def _cloud(n=300, r=200, seed=0, sh_bases=4, min_scale=0.05):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    means[:, 2] += 3.0
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    scales = rng.uniform(min_scale, 0.3, (n, 3)).astype(np.float32)
    opac = rng.uniform(0.0, 1.0, n).astype(np.float32)
    opac[::17] = 0.0                       # dead slots
    sh = (rng.normal(size=(n, sh_bases, 3)) * 0.5).astype(np.float32)
    ro = (rng.normal(size=(r, 3)) * 0.1).astype(np.float32)
    rd = (rng.normal(size=(r, 3)) * 0.3).astype(np.float32)
    rd[:, 2] = 1.0
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return means, quats, scales, opac, sh, ro, rd


def jax_select(means, quats, scales, opac, ro, rd, k, block, degree):
    """JAX's select_block scan (holoscene_tpu/ops/gs_trace.py), from its
    own _ray_hits and approx_max_k."""
    rot = jrot(jnp.asarray(quats))
    inv = 1.0 / jnp.maximum(jnp.asarray(scales), 1e-12)
    r = ro.shape[0]
    best_t = jnp.full((r, k), -jnp.inf)
    best_i = jnp.zeros((r, k), jnp.int32)
    for b in range(0, means.shape[0], block):
        sl = slice(b, b + block)
        resp, alpha, hit_t, t_proj = jt._ray_hits(
            jnp.asarray(means)[sl], inv[sl], rot[sl], jnp.asarray(opac)[sl],
            jnp.asarray(ro), jnp.asarray(rd), degree)
        ok = (resp > MIN_KERNEL) & (alpha > MIN_ALPHA) & (t_proj > NEAR)
        neg = jnp.where(ok, -hit_t, -jnp.inf)
        idx = b + jnp.arange(neg.shape[1], dtype=jnp.int32)[None, :]
        cand_t = jnp.concatenate([best_t, neg], axis=1)
        cand_i = jnp.concatenate(
            [best_i, jnp.broadcast_to(idx, neg.shape)], axis=1)
        best_t, pos = jax.lax.approx_max_k(cand_t, k)
        best_i = jnp.take_along_axis(cand_i, pos, axis=1)
    return np.asarray(best_i), np.asarray(jnp.isfinite(best_t).sum(axis=1))


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


@pytest.fixture
def one_torch_thread():
    """The selection is compared bit for bit. Right after JAX has run in
    the same process, the first multi-threaded torch op now and then gives
    the rows of its second thread other last bits (never seen with one
    thread); one thread keeps the comparison exact."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("degree", [1, 2, 4, 8])
def test_selection_matches_jax_scan(degree, one_torch_thread):
    means, quats, scales, opac, _sh, ro, rd = _cloud()
    g13 = tt.pack_gaussians(*_t(means, quats, scales, opac))
    for k, block in ((16, 64), (96, 128)):
        ref_i, ref_c = jax_select(means, quats, scales, opac, ro, rd, k,
                                  block, degree)
        idx, cnt = tt.select_hits(g13, *_t(ro, rd), k, MIN_KERNEL,
                                  MIN_ALPHA, NEAR, degree, block=block)
        assert idx.dtype == torch.int32 and cnt.dtype == torch.int32
        np.testing.assert_array_equal(cnt.numpy(), ref_c)
        np.testing.assert_array_equal(idx.numpy(), ref_i)
        assert ref_c.min() < k and ref_c.max() >= 16  # short and full rays
    assert tt.select_hits.launches == 0               # CPU: plain, no launch


@pytest.mark.parametrize("degree", [1, 2, 4, 8])
def test_composite_and_normals_match_jax(degree):
    means, quats, scales, opac, sh, ro, rd = _cloud(seed=1)
    ref = jt.trace_gaussians(*map(jnp.asarray, (means, quats, scales, opac,
                                                sh, ro, rd)),
                             sh_degree=1, max_hits=32, block=128,
                             kernel_degree=degree, with_normal=True)
    got = tt.trace_gaussians(*_t(means, quats, scales, opac, sh, ro, rd),
                             sh_degree=1, max_hits=32, block=128,
                             kernel_degree=degree, with_normal=True)
    atol = 2e-3 if degree == 1 else 1e-4
    for key in ("rgb", "depth", "alpha", "normal"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   atol=atol, rtol=3e-4, err_msg=key)
    assert float(got["alpha"].max()) > 0.9


def test_gradients_match_jax():
    """Particles of scale >= 0.15 (as JAX's gradient test): the gray
    distance's cancellation stays ~10^2, not ~10^3."""
    means, quats, scales, opac, sh, ro, rd = _cloud(n=64, r=48, seed=2,
                                                    min_scale=0.15)

    def jloss(m, s, o, c):
        out = jt.trace_gaussians(m, jnp.asarray(quats), s, o, c,
                                 jnp.asarray(ro), jnp.asarray(rd),
                                 sh_degree=1, max_hits=16)
        return out["rgb"].sum() + 0.1 * out["depth"].sum()

    ref = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (means, scales, opac, sh)))
    leaves = [torch.tensor(a, requires_grad=True)
              for a in (means, scales, opac, sh)]
    out = tt.trace_gaussians(leaves[0], torch.tensor(quats), *leaves[1:],
                             *_t(ro, rd), sh_degree=1, max_hits=16)
    (out["rgb"].sum() + 0.1 * out["depth"].sum()).backward()
    for leaf, r in zip(leaves, ref):
        r = np.asarray(r)
        assert np.abs(r).max() > 0
        np.testing.assert_allclose(leaf.grad.numpy(), r,
                                   atol=1e-4 * np.abs(r).max())


@pytest.mark.parametrize("camera", ["pinhole", "fisheye"])
def test_rays_and_trace_image_match_jax(camera):
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.1, -0.2, 0.05]
    c, s = np.cos(0.2), np.sin(0.2)
    pose[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    intr = np.array([[20.0, 0, 12], [0, 22.0, 8], [0, 0, 1]], np.float32)
    rays = jt.pinhole_rays if camera == "pinhole" else jt.fisheye_rays
    ref_o, ref_d = rays(pose, intr, 24, 16)
    got_o, got_d = (tt.pinhole_rays if camera == "pinhole"
                    else tt.fisheye_rays)(pose, intr, 24, 16)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(ref_o), atol=1e-6)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d), atol=1e-6)

    means, quats, scales, opac, sh, _ro, _rd = _cloud(n=120, seed=3)
    g = {"means": means, "quats": quats * 2.0,   # normalised by trace_image
         "log_scales": np.log(scales),
         "opacity_logits": np.log(opac + 1e-3) - np.log(1.001 - opac),
         "features_dc": sh[:, 0], "features_rest": sh[:, 1:]}
    ref = jt.trace_image(g, pose, intr, 24, 16, sh_degree=1, chunk=100,
                         max_hits=24)
    got = tt.trace_image(g, pose, intr, 24, 16, sh_degree=1, chunk=100,
                         max_hits=24, device="cpu")
    for key in ("rgb", "depth", "alpha"):
        assert got[key].shape == ref[key].shape
        np.testing.assert_allclose(got[key], ref[key], atol=1e-4,
                                   err_msg=key)
    assert got["alpha"].max() > 0.5


def test_trace_agrees_with_the_rasterizer():
    """The port's tracer and its tile rasterizer render the same cloud from
    one pinhole camera within 24 dB PSNR (JAX's test: the EWA projection
    and the exact 3D response differ by design in the tails)."""
    rng = np.random.default_rng(1)
    n = 80
    means = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    means[:, 2] += 2.5
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(rng.uniform(-3.5, -2.5, (n, 3))).astype(np.float32)
    opac = rng.uniform(0.3, 0.9, n).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    res = 48
    intr = np.array([[40.0, 0, res / 2], [0, 40.0, res / 2], [0, 0, 1]],
                    np.float32)
    sh = ((cols - 0.5) / SH_C0)[:, None, :]
    img_r = render_gaussians(*_t(means, quats, scales, opac, sh),
                             torch.eye(4), torch.tensor(intr), res, res,
                             sh_degree=0, max_per_tile=128)["rgb"].numpy()
    g = {"means": means, "quats": quats, "log_scales": np.log(scales),
         "opacity_logits": np.log(opac / (1 - opac)),
         "features_dc": (cols - 0.5) / SH_C0,
         "features_rest": np.zeros((n, 0, 3), np.float32)}
    img_t = tt.trace_image(g, np.eye(4), intr, res, res, sh_degree=0,
                           max_hits=64, device="cpu")["rgb"]
    mse = float(np.mean((img_r - img_t) ** 2))
    assert 10 * np.log10(1.0 / max(mse, 1e-12)) > 24.0


def test_select_hits_rejects_what_t1_cannot_hold():
    g13 = torch.zeros(4, tt.PACK)
    ro = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="1..256"):
        tt.select_hits(g13, ro, ro, 300, MIN_KERNEL, MIN_ALPHA, NEAR)
    with pytest.raises(ValueError, match="kernel_degree"):
        tt.select_hits(g13, ro, ro, 4, MIN_KERNEL, MIN_ALPHA, NEAR, 3)
    with pytest.raises(ValueError, match="float32"):
        tt.select_hits(g13.double(), ro, ro, 4, MIN_KERNEL, MIN_ALPHA, NEAR)


def test_flat_particle_response_is_exact():
    """A flat particle (scale 1e-4 across, as Gaussian-on-Mesh exports
    have) five units away: the response at a lateral offset r is
    exp(-r^2 / (2 s^2)) to float32 precision. The counterpart's
    |gro|^2 - t_proj^2 cancels two ~2.5e9 terms here and is noise."""
    s, r_off = 0.1, 0.12
    means = torch.tensor([[r_off, 0.0, 5.0]])
    quats = torch.tensor([[1.0, 0, 0, 0]])
    scales = torch.tensor([[s, s, 1e-4]])
    opac = torch.tensor([0.9])
    sh = torch.tensor((np.ones((1, 1, 3)) - 0.5) / SH_C0, dtype=torch.float32)
    out = tt.trace_gaussians(means, quats, scales, opac, sh,
                             torch.zeros(1, 3), torch.tensor([[0.0, 0, 1]]),
                             sh_degree=0, max_hits=1)
    want = 0.9 * np.exp(-r_off ** 2 / (2 * s ** 2))
    assert float(out["alpha"][0]) == pytest.approx(want, rel=1e-5)
    assert float(out["depth"][0]) == pytest.approx(5.0 * want, rel=1e-5)
