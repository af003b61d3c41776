"""The port's renderer entry (ops/splat.py) on its top-K path against
holoscene_tpu/ops/splat.py with use_pallas=True (the Pallas kernels in
interpret mode): values and gradients, perspective and orthographic, and the
depth-picking probes. The flat path is covered by test_torch_splat_flat.py.

Tolerances: images atol 2e-4 (K3's); gradients atol 5e-4 / rtol 5e-3 (K4's,
here summed once more over the tiles a gaussian touches)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holoscene_tpu.ops import splat as jsplat
from holoscene_tpu_torch.ops import splat as tsplat
from test_torch_threads import few_torch_threads  # noqa: F401

FWD_ATOL = 2e-4
BWD_ATOL, BWD_RTOL = 5e-4, 5e-3
W, H = 48, 40
NAMES = ("means", "quats", "scales", "opacities", "colors")


def _scene(n, seed, sh=False):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.6, 0.6, n),
                      rng.uniform(1.2, 3.0, n)], -1)
    colors = (rng.normal(0, 0.3, (n, 4, 3)) if sh
              else rng.uniform(0, 1, (n, 3)))
    return [x.astype(np.float32) for x in (
        means, rng.normal(size=(n, 4)), rng.uniform(0.02, 0.08, (n, 3)),
        rng.uniform(0.2, 0.95, n), colors)]


def _intr(ortho):
    f = W * (0.45 if ortho else 0.8)
    return np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)


@pytest.mark.parametrize("case", ["perspective", "ortho", "sh_k_below_n"])
def test_topk_render_values_and_grads_match_jax(case):
    ortho = case == "ortho"
    sh = case == "sh_k_below_n"
    n, k = (300, 512) if not sh else (400, 200)   # k > n clamps to n
    host = _scene(n, 0 if not sh else 4, sh=sh)
    intr = _intr(ortho)
    bg = np.array([0.1, 0.6, 0.3], np.float32)
    wts = np.random.default_rng(9).uniform(0.5, 1.5, (H, W, 3)).astype(
        np.float32)
    kw = dict(max_per_tile=k, ortho=ortho, sh_degree=1 if sh else None)

    def jloss(*xs):
        out = jsplat.render_gaussians(
            *xs, jnp.eye(4), jnp.asarray(intr), W, H, use_pallas=True,
            background=jnp.asarray(bg), **kw)
        return ((out["rgb"] * wts).sum() + out["alpha"].sum()
                + 0.05 * out["depth"].sum()), out

    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4),
                                       has_aux=True)(*map(jnp.asarray, host))
    xs = [torch.tensor(a, requires_grad=True) for a in host]
    tout = tsplat.render_gaussians(
        *xs, torch.eye(4), torch.as_tensor(intr), W, H,
        background=torch.as_tensor(bg), **kw)
    ((tout["rgb"] * torch.as_tensor(wts)).sum() + tout["alpha"].sum()
     + 0.05 * tout["depth"].sum()).backward()

    for key in ("rgb", "alpha"):
        np.testing.assert_allclose(tout[key].detach().numpy(),
                                   np.asarray(jout[key]), atol=FWD_ATOL,
                                   err_msg=key)
    cover = np.asarray(jout["alpha"]) > 0.1
    assert cover.mean() > 0.2
    np.testing.assert_allclose(tout["depth"].detach().numpy()[cover],
                               np.asarray(jout["depth"])[cover],
                               atol=FWD_ATOL, rtol=1e-4)
    for name, x, g in zip(NAMES, xs, jg):
        assert float(x.grad.abs().max()) > 0, name
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g),
                                   atol=BWD_ATOL, rtol=BWD_RTOL,
                                   err_msg=f"grad {name}")


@pytest.mark.parametrize("ortho", [False, True])
def test_overlap_counts_and_depth_picks_equal_jax(ortho):
    means, quats, scales, opac, colors = _scene(1500, 2)
    means[:40, 2] = -1.0          # behind the camera: must count nowhere
    intr = _intr(ortho)
    jc = jsplat.tile_overlap_counts(
        *map(jnp.asarray, (means, quats, scales)), jnp.eye(4),
        jnp.asarray(intr), W, H, ortho=ortho)
    tc = tsplat.tile_overlap_counts(
        *map(torch.as_tensor, (means, quats, scales)), torch.eye(4),
        torch.as_tensor(intr), W, H, ortho=ortho)
    assert tc.dtype == torch.int32 and tc.shape == (9,)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert int(tc.max()) > 64
    for pct, lo, hi in ((99.0, 64, 1024), (50.0, 16, 128), (99.0, 64, 64)):
        assert tsplat.auto_max_per_tile(tc, pct, lo, hi) \
            == jsplat.auto_max_per_tile(np.asarray(jc), pct, lo, hi)
    assert tsplat.auto_max_per_tile(torch.zeros(0)) == 64

    def jrender(k):
        return jsplat.render_gaussians(
            *map(jnp.asarray, (means, quats, scales, opac, colors)),
            jnp.eye(4), jnp.asarray(intr), W, H, max_per_tile=int(k),
            use_pallas=True, ortho=ortho)["rgb"]

    seen = []

    def trender(k):
        seen.append(k)
        return tsplat.render_gaussians(
            *map(torch.as_tensor, (means, quats, scales, opac, colors)),
            torch.eye(4), torch.as_tensor(intr), W, H, max_per_tile=int(k),
            ortho=ortho)["rgb"]

    hi = tsplat.auto_max_per_tile(tc)
    got = tsplat.calibrate_max_per_tile(trender, lo=16, hi=hi)
    assert got == jsplat.calibrate_max_per_tile(jrender, lo=16, hi=hi)
    assert seen[0] == 16 and 16 <= got <= hi and len(seen) >= 2


def test_select_topk_sets_equal_jax_approx_max_k_on_cpu():
    """The port selects exactly (torch.topk); the reference's selection
    (holoscene_tpu/ops/splat.py select_tile_chunk: the same overlap test,
    then jax.lax.approx_max_k over -depth) is exact on the CPU, where its
    per-tile sets must equal the port's. Depths are distinct, so the sets
    are unique; k below and above every tile's overlap count."""
    rng = np.random.default_rng(9)
    n = 700
    xy = rng.uniform(-8, W + 8, (n, 2)).astype(np.float32)
    depth = rng.permutation(n).astype(np.float32) * 0.01 + 1.0
    radius = rng.uniform(1.0, 14.0, n).astype(np.float32)
    valid = rng.uniform(size=n) > 0.1
    x0, y0 = tsplat._tile_origins(W, H, 16, "cpu")
    ov = tsplat._overlap(torch.as_tensor(xy), torch.as_tensor(radius), x0,
                         y0, 16).numpy()
    counts = (ov & valid[None, :]).sum(1)
    assert counts.min() > 64 and counts.max() < 256
    for k in (64, 256):
        idx, live, _ = tsplat.select_topk(
            *map(torch.as_tensor, (xy, depth, radius, valid)), W, H, 16, k)
        gx, gy, r = xy[None, :, 0], xy[None, :, 1], radius[None, :]
        jx0 = jnp.asarray(x0.numpy())[:, None]
        jy0 = jnp.asarray(y0.numpy())[:, None]
        overlap = ((gx + r >= jx0) & (gx - r <= jx0 + 16)
                   & (gy + r >= jy0) & (gy - r <= jy0 + 16))
        neg = jnp.where(overlap, -jnp.where(valid, depth, jnp.inf)[None, :],
                        -jnp.inf)
        vals, jidx = jax.lax.approx_max_k(neg, k)
        jlive = np.isfinite(np.asarray(vals))
        np.testing.assert_array_equal(live.numpy(), jlive)
        for t in range(idx.shape[0]):
            assert set(idx[t][live[t]].tolist()) \
                == set(np.asarray(jidx)[t][jlive[t]].tolist()), (k, t)


def test_non_pinhole_cameras_are_refused():
    """Where the unscented transform cannot go: an orthographic camera
    (the UT projects through a perspective model) and a model it does not
    know. The UT itself is held to JAX in test_torch_gaussians_ut.py."""
    host = _scene(10, 3)
    with pytest.raises(ValueError, match="perspective-only"):
        tsplat.render_gaussians(
            *map(torch.as_tensor, host), torch.eye(4),
            torch.as_tensor(_intr(True)), W, H, ortho=True,
            camera_model="fisheye")
    with pytest.raises(ValueError, match="unknown camera model"):
        tsplat.render_gaussians(
            *map(torch.as_tensor, host), torch.eye(4),
            torch.as_tensor(_intr(False)), W, H, camera_model="kannala")
