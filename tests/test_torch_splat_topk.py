"""The port's top-K compositor (ops/splat_topk.py, the plain versions of the
K3/K4 kernels) against the Pallas kernels of holoscene_tpu/ops/splat_pallas.py
run in interpret mode, on identical per-tile candidate lists.

Tolerances: forward atol 2e-4 (each pixel's sequential float32 sum against
the reference's triangular matmuls); backward atol 5e-4 / rtol 5e-3 (as the
JAX backward's own test: 256 pixel contributions summed per candidate in
another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holoscene_tpu.ops import splat_pallas as jpal
from holoscene_tpu_torch.ops import gaussians as tg
from holoscene_tpu_torch.ops import splat as tsplat
from holoscene_tpu_torch.ops import splat_topk as ttopk
from holoscene_tpu_torch.ops.splat_flat import gather_payload, tile_pixels_at
from test_torch_threads import few_torch_threads  # noqa: F401
from test_torch_walk_cases import (
    FWD_USED,
    cotangent,
    hard_fwd_tiles,
    hard_tiles,
    topk_layout,
)

FWD_ATOL = 2e-4
BWD_ATOL, BWD_RTOL = 5e-4, 5e-3
W, H, TS = 40, 44, 16      # 3 x 3 tiles; the last column and row are half / three quarters inside


def _lists(n, k, seed, wall=False):
    """Per-tile top-k lists of a random projected scene: (cand [T,k,16],
    live [T,k] float, origins [T,2]) as CPU tensors. Depths are distinct
    (continuous draws), so the selection order is unambiguous."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(1.0, 1.1, n) if wall else rng.uniform(1.2, 3.0, n)
    means = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.6, 0.6, n),
                      z], -1)
    f32 = dict(dtype=torch.float32)
    intr = torch.tensor([[W * 0.8, 0, W / 2], [0, W * 0.8, H / 2],
                         [0, 0, 1.0]])
    xy, depth, conic, radius, valid = tg.project_gaussians_fused(
        torch.as_tensor(means, **f32),
        torch.as_tensor(rng.normal(size=(n, 4)), **f32),
        torch.as_tensor(rng.uniform(0.02, 0.12 if wall else 0.08, (n, 3)),
                        **f32), torch.eye(4), intr, W, H)
    opac = torch.as_tensor(rng.uniform(0.9 if wall else 0.2, 0.97, n), **f32)
    rgb = torch.as_tensor(rng.uniform(0, 1, (n, 3)), **f32)
    top_idx, live, origins = tsplat.select_topk(
        xy, depth, radius, valid, W, H, TS, k)
    cand = gather_payload(xy, depth, conic, opac, rgb,
                          top_idx.reshape(-1)).reshape(-1, k, 16)
    return cand, live.float(), origins


def _jax_lists(cand, live):
    c = cand.numpy()
    return (jnp.asarray(c[..., 0:2]), jnp.asarray(c[..., 2:5]),
            jnp.asarray(c[..., 6:9]), jnp.asarray(c[..., 5] * live.numpy()),
            jnp.asarray(c[..., 9]))


def _cotangent(shape, origins, seed):
    """Random cotangent [T, P, 8] of the five differentiable channels, zero
    on the out-of-image pixels of edge tiles as every caller's crop makes
    it (the reference's backward composites those pixels from T = 1, the
    port's from T = 0; neither result is ever read)."""
    v = torch.as_tensor(np.random.default_rng(seed).normal(size=shape),
                        dtype=torch.float32)
    v[..., 5:] = 0.0
    _, _, in_img = tile_pixels_at(origins, TS, W, H)
    return v * in_img[..., None]


CASES = {
    # name: (n, k, seed, wall, counts override)
    "random": (300, 256, 0, False, None),
    "saturated": (1400, 512, 1, True, None),
    "prefix_bound": (600, 256, 2, False, 100),
    "count0": (300, 128, 3, False, 0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fwd_and_bwd_plain_match_pallas_interpret(case):
    n, k, seed, wall, override = CASES[case]
    cand, live, origins = _lists(n, k, seed, wall)
    n_live = live.sum(1).to(torch.int32)
    counts = n_live.clone()
    if override == 0:
        counts[0] = 0                 # one tile that must write zeros
    elif override is not None:
        assert int(n_live.max()) > 128
        counts = torch.clamp(counts, max=override)   # walk one chunk only
    g = ttopk.gate_and_pad(cand, live)

    jx = _jax_lists(cand, live)
    jorig = jnp.asarray(origins.numpy())
    jcounts = jnp.asarray(counts.numpy().astype(np.float32))
    jrgb, jdepth, jalpha, jused = jpal._core_fwd_impl(
        *jx, jorig, jcounts, TS, True, img_w=W, img_h=H)

    out, used = ttopk.composite_fwd(g, origins, counts, TS, W, H)
    np.testing.assert_array_equal(used.numpy(), np.asarray(jused)[:, 0])
    np.testing.assert_allclose(out[..., :3].numpy(), np.asarray(jrgb),
                               atol=FWD_ATOL)
    np.testing.assert_allclose(out[..., 3].numpy(), np.asarray(jdepth),
                               atol=FWD_ATOL)
    np.testing.assert_allclose(out[..., 4].numpy(), np.asarray(jalpha),
                               atol=FWD_ATOL)
    assert not out[..., 5].any() and not out[..., 7].any()
    by_count = -(-counts // 128)
    assert (used <= by_count).all()
    if wall:
        assert (used < by_count).any()      # a tile saturated and stopped
    if override == 0:
        assert int(used[0]) == 0 and not out[0, :, :5].any()
    elif override is not None:
        assert int(used.max()) == 1

    v = _cotangent(out.shape, origins, seed + 10)
    res = (*jx, jorig, jcounts, jused)
    cts = (jnp.asarray(v[..., :3].numpy()), jnp.asarray(v[..., 3].numpy()),
           jnp.asarray(v[..., 4].numpy()))
    jd_xy, jd_conic, jd_rgb, jd_op, jd_z, _, _ = jpal._core_bwd(
        TS, True, "log", 128, W, H, res, cts)
    dcand = ttopk.composite_bwd(g, origins, used, out, v, TS, W, H)
    for name, got, ref in (("xy", dcand[..., 0:2], jd_xy),
                           ("conic", dcand[..., 2:5], jd_conic),
                           ("op", dcand[..., 5], jd_op),
                           ("rgb", dcand[..., 6:9], jd_rgb),
                           ("z", dcand[..., 9], jd_z)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=BWD_ATOL, rtol=BWD_RTOL, err_msg=name)
    assert not dcand[..., 10:].any()
    # dead entries and everything beyond the walked chunks: exact zeros
    assert not dcand[live == 0].any()
    beyond = torch.arange(k)[None, :] >= used[:, None] * 128
    assert not dcand[beyond].any()


def test_fwd_and_bwd_plain_match_pallas_interpret_on_hard_tiles():
    """K3/K4 plain vs the Pallas kernels on the hand-built tiles of
    test_torch_walk_cases.py: used = 0 beside a full walk, candidates live
    in one warp's rows only or nowhere, the 0.999 clamp, edge tiles (their
    out-of-image cotangents zero: the reference starts those pixels at
    T = 1, the port at T = 0), an early stop."""
    lists, origins, (w, h) = hard_tiles()
    cand, counts = map(torch.as_tensor, topk_layout(lists))
    origins = torch.as_tensor(origins)
    jx = _jax_lists(cand, torch.ones(cand.shape[:2]))
    jorig = jnp.asarray(origins.numpy())
    jcounts = jnp.asarray(counts.numpy().astype(np.float32))
    jrgb, jdepth, jalpha, jused = jpal._core_fwd_impl(
        *jx, jorig, jcounts, TS, True, img_w=w, img_h=h)
    out, used = ttopk.composite_fwd(cand, origins, counts, TS, w, h)
    assert used.tolist() == [0, 3, 2, 2, 2, 1]
    np.testing.assert_array_equal(used.numpy(), np.asarray(jused)[:, 0])
    for got, ref in ((out[..., :3], jrgb), (out[..., 3], jdepth),
                     (out[..., 4], jalpha)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=FWD_ATOL)
    v = torch.as_tensor(cotangent(len(lists), origins.numpy(), (w, h)))
    cts = (jnp.asarray(v[..., :3].numpy()), jnp.asarray(v[..., 3].numpy()),
           jnp.asarray(v[..., 4].numpy()))
    jd_xy, jd_conic, jd_rgb, jd_op, jd_z, _, _ = jpal._core_bwd(
        TS, True, "log", 128, w, h, (*jx, jorig, jcounts, jused), cts)
    dcand = ttopk.composite_bwd(cand, origins, used, out, v, TS, w, h)
    for name, got, ref in (("xy", dcand[..., 0:2], jd_xy),
                           ("conic", dcand[..., 2:5], jd_conic),
                           ("op", dcand[..., 5], jd_op),
                           ("rgb", dcand[..., 6:9], jd_rgb),
                           ("z", dcand[..., 9], jd_z)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=BWD_ATOL, rtol=BWD_RTOL, err_msg=name)


def test_fwd_plain_matches_pallas_interpret_on_hard_fwd_tiles():
    """K3 plain vs the Pallas kernel on the forward walk's hand-built tiles
    of test_torch_walk_cases.py, without the candidates at the 1/255 cut
    (they can flip between the two on their own)."""
    lists, origins, (w, h) = hard_fwd_tiles(near_cut=False)
    cand, counts = map(torch.as_tensor, topk_layout(lists))
    origins = torch.as_tensor(origins)
    jrgb, jdepth, jalpha, jused = jpal._core_fwd_impl(
        *_jax_lists(cand, torch.ones(cand.shape[:2])),
        jnp.asarray(origins.numpy()),
        jnp.asarray(counts.numpy().astype(np.float32)), TS, True,
        img_w=w, img_h=h)
    out, used = ttopk.composite_fwd(cand, origins, counts, TS, w, h)
    assert used.tolist() == FWD_USED
    np.testing.assert_array_equal(used.numpy(), np.asarray(jused)[:, 0])
    for got, ref in ((out[..., :3], jrgb), (out[..., 3], jdepth),
                     (out[..., 4], jalpha)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=FWD_ATOL)


def test_closed_form_backward_is_the_autograd_of_the_forward():
    cand, live, origins = _lists(300, 128, 5)
    g = ttopk.gate_and_pad(cand, live).requires_grad_()
    counts = live.sum(1).to(torch.int32)
    out, used = ttopk.composite_fwd_plain(g, origins, counts, TS, W, H)
    v = _cotangent(out.shape, origins, 6)
    (auto,) = torch.autograd.grad((out * v).sum(), g)
    closed = ttopk.composite_bwd_plain(g.detach(), origins, used,
                                       out.detach(), v, TS, W, H)
    np.testing.assert_allclose(closed.numpy()[..., :10],
                               auto.numpy()[..., :10], atol=BWD_ATOL,
                               rtol=BWD_RTOL)


def test_composite_tiles_topk_pads_k_and_matches_composite_tiles_pallas():
    """K = 200 (no multiple of 128): values and gradients through the
    autograd Function against the JAX entry point, and the wrappers count
    no launch on the CPU."""
    import jax

    k = 200
    cand, live, origins = _lists(400, k, 7)
    n_live = live.sum(1)
    c = cand.clone().requires_grad_()
    n_fwd, n_bwd = ttopk.composite_fwd.launches, ttopk.composite_bwd.launches
    rgb, depth, alpha, used = ttopk.composite_tiles_topk(
        c, live, origins, tile_size=TS, n_live=n_live, img_w=W, img_h=H)
    # the loss reads in-image pixels only, as a cropped image does
    m = tile_pixels_at(origins, TS, W, H)[2].float()
    ((rgb * m[..., None]).square().sum() + (alpha * m).sum()
     + 0.1 * (depth * m).sum()).backward()
    assert (ttopk.composite_fwd.launches, ttopk.composite_bwd.launches) \
        == (n_fwd, n_bwd)

    cn = cand.numpy()

    def jloss(xy, conic, col, op, z):
        r, d, a = jpal.composite_tiles_pallas(
            xy, conic, col, op, z, jnp.asarray(live.numpy()),
            jnp.asarray(origins.numpy()), tile_size=TS, interpret=True,
            n_live=jnp.asarray(n_live.numpy()), img_w=W, img_h=H)
        jm = jnp.asarray(m.numpy())
        return (((r * jm[..., None]) ** 2).sum() + (a * jm).sum()
                + 0.1 * (d * jm).sum()), (r, d, a)

    args = (cn[..., 0:2], cn[..., 2:5], cn[..., 6:9], cn[..., 5], cn[..., 9])
    (_, (jr, jd, ja)), jg = jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
            *map(jnp.asarray, args))
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(jr),
                               atol=FWD_ATOL)
    np.testing.assert_allclose(alpha.detach().numpy(), np.asarray(ja),
                               atol=FWD_ATOL)
    np.testing.assert_allclose(depth.detach().numpy(), np.asarray(jd),
                               atol=2e-3)   # divided by alpha >= 1e-10
    got = c.grad.numpy()
    for name, sl, ref in (("xy", slice(0, 2), jg[0]),
                          ("conic", slice(2, 5), jg[1]),
                          ("rgb", slice(6, 9), jg[2])):
        np.testing.assert_allclose(got[..., sl], np.asarray(ref),
                                   atol=BWD_ATOL, rtol=BWD_RTOL, err_msg=name)
    np.testing.assert_allclose(got[..., 5], np.asarray(jg[3]), atol=BWD_ATOL,
                               rtol=BWD_RTOL)
    np.testing.assert_allclose(got[..., 9], np.asarray(jg[4]), atol=BWD_ATOL,
                               rtol=BWD_RTOL)
    assert int(used.max()) <= 2


def test_wrappers_refuse_what_the_kernels_cannot_read():
    cand, live, origins = _lists(200, 128, 8)
    counts = live.sum(1).to(torch.int32)
    with pytest.raises(ValueError, match="multiple of 128"):
        ttopk.composite_fwd(cand[:, :100].contiguous(), origins, counts, TS,
                            W, H)
    with pytest.raises(ValueError, match="int32"):
        ttopk.composite_fwd(cand, origins, counts.long(), TS, W, H)
    with pytest.raises(ValueError, match="contiguous"):
        ttopk.composite_fwd(cand.transpose(0, 1).contiguous().transpose(0, 1),
                            origins, counts, TS, W, H)
