"""Hand-built tiles for the tile walks K1-K4 (the inputs a walk is most
likely to get wrong), in both layouts, and the plain versions held to their
own claims on them. No JAX here: tests/test_torch_splat_flat.py and
tests/test_torch_splat_topk.py hold the plain versions against the JAX
kernels on these tiles, tests/test_torch_cuda_kernels.py the CUDA kernels
against plain.

The 3 x 2 tiles of `hard_tiles` (tile size ts, image 2.5 x 1.5 tiles, so the
last column and the last row are half outside the image), built for the
backward walks:
  0  no candidate at all: used = 0 beside
  1  three chunks of faint candidates: the walk takes every chunk
  2  (edge column) candidates over the whole tile, the out-of-image half too
  3  (edge row) candidates live in the tile's first rows only (one warp of a
     16 x 16 tile), candidates live nowhere (opacity under 1/255, or far
     away), a few ordinary ones; two chunks
  4  (edge row) two candidates of opacity 1 whose alpha is clamped to 0.999
     around their centres, one of them centred on a pixel centre (power = 0),
     among faint ones; two chunks
  5  (corner) an opaque first chunk: the walk stops after it and the second
     chunk's rows stay exact zeros
The 4 x 2 tiles of `hard_fwd_tiles` are built for the forward walks (their
per-warp test and their stops); its docstring lists them.
"""

import numpy as np
import pytest
import torch

from holoscene_tpu_torch.ops import splat_flat as tflat
from holoscene_tpu_torch.ops import splat_topk as ttopk
from test_torch_threads import few_torch_threads  # noqa: F401

CHUNK = tflat.CHUNK
BWD_ATOL, BWD_RTOL = 5e-4, 5e-3   # as the files that use these tiles


def _rows(rng, x, y, sigma, op):
    """Candidate rows [n, 16] at centres (x, y) with isotropic-ish conics."""
    n = len(x)
    ca = 1.0 / np.square(sigma * rng.uniform(0.8, 1.25, n))
    cc = 1.0 / np.square(sigma * rng.uniform(0.8, 1.25, n))
    cb = rng.uniform(-0.5, 0.5, n) * np.sqrt(ca * cc)
    rows = np.zeros((n, 16), np.float32)
    rows[:, 0], rows[:, 1] = x, y
    rows[:, 2], rows[:, 3], rows[:, 4] = ca, cb, cc
    rows[:, 5] = op
    rows[:, 6:9] = rng.uniform(0, 1, (n, 3))
    rows[:, 10] = 1.0
    return rows


def hard_tiles(seed=0, ts=16):
    """(lists, origins, (w, h)): six per-tile candidate lists ([n_i, 16]
    float32, front to back) and the tiles' pixel origins [6, 2]."""
    rng = np.random.default_rng(seed)
    w, h = ts * 5 // 2, ts * 3 // 2
    origins = np.array([[tx * ts, ty * ts] for ty in range(2)
                        for tx in range(3)], np.float32)
    u = lambda lo, hi, n: rng.uniform(lo, hi, n)   # noqa: E731
    s = ts / 16.0

    def over(t, n, sigma, op):
        ox, oy = origins[t]
        return _rows(rng, ox + u(0, ts, n), oy + u(0, ts, n), sigma, op)

    lists = [np.zeros((0, 16), np.float32)]
    lists.append(over(1, 300, u(2 * s, 5 * s, 300), u(0.02, 0.1, 300)))
    lists.append(over(2, 150, u(1.5 * s, 4 * s, 150), u(0.1, 0.6, 150)))
    ox, oy = origins[3]
    top = _rows(rng, ox + u(0, ts, 40), oy + u(0.3, 1.2, 40),
                np.full(40, 0.25), u(0.3, 0.9, 40))
    faint = over(3, 40, u(2 * s, 5 * s, 40), np.full(40, 0.003))
    away = _rows(rng, ox + u(200, 300, 20), oy + u(200, 300, 20),
                 np.full(20, 2.0), u(0.3, 0.9, 20))
    plain = over(3, 30, u(2 * s, 4 * s, 30), u(0.1, 0.5, 30))
    mixed = np.concatenate([top, faint, away, plain])
    lists.append(mixed[rng.permutation(len(mixed))])
    ox, oy = origins[4]
    clamp = _rows(rng, np.array([ox + 5.5, ox + 10.25]),
                  np.array([oy + 3.5, oy + 5.75]), np.full(2, 40.0 * s),
                  np.ones(2))
    clamp[:, 3] = 0.0
    clamp[:, 2] = clamp[:, 4] = 1.0 / (40.0 * s) ** 2
    rest = over(4, 158, u(1.5 * s, 4 * s, 158), u(0.02, 0.1, 158))
    lists.append(np.concatenate([rest[:50], clamp[:1], rest[50:120],
                                 clamp[1:], rest[120:]]))
    wall = over(5, 128, u(5 * s, 8 * s, 128), np.full(128, 0.95))
    lists.append(np.concatenate([wall, over(5, 50, u(2 * s, 4 * s, 50),
                                            u(0.2, 0.8, 50))]))
    for rows in lists:
        rows[:, 9] = 1.0 + 0.01 * np.arange(len(rows))    # depth, ascending
    return lists, origins, (w, h)


def _thin(rng, ox, oy, ts, n, vertical):
    """n thin ellipses (long sigma 40 ts/16, short 0.35 px, |cb| near
    sqrt(ca cc)) whose centres lie 3-10 px left of (or above) the tile at
    (ox, oy) and whose long axes cross it near one row (or column)."""
    s = ts / 16.0
    theta = rng.uniform(-0.25, 0.25, n) + (np.pi / 2 if vertical else 0.0)
    cos, sin = np.cos(theta), np.sin(theta)
    long2, short2 = (40.0 * s) ** 2, 0.35 ** 2
    ca = cos ** 2 / long2 + sin ** 2 / short2
    cc = sin ** 2 / long2 + cos ** 2 / short2
    cb = cos * sin * (1.0 / long2 - 1.0 / short2)
    xc = ox + rng.uniform(1, ts - 1, n)         # a point of the tile on
    yc = oy + rng.uniform(1, ts - 1, n)         # the long axis
    if vertical:
        dist = yc - oy + rng.uniform(3, 10, n)
    else:
        dist = xc - ox + rng.uniform(3, 10, n)
    rows = _rows(rng, xc - dist * cos, yc - dist * sin, np.ones(n),
                 rng.uniform(0.6, 0.95, n))
    rows[:, 2], rows[:, 3], rows[:, 4] = ca, cb, cc
    return rows


def _single_pixel(rng, ox, oy, pixels):
    """Candidates of sigma 0.3 px centred on the given (col, row) pixel
    centres of the tile at (ox, oy): alpha >= 1/255 there only."""
    pix = np.asarray(pixels, np.float32)
    n = len(pix)
    rows = _rows(rng, ox + pix[:, 0] + 0.5, oy + pix[:, 1] + 0.5,
                 np.full(n, 0.3), np.full(n, 0.8))
    rows[:, 3] = 0.0
    rows[:, 2] = rows[:, 4] = 1.0 / 0.09
    return rows


def _near_cut(rng, ox, oy, n):
    """n isotropic candidates whose alpha at one pixel centre (x0, y0) of
    the tile's top-left 8 x 4 block lies 1e-8..1e-6 from 1/255, above and
    below it: the centre sits 2-4 px to the right of that pixel, so the
    block's warp sees it exactly at the Schur bound."""
    x0 = ox + 7.5 - np.arange(n) % 3
    y0 = oy + 0.5 + np.arange(n) % 4
    r = rng.uniform(2.0, 4.0, n)
    op = rng.uniform(0.3, 0.9, n)
    target = (1.0 + np.where(np.arange(n) % 2, 1.0, -1.0)
              * rng.uniform(2e-5, 2e-4, n)) / 255.0
    s = 2.0 * np.log(op / target) / (r * r)
    rows = _rows(rng, x0 + r, y0, np.ones(n), op)
    rows[:, 2] = rows[:, 4] = s
    rows[:, 3] = 0.0
    return rows


def _wall(rng, ox, oy, ts, n):
    """n opaque candidates (opacity 0.99, sigma 30 ts/16) over the whole
    tile: a few of them take every pixel's T below 1e-4."""
    return _rows(rng, ox + ts / 2 + rng.uniform(-1, 1, n),
                 oy + ts / 2 + rng.uniform(-1, 1, n),
                 np.full(n, 30.0 * ts / 16.0), np.full(n, 0.99))


def hard_fwd_tiles(seed=0, ts=16, near_cut=True):
    """Hand-built tiles for the forward walks K1 / K3, whose per-warp test
    and look-ahead are most likely to go wrong on them: (lists, origins,
    (w, h)) as hard_tiles, 4 x 2 tiles of an image 3.5 x 2 tiles large:
      0  thin, strongly anisotropic ellipses centred outside the tile that
         cross it near one row or one column
      1  candidates live at a single pixel each, the corners of warps
      2  near_cut: candidates whose alpha at one pixel sits within 1e-6 of
         1/255 (left out of comparisons with JAX, where such a candidate
         may flip on its own), among ordinary ones
      3  conics that are not positive definite (indefinite, negative,
         zero, singular) among ordinary ones
      4  saturates in the last eight candidates of its first chunk: the
         stop falls on a chunk boundary, chunk 1 is not walked
      5  saturates in the middle of chunk 1 of 3
      6  never saturates: every chunk walked
      7  (edge column, half outside the image) thin ellipses, single-pixel
         candidates, a wall beyond the image edge and ordinary ones"""
    rng = np.random.default_rng(seed)
    w, h = ts * 7 // 2, ts * 2
    origins = np.array([[tx * ts, ty * ts] for ty in range(2)
                        for tx in range(4)], np.float32)
    u = lambda lo, hi, n: rng.uniform(lo, hi, n)   # noqa: E731
    s = ts / 16.0

    def over(t, n, sigma, op):
        ox, oy = origins[t]
        return _rows(rng, ox + u(0, ts, n), oy + u(0, ts, n), sigma, op)

    def ordinary(t, n):
        return over(t, n, u(1.5 * s, 4 * s, n), u(0.02, 0.15, n))

    corners = [(0, 0), (ts - 1, 0), (7, 3), (8, 4), (ts - 1, 1), (0, ts - 1),
               (ts - 1, ts - 1), (7, 1)]
    lists = []
    ox, oy = origins[0]
    lists.append(np.concatenate([_thin(rng, ox, oy, ts, 8, False),
                                 _thin(rng, ox, oy, ts, 6, True),
                                 ordinary(0, 20)]))
    ox, oy = origins[1]
    lists.append(np.concatenate([ordinary(1, 30),
                                 _single_pixel(rng, ox, oy, corners),
                                 ordinary(1, 30)]))
    ox, oy = origins[2]
    lists.append(np.concatenate(
        [ordinary(2, 40)] + ([_near_cut(rng, ox, oy, 12)] if near_cut else [])
        + [ordinary(2, 40)]))
    ox, oy = origins[3]
    odd = _rows(rng, ox + u(2, ts - 2, 5), oy + u(2, ts - 2, 5), np.ones(5),
                np.full(5, 0.1))
    odd[:, 2:5] = [[0.05, 0.1, 0.05],      # indefinite
                   [-0.02, 0.0, 0.03],     # a negative diagonal
                   [0.0, 0.0, 0.0],        # zero: alpha = op everywhere
                   [0.04, 0.04, 0.04],     # singular: a line
                   [0.3, 0.0, -0.3]]
    lists.append(np.concatenate([ordinary(3, 50), odd, ordinary(3, 50)]))
    ox, oy = origins[4]
    lists.append(np.concatenate([ordinary(4, CHUNK - 8), _wall(rng, ox, oy,
                                                               ts, 8),
                                 ordinary(4, 60)]))
    ox, oy = origins[5]
    lists.append(np.concatenate([ordinary(5, CHUNK + 40),
                                 _wall(rng, ox, oy, ts, 8),
                                 ordinary(5, CHUNK + 20)]))
    lists.append(over(6, 250, u(2 * s, 5 * s, 250), u(0.02, 0.06, 250)))
    ox, oy = origins[7]
    beyond = _wall(rng, ox + ts, oy, ts, 4)
    beyond[:, 0] = ox + ts * 0.75 + u(0, 2, 4)
    beyond[:, 2] = beyond[:, 4] = 1.0 / 9.0
    lists.append(np.concatenate([_thin(rng, ox, oy, ts, 6, False),
                                 _single_pixel(rng, ox, oy, corners[:4]),
                                 beyond, ordinary(7, 40)]))
    for rows in lists:
        rows[:, 9] = 1.0 + 0.01 * np.arange(len(rows))    # depth, ascending
    return lists, origins, (w, h)


def flat_layout(lists):
    """The lists as flat chunk ranges: cand [c_max, 16] (zero rows pad each
    tile's last chunk; one spare chunk at the end belongs to no tile), cs /
    cc [T] int32."""
    chunks = [-(-len(rows) // CHUNK) for rows in lists]
    cand = np.zeros(((sum(chunks) + 1) * CHUNK, 16), np.float32)
    cs = np.concatenate([[0], np.cumsum(chunks)[:-1]]).astype(np.int32)
    for rows, c0 in zip(lists, cs):
        cand[c0 * CHUNK:c0 * CHUNK + len(rows)] = rows
    return cand, cs, np.asarray(chunks, np.int32)


def topk_layout(lists):
    """The lists as per-tile top-K lists: cand [T, K, 16] zero-padded to the
    longest list's chunks, counts [T] int32."""
    k = max(-(-len(rows) // CHUNK) for rows in lists) * CHUNK
    cand = np.zeros((len(lists), k, 16), np.float32)
    for t, rows in enumerate(lists):
        cand[t, :len(rows)] = rows
    return cand, np.asarray([len(rows) for rows in lists], np.int32)


def cotangent(n_tiles, origins, size, ts=16, seed=1):
    """Random cotangent [T, ts^2, 8] of the five differentiable channels,
    zero on out-of-image pixels as every caller's crop makes it."""
    v = np.random.default_rng(seed).normal(
        size=(n_tiles, ts * ts, 8)).astype(np.float32)
    v[..., 5:] = 0.0
    in_img = tflat.tile_pixels_at(torch.as_tensor(origins), ts, *size)[2]
    return v * in_img.numpy()[..., None]


def _t(x):
    return torch.as_tensor(np.array(x))


def _keep(lists, origins, size, t, ts=16):
    """[P, n] bool: alpha >= 1/255 of tile t's candidates at its pixels."""
    px, py, in_img = tflat.tile_pixels_at(_t(origins[t:t + 1]), ts, *size)
    keep = tflat._chunk_alpha(px, py, _t(lists[t])[None])[6][0]
    return keep, in_img[0]


def test_hard_tiles_are_what_they_claim():
    lists, origins, size = hard_tiles()
    keep3, _ = _keep(lists, origins, size, 3)
    rows_live = keep3.reshape(16, 16, -1).any(1)             # [tile row, n]
    one_warp = rows_live[:2].any(0) & ~rows_live[2:].any(0)
    assert one_warp.sum() >= 30                # live in rows 0-1 only
    assert (~rows_live.any(0)).sum() >= 50     # live nowhere
    px, py, _ = tflat.tile_pixels_at(_t(origins[4:5]), 16, *size)
    a_pre = tflat._chunk_alpha(px, py, _t(lists[4])[None])[4][0]
    power = tflat._chunk_alpha(px, py, _t(lists[4])[None])[2][0]
    clamped = (a_pre >= 0.999).sum(0)
    assert (clamped > 1).sum() == 2            # both opacity-1 candidates
    assert ((power == 0) & (a_pre >= 0.999)).any()
    assert not _keep(lists, origins, size, 2)[1].all()       # edge tile


@pytest.mark.parametrize("layout", ["flat", "topk"])
def test_plain_walks_on_hard_tiles(layout):
    """used = 0 beside a full walk, an early stop; the closed-form backward
    is autograd's of the forward; rows of unwalked chunks, of padding and of
    candidates live nowhere are exact zeros."""
    lists, origins, size = hard_tiles()
    v = _t(cotangent(len(lists), origins, size))
    if layout == "flat":
        cand, cs, cc = map(_t, flat_layout(lists))
        geom = (3, 16, *size)
        cand.requires_grad_()
        out = tflat.flat_fwd_plain(cand, cs, cc, *geom)
        used = out[:, 0, 5].detach().int()
        closed = tflat.flat_bwd_plain(cand.detach(), cs, out.detach(), v,
                                      *geom)
        rows_of = [closed[int(c0) * CHUNK:int(c0 + n) * CHUNK]
                   for c0, n in zip(cs, cc)]
        assert not closed[-CHUNK:].any()       # the spare chunk
    else:
        cand, counts = map(_t, topk_layout(lists))
        cc = -(-counts // CHUNK)
        cand.requires_grad_()
        out, used = ttopk.composite_fwd_plain(cand, _t(origins), counts, 16,
                                              *size)
        closed = ttopk.composite_bwd_plain(cand.detach(), _t(origins), used,
                                           out.detach(), v, 16, *size)
        rows_of = list(closed)
    assert used.tolist() == [0, 3, 2, 2, 2, 1]
    assert cc.tolist() == [0, 3, 2, 2, 2, 2]
    (auto,) = torch.autograd.grad((out[..., :5] * v[..., :5]).sum(), cand)
    np.testing.assert_allclose(closed.numpy()[..., :10],
                               auto.numpy()[..., :10], atol=BWD_ATOL,
                               rtol=BWD_RTOL)
    assert not closed[..., 10:].any()
    assert not rows_of[5][CHUNK:].any()        # stopped after chunk 0
    assert rows_of[1][:300].abs().sum(1).gt(0).all()
    for t, rows in enumerate(lists):
        assert not rows_of[t][len(rows):].any()              # padding
        if len(rows):
            dead = ~_keep(lists, origins, size, t)[0].any(0)
            assert not rows_of[t][:len(rows)][dead].any()


@pytest.mark.parametrize("layout", ["flat", "topk"])
def test_plain_backward_with_float64_sums_keeps_the_float32_walk(layout):
    """acc=float64 (the card check's exact reference for K2/K4): float64
    rows, non-zero exactly where the float32 walk's are (the alphas and
    their masks stay float32), and within the walks' tolerance of them."""
    lists, origins, size = hard_tiles()
    v = _t(cotangent(len(lists), origins, size))
    if layout == "flat":
        cand, cs, cc = map(_t, flat_layout(lists))
        geom = (3, 16, *size)
        out = tflat.flat_fwd_plain(cand, cs, cc, *geom)
        f32, f64 = (tflat.flat_bwd_plain(cand, cs, out, v, *geom, acc=acc)
                    for acc in (None, torch.float64))
    else:
        cand, counts = map(_t, topk_layout(lists))
        out, used = ttopk.composite_fwd_plain(cand, _t(origins), counts, 16,
                                              *size)
        f32, f64 = (ttopk.composite_bwd_plain(cand, _t(origins), used, out,
                                              v, 16, *size, acc=acc)
                    for acc in (None, torch.float64))
    assert f32.dtype == torch.float32 and f64.dtype == torch.float64
    assert torch.equal(f32 != 0, f64 != 0)
    assert f64[..., :10].abs().sum(-1).gt(0).any()
    np.testing.assert_allclose(f32.numpy(), f64.numpy(), atol=BWD_ATOL,
                               rtol=BWD_RTOL)


FWD_USED = [1, 1, 1, 1, 1, 2, 2, 1]      # hard_fwd_tiles, walked chunks
FWD_CHUNKS = [1, 1, 1, 1, 2, 3, 2, 1]    # and chunks available


def _alpha(rows, origin, size, ts):
    """(a_pre, keep) [P, n] of candidate rows at the pixels of one tile."""
    px, py, _ = tflat.tile_pixels_at(_t(origin[None]), ts, *size)
    k = tflat._chunk_alpha(px, py, _t(rows)[None])
    return k[4][0], k[6][0]


def test_hard_fwd_tiles_are_what_they_claim():
    lists, origins, size = hard_fwd_tiles()
    ts = 16
    # 0: thin ellipses centred outside the tile, live in a narrow band
    thin = lists[0][:14]
    outside = ((thin[:, 0] < origins[0, 0]) | (thin[:, 1] < origins[0, 1]))
    assert outside.all()
    assert (thin[:, 3] ** 2 > 0.95 * thin[:, 2] * thin[:, 4]).all()
    live = _alpha(thin, origins[0], size, ts)[1].sum(0)
    assert (live > 0).all() and (live < 0.25 * ts * ts).all()
    # 1: single-pixel candidates
    assert (_alpha(lists[1][30:38], origins[1], size, ts)[1].sum(0)
            == 1).all()
    # 2: alpha within 1e-6 of the cut at one pixel, on both sides of it
    a_pre = _alpha(lists[2][40:52], origins[2], size, ts)[0]
    gap = (a_pre - tflat.ALPHA_EPS).abs().amin(0)
    assert ((gap > 1e-8) & (gap < 1e-6)).all()
    nearest = a_pre.gather(0, (a_pre - tflat.ALPHA_EPS).abs().argmin(
        0, keepdim=True))[0]
    assert (nearest > tflat.ALPHA_EPS).any() \
        and (nearest < tflat.ALPHA_EPS).any()
    assert len(hard_fwd_tiles(near_cut=False)[0][2]) == 80
    # 3: conics that are not positive definite, each live somewhere
    odd = lists[3][50:55]
    assert not ((odd[:, 2] > 0) & (odd[:, 4] > 0)
                & (odd[:, 2] * odd[:, 4] > odd[:, 3] ** 2)).any()
    assert _alpha(odd, origins[3], size, ts)[1].any(0).all()
    # 4 / 5 / 6: the stops, and where they fall without the walls
    cand, counts = map(_t, topk_layout(lists))
    out, used = ttopk.composite_fwd_plain(cand, _t(origins), counts, ts,
                                          *size)
    assert used.tolist() == FWD_USED
    assert (-(-counts // CHUNK)).tolist() == FWD_CHUNKS
    assert out[6, :, 4].max() < 1.0 - tflat.TERM_EPS     # never saturates
    cand[4, CHUNK - 8:CHUNK, 5] = 0.0
    cand[5, CHUNK + 40:CHUNK + 48, 5] = 0.0
    used_open = ttopk.composite_fwd_plain(cand, _t(origins), counts, ts,
                                          *size)[1]
    assert used_open[4:6].tolist() == [2, 3]


def _warp_cases(case):
    """(rect [T, W, 4], candidate rows [T, C, 16], live [T, W, C]) of one
    sweep for the per-warp test, with warps as the kernels map them."""
    rng = np.random.default_rng(3)
    if case.startswith("hard_fwd_tiles"):
        ts = int(case[-2:])
        lists, origins, size = hard_fwd_tiles(ts=ts)
        cand = _t(topk_layout(lists)[0])
        org = _t(origins)
    else:
        ts, n_tiles = 16, 48
        org = _t(rng.integers(0, 8, (n_tiles, 2)) * ts).float()
        cand = torch.zeros(n_tiles, CHUNK, 16)
        n = n_tiles * CHUNK
        if case == "random":
            # covariances from round to needle-thin, centres around the tile
            big = np.exp(rng.uniform(np.log(0.2), np.log(60), n))
            small = np.exp(rng.uniform(np.log(0.05), np.log(10), n))
            theta = rng.uniform(0, np.pi, n)
            cos, sin = np.cos(theta), np.sin(theta)
            ca = cos ** 2 / big ** 2 + sin ** 2 / small ** 2
            cc = sin ** 2 / big ** 2 + cos ** 2 / small ** 2
            cb = cos * sin * (1 / big ** 2 - 1 / small ** 2)
            xy = rng.uniform(-60, 76, (n, 2))
            op = np.where(rng.uniform(size=n) < 0.2,
                          rng.uniform(0.0039, 0.0041, n), rng.uniform(0, 1, n))
        else:
            # "tight": left of the tile on a pixel row, where the Schur bound
            # is exact, at alpha 1/255 (+-1e-6 relative) on the first column
            ca = np.exp(rng.uniform(np.log(1e-3), np.log(10), n))
            cc = ca * rng.uniform(0.5, 2, n)
            cb = np.zeros(n)
            op = rng.uniform(0.01, 1.0, n)
            thr = 2 * np.log(255 * op)
            xy = np.stack([0.5 - np.sqrt(thr / ca)
                           * (1 + rng.uniform(-1e-6, 1e-6, n)),
                           0.5 + np.round(rng.uniform(0, 15, n))], -1)
        rows = np.stack([xy[:, 0], xy[:, 1], ca, cb, cc, op], -1)
        cand[..., :6] = _t(rows.astype(np.float32)).reshape(n_tiles, CHUNK, 6)
        cand[..., :2] += org[:, None]
        size = (10 ** 6, 10 ** 6)
    order = tflat.fwd_thread_pixels(ts)
    px, py, _ = tflat.tile_pixels_at(org, ts, *size)
    px, py = px[:, order], py[:, order]
    keep = tflat._chunk_alpha(px, py, cand)[6]
    n_t, n_p, n_c = keep.shape
    live = keep.reshape(n_t, n_p // 32, 32, n_c).any(2)
    return tflat.warp_rects(px, py), cand, live


@pytest.mark.parametrize("case", ["hard_fwd_tiles16", "hard_fwd_tiles32",
                                  "random", "tight"])
def test_warp_test_never_drops_a_live_candidate(case, monkeypatch):
    """The plain mirror of the forward walk's per-warp test never rejects
    a candidate that alpha >= 1/255 keeps at some pixel of the warp; it
    rejects every opacity below 1/255, no conic that is not positive
    definite, and most of what it can; on the tight sweep it is the margin
    that keeps it right."""
    rect, cand, live = _warp_cases(case)
    ok = tflat.warp_may_keep_plain(rect, cand)
    assert not (live & ~ok).any()
    op = cand[..., 5][:, None, :].expand_as(ok)
    assert not ok[op < tflat.ALPHA_EPS].any()
    ca, cb, cc = (cand[..., i].double() for i in (2, 3, 4))
    odd = ~((ca > 0) & (cc > 0) & (ca * cc - cb * cb > 0))
    assert ok[odd[:, None, :].expand_as(ok) & (op >= tflat.ALPHA_EPS)].all()
    assert (~ok & ~live).sum() > 0.3 * (~live).sum()
    if case == "tight":
        monkeypatch.setattr(tflat, "CUT_MARGIN", 0.0)
        monkeypatch.setattr(tflat, "CUT_MARGIN_REL", 0.0)
        bare = tflat.warp_may_keep_plain(rect, cand)
        assert (live & ~bare).any()


def test_forward_kernels_share_one_walk():
    """K1 and K3 are one forward walk (splat_walk.cuh::composite_tile), on
    the staging helpers K2 and K4 use."""
    from holoscene_tpu_torch import kernels

    walk = (kernels.CSRC / "splat_walk.cuh").read_text()
    code = "\n".join(line.split("//")[0] for line in walk.splitlines())
    assert code.count("prefetch_chunk(") == 5   # defined, 2 forward, 2 back
    for name in ("splat_flat_fwd.cu", "splat_topk_fwd.cu"):
        src = (kernels.CSRC / name).read_text()
        code = "\n".join(line.split("//")[0] for line in src.splitlines())
        assert code.count("composite_tile(") == 1
        assert "composite_chunk" not in code and "__shared__" not in code


def test_backward_kernels_share_one_walk_without_atomics():
    """K2 and K4 are one walk (splat_walk.cuh::backprop_tile) whose sums are
    stored, never added atomically: the order of every sum is fixed."""
    from holoscene_tpu_torch import kernels

    walk = (kernels.CSRC / "splat_walk.cuh").read_text()
    code = "\n".join(line.split("//")[0] for line in walk.splitlines())
    assert "atomic" not in code and "backprop_tile" in code
    for name in ("splat_flat_bwd.cu", "splat_topk_bwd.cu"):
        src = (kernels.CSRC / name).read_text()
        code = "\n".join(line.split("//")[0] for line in src.splitlines())
        assert "atomic" not in code and code.count("backprop_tile(") == 1


def test_walk_bench_refuses_to_run_without_a_card():
    from holoscene_tpu_torch.utils import walk_bench

    if torch.cuda.is_available():
        pytest.skip("a card is present: the bench would run")
    assert walk_bench.main([]) == 2
