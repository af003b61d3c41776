"""Hand-built tiles for the backward tile walks K2 / K4 (the inputs a walk
is most likely to get wrong), in both layouts, and the plain versions held
to their own claims on them. No JAX here: tests/test_torch_splat_flat.py and
tests/test_torch_splat_topk.py hold the plain versions against the JAX
kernels on these tiles, tests/test_torch_cuda_kernels.py the CUDA kernels
against plain.

The 3 x 2 tiles of `hard_tiles` (tile size ts, image 2.5 x 1.5 tiles, so the
last column and the last row are half outside the image):
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
