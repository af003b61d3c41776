# Frozen copy of holoscene_tpu_torch/ops/splat_topk.py at commit badb067, for the
# benchmark's plain reference: imports rewired to port_bench.ref_s4, cut to
# the paths the benchmark's Stage-4 configuration runs, in plain PyTorch.
# Do not edit to follow the port.
"""Top-K gaussian splat compositor: the K3/K4 tile-walk kernels (port of
holoscene_tpu/ops/splat_pallas.py).

Every tile brings its own list of K depth-sorted candidates (front to back,
dead entries last), gathered by the caller as row-major [T, K, 16] payload
rows (x y conic_a conic_b conic_c opacity r g b depth 1 pad*5, the layout of
ops/splat_flat.gather_payload) with K a multiple of 128. The list is walked in
chunks of 128 by

  K3 `composite_fwd` - per tile, front to back over
      min(K / 128, ceil(count / 128)) chunks with per-tile chunk-granular
      early termination (csrc/splat_topk_fwd.cu),
  K4 `composite_bwd` - the reverse walk over exactly the chunks K3 used, in
      closed form (csrc/splat_topk_bwd.cu),

joined by the autograd Function `_TopKWalk` (the counterpart's
`_composite_core` with `_core_fwd` / `_core_bwd`). `composite_tiles_topk` is
the counterpart of `composite_tiles_pallas`. Each wrapper launches its CUDA
kernel for a CUDA tensor and runs its plain PyTorch version (`*_plain`) for a
CPU tensor; there is no fallback from one to the other.

The counterpart has a second, pure-JAX top-K compositor for backends without
Pallas and the A/B knobs cumprod_mode / chunk_size; the port has this one
compositor and 128-candidate chunks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from port_bench.ref_s4.splat_flat import (
    CAND_ROWS,
    CHUNK,
    tile_pixels_at,
    walk_bwd_plain,
    walk_fwd_plain,
)

TILE_BLOCK = 128     # tiles per pass of the plain versions ([Tb, P, 128] temps)


def _walk_lengths(counts, k):
    """Chunks each tile may walk: min(K / 128, ceil(count / 128))."""
    return torch.clamp(-(-counts.long() // CHUNK), 0, k // CHUNK)


def composite_fwd_plain(cand, origins, counts, tile_size: int, img_w: int,
                        img_h: int):
    """Plain PyTorch K3 (the CPU path and the card's reference), in passes
    of TILE_BLOCK tiles. Differentiable (autograd), which the tests use to
    check K4.

    cand [T, K, 16] f32, origins [T, 2] f32, counts [T] int32. Returns
    (out [T, P, 8] = rgb(3), depth_acc, 1 - T, 0, total log(1 - alpha), 0;
    used [T] int32 = chunks walked)."""
    n_tiles, k = cand.shape[0], cand.shape[1]
    per = k // CHUNK
    lengths = _walk_lengths(counts, k)
    px, py, in_img = tile_pixels_at(origins, tile_size, img_w, img_h)
    outs = []
    for t0 in range(0, n_tiles, TILE_BLOCK):
        sl = slice(t0, min(t0 + TILE_BLOCK, n_tiles))
        nb = sl.stop - t0
        cs = torch.arange(nb, device=cand.device) * per
        outs.append(walk_fwd_plain(
            cand[sl].reshape(-1, CHUNK, CAND_ROWS), cs, lengths[sl], px[sl],
            py[sl], in_img[sl]))
    out = torch.cat(outs) if outs else cand.new_zeros(
        0, tile_size * tile_size, 8)
    used = out[:, 0, 5].detach().to(torch.int32)
    zero = torch.zeros_like(out[..., :1])
    return torch.cat([out[..., :5], zero, out[..., 6:7], zero], -1), used


def composite_bwd_plain(cand, origins, used, fwd_out, v, tile_size: int,
                        img_w: int, img_h: int, acc=None) -> torch.Tensor:
    """Plain PyTorch K4 in closed form: walk_bwd_plain over the `used`
    chunks of each tile's list from K3's stored total (fwd_out[..., 6]),
    its sums in dtype `acc` (default cand's). Returns dcand [T, K, 16];
    slots never walked and columns 10-15 are zero."""
    n_tiles, k = cand.shape[0], cand.shape[1]
    per = k // CHUNK
    px, py, in_img = tile_pixels_at(origins, tile_size, img_w, img_h)
    outs = []
    for t0 in range(0, n_tiles, TILE_BLOCK):
        sl = slice(t0, min(t0 + TILE_BLOCK, n_tiles))
        nb = sl.stop - t0
        cs = torch.arange(nb, device=cand.device) * per
        outs.append(walk_bwd_plain(
            cand[sl].reshape(-1, CHUNK, CAND_ROWS), cs, used[sl],
            fwd_out[sl, :, 6], v[sl], px[sl], py[sl], in_img[sl], acc,
        ).reshape(nb, k, CAND_ROWS))
    return torch.cat(outs) if outs else torch.zeros_like(cand, dtype=acc)


def _check_args(cand, origins, tile_size, ints, blocks):
    """Validate what the kernels read through raw pointers: cand f32
    [T, K, 16] with K % 128 == 0; origins f32 [T, 2]; ints (counts / used)
    int32 [T]; blocks (forward output, cotangent) f32 [T, tile_size^2, 8];
    one device, contiguous."""
    if cand.dtype != torch.float32 or cand.dim() != 3 \
            or cand.shape[2] != CAND_ROWS or cand.shape[1] % CHUNK \
            or cand.shape[1] == 0:
        raise ValueError(f"cand must be f32 [T, K, {CAND_ROWS}] with K a "
                         f"positive multiple of {CHUNK}, got {cand.dtype} "
                         f"{tuple(cand.shape)}")
    if (tile_size * tile_size) % 32 or tile_size * tile_size > 1024:
        raise ValueError(f"tile_size {tile_size}: tile_size^2 must be a "
                         "multiple of 32 and <= 1024 (one thread per pixel)")
    n_tiles = cand.shape[0]
    if origins.dtype != torch.float32 or origins.shape != (n_tiles, 2):
        raise ValueError(f"origins must be f32 [{n_tiles}, 2], got "
                         f"{origins.dtype} {tuple(origins.shape)}")
    for x in ints:
        if x.dtype != torch.int32 or x.shape != (n_tiles,):
            raise ValueError(f"per-tile counts must be int32 [{n_tiles}], "
                             f"got {x.dtype} {tuple(x.shape)}")
    for x in blocks:
        if x.dtype != torch.float32 or x.shape != (
                n_tiles, tile_size * tile_size, 8):
            raise ValueError(f"tile blocks must be f32 [{n_tiles}, "
                             f"{tile_size * tile_size}, 8], got {x.dtype} "
                             f"{tuple(x.shape)}")
    for x in (cand, origins, *ints, *blocks):
        if x.device != cand.device or not x.is_contiguous():
            raise ValueError("walk tensors must share one device and be "
                             "contiguous")


def composite_fwd(cand, origins, counts, tile_size: int, img_w: int,
                  img_h: int):
    """K3 wrapper. CUDA tensor: launches `splat_topk_fwd` of
    csrc/splat_topk_fwd.cu (one block per tile, one thread per pixel, the
    forward walk of csrc/splat_walk.cuh) and counts the launch in
    `composite_fwd.launches`; CPU tensor:
    composite_fwd_plain. Returns (out [T, P, 8], used [T] int32)."""
    _check_args(cand, origins, tile_size, (counts,), ())
    return composite_fwd_plain(cand, origins, counts, tile_size, img_w,
                               img_h)


composite_fwd.launches = 0


def composite_bwd(cand, origins, used, fwd_out, v, tile_size: int,
                  img_w: int, img_h: int) -> torch.Tensor:
    """K4 wrapper. CUDA tensor: launches `splat_topk_bwd` of
    csrc/splat_topk_bwd.cu into a zeroed dcand (the zeros stand for every
    slot the walk skipped) and counts it in `composite_bwd.launches`; CPU
    tensor: composite_bwd_plain."""
    _check_args(cand, origins, tile_size, (used,), (fwd_out, v))
    return composite_bwd_plain(cand, origins, used, fwd_out, v,
                               tile_size, img_w, img_h)


composite_bwd.launches = 0


class _TopKWalk(torch.autograd.Function):
    """(out [T, P, 8], used [T]) = K3(cand); d cand = K4(cand, out, d out).
    Channel 6 of out (the total log-transmittance K4 reads) is a
    diagnostic: callers do not differentiate through it, and K4 pairs its
    cotangent with a zero payload column."""

    @staticmethod
    def forward(ctx, cand, origins, counts, tile_size, img_w, img_h):
        out, used = composite_fwd(cand, origins, counts, tile_size, img_w,
                                  img_h)
        ctx.save_for_backward(cand, origins, used, out)
        ctx.geom = (tile_size, img_w, img_h)
        ctx.mark_non_differentiable(used)
        return out, used

    @staticmethod
    def backward(ctx, d_out, _d_used):
        cand, origins, used, out = ctx.saved_tensors
        dcand = composite_bwd(cand, origins, used, out, d_out.contiguous(),
                              *ctx.geom)
        return dcand, None, None, None, None, None


def gate_and_pad(cand: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """The lists as the walks take them: opacity column gated by `live`
    [T, K] (dead entries, whatever they index, then have alpha 0 and receive
    exact-zero gradients) and K padded with zero rows to a multiple of
    128."""
    n_tiles, k = cand.shape[0], cand.shape[1]
    gate = cand.new_ones(n_tiles, k, CAND_ROWS)
    gate[..., 5] = live
    pad = (-k) % CHUNK if k else CHUNK
    return F.pad(cand * gate, (0, 0, 0, pad)).contiguous()


def composite_tiles_topk(
    cand: torch.Tensor,       # [T, K, 16] payload rows, depth-sorted per tile
    live: torch.Tensor,       # [T, K] float 0/1, dead entries at the END
    origins: torch.Tensor,    # [T, 2] float tile pixel origins
    n_live: torch.Tensor,     # [T] live-prefix length per tile
    tile_size: int,
    img_w: int,               # image extent: pixels of edge tiles beyond it
    img_h: int,               # start saturated
):
    """Returns (rgb [T, P, 3], depth [T, P] alpha-normalized, alpha [T, P],
    used [T] int32 chunks walked). Differentiable w.r.t. cand through K4.

    The lists go through `gate_and_pad`; `n_live` bounds each tile's walk to
    its live prefix."""
    cand = gate_and_pad(cand, live)
    counts = n_live.to(torch.int32)
    out, used = _TopKWalk.apply(cand, origins.contiguous(), counts,
                                tile_size, img_w, img_h)
    alpha = out[:, :, 4]
    depth_norm = out[:, :, 3] / torch.clamp(alpha, min=1e-10)
    return out[:, :, :3], depth_norm, alpha, used
