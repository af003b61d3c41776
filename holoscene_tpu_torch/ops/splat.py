"""Tile-based gaussian splat renderer: port of
holoscene_tpu/ops/splat.py::render_gaussians, its two compositors and its
image epilogue.

Projection (EWA) and view-dependent colour are shared. Compositing is either
  * the flat sorted-candidate pipeline (a `flat_plan` given;
    ops/splat_flat.py, kernels K1/K2): exact, no per-tile truncation, or
  * the top-K pipeline (no `flat_plan`; ops/splat_topk.py, kernels K3/K4):
    per tile the `max_per_tile` nearest overlapping gaussians, selected here
    with `torch.topk` over -depth in chunks of 64 tiles, gathered as packed
    width-16 payload rows and walked front to back.
`tile_overlap_counts`, `auto_max_per_tile` and `calibrate_max_per_tile` pick
the top-K depth from a scene. Projection through the unscented transform
(non-pinhole cameras) is not ported; ROADMAP.md queues it.
"""

from __future__ import annotations

import numpy as np
import torch

from holoscene_tpu_torch.ops.gaussians import (
    covariance_3d,
    eval_sh,
    project_gaussians,
    project_gaussians_fused,
)
from holoscene_tpu_torch.ops.splat_flat import (
    composite_tiles_flat,
    gather_payload,
)
from holoscene_tpu_torch.ops.splat_topk import composite_tiles_topk

TILE_CHUNK = 64      # tiles per selection pass (dense [64, N] overlap matrix)


def _tile_origins(width: int, height: int, tile_size: int, device):
    """Pixel origins (x0 [T], y0 [T], int64) of the row-major tile grid."""
    tiles_x = -(-width // tile_size)
    tiles_y = -(-height // tile_size)
    t_idx = torch.arange(tiles_x * tiles_y, device=device)
    return (t_idx % tiles_x) * tile_size, (t_idx // tiles_x) * tile_size


def _overlap(xy, radius, x0, y0, tile_size: int):
    """Gaussian circle vs tile rect, [Tc, N] bool."""
    gx, gy, r = xy[None, :, 0], xy[None, :, 1], radius[None, :]
    return ((gx + r >= x0[:, None]) & (gx - r <= x0[:, None] + tile_size)
            & (gy + r >= y0[:, None]) & (gy - r <= y0[:, None] + tile_size))


@torch.no_grad()
def tile_overlap_counts(means, quats, scales, viewmat, intrinsics,
                        width: int, height: int, tile_size: int = 16,
                        ortho: bool = False) -> torch.Tensor:
    """Per-tile overlapping-gaussian counts [n_tiles] int32 for one camera:
    the probe that picks max_per_tile from the scene's actual tile occupancy
    (compositing cost is linear in K). Projects through `project_gaussians`
    (matrix form), as the counterpart's probe does, not through the fused
    form: see that function's note on the radius `ceil`."""
    xy, _depth, _conic, radius, valid = project_gaussians(
        means, covariance_3d(quats, scales), viewmat, intrinsics, width,
        height, ortho=ortho)
    # invalid gaussians must count in NO tile: a large negative radius
    # empties the interval, matching the render path's depth=inf masking
    radius = torch.where(valid, radius, torch.full_like(radius, -1e9))
    x0, y0 = _tile_origins(width, height, tile_size, means.device)
    counts = [
        _overlap(xy, radius, x0[i:i + TILE_CHUNK], y0[i:i + TILE_CHUNK],
                 tile_size).sum(dim=1)
        for i in range(0, x0.shape[0], TILE_CHUNK)]
    return torch.cat(counts).to(torch.int32)


def auto_max_per_tile(counts, percentile: float = 99.0, lo: int = 64,
                      hi: int = 1024) -> int:
    """Compositing depth K from tile-overlap statistics: the p99 tile
    occupancy rounded up to a power of two, clamped to [lo, hi]. Geometric
    overlap is an UPPER bound on the useful depth; `calibrate_max_per_tile`
    refines the pick empirically."""
    c = np.asarray(torch.as_tensor(counts).cpu()).reshape(-1)
    if c.size == 0:
        return lo
    p = float(np.percentile(c, percentile))
    k = lo
    while k < p and k < hi:
        k *= 2
    return int(min(max(k, lo), hi))


def calibrate_max_per_tile(render_k, lo: int = 64, hi: int = 1024,
                           psnr_thresh: float = 45.0,
                           verbose: bool = False) -> int:
    """Empirical compositing-depth pick: double K until the render stops
    changing (PSNR(render(K), render(2K)) >= psnr_thresh), i.e. until the
    gaussians truncated past K are hidden behind saturated transmittance.
    `render_k(k) -> rgb` renders ONE representative camera at depth k; at
    most log2(hi / lo) + 1 probe renders."""
    def probe(k):
        return np.asarray(torch.as_tensor(render_k(k)).detach().cpu())

    lo = max(1, int(lo))
    hi = max(lo, int(hi))
    k = lo
    prev = probe(k)
    while k < hi:
        k2 = min(2 * k, hi)
        cur = probe(k2)
        mse = float(np.mean((prev - cur) ** 2))
        psnr = -10.0 * np.log10(max(mse, 1e-12))
        if verbose:
            print(f"[calibrate_max_per_tile] K={k} vs {k2}: {psnr:.1f} dB")
        if psnr >= psnr_thresh:
            return k
        k, prev = k2, cur
    return hi


@torch.no_grad()
def select_topk(xy, depth, radius, valid, width: int, height: int,
                tile_size: int, k: int):
    """Per-tile selection: the k nearest overlapping gaussians of every
    tile, front to back, dead entries last. Returns (top_idx [T, k] int64,
    live [T, k] bool, origins [T, 2] float). `torch.topk` over -depth with
    -inf for misses is exact; equal depths come out in no fixed order.

    The selection is exact on purpose. The reference selects with
    jax.lax.approx_max_k (holoscene_tpu/ops/splat.py:304), which is exact
    on the CPU but has a recall of ~0.95 on a TPU, so on its own hardware
    it could composite a slightly different set of gaussians. The port
    keeps the set the reference computes where it is exact (the CPU);
    tests/test_torch_splat.py pins the port's sets to that result."""
    x0, y0 = _tile_origins(width, height, tile_size, xy.device)
    inf = torch.full_like(depth, float("inf"))
    neg_depth = -torch.where(valid, depth, inf)
    miss = torch.full_like(depth, float("-inf"))[None, :]
    idx, live = [], []
    for i in range(0, x0.shape[0], TILE_CHUNK):
        hit = _overlap(xy, radius, x0[i:i + TILE_CHUNK],
                       y0[i:i + TILE_CHUNK], tile_size)
        vals, top = torch.topk(torch.where(hit, neg_depth[None, :], miss), k,
                               dim=1, sorted=True)
        idx.append(top)
        live.append(torch.isfinite(vals))
    return (torch.cat(idx), torch.cat(live),
            torch.stack([x0, y0], dim=-1).float())


def render_gaussians(
    means: torch.Tensor,          # [N, 3]
    quats: torch.Tensor,          # [N, 4] (w,x,y,z), need not be normalized
    scales: torch.Tensor,         # [N, 3] linear scales
    opacities: torch.Tensor,      # [N] in [0, 1]
    colors: torch.Tensor,         # [N, 3] rgb or [N, B, 3] SH coeffs
    viewmat: torch.Tensor,        # [4, 4] world-to-camera
    intrinsics: torch.Tensor,     # [3, 3]
    width: int,
    height: int,
    tile_size: int = 16,
    max_per_tile: int = 512,
    sh_degree: int | None = None,
    background: torch.Tensor | None = None,
    ortho: bool = False,
    camera_model: str = "pinhole",
    flat_plan=None,
    flat_bins: dict | None = None,
    chw: bool = False,
):
    """Returns dict(rgb [H,W,3] (or [3,H,W] with chw), depth [H,W]
    alpha-normalized expected depth, alpha [H,W]); the flat path adds its
    flags overflow / stale / used_chunks (/ xy_drift with cached bins), the
    top-K path used_chunks [T] (chunks each tile walked).

    flat_plan (ops/splat_flat.FlatPlan) switches binning + compositing to
    the flat sorted-candidate pipeline (`max_per_tile` is ignored);
    flat_bins is a cached binning plan for it. Without a plan each tile
    composites its `max_per_tile` nearest overlapping gaussians. ortho=True
    projects orthographically (intrinsics hold pixels per world unit)."""
    if camera_model != "pinhole":
        raise NotImplementedError(
            "unscented-transform projection is not ported yet "
            "(see ROADMAP.md)")
    tiles_x = -(-width // tile_size)
    tiles_y = -(-height // tile_size)
    xy, depth, conic, radius, valid = project_gaussians_fused(
        means, quats, scales, viewmat, intrinsics, width, height, ortho=ortho)
    rgb_n = shade(means, colors, viewmat, sh_degree)

    if flat_plan is not None:
        rgb_t, depth_norm_t, alpha_t, flags = composite_tiles_flat(
            xy, depth, conic, opacities, rgb_n, valid,
            width, height, tile_size, flat_plan, bins=flat_bins)
        out = _image_epilogue(rgb_t, depth_norm_t * alpha_t, alpha_t,
                              tiles_x, tiles_y, tile_size, width, height,
                              background, chw=chw)
        out.update(flags)
        return out

    n = means.shape[0]
    k = min(max_per_tile, n)
    top_idx, live, origins = select_topk(
        xy.detach(), depth.detach(), radius.detach(), valid, width, height,
        tile_size, k)
    # ONE width-16 row gather fetches the whole candidate payload; its
    # autograd transpose is one index_add
    cand = gather_payload(xy, depth, conic, opacities, rgb_n,
                          top_idx.reshape(-1)).reshape(-1, k, 16)
    rgb_t, depth_norm_t, alpha_t, used = composite_tiles_topk(
        cand, live.to(cand.dtype), origins, tile_size=tile_size,
        # topk puts dead (-inf) entries at the end, so live is a prefix:
        # its sum bounds each tile's chunk walk
        n_live=live.sum(dim=1),
        # lets edge tiles' saturation early-exit ignore out-of-image pixels
        img_w=width, img_h=height)
    out = _image_epilogue(rgb_t, depth_norm_t * alpha_t, alpha_t, tiles_x,
                          tiles_y, tile_size, width, height, background,
                          chw=chw)
    out["used_chunks"] = used
    return out


def shade(means, colors, viewmat, sh_degree: int | None):
    """Per-gaussian rgb: `colors` as given, or its SH coefficients
    evaluated along the view direction and clamped at 0."""
    if sh_degree is None:
        return colors
    cam_pos = -viewmat[:3, :3].T @ viewmat[:3, 3]
    dirs = means - cam_pos[None, :]
    dirs = dirs / torch.clamp(
        torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-8)
    return torch.clamp(eval_sh(colors, dirs, sh_degree), min=0.0)


def _image_epilogue(rgb_t, depth_t, alpha_t, tiles_x, tiles_y, tile_size,
                    width, height, background, chw: bool = False):
    """[n_tiles, P(,C)] tile buffers -> image dict; chw=True emits rgb as
    [3, H, W] (the training-loss layout)."""

    def tiles_to_image(tiles_flat, channels):
        img = tiles_flat.reshape(tiles_y, tiles_x, tile_size, tile_size,
                                 channels)
        img = img.permute(0, 2, 1, 3, 4).reshape(
            tiles_y * tile_size, tiles_x * tile_size, channels)
        return img[:height, :width]

    def tiles_to_image_chw(tiles_flat, channels):
        img = tiles_flat.reshape(tiles_y, tiles_x, tile_size, tile_size,
                                 channels)
        img = img.permute(4, 0, 2, 1, 3).reshape(
            channels, tiles_y * tile_size, tiles_x * tile_size)
        return img[:, :height, :width]

    if chw:
        rgb = tiles_to_image_chw(rgb_t, 3)                       # [3, H, W]
        alpha = tiles_to_image_chw(alpha_t[..., None], 1)[0]
        depth_acc = tiles_to_image_chw(depth_t[..., None], 1)[0]
        depth_norm = depth_acc / torch.clamp(alpha, min=1e-10)
        if background is not None:
            rgb = rgb + (1.0 - alpha[None]) * background[:, None, None]
        return {"rgb": rgb, "depth": depth_norm, "alpha": alpha}

    rgb = tiles_to_image(rgb_t, 3)
    alpha = tiles_to_image(alpha_t[..., None], 1)[..., 0]
    depth_acc = tiles_to_image(depth_t[..., None], 1)[..., 0]
    depth_norm = depth_acc / torch.clamp(alpha, min=1e-10)
    if background is not None:
        rgb = rgb + (1.0 - alpha[..., None]) * background[None, None, :]
    return {"rgb": rgb, "depth": depth_norm, "alpha": alpha}
