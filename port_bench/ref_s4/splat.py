# Frozen copy of holoscene_tpu_torch/ops/splat.py at commit badb067, for the
# benchmark's plain reference: imports rewired to port_bench.ref_s4, cut to
# the paths the benchmark's Stage-4 configuration runs, in plain PyTorch.
# Do not edit to follow the port.
"""Tile-based gaussian splat renderer: port of
holoscene_tpu/ops/splat.py::render_gaussians, its two compositors and its
image epilogue.

Projection (EWA) and view-dependent colour are shared. Compositing is either
  * the flat sorted-candidate pipeline (a `flat_plan` given;
    ops/splat_flat.py, kernels K1/K2): exact, no per-tile truncation, or
  * the top-K pipeline (no `flat_plan`; ops/splat_topk.py, kernels K3/K4):
    per tile the `max_per_tile` nearest overlapping gaussians, selected here
    with `torch.topk` over -depth (ties to the smaller index) in chunks of
    64 tiles, gathered as packed width-16 payload rows (the gather's
    transpose H4) and walked front to back.
Cut to the pinhole camera the benchmark's Stage-4 configuration renders
with: a non-pinhole camera or a rolling shutter is refused.
"""

from __future__ import annotations

import torch

from port_bench.ref_s4.gaussians import eval_sh, project_gaussians_fused
from port_bench.ref_s4.splat_flat import (
    composite_tiles_flat,
    gather_payload,
)
from port_bench.ref_s4.splat_topk import composite_tiles_topk

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


def _ordered_bits(x):
    """int64 [n] of float32 x [n], ordered as the values (-0.0 as +0.0)."""
    bits = (x + 0.0).view(torch.int32)
    return (bits ^ ((bits >> 31) & 0x7FFFFFFF)).long()


@torch.no_grad()
def select_topk(xy, depth, radius, valid, width: int, height: int,
                tile_size: int, k: int):
    """Per-tile selection: the k nearest overlapping gaussians of every
    tile, front to back, equal depths to the smaller index, dead entries
    last and pointing at the payload's trash row N. Returns (top_idx
    [T, k] int64, live [T, k] bool, origins [T, 2] float).

    `torch.topk` runs over int64 keys that are all distinct: the bits of
    -depth (-inf for misses and invalid gaussians) ordered as the floats,
    above the complement of the index. So the set, the order and the
    indices are one function of the inputs, whatever order topk breaks
    ties in; on the CPU they are the reference's (jax.lax.approx_max_k,
    holoscene_tpu/ops/splat.py:304, exact there, keeps the smaller index
    of equal values). The reference's recall on a TPU is ~0.95, so on its
    own hardware it could composite a slightly different set; the port
    keeps the set it computes where it is exact. tests/test_torch_splat.py
    and tests/test_torch_planned_take.py pin the port's lists to it."""
    n = xy.shape[0]
    x0, y0 = _tile_origins(width, height, tile_size, xy.device)
    low = (1 << 32) - 1 - torch.arange(n, device=xy.device)
    inf = torch.full_like(depth, float("inf"))
    key = _ordered_bits(-torch.where(valid, depth, inf)) * (1 << 32) + low
    miss_bits = _ordered_bits(torch.full_like(depth[:1], float("-inf")))
    miss = miss_bits * (1 << 32) + low                     # [n]
    idx, live = [], []
    for i in range(0, x0.shape[0], TILE_CHUNK):
        hit = _overlap(xy, radius, x0[i:i + TILE_CHUNK],
                       y0[i:i + TILE_CHUNK], tile_size)
        top = torch.topk(torch.where(hit, key[None, :], miss[None, :]), k,
                         dim=1, sorted=True).values
        ok = top > miss_bits * (1 << 32) + ((1 << 32) - 1)
        idx.append(torch.where(ok, (1 << 32) - 1 - (top & ((1 << 32) - 1)),
                               n))
        live.append(ok)
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
    dist=None,
    viewmat_end: torch.Tensor | None = None,
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
    projects orthographically (intrinsics hold pixels per world unit).
    camera_model opencv / fisheye (coefficients in `dist`) or a
    `viewmat_end` (linear rolling shutter) project through the unscented
    transform instead of the EWA linearisation."""
    tiles_x = -(-width // tile_size)
    tiles_y = -(-height // tile_size)
    xy, depth, conic, radius, valid = project_for_render(
        means, quats, scales, viewmat, intrinsics, width, height, ortho,
        camera_model, dist, viewmat_end)
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
    # transpose is H4 through the plan of these lists, built when the
    # backward runs (dead entries gather the trash row, whose run H4 skips)
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


def project_for_render(means, quats, scales, viewmat, intrinsics,
                       width: int, height: int, ortho: bool = False,
                       camera_model: str = "pinhole", dist=None,
                       viewmat_end=None):
    """The renderer's projection: EWA (project_gaussians_fused) for a
    pinhole camera. Returns (xy, depth, conic, radius, valid)."""
    if camera_model != "pinhole" or viewmat_end is not None:
        raise NotImplementedError("a non-pinhole camera or a rolling shutter")
    return project_gaussians_fused(means, quats, scales, viewmat,
                                   intrinsics, width, height, ortho=ortho)


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
