"""Tile-based gaussian splat renderer: the flat-pipeline branch of
holoscene_tpu/ops/splat.py::render_gaussians and its image epilogue.

Only the flat sorted-candidate path (ops/splat_flat.py, kernels K1/K2) is
ported. The top-K compositor (Pallas kernels K3/K4 of
holoscene_tpu/ops/splat_pallas.py) and the unscented-transform projection
raise NotImplementedError; ROADMAP.md queues them.
"""

from __future__ import annotations

import torch

from holoscene_tpu_torch.ops.gaussians import eval_sh, project_gaussians_fused
from holoscene_tpu_torch.ops.splat_flat import composite_tiles_flat


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
    sh_degree: int | None = None,
    background: torch.Tensor | None = None,
    camera_model: str = "pinhole",
    flat_plan=None,
    flat_bins: dict | None = None,
    chw: bool = False,
):
    """Returns dict(rgb [H,W,3] (or [3,H,W] with chw), depth [H,W]
    alpha-normalized expected depth, alpha [H,W], and the flat-path flags
    overflow / stale / used_chunks (/ xy_drift with cached bins))."""
    if flat_plan is None:
        raise NotImplementedError(
            "the top-K compositor (Pallas kernels K3/K4) is not ported yet; "
            "pass a flat_plan (see ROADMAP.md)")
    if camera_model != "pinhole":
        raise NotImplementedError(
            "unscented-transform projection is not ported yet "
            "(see ROADMAP.md)")
    tiles_x = -(-width // tile_size)
    tiles_y = -(-height // tile_size)
    xy, depth, conic, valid, rgb_n = project_and_shade(
        means, quats, scales, colors, viewmat, intrinsics, width, height,
        sh_degree=sh_degree)
    rgb_t, depth_norm_t, alpha_t, flags = composite_tiles_flat(
        xy, depth, conic, opacities, rgb_n, valid,
        width, height, tile_size, flat_plan, bins=flat_bins)
    out = _image_epilogue(rgb_t, depth_norm_t * alpha_t, alpha_t, tiles_x,
                          tiles_y, tile_size, width, height, background,
                          chw=chw)
    out.update(flags)
    return out


def project_and_shade(means, quats, scales, colors, viewmat, intrinsics,
                      width: int, height: int, sh_degree: int | None = None):
    """The compositor's per-gaussian inputs: EWA projection plus the view-
    dependent colour. Returns (xy, depth, conic, valid, rgb)."""
    xy, depth, conic, _radius, valid = project_gaussians_fused(
        means, quats, scales, viewmat, intrinsics, width, height)
    if sh_degree is None:
        return xy, depth, conic, valid, colors
    cam_pos = -viewmat[:3, :3].T @ viewmat[:3, 3]
    dirs = means - cam_pos[None, :]
    dirs = dirs / torch.clamp(
        torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-8)
    rgb = torch.clamp(eval_sh(colors, dirs, sh_degree), min=0.0)
    return xy, depth, conic, valid, rgb


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
