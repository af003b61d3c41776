"""Occluder inpainting + depth/normal consistency gating of Stage-2 object
views — the heart of "recover the unseen parts" (port of
holoscene_tpu/stage2/inpaint_views.py: the rasterizations run on the
caller's `device`, dilation and the gate in numpy on the host).

Reference semantics (training/holoscene_train_post.py:1013-1112): for each
selected view of an object,

  1. render the object orthographically (rgb / normal / depth) and find the
     region where OTHER scene objects occlude it (`mesh_desc_opa`);
  2. paint the background white, clip rgb to 0.9, and inpaint the (dilated)
     occluded region in rgb, [0,1]-mapped normal, and min-max-normalized
     depth with the inpainting provider (LaMa in the reference);
  3. recover per-channel validity masks as "deviates from the white
     background by > eps_bg", OR-ed with the object's own visible region;
  4. derive a second normal estimate from the inpainted depth's screen-space
     gradients (orthographic pixel scale), keeping the rendered normal
     outside the inpainted region;
  5. gate: in the newly generated region, compute the fraction of pixels
     whose inpainted-normal vs depth-normal angle exceeds 30/45/60/90
     degrees; if any fraction exceeds (0.4, 0.3, 0.2, 0.1) the inpainted
     normals are deemed deviated and the depth-derived normals are used
     instead (:1085-1112).

The resulting pack supervises `invisible_view_loss` with per-channel masks.
"""

from __future__ import annotations

import numpy as np

from holoscene_tpu_torch.ops.rasterizer import rasterize_mesh_list
from holoscene_tpu_torch.utils.mesh import Mesh

BG_COLOR = np.array([1.0, 1.0, 1.0], dtype=np.float32)
EPS_BG = 0.05
# angle cosines 30/45/60/90 deg and the allowed deviated-pixel ratios
_DEV_COS = (0.866, 0.707, 0.5, 0.0)
_DEV_RATIO = (0.4, 0.3, 0.2, 0.1)


def binary_dilate(mask: np.ndarray, iterations: int = 2) -> np.ndarray:
    """4-neighborhood binary dilation (scipy-free)."""
    m = mask.astype(bool)
    for _ in range(iterations):
        grown = m.copy()
        grown[1:, :] |= m[:-1, :]
        grown[:-1, :] |= m[1:, :]
        grown[:, 1:] |= m[:, :-1]
        grown[:, :-1] |= m[:, 1:]
        m = grown
    return m


def normal_from_ortho_depth(depth: np.ndarray, mask: np.ndarray,
                            pixel_scale: float) -> np.ndarray:
    """Camera-frame normals from an orthographic depth map's screen-space
    gradients (reference get_normal_map_from_depth). pixel_scale = world
    units per pixel (2 * half_extent / res). Camera looks along +z, x right,
    y down; the visible surface normal has negative z."""
    dz_dy, dz_dx = np.gradient(depth)
    n = np.stack(
        [-dz_dx / max(pixel_scale, 1e-12),
         -dz_dy / max(pixel_scale, 1e-12),
         -np.ones_like(depth)],
        axis=-1,
    )
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    n[~mask] = np.array([0.0, 0.0, -1.0])
    return n.astype(np.float32)


def normals_deviated(nm_inpainted: np.ndarray, nm_from_depth: np.ndarray,
                     region: np.ndarray) -> bool:
    """The reference's multi-threshold deviation gate
    (holoscene_train_post.py:1085-1112)."""
    if region.sum() == 0:
        return False
    a = nm_inpainted[region].reshape(-1, 3)
    b = nm_from_depth[region].reshape(-1, 3)
    a = a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-12)
    b = b / np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1e-12)
    cos = np.sum(a * b, axis=-1)
    for thr, ratio in zip(_DEV_COS, _DEV_RATIO):
        if np.count_nonzero(cos < thr) / len(cos) > ratio:
            return True
    return False


def occluded_region(
    obj_mesh: Mesh,
    occluder_meshes: list[Mesh],
    pose: np.ndarray,
    half_extent: float,
    res: int,
    depth_eps: float = 1e-3,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """(occluded [H,W] bool, self_visible [H,W] bool): pixels where the
    object's surface exists but another mesh is strictly in front (the
    reference's mesh_desc_opa vs mesh_self_opa split)."""
    alone = rasterize_mesh_list(
        [(obj_mesh.vertices, obj_mesh.faces)], pose, None, (res, res),
        ortho_half_extent=half_extent, device=device,
    )
    obj_mask = alone["instance_id"].cpu().numpy() == 0
    obj_depth = alone["depth"].cpu().numpy()

    occs = [(m.vertices, m.faces) for m in occluder_meshes if m is not None]
    if not occs:
        return np.zeros((res, res), bool), obj_mask
    occ = rasterize_mesh_list(
        occs, pose, None, (res, res), ortho_half_extent=half_extent,
        device=device,
    )
    occ_mask = occ["instance_id"].cpu().numpy() >= 0
    occ_depth = occ["depth"].cpu().numpy()
    occluded = obj_mask & occ_mask & (occ_depth < obj_depth - depth_eps)
    return occluded, obj_mask & ~occluded


def inpaint_object_view(
    view: dict,
    occluded: np.ndarray,
    self_visible: np.ndarray,
    inpaint_provider,
    half_extent: float,
    dilate_iterations: int = 2,
) -> dict:
    """Inpaint one rendered object view's occluded region and gate the
    result. `view` = {rgb [H,W,3], normal [H,W,3] camera-frame, depth [H,W],
    mask [H,W]} (render_object_view output). Returns the supervision pack
    {rgb, normal, depth, mask, nm_mask, depth_mask, sm_mask, deviated}.
    """
    res = view["rgb"].shape[0]
    obj_mask = view["mask"] | occluded

    # white-background canvases (reference clips rgb to 0.9 so the white
    # background is separable from bright content)
    rgb = np.clip(view["rgb"], 0.0, 0.9).astype(np.float32)
    rgb[~obj_mask] = BG_COLOR

    nm01 = (view["normal"] * 0.5 + 0.5).astype(np.float32)
    nm01[~obj_mask] = BG_COLOR

    depth = view["depth"].astype(np.float32)
    fg = obj_mask & ~occluded
    if fg.sum() == 0:
        return {
            "rgb": rgb, "normal": view["normal"], "depth": depth,
            "mask": view["mask"], "nm_mask": view["mask"],
            "depth_mask": view["mask"], "sm_mask": occluded,
            "deviated": False,
        }
    dmin = float(depth[fg].min()) - 0.1
    dmax = float(depth[fg].max()) + 0.1
    depth01 = np.repeat(
        ((depth - dmin) / (dmax - dmin))[..., None], 3, axis=-1
    ).astype(np.float32)
    depth01[~obj_mask] = BG_COLOR

    fill = binary_dilate(occluded, dilate_iterations)

    rgb_in = inpaint_provider.inpaint(rgb, fill).astype(np.float32)
    nm_in01 = inpaint_provider.inpaint(nm01, fill).astype(np.float32)
    depth_in01 = inpaint_provider.inpaint(depth01, fill).astype(np.float32)

    # per-channel validity: deviates-from-background, OR self-visible
    def fg_of(img):
        return (
            np.any(np.abs(img - BG_COLOR[None, None]) > EPS_BG, axis=-1)
            | self_visible
        )

    mask = fg_of(rgb_in)
    nm_mask = fg_of(nm_in01) & mask
    depth_mask = fg_of(depth_in01) & mask

    nm_in = nm_in01 * 2.0 - 1.0
    depth_in = depth_in01.mean(axis=-1) * (dmax - dmin) + dmin

    # depth -> normal consistency
    px_scale = 2.0 * half_extent / res
    nm_from_depth = normal_from_ortho_depth(depth_in, depth_mask, px_scale)
    nm_from_depth[~fill] = view["normal"][~fill]

    new_region = mask & fill
    deviated = normals_deviated(nm_in, nm_from_depth, new_region)
    normal = nm_from_depth if deviated else nm_in
    # outside the inpainted region the render's own normals are exact
    normal = np.where(fill[..., None], normal, view["normal"]).astype(
        np.float32
    )
    normal = normal / np.maximum(
        np.linalg.norm(normal, axis=-1, keepdims=True), 1e-12
    )

    rgb_out = np.where(fill[..., None], rgb_in, rgb).astype(np.float32)
    depth_out = np.where(fill, depth_in, depth).astype(np.float32)

    return {
        "rgb": rgb_out,
        "normal": normal,
        "depth": depth_out,
        "mask": mask,
        "nm_mask": nm_mask,
        "depth_mask": depth_mask,
        "sm_mask": fill,
        "deviated": bool(deviated),
    }
