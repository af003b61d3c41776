"""Visibility-based pruning of extracted instance meshes (port of
holoscene_tpu/training/pruning.py).

Reference semantics: training/holoscene_train.py:523-641
(`instance_meshes_post_pruning` + `mask_filter` + `generate_bbox`) — each
object's marching-cubes mesh is split into connected components; components
are kept only if, when the whole scene is rasterized into the training
views, their pixels land inside that object's ground-truth instance mask
often enough. This removes floaters the SDF hallucinates in unobserved
space.

One joint rasterization of ALL instance meshes per view (instance + face
ids from fragment scatters of fixed-size face chunks, on the caller's
device), host-side tallies.
"""

from __future__ import annotations

import numpy as np

from holoscene_tpu_torch.ops.rasterizer import rasterize_mesh_list
from holoscene_tpu_torch.utils.mesh import Mesh


def instance_meshes_post_pruning(
    meshes: list[Mesh | None],
    dataset,
    n_views: int = 12,
    min_visible_pixels: int = 10,
    agreement_ratio: float = 0.1,
    grid_size: int = 6,
    seed: int = 0,
    device="cuda",
) -> list[Mesh | None]:
    """Drop mesh components never seen under their own instance mask.

    meshes[k] is the mesh of object k (the dataset's instance id k).
    Returns pruned meshes (None for fully-pruned objects). The views are
    rasterized on `device`.
    """
    rng = np.random.default_rng(seed)
    present = [(k, m) for k, m in enumerate(meshes) if m is not None]
    if not present:
        return meshes

    # face -> (object, component) bookkeeping
    comp_labels = {}
    comp_counts = {}
    for k, mesh in present:
        labels = mesh.connected_components()
        comp_labels[k] = labels
        comp_counts[k] = np.zeros(labels.max() + 1, dtype=np.int64)

    face_offsets = {}
    off = 0
    pairs = []
    for k, mesh in present:
        face_offsets[k] = off
        off += len(mesh.faces)
        pairs.append((mesh.vertices, mesh.faces))

    h, w = dataset.img_res
    n_frames = dataset.n_images
    view_ids = rng.choice(n_frames, size=min(n_views, n_frames), replace=False)

    for frame_idx in view_ids:
        pose = dataset.pose_all[frame_idx]
        out = rasterize_mesh_list(
            pairs, pose, dataset.intrinsics[:3, :3], (h, w),
            grid_size=grid_size, device=device,
        )
        inst = out["instance_id"].cpu().numpy().reshape(-1)
        fid = out["face_id"].cpu().numpy().reshape(-1)
        gt = dataset.semantic_images[frame_idx].reshape(-1)

        for local_i, (k, mesh) in enumerate(present):
            sel = (inst == local_i) & (gt == k)
            if not sel.any():
                continue
            local_faces = fid[sel] - face_offsets[k]
            comps = comp_labels[k][local_faces]
            np.add.at(comp_counts[k], comps, 1)

    pruned: list[Mesh | None] = list(meshes)
    for k, mesh in present:
        counts = comp_counts[k]
        total = counts.sum()
        if total == 0:
            pruned[k] = None
            continue
        keep_comps = np.flatnonzero(
            (counts >= min_visible_pixels)
            | (counts >= agreement_ratio * total)
        )
        keep_mask = np.isin(comp_labels[k], keep_comps)
        if not keep_mask.any():
            pruned[k] = None
        else:
            pruned[k] = mesh.submesh(keep_mask)
    return pruned
