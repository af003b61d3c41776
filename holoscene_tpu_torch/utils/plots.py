"""Per-object mesh extraction from the compositional SDF field (port of
holoscene_tpu/utils/plots.py).

Reference semantics: utils/plots.py:317-422 (`get_surface_sliding`) and
:688-860 (per-object marching cubes with bbox partitioning), plus
training/holoscene_train.py:620 (`generate_bbox`).

One coarse full-volume sweep of ALL K object SDFs (device chunks) finds
each object's occupied bbox; each object then gets a fine grid evaluation
restricted to its padded bbox, at the voxel size of the requested
resolution, and marching tetrahedra on the host. File names and JSON keys
are the reference's: Stage 2 and the exporters read them.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from holoscene_tpu_torch.utils.mc import evaluate_grid, marching_tetrahedra
from holoscene_tpu_torch.utils.mesh import Mesh, write_ply


def _add(seconds: dict | None, key: str, t0: float) -> None:
    if seconds is not None:
        seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t0


def _eval_grid_multi(sdf_raw_fn, resolution: int, bounds, chunk: int,
                     device="cuda") -> np.ndarray:
    """sdf_raw_fn ([M,3] -> [M,K]) on a dense grid: [R, R, R, K] float32
    (host)."""
    lo, hi = bounds
    axis = np.linspace(lo, hi, resolution, dtype=np.float32)
    vals = evaluate_grid(sdf_raw_fn, (axis,) * 3, chunk, device)
    return vals.reshape(resolution, resolution, resolution, -1)


def extract_object_meshes(
    sdf_raw_fn,
    num_objects: int,
    resolution: int = 256,
    grid_boundary=(-1.0, 1.0),
    coarse_resolution: int = 64,
    chunk: int = 262144,
    bbox_pad: float = 0.05,
    device="cuda",
    seconds: dict | None = None,
    fine_resolutions: list | None = None,
    only: "set[int] | None" = None,
) -> list[Mesh | None]:
    """Extract one mesh per object SDF (None when an object is empty).

    sdf_raw_fn: [M,3] points on `device` -> [M,K] per-object SDFs.
    only: when given, run the fine extraction for just these object
    indices; every other slot is None (Stage 2 re-extracts the objects the
    disentangled SDF emptied).
    seconds, when given, gathers the wall time of the grid evaluations
    ("grid_eval") and of marching tetrahedra ("marching_tetrahedra");
    fine_resolutions, when given, gathers the resolution of each fine
    (per-object) grid in the order they are evaluated."""
    lo, hi = grid_boundary

    # coarse sweep -> per-object bboxes
    t0 = time.perf_counter()
    coarse = _eval_grid_multi(sdf_raw_fn, coarse_resolution, grid_boundary,
                              chunk, device)
    _add(seconds, "grid_eval", t0)
    axis = np.linspace(lo, hi, coarse_resolution)
    meshes: list[Mesh | None] = []
    spacing_coarse = (hi - lo) / (coarse_resolution - 1)

    for k in range(num_objects):
        if only is not None and k not in only:
            meshes.append(None)
            continue
        occ = coarse[..., k] < 0
        if not occ.any():
            meshes.append(None)
            continue
        idx = np.argwhere(occ)
        lo_k = axis[idx.min(axis=0)] - bbox_pad - spacing_coarse
        hi_k = axis[idx.max(axis=0)] + bbox_pad + spacing_coarse
        lo_k = np.maximum(lo_k, lo)
        hi_k = np.minimum(hi_k, hi)

        # fine grid restricted to the object's bbox, resolution scaled to
        # preserve the requested global voxel size
        extent = float((hi_k - lo_k).max())
        res_k = int(
            np.clip(np.ceil(extent / (hi - lo) * resolution), 16, resolution)
        )
        if fine_resolutions is not None:
            fine_resolutions.append(res_k)
        t0 = time.perf_counter()
        grid, origin, spacing = _eval_bbox_grid(
            sdf_raw_fn, k, lo_k, hi_k, res_k, chunk, device
        )
        _add(seconds, "grid_eval", t0)
        t0 = time.perf_counter()
        verts, faces = marching_tetrahedra(grid, origin=origin,
                                           spacing=spacing)
        _add(seconds, "marching_tetrahedra", t0)
        if len(faces) == 0:
            meshes.append(None)
            continue
        meshes.append(Mesh(verts, faces))
    return meshes


def _eval_bbox_grid(sdf_raw_fn, obj_idx: int, lo_k, hi_k, res: int,
                    chunk: int, device="cuda"):
    axes = [np.linspace(lo_k[d], hi_k[d], res, dtype=np.float32)
            for d in range(3)]
    vals = evaluate_grid(lambda pts: sdf_raw_fn(pts)[:, obj_idx], axes,
                         chunk, device)
    grid = vals.reshape(res, res, res)
    spacing = (hi_k - lo_k) / (res - 1)
    return grid, lo_k, spacing


def generate_bbox(meshes: list[Mesh | None], out_dir: str, pad: float = 0.0):
    """Write bbox/bbox_{i}.json artifacts (reference holoscene_train.py:620)."""
    bbox_dir = os.path.join(out_dir, "bbox")
    os.makedirs(bbox_dir, exist_ok=True)
    bboxes = {}
    for i, mesh in enumerate(meshes):
        if mesh is None:
            continue
        b = mesh.bounds
        data = {
            "min": (b[0] - pad).tolist(),
            "max": (b[1] + pad).tolist(),
            "center": ((b[0] + b[1]) / 2).tolist(),
            "scale": ((b[1] - b[0]) / 2 + pad).tolist(),
        }
        with open(os.path.join(bbox_dir, f"bbox_{i}.json"), "w") as f:
            json.dump(data, f)
        bboxes[i] = data
    return bboxes


def save_object_meshes(meshes: list[Mesh | None], plots_dir: str, epoch: int):
    """surface_{epoch}_{obj}.ply artifacts (reference plots layout)."""
    paths = []
    for i, mesh in enumerate(meshes):
        if mesh is None:
            paths.append(None)
            continue
        p = os.path.join(plots_dir, f"surface_{epoch}_{i}.ply")
        write_ply(p, mesh)
        paths.append(p)
    return paths
