"""View sampling and view-quality weighting for Stage-2 generative refinement
(port of holoscene_tpu/stage2/views.py). The camera geometry is numpy on
the host; every rasterization runs on the caller's `device`.

Reference semantics: utils/general.py —
  * cameras on an (azimuth, elevation) sphere around an object, looking at
    its center (camera builders :2105-2125, FPS/grid sampling :1176, :1863);
  * per-view quality weight = how much of the object is visible from that
    view, discounting pixels occluded by other scene geometry and
    back-facing coverage
    (get_view_weights_of_subset_meshes_with_training_views_backface_discount*,
    training/holoscene_train_post.py:2023-2413);
  * the Wonder3D camera rig: 6 orthographic views at azimuths
    (front, front-right, right, back, left, front-left) and 0 elevation
    (make_wonder3D_cameras, utils/general.py:2910).

All visibility tests run through the fragment-scatter rasterizer: one joint
render of (object + occluders) gives occlusion fractions per candidate view.
"""

from __future__ import annotations

import numpy as np

from holoscene_tpu_torch.ops.rasterizer import rasterize_mesh_list
from holoscene_tpu_torch.utils.mesh import Mesh


def look_at_pose(eye: np.ndarray, target: np.ndarray,
                 up=(0.0, -1.0, 0.0)) -> np.ndarray:
    """OpenCV c2w (x right, y down, z forward) camera looking at target.
    Default up is -y (y-down scenes)."""
    eye = np.asarray(eye, dtype=np.float64)
    fwd = np.asarray(target, dtype=np.float64) - eye
    fwd = fwd / max(np.linalg.norm(fwd), 1e-12)
    world_up = np.asarray(up, dtype=np.float64)
    right = np.cross(fwd, -world_up)
    nrm = np.linalg.norm(right)
    if nrm < 1e-8:  # looking straight along up
        right = np.array([1.0, 0.0, 0.0])
    else:
        right = right / nrm
    down = np.cross(fwd, right)
    pose = np.eye(4)
    pose[:3, 0] = right
    pose[:3, 1] = down
    pose[:3, 2] = fwd
    pose[:3, 3] = eye
    return pose


def camera_on_sphere(center: np.ndarray, radius: float, azimuth: float,
                     elevation: float) -> np.ndarray:
    """Camera at spherical (azimuth around y, elevation above the xz plane)
    looking at `center` (reference camera-from-angles builders,
    utils/general.py:2105-2125). y-down world: +elevation moves toward -y."""
    eye = center + radius * np.array(
        [
            np.cos(elevation) * np.cos(azimuth),
            -np.sin(elevation),
            np.cos(elevation) * np.sin(azimuth),
        ]
    )
    return look_at_pose(eye, center)


def view_grid(n_azimuth: int = 16, n_elevation: int = 4,
              elevation_range=(-0.2, 1.1)) -> list[tuple[float, float]]:
    """(azimuth, elevation) grid (the reference weights views over such a
    grid, holoscene_train_post.py:885)."""
    azims = np.linspace(0, 2 * np.pi, n_azimuth, endpoint=False)
    elevs = np.linspace(elevation_range[0], elevation_range[1], n_elevation)
    return [(float(a), float(e)) for e in elevs for a in azims]


def wonder3d_camera_rig(center: np.ndarray, radius: float,
                        front_azimuth: float = 0.0) -> list[np.ndarray]:
    """The 6-view multiview-diffusion rig: front, front-right, right, back,
    left, front-left at zero elevation (make_wonder3D_cameras,
    utils/general.py:2910)."""
    offsets = [0.0, np.pi / 4, np.pi / 2, np.pi, -np.pi / 2, -np.pi / 4]
    return [
        camera_on_sphere(center, radius, front_azimuth + o, 0.0)
        for o in offsets
    ]


def object_view_weights(
    obj_mesh: Mesh,
    occluder_meshes: list[Mesh],
    views: list[np.ndarray],
    img_res: int = 128,
    ortho_half_extent: float | None = None,
    backface_discount: float = 0.5,
    device="cuda",
) -> np.ndarray:
    """Per-view quality weights in [0, 1].

    weight = (#object pixels visible in the joint render) /
             (#object pixels when rendered alone), discounted by the
    fraction of back-facing coverage (reference
    ..._backface_discount_limited_phi, holoscene_train_post.py:2023).
    """
    intr = None
    if ortho_half_extent is None:
        b = obj_mesh.bounds
        ortho_half_extent = float(np.linalg.norm(b[1] - b[0]) / 2 * 1.2)

    pairs_all = [(obj_mesh.vertices, obj_mesh.faces)] + [
        (m.vertices, m.faces) for m in occluder_meshes if m is not None
    ]
    weights = np.zeros(len(views))
    for vi, pose in enumerate(views):
        alone = rasterize_mesh_list(
            pairs_all[:1], pose, intr, (img_res, img_res),
            ortho_half_extent=ortho_half_extent, device=device,
        )
        alone_px = int((alone["instance_id"] == 0).sum())
        if alone_px == 0:
            continue
        joint = rasterize_mesh_list(
            pairs_all, pose, intr, (img_res, img_res),
            ortho_half_extent=ortho_half_extent, device=device,
        )
        visible_px = int((joint["instance_id"] == 0).sum())

        # backface coverage: rasterize the object alone with culling — the
        # deficit is back-facing area seen through holes
        culled = rasterize_mesh_list(
            pairs_all[:1], pose, intr, (img_res, img_res),
            ortho_half_extent=ortho_half_extent, cull_backfaces=True,
            device=device,
        )
        front_px = int((culled["instance_id"] == 0).sum())
        back_frac = 1.0 - front_px / max(alone_px, 1)

        w = visible_px / alone_px
        weights[vi] = w * (1.0 - backface_discount * back_frac)
    return weights


def select_best_views(
    obj_mesh: Mesh,
    occluder_meshes: list[Mesh],
    n_views: int = 6,
    n_azimuth: int = 16,
    n_elevation: int = 4,
    radius_scale: float = 2.0,
    img_res: int = 96,
    min_azimuth_gap: float = np.pi / 8,
    device="cuda",
) -> list[tuple[np.ndarray, float]]:
    """Pick the n best-weighted, azimuthally-spread views around the object
    (reference find_best_additional_view / uniform_metric,
    utils/general.py:1398, :1288)."""
    b = obj_mesh.bounds
    center = (b[0] + b[1]) / 2
    radius = float(np.linalg.norm(b[1] - b[0]) / 2) * radius_scale
    angles = view_grid(n_azimuth, n_elevation)
    views = [camera_on_sphere(center, radius, a, e) for a, e in angles]
    weights = object_view_weights(obj_mesh, occluder_meshes, views, img_res,
                                  device=device)

    chosen: list[int] = []
    order = np.argsort(-weights)
    for idx in order:
        if len(chosen) >= n_views:
            break
        az = angles[idx][0]
        if any(
            min(abs(az - angles[c][0]), 2 * np.pi - abs(az - angles[c][0]))
            < min_azimuth_gap
            and abs(angles[idx][1] - angles[c][1]) < 1e-6
            for c in chosen
        ):
            continue
        chosen.append(int(idx))
    return [(views[i], float(weights[i])) for i in chosen]


def training_view_vertex_visibility(
    obj_mesh: Mesh,
    occluder_meshes: list[Mesh],
    poses: list[np.ndarray],
    intrinsics: np.ndarray,
    img_res: tuple[int, int],
    device="cuda",
) -> np.ndarray:
    """Per-vertex visibility fraction across the TRAINING cameras: a vertex
    counts as seen in a frame when one of its faces wins pixels in the joint
    (object + occluders) render. The per-vertex weights the reference
    accumulates in get_view_weights_of_subset_meshes_with_training_views_*
    (holoscene_train_post.py:2023-2413)."""
    pairs = [(obj_mesh.vertices, obj_mesh.faces)] + [
        (m.vertices, m.faces) for m in occluder_meshes if m is not None
    ]
    vis = np.zeros(len(obj_mesh.vertices))
    for pose in poses:
        out = rasterize_mesh_list(pairs, pose, intrinsics, img_res,
                                  device=device)
        fid = out["face_id"].cpu().numpy()
        inst = out["instance_id"].cpu().numpy()
        win = np.unique(fid[(inst == 0) & (fid >= 0)])
        win = win[win < len(obj_mesh.faces)]
        if len(win):
            vis[np.unique(obj_mesh.faces[win])] += 1.0
    return vis / max(len(poses), 1)


def integrated_view_coverage(
    obj_mesh: Mesh,
    vertex_vis: np.ndarray,
    n_azimuth: int = 16,
    n_elevation: int = 4,
    elevation_range=(-0.2, 1.1),
    facing_thresh: float = 0.3,
    seen_thresh: float = 0.05,
) -> tuple[float, np.ndarray]:
    """Integrate per-vertex training visibility over the full (azimuth,
    phi-limited elevation) direction grid (the reference integrates weight
    maps rather than taking a max — holoscene_train_post.py:2023 ff.).

    Returns (coverage scalar = mean over grid directions of the seen
    fraction among vertices facing that direction, coverage_map [n_dirs]).
    """
    # per-vertex area-weighted normals
    fn_ = obj_mesh.vertices[obj_mesh.faces]
    face_n = np.cross(fn_[:, 1] - fn_[:, 0], fn_[:, 2] - fn_[:, 0])
    vert_n = np.zeros_like(obj_mesh.vertices)
    for k in range(3):
        np.add.at(vert_n, obj_mesh.faces[:, k], face_n)
    vert_n /= np.maximum(np.linalg.norm(vert_n, axis=1, keepdims=True), 1e-12)

    seen = vertex_vis > seen_thresh
    cov = []
    for az, el in view_grid(n_azimuth, n_elevation, elevation_range):
        # camera direction toward the object center from (az, el)
        d = -np.array(
            [np.cos(el) * np.cos(az), -np.sin(el), np.cos(el) * np.sin(az)]
        )
        facing = (vert_n @ -d) > facing_thresh
        if facing.sum() == 0:
            cov.append(1.0)  # nothing faces this direction: vacuously fine
            continue
        cov.append(float(seen[facing].mean()))
    cov = np.asarray(cov)
    return float(cov.mean()), cov


def find_longest_continuous_azimuth_gap(azimuths: np.ndarray) -> float:
    """Center of the largest azimuthal gap in observed directions — where
    novel views are most needed (find_longest_continuous_azimuths,
    utils/general.py:2435)."""
    az = np.sort(np.mod(azimuths, 2 * np.pi))
    if len(az) == 0:
        return 0.0
    gaps = np.diff(np.concatenate([az, az[:1] + 2 * np.pi]))
    i = int(np.argmax(gaps))
    return float(np.mod(az[i] + gaps[i] / 2, 2 * np.pi))
