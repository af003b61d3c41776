"""Procedural synthetic scene written in the reference's on-disk format, its
analytic meshes, and analytic invisible-view packs.

`generate_scene` (the port's own copy of holoscene_tpu/datasets/synthetic.py)
ray-traces a "room with objects" scene analytically and writes it exactly as
NSDataset expects (images/, depth/*.npy, normal/*.png, instance_mask/*.png,
transforms.json, graph.json) so the pipeline can be exercised end-to-end
without Replica data.

Geometry (world units): a cubic room [-1,1]^3 (background, instance 255 in
masks -> id 0 after loading) containing K spheres (instances 0..K-1 in
masks -> ids 1..K). Cameras sit on an interior ring looking at the center.
Normals are written in the OpenCV camera frame, [0,1]-encoded.

`scene_meshes` extracts the room box and the spheres by marching tetrahedra
in the NORMALIZED coordinates NSDataset loads the scene in; they stand in for
the Stage-3 meshes when Stage 4 is driven on its own. `sphere_view_packs`
stands in for Stage 2's generated-view packs the same way: orthographic
views of each sphere, written where `Stage4Runner.load_vis_info` reads them.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np
from PIL import Image

from holoscene_tpu_torch.utils.mc import marching_tetrahedra
from holoscene_tpu_torch.utils.mesh import Mesh, write_obj


DEFAULT_SPHERES = (
    {"center": (0.35, -0.45, 0.0), "radius": 0.35, "color": (0.85, 0.25, 0.2)},
    {"center": (-0.4, -0.55, 0.3), "radius": 0.25, "color": (0.2, 0.4, 0.85)},
)
ROOM_HALF = 1.0
WALL_COLORS = {
    "floor": (0.55, 0.5, 0.45),
    "ceil": (0.8, 0.8, 0.82),
    "wall": (0.65, 0.68, 0.6),
}


def _trace(rays_o, rays_d, spheres):
    """Analytic closest-hit: room interior walls + spheres.

    Returns (t, rgb, normal_world, instance) with instance 255 = room walls,
    k = sphere k. Normals point toward the viewer (outward from solids).
    """
    n = rays_o.shape[0]
    t_best = np.full(n, np.inf)
    rgb = np.zeros((n, 3), dtype=np.float32)
    normal = np.zeros((n, 3), dtype=np.float32)
    inst = np.full(n, 255, dtype=np.int32)

    # room walls: exit point of the AABB [-R, R]^3 (camera is inside)
    with np.errstate(divide="ignore"):
        t1 = (-ROOM_HALF - rays_o) / rays_d
        t2 = (ROOM_HALF - rays_o) / rays_d
    t_exit_per_axis = np.maximum(t1, t2)
    axis = np.argmin(t_exit_per_axis, axis=1)
    t_wall = t_exit_per_axis[np.arange(n), axis]
    t_best[:] = t_wall
    wall_n = np.zeros((n, 3), dtype=np.float32)
    sign = np.sign(rays_d[np.arange(n), axis])
    wall_n[np.arange(n), axis] = -sign  # inward-facing wall normal
    normal[:] = wall_n
    is_floor = (axis == 1) & (sign < 0)
    is_ceil = (axis == 1) & (sign > 0)
    rgb[:] = WALL_COLORS["wall"]
    rgb[is_floor] = WALL_COLORS["floor"]
    rgb[is_ceil] = WALL_COLORS["ceil"]

    for k, sp in enumerate(spheres):
        c = np.asarray(sp["center"], dtype=np.float64)
        r = sp["radius"]
        oc = rays_o - c
        b = np.sum(rays_d * oc, axis=1)
        cq = np.sum(oc * oc, axis=1) - r * r
        disc = b * b - cq
        hit = disc > 0
        t = -b - np.sqrt(np.maximum(disc, 0))
        hit &= (t > 1e-4) & (t < t_best)
        t_best[hit] = t[hit]
        p = rays_o[hit] + t[hit, None] * rays_d[hit]
        normal[hit] = (p - c) / r
        shade = 0.6 + 0.4 * np.clip(normal[hit] @ np.array([0.3, 0.8, 0.2]), 0, 1)
        rgb[hit] = np.asarray(sp["color"]) * shade[:, None]
        inst[hit] = k

    return t_best, rgb.astype(np.float32), normal, inst


def generate_scene(
    out_dir: str,
    n_images: int = 12,
    img_res: tuple[int, int] = (64, 64),
    spheres=DEFAULT_SPHERES,
    fov_deg: float = 70.0,
    seed: int = 0,
) -> str:
    """Write the scene; returns out_dir."""
    h, w = img_res
    os.makedirs(out_dir, exist_ok=True)
    for sub in ("images", "depth", "normal", "instance_mask"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)

    f = 0.5 * w / np.tan(np.radians(fov_deg) / 2)
    cx, cy = w / 2.0, h / 2.0

    frames = []
    ring_r = 0.65
    for i in range(n_images):
        ang = 2 * np.pi * i / n_images
        cam_pos = np.array([ring_r * np.cos(ang), 0.1, ring_r * np.sin(ang)])
        target = np.array([0.0, -0.25, 0.0])

        # OpenCV c2w: z forward (towards target), x right, y down
        fwd = target - cam_pos
        fwd /= np.linalg.norm(fwd)
        world_up = np.array([0.0, 1.0, 0.0])
        right = np.cross(fwd, world_up)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        c2w_cv = np.eye(4)
        c2w_cv[:3, 0] = right
        c2w_cv[:3, 1] = down
        c2w_cv[:3, 2] = fwd
        c2w_cv[:3, 3] = cam_pos

        ys, xs = np.mgrid[0:h, 0:w]
        dirs_cam = np.stack(
            [(xs - cx) / f, (ys - cy) / f, np.ones_like(xs, dtype=np.float64)], -1
        ).reshape(-1, 3)
        dirs_world = dirs_cam @ c2w_cv[:3, :3].T
        dirs_world /= np.linalg.norm(dirs_world, axis=1, keepdims=True)
        rays_o = np.broadcast_to(cam_pos, dirs_world.shape)

        t, rgb, normal_w, inst = _trace(rays_o, dirs_world, spheres)

        # z-depth (not distance) like a monocular depth prior
        z_depth = t * (dirs_cam / np.linalg.norm(dirs_cam, axis=1, keepdims=True))[:, 2]
        # camera-frame normals
        normal_cam = normal_w @ c2w_cv[:3, :3]  # w2c rotate = R^T; (n @ R) == R^T n
        normal_png = np.clip((normal_cam + 1) / 2 * 255, 0, 255).astype(np.uint8)

        name = f"{i:04d}"
        Image.fromarray(
            (np.clip(rgb, 0, 1) * 255).astype(np.uint8).reshape(h, w, 3)
        ).save(os.path.join(out_dir, "images", name + ".png"))
        np.save(
            os.path.join(out_dir, "depth", name + ".npy"),
            z_depth.reshape(h, w).astype(np.float32),
        )
        Image.fromarray(normal_png.reshape(h, w, 3)).save(
            os.path.join(out_dir, "normal", name + ".png")
        )
        Image.fromarray(inst.astype(np.uint8).reshape(h, w)).save(
            os.path.join(out_dir, "instance_mask", name + ".png")
        )

        # transforms.json expects OpenGL (the loader flips cols 1:3 back)
        c2w_gl = c2w_cv.copy()
        c2w_gl[:3, 1:3] *= -1
        frames.append({"file_path": f"images/{name}.png",
                       "transform_matrix": c2w_gl.tolist()})

    with open(os.path.join(out_dir, "transforms.json"), "w") as fjson:
        json.dump(
            {"fl_x": f, "fl_y": f, "cx": cx, "cy": cy, "w": w, "h": h,
             "frames": frames},
            fjson,
        )

    # scene graph: room (node 0) supports every sphere
    graph = [{"node_id": 0, "adj_nodes": [k + 1 for k in range(len(spheres))]}]
    for k in range(len(spheres)):
        graph.append({"node_id": k + 1, "adj_nodes": [0]})
    with open(os.path.join(out_dir, "graph.json"), "w") as fjson:
        json.dump(graph, fjson)

    return out_dir


# generate_scene puts the cameras on a ring of radius 0.65 at height 0.1;
# NSDataset normalizes by the camera bbox: its centre and its largest extent
# (the ring diameter)
NORMALIZE_CENTER = (0.0, 0.1, 0.0)
NORMALIZE_SCALE = 1.3


def _normalized_sphere(sphere: dict):
    """(centre [3], radius) of a sphere in NSDataset's normalized frame."""
    c = (np.asarray(sphere["center"], dtype=np.float64)
         - np.asarray(NORMALIZE_CENTER)) / NORMALIZE_SCALE
    return c, sphere["radius"] / NORMALIZE_SCALE


def scene_meshes(res: int = 20) -> list[Mesh]:
    """[room, sphere_0, sphere_1, ...] on a res^3 grid over [-1, 1]^3."""
    axis = np.linspace(-1.0, 1.0, res)
    x, y, z = np.meshgrid(axis, axis, axis, indexing="ij")
    sp = 2.0 / (res - 1)
    c0 = -np.asarray(NORMALIZE_CENTER) / NORMALIZE_SCALE
    room = np.maximum.reduce([np.abs(x - c0[0]), np.abs(y - c0[1]),
                              np.abs(z - c0[2])]) - ROOM_HALF / NORMALIZE_SCALE
    sdfs = [-room]
    for s in DEFAULT_SPHERES:
        c, r = _normalized_sphere(s)
        sdfs.append(np.sqrt((x - c[0]) ** 2 + (y - c[1]) ** 2
                            + (z - c[2]) ** 2) - r)
    meshes = []
    for sdf in sdfs:
        v, f = marching_tetrahedra(sdf, origin=(-1,) * 3, spacing=(sp,) * 3)
        meshes.append(Mesh(v, f))
    return meshes


def write_stage3_meshes(plots_dir: str, meshes: list[Mesh]) -> None:
    """Write meshes where the Stage-4 CLI looks for Stage 3's output:
    plots_dir/surface_{i}.obj."""
    for i, m in enumerate(meshes):
        write_obj(os.path.join(plots_dir, f"surface_{i}.obj"), m)


def _look_at(eye, target) -> np.ndarray:
    """OpenCV c2w (x right, y down, z forward) looking at target, world up
    +y."""
    fwd = np.asarray(target, dtype=np.float64) - np.asarray(eye)
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right /= np.linalg.norm(right)
    pose = np.eye(4)
    pose[:3, 0] = right
    pose[:3, 1] = np.cross(fwd, right)
    pose[:3, 2] = fwd
    pose[:3, 3] = eye
    return pose.astype(np.float32)


def sphere_view_packs(sphere: dict, n_views: int = 4, res: int = 256,
                      distance: float = 1.5) -> list[dict]:
    """Analytic generated-view packs of one sphere, in the layout Stage 2
    writes: per view {pose [4,4] c2w, half_extent, rgb [res,res,3], mask
    [res,res]}. Each is an orthographic view from a ring around the sphere
    (normalized frame), half_extent = 1.3 r: the mask is the disc of radius
    r / half_extent in [-1,1] image units and the colour is the sphere's
    flat `color`."""
    c, r = _normalized_sphere(sphere)
    half = 1.3 * r
    u = (np.arange(res) + 0.5) / res * 2.0 - 1.0
    mask = (u[None, :] ** 2 + u[:, None] ** 2) <= (r / half) ** 2
    rgb = mask[..., None] * np.asarray(sphere["color"], dtype=np.float32)
    packs = []
    for i in range(n_views):
        ang = 2 * np.pi * (i + 0.5) / n_views
        eye = c + distance * np.array([np.cos(ang) * 0.9, 0.436,
                                       np.sin(ang) * 0.9])
        packs.append({"pose": _look_at(eye, c), "half_extent": float(half),
                      "rgb": rgb.astype(np.float32),
                      "mask": mask.astype(np.float32)})
    return packs


def write_vis_info(plots_dir: str, n_views: int = 4, res: int = 256) -> list:
    """vis_info_{i}.pkl for every sphere (mesh i = sphere i - 1; the room,
    mesh 0, gets no pack). Returns the paths."""
    paths = []
    for k, s in enumerate(DEFAULT_SPHERES):
        p = os.path.join(plots_dir, f"vis_info_{k + 1}.pkl")
        with open(p, "wb") as f:
            pickle.dump(sphere_view_packs(s, n_views, res), f)
        paths.append(p)
    return paths
