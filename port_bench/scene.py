"""The benchmark's room: a box with disjoint seeded spheres resting on its
floor, ray-traced analytically into posed frames in the on-disk layout the
port's NSDataset reads, with its meshes and its generated-view packs.

Rewritten from holoscene_tpu_torch/datasets/synthetic.py at commit badb067
(`_trace`, `generate_scene`, the camera ring and the normalisation) for a
room of many objects. It imports nothing of the port: the scene is the
benchmark's input, and the plain references read the arrays kept here.

Every seed gives the same set of sizes (`RADII`, the frames, the views);
the seed moves the spheres on the floor and picks their colours, so the
work of a step does not change with the seed.
"""

from __future__ import annotations

import json
import os
import pickle
from dataclasses import dataclass, field

import numpy as np
import torch
from PIL import Image

ROOM_HALF = 1.0
WALL_COLORS = {"floor": (0.55, 0.5, 0.45), "ceil": (0.8, 0.8, 0.82),
               "wall": (0.65, 0.68, 0.6)}
# the 31 radii every seed places, largest first (world units)
RADII = tuple(float(r) for r in np.linspace(0.15, 0.06, 31))
RING_R, RING_Y, TARGET = 0.65, 0.1, (0.0, -0.25, 0.0)
FOV_DEG = 70.0
MIN_PIXELS = 64        # pixels of some 512^2 frame each object covers
GAP = 0.02             # the least distance between two spheres' surfaces


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(int(seed)))


def place_spheres(seed: int, radii=RADII, attempt: int = 0) -> list[dict]:
    """Disjoint spheres on the floor (centre y = -1 + r) inside the room,
    each with a seeded colour, largest first."""
    rng = _rng(int(seed) * 7919 + attempt)
    spheres: list[dict] = []
    lim = ROOM_HALF - 0.02
    placed = np.zeros((0, 3))          # (x, z, r) of the spheres so far
    for r in radii:
        for _ in range(100):
            xz = rng.uniform(-lim + r, lim - r, (256, 2))
            gap = np.linalg.norm(xz[:, None] - placed[None, :, :2], axis=2) \
                - placed[None, :, 2] - r
            ok = np.flatnonzero((gap > GAP).all(1))
            if len(ok):
                x, z = xz[ok[0]]
                break
        else:
            raise RuntimeError("no room left for a sphere")
        placed = np.vstack([placed, [x, z, r]])
        colour = rng.uniform(0.15, 0.95, 3)
        spheres.append({"center": (float(x), -ROOM_HALF + r, float(z)),
                        "radius": r,
                        "color": tuple(float(v) for v in colour)})
    return spheres


def trace(rays_o, rays_d, spheres):
    """Closest hit of the room's walls (from inside) and the spheres, for
    float64 torch rays [N, 3] on any device: (t, rgb, world normal toward
    the viewer, instance: 255 walls, k sphere k)."""
    n = rays_o.shape[0]
    dev, f64 = rays_o.device, torch.float64
    t_axis = torch.maximum((-ROOM_HALF - rays_o) / rays_d,
                           (ROOM_HALF - rays_o) / rays_d)
    t_best, axis = t_axis.min(1)
    ar = torch.arange(n, device=dev)
    sign = torch.sign(rays_d[ar, axis])
    normal = torch.zeros(n, 3, dtype=f64, device=dev)
    normal[ar, axis] = -sign
    rgb = torch.empty(n, 3, dtype=f64, device=dev)
    rgb[:] = torch.tensor(WALL_COLORS["wall"], dtype=f64)
    rgb[(axis == 1) & (sign < 0)] = torch.tensor(WALL_COLORS["floor"],
                                                 dtype=f64, device=dev)
    rgb[(axis == 1) & (sign > 0)] = torch.tensor(WALL_COLORS["ceil"],
                                                 dtype=f64, device=dev)
    inst = torch.full((n,), 255, dtype=torch.int32, device=dev)
    light = torch.tensor([0.3, 0.8, 0.2], dtype=f64, device=dev)
    for k, sp in enumerate(spheres):
        c = torch.tensor(sp["center"], dtype=f64, device=dev)
        r = sp["radius"]
        oc = rays_o - c
        b = (rays_d * oc).sum(1)
        disc = b * b - ((oc * oc).sum(1) - r * r)
        t = -b - torch.sqrt(disc.clamp(min=0.0))
        hit = (disc > 0) & (t > 1e-4) & (t < t_best)
        t_best = torch.where(hit, t, t_best)
        nrm = (rays_o + t[:, None] * rays_d - c) / r
        normal = torch.where(hit[:, None], nrm, normal)
        shade = 0.6 + 0.4 * (nrm @ light).clamp(0, 1)
        colour = torch.tensor(sp["color"], dtype=f64, device=dev)
        rgb = torch.where(hit[:, None], colour * shade[:, None], rgb)
        inst = torch.where(hit, torch.full_like(inst, k), inst)
    return t_best, rgb, normal, inst


def camera_poses(n_frames: int) -> np.ndarray:
    """OpenCV camera-to-world [n, 4, 4] on the interior ring, looking at
    TARGET."""
    poses = []
    for i in range(n_frames):
        ang = 2 * np.pi * i / n_frames
        eye = np.array([RING_R * np.cos(ang), RING_Y, RING_R * np.sin(ang)])
        poses.append(look_at(eye, np.asarray(TARGET)))
    return np.stack(poses)


def look_at(eye, target) -> np.ndarray:
    fwd = np.asarray(target, dtype=np.float64) - np.asarray(eye)
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right /= np.linalg.norm(right)
    pose = np.eye(4)
    pose[:3, 0], pose[:3, 1], pose[:3, 2] = right, np.cross(fwd, right), fwd
    pose[:3, 3] = eye
    return pose


@dataclass
class Room:
    """A traced room: the uint8 images and masks, the float depth and the
    uint8 normals exactly as written, the OpenCV poses in world units, the
    intrinsics, and the spheres."""

    spheres: list
    res: int
    focal: float
    poses: np.ndarray
    rgb: np.ndarray = field(repr=False)        # [F, H, W, 3] uint8
    depth: np.ndarray = field(repr=False)      # [F, H, W] float32
    normal: np.ndarray = field(repr=False)     # [F, H, W, 3] uint8
    mask: np.ndarray = field(repr=False)       # [F, H, W] uint8

    @property
    def n_objects(self) -> int:
        return len(self.spheres)


def make_room(seed: int, n_frames: int = 8, res: int = 512,
              radii=RADII, device="cpu") -> Room:
    """Trace the room of `seed` (in float64 on `device`); re-places the
    spheres (deterministically) until each one covers MIN_PIXELS of some
    frame."""
    f64 = torch.float64
    f = 0.5 * res / np.tan(np.radians(FOV_DEG) / 2)
    c = res / 2.0
    ys, xs = np.mgrid[0:res, 0:res]
    dirs_cam = np.stack([(xs - c) / f, (ys - c) / f,
                         np.ones((res, res))], -1).reshape(-1, 3)
    zdir = torch.tensor(
        (dirs_cam / np.linalg.norm(dirs_cam, axis=1, keepdims=True))[:, 2],
        dtype=f64, device=device)
    dirs_cam = torch.tensor(dirs_cam, dtype=f64, device=device)
    poses = camera_poses(n_frames)
    min_px = max(1, round(MIN_PIXELS * (res / 512) ** 2))
    for attempt in range(50):
        spheres = place_spheres(seed, radii, attempt)
        out = {k: [] for k in ("rgb", "depth", "normal", "mask")}
        for pose in poses:
            rot = torch.tensor(pose[:3, :3], dtype=f64, device=device)
            d = dirs_cam @ rot.T
            d = d / d.norm(dim=1, keepdim=True)
            o = torch.tensor(pose[:3, 3], dtype=f64,
                             device=device).expand_as(d)
            t, rgb, nrm, inst = trace(o, d, spheres)
            out["rgb"].append((rgb.clamp(0, 1) * 255).to(torch.uint8))
            out["depth"].append((t * zdir).to(torch.float32))
            n_cam = nrm @ rot
            out["normal"].append(
                ((n_cam + 1) / 2 * 255).clamp(0, 255).to(torch.uint8))
            out["mask"].append(inst.to(torch.uint8))
        masks = torch.stack(out["mask"])
        seen = torch.stack([(masks == k).sum(1).max()
                            for k in range(len(spheres))])
        if int(seen.min()) >= min_px:
            break
    else:
        raise RuntimeError("could not place every sphere in view")
    shp = (n_frames, res, res)

    def host(key, *tail):
        return torch.stack(out[key]).cpu().numpy().reshape(*shp, *tail)

    return Room(spheres, res, float(f), poses, host("rgb", 3), host("depth"),
                host("normal", 3), host("mask"))


def write_room(room: Room, scene_dir: str) -> str:
    """Write the room as NSDataset reads it (images/, depth/, normal/,
    instance_mask/, transforms.json with OpenGL poses, graph.json: the room
    supports every object)."""
    for sub in ("images", "depth", "normal", "instance_mask"):
        os.makedirs(os.path.join(scene_dir, sub), exist_ok=True)
    frames = []
    for i in range(len(room.poses)):
        name = f"{i:04d}"
        Image.fromarray(room.rgb[i]).save(
            os.path.join(scene_dir, "images", name + ".png"))
        np.save(os.path.join(scene_dir, "depth", name + ".npy"), room.depth[i])
        Image.fromarray(room.normal[i]).save(
            os.path.join(scene_dir, "normal", name + ".png"))
        Image.fromarray(room.mask[i]).save(
            os.path.join(scene_dir, "instance_mask", name + ".png"))
        gl = room.poses[i].copy()
        gl[:3, 1:3] *= -1
        frames.append({"file_path": f"images/{name}.png",
                       "transform_matrix": gl.tolist()})
    c = room.res / 2.0
    with open(os.path.join(scene_dir, "transforms.json"), "w") as fh:
        json.dump({"fl_x": room.focal, "fl_y": room.focal, "cx": c, "cy": c,
                   "w": room.res, "h": room.res, "frames": frames}, fh)
    k = room.n_objects
    graph = [{"node_id": 0, "adj_nodes": list(range(1, k + 1))}]
    graph += [{"node_id": i + 1, "adj_nodes": [0]} for i in range(k)]
    with open(os.path.join(scene_dir, "graph.json"), "w") as fh:
        json.dump(graph, fh)
    return scene_dir


def normalization(poses: np.ndarray) -> tuple[np.ndarray, float]:
    """The camera-bbox normalisation NSDataset applies (its centre and its
    largest extent)."""
    t = poses[:, :3, 3]
    return (t.max(0) + t.min(0)) / 2, float((t.max(0) - t.min(0)).max())


def train_frames(n_frames: int, test_split: bool,
                 ratio: float = 0.1) -> np.ndarray:
    """The frames NSDataset trains on (its test split holds out the
    rest)."""
    if not test_split:
        return np.arange(n_frames)
    n_test = max(1, int(n_frames * ratio))
    return np.linspace(0, n_frames - 1, n_frames - n_test).astype(int)


# --- meshes ----------------------------------------------------------------

def _icosphere(level: int) -> tuple[np.ndarray, np.ndarray]:
    t = (1 + 5 ** 0.5) / 2
    v = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t),
         (0, 1, t), (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1),
         (-t, 0, -1), (-t, 0, 1)]
    f = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
         (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
         (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
         (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    verts = [np.asarray(p, dtype=np.float64) / np.linalg.norm(p) for p in v]
    faces = list(f)
    for _ in range(level):
        cache: dict = {}

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
                cache[key] = len(verts) - 1
            return cache[key]

        nxt = []
        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nxt += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = nxt
    return np.stack(verts), np.asarray(faces, dtype=np.int64)


def room_meshes(room: Room, sphere_level: int = 3):
    """[(vertices [V, 3], faces [F, 3], vertex colours [V, 3] uint8)] of the
    room box (faces toward the inside) and each sphere (faces outward), in
    NSDataset's normalised frame: mesh 0 the room, mesh k + 1 sphere k."""
    centre, scale = normalization(room.poses)
    h = ROOM_HALF
    corners = np.array([[x, y, z] for x in (-h, h) for y in (-h, h)
                        for z in (-h, h)], dtype=np.float64)
    # each wall as two triangles wound so the normal points inward
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    walls = ["wall", "wall", "floor", "ceil", "wall", "wall"]
    verts, faces, cols = [], [], []
    for q, kind in zip(quads, walls):
        base = len(verts)
        verts += [corners[i] for i in q]
        col = (np.asarray(WALL_COLORS[kind]) * 255).astype(np.uint8)
        cols += [col] * 4
        for a, b, c in ((0, 1, 2), (0, 2, 3)):
            tri = [base + a, base + b, base + c]
            p = np.asarray([verts[i] for i in tri])
            n = np.cross(p[1] - p[0], p[2] - p[0])
            if np.dot(n, -p.mean(0)) < 0:   # face the room's centre
                tri = [tri[0], tri[2], tri[1]]
            faces.append(tri)
    out = [((np.asarray(verts) - centre) / scale, np.asarray(faces),
            np.stack(cols))]
    sv, sf = _icosphere(sphere_level)
    for sp in room.spheres:
        v = (sv * sp["radius"] + np.asarray(sp["center"]) - centre) / scale
        col = (np.asarray(sp["color"]) * 255).astype(np.uint8)
        out.append((v, sf.copy(), np.repeat(col[None], len(sv), 0)))
    return out


# --- generated-view packs ---------------------------------------------------

def object_view_packs(room: Room, obj: int, res: int = 256,
                      distance: float = 1.5) -> list[dict]:
    """Six orthographic views of sphere `obj` (the Wonder3D rig: front,
    front-right, right, back, left, front-left around the object, at a
    little elevation), packed as Stage 2 packs its generated views: per
    view {pose [4, 4] c2w (OpenCV, normalised frame), half_extent,
    rgb [res, res, 3] float32, mask [res, res] float32}. The images are the
    sphere traced orthographically, shaded as the frames shade it."""
    centre, scale = normalization(room.poses)
    sp = room.spheres[obj]
    c = (np.asarray(sp["center"]) - centre) / scale
    r = sp["radius"] / scale
    half = 1.3 * r
    u = (np.arange(res) + 0.5) / res * 2.0 - 1.0
    packs = []
    for deg in (0.0, 45.0, 90.0, 180.0, 270.0, 315.0):
        ang = np.radians(deg)
        eye = c + distance * np.array([np.sin(ang) * 0.9, 0.436,
                                       np.cos(ang) * 0.9])
        pose = look_at(eye, c)
        # orthographic rays through the image plane, in the normalised frame
        px = u[None, :] * half
        py = u[:, None] * half
        o = (eye[None, None, :] + px[..., None] * pose[:3, 0]
             + py[..., None] * pose[:3, 1]).reshape(-1, 3)
        d = np.broadcast_to(pose[:3, 2], o.shape)
        oc = o - c
        b = np.sum(d * oc, axis=1)
        disc = b * b - (np.sum(oc * oc, axis=1) - r * r)
        hit = disc > 0
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        nrm = (o + t[:, None] * d - c) / r
        shade = 0.6 + 0.4 * np.clip(nrm @ np.array([0.3, 0.8, 0.2]), 0, 1)
        rgb = np.asarray(sp["color"])[None] * shade[:, None] * hit[:, None]
        packs.append({"pose": pose.astype(np.float32),
                      "half_extent": float(half),
                      "rgb": rgb.reshape(res, res, 3).astype(np.float32),
                      "mask": hit.reshape(res, res).astype(np.float32)})
    return packs


def write_view_packs(room: Room, plots_dir: str, res: int = 256) -> list:
    """vis_info_{k + 1}.pkl for every sphere k, where the Stage-4 runner's
    load_vis_info reads them (mesh 0, the room, gets none)."""
    os.makedirs(plots_dir, exist_ok=True)
    paths = []
    for k in range(room.n_objects):
        p = os.path.join(plots_dir, f"vis_info_{k + 1}.pkl")
        with open(p, "wb") as fh:
            pickle.dump(object_view_packs(room, k, res), fh)
        paths.append(p)
    return paths
