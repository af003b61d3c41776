"""Datasets for the standalone Gaussian trainer (3dgrut-core parity).

The port's own copy of holoscene_tpu/datasets/gs_datasets.py: the port
imports nothing of the JAX package.

Reference counterparts: threedgrut/datasets/dataset_nerf.py (blender
transforms_{split}.json), dataset_colmap.py (COLMAP sparse binary/text
reconstructions), dataset_scannetpp.py (a COLMAP layout variant). Loaded
into the same host-side numpy protocol `GSTrainer` consumes (img_res,
n_images, pose_all (c2w, OpenCV), intrinsics, rgb_images flattened
[N, H*W, 3], optional .test split), plus seed points for initialization.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np

# OpenGL (blender) -> OpenCV camera-axes flip
_GL2CV = np.diag([1.0, -1.0, -1.0, 1.0])


class _Split:
    def __init__(self, d: dict):
        for k, v in d.items():
            setattr(self, k, v)

    def __getitem__(self, k):
        return getattr(self, k)

    def __contains__(self, k):
        return hasattr(self, k)


def _load_images(paths, white_background=True):
    from PIL import Image

    imgs = []
    for p in paths:
        im = np.asarray(Image.open(p), dtype=np.float32) / 255.0
        if im.ndim == 2:
            im = np.repeat(im[..., None], 3, -1)
        if im.shape[-1] == 4:
            a = im[..., 3:4]
            bg = 1.0 if white_background else 0.0
            im = im[..., :3] * a + bg * (1 - a)
        imgs.append(im[..., :3])
    return imgs


class NerfSyntheticDataset:
    """Blender transforms_{split}.json scenes (dataset_nerf.py:36-214)."""

    def __init__(self, root: str, split: str = "train",
                 test_split: str = "test", white_background: bool = True,
                 max_num_images: int = -1):
        self.root = root
        tr = self._load_split(root, split, white_background, max_num_images)
        self.img_res = tr["img_res"]
        self.n_images = len(tr["pose_all"])
        self.pose_all = tr["pose_all"]
        self.intrinsics = tr["intrinsics"]
        self.rgb_images = tr["rgb_images"]
        self.test = None
        tpath = os.path.join(root, f"transforms_{test_split}.json")
        if test_split != split and os.path.exists(tpath):
            te = self._load_split(root, test_split, white_background,
                                  max_num_images)
            self.test = {"pose_all": te["pose_all"],
                         "rgb_images": te["rgb_images"]}

    @staticmethod
    def _load_split(root, split, white_background, max_num_images):
        with open(os.path.join(root, f"transforms_{split}.json")) as f:
            meta = json.load(f)
        frames = meta["frames"]
        if 0 < max_num_images < len(frames):
            keep = np.linspace(0, len(frames) - 1, max_num_images).astype(int)
            frames = [frames[i] for i in keep]
        paths = []
        poses = []
        for fr in frames:
            p = os.path.join(root, fr["file_path"])
            if not os.path.splitext(p)[1]:
                p += ".png"
            paths.append(p)
            c2w = np.asarray(fr["transform_matrix"], np.float64) @ _GL2CV
            poses.append(c2w.astype(np.float32))
        imgs = _load_images(paths, white_background)
        h, w = imgs[0].shape[:2]
        fx = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
        fy = float(meta.get("camera_angle_y", 0)) and \
            0.5 * h / np.tan(0.5 * float(meta["camera_angle_y"])) or fx
        intr = np.array([[fx, 0, w / 2], [0, fy, h / 2], [0, 0, 1]],
                        np.float32)
        return {
            "img_res": (h, w),
            "pose_all": np.stack(poses),
            "intrinsics": intr,
            "rgb_images": np.stack([im.reshape(h * w, 3) for im in imgs]),
        }

    def seed_points(self, n: int = 50_000, extent: float = 1.5,
                    seed: int = 0):
        rng = np.random.default_rng(seed)
        pts = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
        cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
        return pts, cols


# ---------------------------------------------------------------------------
# COLMAP sparse reconstructions (binary + text)
# ---------------------------------------------------------------------------

# camera model id -> (name, n_params) — full COLMAP table; param counts
# must be exact or the binary stream desyncs for every later camera
_CAM_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4), 3: ("RADIAL", 5), 4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8), 6: ("FULL_OPENCV", 12), 7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4), 9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}

# models whose params lead with a single shared focal: (f, cx, cy, ...)
_SINGLE_FOCAL = {"SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                 "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE"}


def _colmap_distortion(cam: dict) -> tuple[str, tuple | None]:
    """COLMAP camera model -> (renderer camera_model, dist coeffs) in the
    layout ops/gaussians.camera_project expects: opencv (k1,k2,p1,p2[,k3]),
    fisheye (k1,k2,k3,k4). Pinhole models carry no distortion."""
    model = cam["model"]
    tail = tuple(float(v) for v in cam["params"][
        3 if model in _SINGLE_FOCAL else 4:
    ])
    if model in ("SIMPLE_PINHOLE", "PINHOLE"):
        return "pinhole", None
    if model == "SIMPLE_RADIAL":
        return "opencv", (tail[0], 0.0, 0.0, 0.0)
    if model == "RADIAL":
        return "opencv", (tail[0], tail[1], 0.0, 0.0)
    if model == "OPENCV":
        return "opencv", tail[:4]
    if model == "FULL_OPENCV":                 # k1 k2 p1 p2 k3 (k4-k6 drop)
        return "opencv", tail[:5]
    if model == "OPENCV_FISHEYE":
        return "fisheye", tail[:4]
    if model == "SIMPLE_RADIAL_FISHEYE":
        return "fisheye", (tail[0], 0.0, 0.0, 0.0)
    if model == "RADIAL_FISHEYE":
        return "fisheye", (tail[0], tail[1], 0.0, 0.0)
    import warnings

    warnings.warn(f"ColmapDataset: unsupported distortion model {model}; "
                  "rendering as undistorted pinhole")
    return "pinhole", None


def read_colmap_cameras_bin(path: str) -> dict:
    cams = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            cid, model, w, h = struct.unpack("<iiQQ", f.read(24))
            if model not in _CAM_MODELS:
                raise ValueError(
                    f"unknown COLMAP camera model id {model}; cannot skip "
                    "its params without desyncing the stream"
                )
            name, np_ = _CAM_MODELS[model]
            params = struct.unpack(f"<{np_}d", f.read(8 * np_))
            cams[cid] = {"model": name, "width": int(w), "height": int(h),
                         "params": np.asarray(params)}
    return cams


def read_colmap_images_bin(path: str) -> dict:
    imgs = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            iid = struct.unpack("<i", f.read(4))[0]
            qvec = np.asarray(struct.unpack("<4d", f.read(32)))
            tvec = np.asarray(struct.unpack("<3d", f.read(24)))
            cam_id = struct.unpack("<i", f.read(4))[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n2d,) = struct.unpack("<Q", f.read(8))
            f.read(24 * n2d)  # 2D points unused here
            imgs[iid] = {"qvec": qvec, "tvec": tvec, "camera_id": cam_id,
                         "name": name.decode()}
    return imgs


def read_colmap_points_bin(path: str):
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        xyz = np.empty((n, 3))
        rgb = np.empty((n, 3), np.uint8)
        for i in range(n):
            f.read(8)  # point id
            xyz[i] = struct.unpack("<3d", f.read(24))
            rgb[i] = struct.unpack("<3B", f.read(3))
            f.read(8)  # reprojection error
            (tl,) = struct.unpack("<Q", f.read(8))
            f.read(8 * tl)
    return xyz.astype(np.float32), rgb.astype(np.float32) / 255.0


def _qvec2rot(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


class ColmapDataset:
    """COLMAP layout: <root>/sparse/0/{cameras,images,points3D}.bin +
    <root>/<images_dir>/ (dataset_colmap.py:50-357; ScanNet++'s DSLR
    exports use the same structure — point images_dir at it)."""

    def __init__(self, root: str, images_dir: str = "images",
                 sparse_dir: str = "sparse/0", test_every: int = 8,
                 max_num_images: int = -1):
        sp = os.path.join(root, sparse_dir)
        cams = read_colmap_cameras_bin(os.path.join(sp, "cameras.bin"))
        imgs = read_colmap_images_bin(os.path.join(sp, "images.bin"))
        ppath = os.path.join(sp, "points3D.bin")
        self.points_xyz, self.points_rgb = (
            read_colmap_points_bin(ppath) if os.path.exists(ppath)
            else (None, None)
        )

        order = sorted(imgs, key=lambda i: imgs[i]["name"])
        if 0 < max_num_images < len(order):
            keep = np.linspace(0, len(order) - 1, max_num_images).astype(int)
            order = [order[i] for i in keep]
        poses, paths, intr_all = [], [], []
        for iid in order:
            rec = imgs[iid]
            cam = cams[rec["camera_id"]]
            R = _qvec2rot(rec["qvec"])          # w2c rotation
            t = rec["tvec"]
            c2w = np.eye(4)
            c2w[:3, :3] = R.T
            c2w[:3, 3] = -R.T @ t
            poses.append(c2w.astype(np.float32))
            paths.append(os.path.join(root, images_dir, rec["name"]))
            p = cam["params"]
            if cam["model"] in _SINGLE_FOCAL:   # (f, cx, cy, distortion...)
                fx = fy = p[0]; cx, cy = p[1], p[2]
            else:                               # (fx, fy, cx, cy, ...)
                fx, fy, cx, cy = p[0], p[1], p[2], p[3]
            intr_all.append(np.array(
                [[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32))
        # distortion of the (first) camera -> the renderer's camera model
        # (project_gaussians_ut); COLMAP leaves coefficients after the
        # focal/principal block
        self.camera_model, self.dist = _colmap_distortion(
            cams[imgs[order[0]]["camera_id"]]
        )
        used_cams = {imgs[i]["camera_id"] for i in order}
        models = {_colmap_distortion(cams[c]) for c in used_cams}
        if len(models) > 1:
            import warnings
            warnings.warn(
                "ColmapDataset: reconstruction mixes distortion models "
                f"{sorted(m for m, _ in models)}; all views render through "
                f"the first camera's ({self.camera_model}, {self.dist})"
            )
        intr_all = np.stack(intr_all)
        if not np.allclose(intr_all, intr_all[0], rtol=1e-3):
            import warnings
            warnings.warn(
                "ColmapDataset: reconstruction has heterogeneous camera "
                "intrinsics; the renderer uses the first camera's matrix "
                "for all views (per-view intrinsics kept in intrinsics_all)"
            )
        intr = intr_all[0]

        images = _load_images(paths)
        h, w = images[0].shape[:2]
        flat = np.stack([im.reshape(h * w, 3) for im in images])
        poses = np.stack(poses)

        is_test = np.zeros(len(poses), bool)
        if test_every > 0:
            is_test[::test_every] = True
        self.img_res = (h, w)
        self.intrinsics = intr
        self.intrinsics_all = intr_all[~is_test]
        self.pose_all = poses[~is_test]
        self.rgb_images = flat[~is_test]
        self.n_images = len(self.pose_all)
        self.test = (
            {"pose_all": poses[is_test], "rgb_images": flat[is_test],
             "intrinsics_all": intr_all[is_test]}
            if is_test.any() else None
        )

    def seed_points(self, n: int | None = None, **_):
        assert self.points_xyz is not None, "no points3D in reconstruction"
        xyz, rgb = self.points_xyz, self.points_rgb
        if n is not None and len(xyz) > n:
            keep = np.linspace(0, len(xyz) - 1, n).astype(int)
            xyz, rgb = xyz[keep], rgb[keep]
        return xyz, rgb
