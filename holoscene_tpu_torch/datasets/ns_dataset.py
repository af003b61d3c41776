"""Replica/ScanNet-style dataset loader (reference on-disk format).

The port's own copy of holoscene_tpu/datasets/ns_dataset.py: the port
imports nothing of the JAX package.

Reference semantics: datasets/ns_dataset.py:19-479 —
  * directory layout: images/, depth/*.npy, normal/*.png, instance_mask/*.png,
    transforms.json (single shared intrinsics `fl_x fl_y cx cy` + per-frame
    OpenGL c2w `transform_matrix`), optional graph.json (scene-graph adjacency)
  * pose convention: flip columns 1:3 (OpenGL -> OpenCV, ns_dataset.py:227)
  * scene normalization: center/scale from the camera-position bounding box
    (ns_dataset.py:238-247)
  * instance masks: 255 -> background id 0, else id+1 (ns_dataset.py:300-305)
  * normals: png [0,1] -> [-1,1]
  * evenly-spaced train/test split (ns_dataset.py:333-375)
  * semantic-class-balanced pixel sampling: half the batch split evenly over
    the classes present in the frame, half uniform (ns_dataset.py:409-453)

Pure numpy on the host (no torch dataloader); batches are returned as
fixed-size numpy arrays (exactly `sampling_size` rays — the balanced quota is
padded with uniform pixels so batch shapes never change).
"""

from __future__ import annotations

import json
import os
from collections import defaultdict, deque

import numpy as np
from PIL import Image


def extract_graph_node_properties(graph: list[dict]) -> dict[int, dict]:
    """Scene-graph adjacency list -> per-node {parent, root, leaf, layer,
    desc, dist_to_root} (reference ns_dataset.py:19-131)."""
    adjacency = defaultdict(set)
    for node in graph:
        nid = node["node_id"]
        for adj in node["adj_nodes"]:
            adjacency[nid].add(adj)
            adjacency[adj].add(nid)

    n = len(graph)
    root = 0
    parents = {root: -1}
    tree = defaultdict(list)
    visited: set[int] = set()
    queue = deque([(root, None)])
    while queue:
        node, parent = queue.popleft()
        if node in visited:
            continue
        visited.add(node)
        if parent is not None and node != root:
            parents[node] = parent
        if parent is not None:
            tree[parent].append(node)
        for nb in adjacency[node]:
            if nb not in visited:
                queue.append((nb, node))

    leaf_nodes = {node for node in range(n) if not tree.get(node)}

    def descendants(node):
        out = []

        def dfs(cur):
            for child in tree.get(cur, []):
                out.append(child)
                dfs(child)

        dfs(node)
        return sorted(out)

    all_desc = {node: descendants(node) for node in range(n)}

    layer_map: dict[int, int] = {}
    remaining = set(range(n))
    layer = 0
    while remaining:
        batch = sorted(
            node for node in remaining
            if not any(child in remaining for child in tree.get(node, []))
        )
        if not batch:
            break
        for node in batch:
            layer_map[node] = layer
        remaining -= set(batch)
        layer += 1

    dist_to_root = {}
    for node in range(n):
        d, cur = 0, node
        while cur != root:
            d += 1
            cur = parents[cur]
        dist_to_root[node] = d

    return {
        node: {
            "parent": parents.get(node, -1),
            "root": node == root,
            "leaf": node in leaf_nodes,
            "layer": layer_map.get(node, -1),
            "desc": all_desc[node],
            "dist_to_root": dist_to_root[node],
        }
        for node in range(n)
    }


def _listdir_full(d: str) -> list[str]:
    return [os.path.join(d, f) for f in sorted(os.listdir(d))]


class NSDataset:
    """Host-side dataset. All tensors are numpy float32, image-major layout
    [n_images, H*W, C]."""

    def __init__(
        self,
        data_root_dir: str,
        data_dir: str,
        img_res: tuple[int, int],
        scene_normalize_scale: float = 1.0,
        test_split: bool = False,
        test_split_ratio: float = 0.1,
        prior_dir: str = "",
        fix_length: int = 0,
        max_num_images: int = -1,
        seed: int = 0,
    ):
        self.instance_dir = os.path.join(data_root_dir, data_dir)
        assert os.path.exists(self.instance_dir), f"missing {self.instance_dir}"
        self.img_res = tuple(img_res)
        self.total_pixels = img_res[0] * img_res[1]
        self.fix_length = fix_length
        self.rng = np.random.default_rng(seed)

        image_paths = _listdir_full(os.path.join(self.instance_dir, "images"))
        depth_paths = _listdir_full(os.path.join(self.instance_dir, prior_dir, "depth"))
        normal_paths = _listdir_full(os.path.join(self.instance_dir, prior_dir, "normal"))
        mask_paths = _listdir_full(os.path.join(self.instance_dir, "instance_mask"))

        if max_num_images > 0 and max_num_images < len(image_paths):
            keep = np.linspace(0, len(image_paths) - 1, max_num_images).astype(int)
            image_paths = [image_paths[i] for i in keep]
            depth_paths = [depth_paths[i] for i in keep]
            normal_paths = [normal_paths[i] for i in keep]
            mask_paths = [mask_paths[i] for i in keep]

        graph_path = os.path.join(self.instance_dir, "graph.json")
        self.graph_node_dict = None
        if os.path.exists(graph_path):
            with open(graph_path) as f:
                self.graph_node_dict = extract_graph_node_properties(json.load(f))

        with open(os.path.join(self.instance_dir, "transforms.json")) as f:
            cam = json.load(f)
        intr = np.eye(4, dtype=np.float32)
        intr[0, 0], intr[1, 1] = cam["fl_x"], cam["fl_y"]
        intr[0, 2], intr[1, 2] = cam["cx"], cam["cy"]
        self.intrinsics = intr

        poses = []
        for frame in cam["frames"][: len(image_paths)]:
            p = np.array(frame["transform_matrix"], dtype=np.float64).reshape(4, 4)
            p[:3, 1:3] *= -1  # OpenGL -> OpenCV
            poses.append(p)
        poses = np.stack(poses)

        # camera-bbox scene normalization (ns_dataset.py:238-247)
        max_xyz = poses[:, :3, 3].max(axis=0)
        min_xyz = poses[:, :3, 3].min(axis=0)
        self.scene_center = (max_xyz + min_xyz) / 2
        self.scene_scale = float((max_xyz - min_xyz).max()) * scene_normalize_scale
        poses[:, :3, 3] = (poses[:, :3, 3] - self.scene_center) / self.scene_scale
        self.pose_all = poses.astype(np.float32)

        n = len(image_paths)
        first = np.asarray(Image.open(image_paths[0]))
        if first.shape[0] * first.shape[1] != self.total_pixels:
            raise ValueError(
                f"dataset.img_res {self.img_res} does not match on-disk "
                f"images {first.shape[:2]} under {self.instance_dir} (the "
                "loader, like the reference, does not resize)"
            )
        self.rgb_images = np.stack(
            [
                (np.asarray(Image.open(p), dtype=np.float32) / 255.0)[..., :3]
                .reshape(-1, 3)
                for p in image_paths
            ]
        )
        self.depth_images = np.stack(
            [np.load(p).reshape(-1, 1).astype(np.float32) for p in depth_paths]
        )
        self.normal_images = np.stack(
            [
                (np.asarray(Image.open(p), dtype=np.float32) / 255.0).reshape(-1, 3)
                * 2.0
                - 1.0
                for p in normal_paths
            ]
        )

        sem, classes_per_frame = [], []
        num_instances = 0
        class_id_occurences: dict[int, list[int]] = defaultdict(list)
        for i, p in enumerate(mask_paths):
            m = np.asarray(Image.open(p), dtype=np.int32).reshape(-1)
            bg = m == 255
            m = m + 1
            m[bg] = 0
            num_instances = max(num_instances, int(m.max()))
            classes_per_frame.append(np.unique(m))
            sem.append(m)
        for i, m in enumerate(sem):
            ids, counts = np.unique(m, return_counts=True)
            for obj_i, cnt in zip(ids, counts):
                if cnt >= 8:
                    class_id_occurences[int(obj_i)].append(i)
        self.semantic_images = np.stack(sem)
        self.semantic_images_classes = classes_per_frame
        self.class_id_occurences = dict(class_id_occurences)
        self.label_mapping = list(range(num_instances + 1))
        self.num_instances = num_instances
        self.mask_images = np.ones_like(self.depth_images)

        self.n_images = n
        self.test = None
        if test_split:
            # keep at least one held-out frame even for tiny scenes
            n_test = max(1, int(n * test_split_ratio))
            train_idx = np.linspace(0, n - 1, n - n_test).astype(int)
            test_idx = np.setdiff1d(np.arange(n), train_idx)
            self.test = self._subset(test_idx)
            for name in ("rgb_images", "depth_images", "normal_images",
                         "semantic_images", "mask_images", "pose_all"):
                setattr(self, name, getattr(self, name)[train_idx])
            self.semantic_images_classes = [
                self.semantic_images_classes[i] for i in train_idx
            ]
            self.class_id_occurences = {
                k: [int(np.searchsorted(train_idx, i)) for i in v if i in set(train_idx)]
                for k, v in class_id_occurences.items()
            }
            self.n_images = len(train_idx)

        ys, xs = np.mgrid[0 : self.img_res[0], 0 : self.img_res[1]]
        self.uv_full = np.stack([xs, ys], axis=-1).reshape(-1, 2).astype(np.float32)

        # lazily-built per-(frame, class) pixel index lists: turns the
        # per-iteration O(H*W) mask scans of class-balanced sampling into
        # O(batch) lookups
        self._class_pixels: dict[tuple[int, int], np.ndarray] = {}

    def _class_pixel_idx(self, frame_idx: int, cls: int) -> np.ndarray:
        key = (frame_idx, int(cls))
        cached = self._class_pixels.get(key)
        if cached is None:
            cached = np.flatnonzero(self.semantic_images[frame_idx] == cls)
            self._class_pixels[key] = cached
        return cached

    def _subset(self, idx):
        return {
            "rgb_images": self.rgb_images[idx],
            "depth_images": self.depth_images[idx],
            "normal_images": self.normal_images[idx],
            "semantic_images": self.semantic_images[idx],
            "mask_images": self.mask_images[idx],
            "pose_all": self.pose_all[idx],
        }

    # ------------------------------------------------------------------
    # sampling
    # ------------------------------------------------------------------

    def __len__(self) -> int:
        return self.n_images if self.fix_length == 0 else self.fix_length

    def sample_rays(self, sampling_size: int, frame_idx: int | None = None,
                    class_id: int = -1):
        """Semantic-balanced ray batch of EXACTLY `sampling_size` pixels
        (ns_dataset.py:409-453; shortfalls padded with uniform pixels so
        batch shapes stay static).

        Returns (frame_idx, sample dict, ground_truth dict) of numpy arrays.
        """
        if frame_idx is None:
            frame_idx = int(self.rng.integers(0, self.n_images))
        if class_id != -1:
            occ = self.class_id_occurences.get(class_id, [])
            assert occ, f"class {class_id} never observed"
            frame_idx = int(self.rng.choice(occ))

        if class_id == -1:
            half = sampling_size // 2
            classes = self.semantic_images_classes[frame_idx]
            per_sem = max(half // max(len(classes), 1), 1)
            picks = []
            for ci, cls in enumerate(classes):
                quota = (
                    half - per_sem * (len(classes) - 1) if ci == 0 else per_sem
                )
                pix = self._class_pixel_idx(frame_idx, cls)
                if len(pix) > quota:
                    pix = self.rng.choice(pix, quota, replace=False)
                picks.append(pix)
            picks.append(
                self.rng.choice(self.total_pixels, sampling_size - half, replace=False)
            )
            idx = np.concatenate(picks)
            if len(idx) < sampling_size:  # pad shortfall uniformly
                idx = np.concatenate(
                    [idx, self.rng.choice(self.total_pixels, sampling_size - len(idx))]
                )
            idx = idx[:sampling_size]
        else:
            pix = self._class_pixel_idx(frame_idx, class_id)
            idx = (
                self.rng.choice(pix, sampling_size, replace=False)
                if len(pix) >= sampling_size
                else self.rng.choice(pix, sampling_size, replace=True)
            )

        sample = {
            "uv": self.uv_full[idx],
            "intrinsics": self.intrinsics,
            "pose": self.pose_all[frame_idx],
            "sampling_idx": idx.astype(np.int64),
        }
        gt = {
            "rgb": self.rgb_images[frame_idx][idx],
            "depth": self.depth_images[frame_idx][idx],
            "normal": self.normal_images[frame_idx][idx],
            "segs": self.semantic_images[frame_idx][idx],
            "mask": self.mask_images[frame_idx][idx],
        }
        return frame_idx, sample, gt

    def full_frame(self, frame_idx: int, split: str = "train"):
        """Whole-frame data for eval renders."""
        src = self if split == "train" else _Split(self.test)
        sample = {
            "uv": self.uv_full,
            "intrinsics": self.intrinsics,
            "pose": src.pose_all[frame_idx],
        }
        gt = {
            "rgb": src.rgb_images[frame_idx],
            "depth": src.depth_images[frame_idx],
            "normal": src.normal_images[frame_idx],
            "segs": src.semantic_images[frame_idx],
            "mask": src.mask_images[frame_idx],
        }
        return sample, gt


class _Split:
    def __init__(self, d: dict):
        for k, v in d.items():
            setattr(self, k, v)


class NSDatasetTex(NSDataset):
    """Full-frame dataset variant for Stages 3/4 (reference
    datasets/ns_dataset_tex.py:18-261: whole image + intrinsics + pose per
    item, no ray subsampling). Same loading/normalization as NSDataset;
    iteration yields full frames."""

    def __getitem__(self, idx: int):
        sample, gt = self.full_frame(idx)
        sample["image_res"] = np.asarray(self.img_res)
        return idx, sample, gt
