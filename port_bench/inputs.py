"""Inputs the harness makes and hands to both the program and the plain
reference: Stage-1 weights drawn on the device from the seed, and Stage-1
ray batches read back from the room's own arrays.

The weights follow the Stage-1 network's published initialisation
(geometric init of the SDF MLP, uniform hash tables of +-1e-4, kaiming
colour and rendering MLPs, beta 0.1) with the harness's own draws from a
torch.Generator on the card, one call a tensor.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from port_bench import scene


def stage1_weights(model, seed: int, device) -> dict:
    """{parameter name: tensor} for a Stage-1 model with the reference's
    parameter names (port_bench/ref_s1/holoscene.py::HoloSceneModel),
    drawn on `device` from `seed`."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    icfg = model.cfg.implicit
    out: dict[str, torch.Tensor] = {}

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    def uniform(shape, bound):
        return (torch.rand(shape, generator=gen, device=device) * 2 - 1) \
            * bound

    def wn(prefix, v, b):
        out[f"{prefix}.v"] = v
        out[f"{prefix}.g"] = torch.linalg.norm(v, dim=1)
        out[f"{prefix}.b"] = b

    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    n_imp = len(model.implicit.mlp)
    for i in range(n_imp):
        out_dim, in_dim = shapes[f"implicit.mlp.lin{i}.v"]
        b = torch.zeros(out_dim, device=device)
        if icfg.geometric_init and i == n_imp - 1:
            w = normal((out_dim, in_dim), 1e-4)
            w[0] -= math.sqrt(math.pi) / math.sqrt(in_dim)
            w[1:] += math.sqrt(math.pi) / math.sqrt(in_dim)
            b[0] = icfg.bias
            b[1:] = -0.5 * icfg.bias
        elif icfg.geometric_init and icfg.multires > 0 and i == 0:
            w = torch.zeros(out_dim, in_dim, device=device)
            w[:, :3] = normal((out_dim, 3), math.sqrt(2) / math.sqrt(out_dim))
        else:
            w = normal((out_dim, in_dim), math.sqrt(2) / math.sqrt(out_dim))
        wn(f"implicit.mlp.lin{i}", w, b)
    for name in ("implicit.grid", "implicit.color_grid"):
        if name in shapes:
            out[name] = uniform(shapes[name], 1e-4)
    for i in range(2 if "implicit.color_map_mlp.lin0.w" in shapes else 0):
        o, n = shapes[f"implicit.color_map_mlp.lin{i}.w"]
        out[f"implicit.color_map_mlp.lin{i}.w"] = uniform(
            (o, n), math.sqrt(1.0 / n) * math.sqrt(3.0))
        out[f"implicit.color_map_mlp.lin{i}.b"] = uniform(
            (o,), math.sqrt(1.0 / n))
    for i in range(len(model.rendering.mlp)):
        o, n = shapes[f"rendering.mlp.lin{i}.v"]
        bound = math.sqrt(1.0 / n)
        wn(f"rendering.mlp.lin{i}", uniform((o, n), bound * math.sqrt(3)),
           uniform((o,), bound))
    out["density.beta"] = torch.tensor(model.cfg.beta_init, device=device)
    missing = set(shapes) - set(out)
    if missing:
        raise KeyError(f"no rule for the parameters {sorted(missing)}")
    return out


class RoomBatches:
    """Stage-1 batches from the room's own arrays, as the dataset reader
    lays them out: the training split's frame, the pixels' uv, the
    normalised OpenCV pose, the 4 x 4 intrinsics, rgb / depth / normal /
    mask and the instance ids (walls 0, sphere k k + 1)."""

    def __init__(self, room: scene.Room, test_split: bool, device):
        self.room = room
        self.device = device
        self.frames = scene.train_frames(len(room.poses), test_split)
        centre, scale = scene.normalization(room.poses)
        poses = room.poses.copy()
        poses[:, :3, 3] = (poses[:, :3, 3] - centre) / scale
        self.poses = poses.astype(np.float32)
        intr = np.eye(4, dtype=np.float32)
        intr[0, 0] = intr[1, 1] = room.focal
        intr[0, 2] = intr[1, 2] = room.res / 2.0
        self.intrinsics = intr

    def batch(self, train_frame: int, idx: np.ndarray) -> dict:
        f = int(self.frames[train_frame])
        r = self.room
        w = r.res
        idx = np.asarray(idx, dtype=np.int64)
        uv = np.stack([idx % w, idx // w], -1).astype(np.float32)
        rgb = r.rgb[f].reshape(-1, 3)[idx].astype(np.float32) / 255.0
        depth = r.depth[f].reshape(-1, 1)[idx].astype(np.float32)
        normal = (r.normal[f].reshape(-1, 3)[idx].astype(np.float32)
                  / 255.0) * 2.0 - 1.0
        m = r.mask[f].reshape(-1)[idx].astype(np.int64)
        segs = np.where(m == 255, 0, m + 1)
        dev = self.device

        def t(a, dtype=torch.float32):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=dev)

        return {"uv": t(uv), "pose": t(self.poses[f]),
                "intrinsics": t(self.intrinsics), "rgb": t(rgb),
                "depth": t(depth), "normal": t(normal),
                "mask": torch.ones(len(idx), 1, device=dev),
                "segs": t(segs, torch.int64)}
