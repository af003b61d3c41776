"""Converters between the JAX package's state (Gaussian-on-Mesh params and
static dict, Stage-1 and colour-field params, the free-Gaussian trainer's
params / state / SelectiveAdam moments) and the port's tensors, and the
reader of the JAX package's flax msgpack files. Inputs are numpy arrays
(np.asarray of the JAX leaves), so this module never imports jax; the tests
use it to start both sides from identical state."""

from __future__ import annotations

import msgpack
import numpy as np
import torch

from holoscene_tpu_torch import as_tensor


def gom_params_from_jax(tree: dict, device: str | torch.device = "cpu",
                        requires_grad: bool = True) -> dict:
    """JAX GoM params {name: array} -> {name: float32 leaf tensor}, same
    keys and shapes."""
    dev = torch.device(device)
    return {k: as_tensor(np.asarray(v), dev).requires_grad_(requires_grad)
            for k, v in tree.items()}


def gom_static_from_jax(static: dict,
                        device: str | torch.device = "cpu") -> dict:
    """JAX GoM static dict -> the port's: array entries become float32
    tensors; instance_ranges and num_gaussians are copied."""
    dev = torch.device(device)
    out = {k: as_tensor(np.asarray(v), dev) for k, v in static.items()
           if k not in ("instance_ranges", "num_gaussians")}
    out["instance_ranges"] = [(int(lo), int(hi))
                              for lo, hi in static["instance_ranges"]]
    out["num_gaussians"] = int(static["num_gaussians"])
    return out


def params_to_numpy(params: dict) -> dict:
    """Tensors -> numpy arrays (the way back)."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def stage1_params_from_jax(tree: dict, device: str | torch.device = "cpu"
                           ) -> dict:
    """JAX Stage-1 params (nested dicts of arrays: implicit / rendering /
    density) -> the port's state dict: paths joined with dots
    ("implicit.mlp.lin0.v"), float32 tensors of the same shapes."""
    dev = torch.device(device)
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                out[f"{prefix}{k}"] = as_tensor(np.asarray(v), dev)

    walk(tree, "")
    return out


def stage1_params_to_jax(state: dict) -> dict:
    """The way back: a state dict -> nested dicts of numpy arrays."""
    tree: dict = {}
    for key, v in state.items():
        node = tree
        *path, leaf = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.detach().cpu().numpy()
    return tree


def color_field_params_from_jax(tree: dict,
                                device: str | torch.device = "cpu") -> dict:
    """JAX colour-field params ({grid, mlp: {lin{i}: {w, b}}}) ->
    ColorField's state dict ("grid", "mlp.lin0.w", ...)."""
    return stage1_params_from_jax(tree, device)


def color_field_params_to_jax(state: dict) -> dict:
    """ColorField's state dict -> JAX's nested numpy tree."""
    return stage1_params_to_jax(state)


def read_flax_msgpack(data: bytes):
    """Decode `flax.serialization.to_bytes` output with msgpack and numpy
    alone: ndarrays are msgpack ext type 1 holding (shape, dtype name, raw
    C-order bytes), numpy scalars ext type 3 (the same, 0-d), complex
    numbers ext type 2; lists and tuples arrive as dicts keyed "0", "1",
    ...; arrays over 2^30 bytes as {"__msgpack_chunked_array__", "shape",
    "chunks"} dicts. Returns the nested dict with numpy leaves."""
    def array(payload: bytes) -> np.ndarray:
        shape, dtype, buf = msgpack.unpackb(payload, raw=True)
        if dtype == b"bfloat16":
            raise ValueError("bfloat16 leaves need ml_dtypes; the Stage-1 "
                             "checkpoints are float32")
        return np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(
            shape).copy()

    def ext(code, payload):
        if code == 1:
            return array(payload)
        if code == 3:
            return array(payload)[()]
        if code == 2:
            re, im = msgpack.unpackb(payload)
            return complex(re, im)
        return msgpack.ExtType(code, payload)

    def unchunk(node):
        if not isinstance(node, dict):
            return node
        if "__msgpack_chunked_array__" in node:
            shape = tuple(node["shape"][str(i)]
                          for i in range(len(node["shape"])))
            chunks = [node["chunks"][str(i)]
                      for i in range(len(node["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: unchunk(v) for k, v in node.items()}

    return unchunk(msgpack.unpackb(data, ext_hook=ext, raw=False,
                                   strict_map_key=False))


_FREE_STATE_DTYPES = {"alive": torch.bool}


def free_gaussians_from_jax(params: dict, state: dict, moments: dict | None
                            = None, device: str | torch.device = "cpu"):
    """The free-Gaussian trainer's JAX params / state / SelectiveAdam
    moments ({"m", "v", "count"}) -> the port's (float32 tensors; alive
    bool; count an int). Returns (params, state, moments or None)."""
    dev = torch.device(device)

    def tree(t):
        return {k: as_tensor(np.asarray(v), dev) for k, v in t.items()}

    p = tree(params)
    st = {k: as_tensor(np.asarray(v), dev,
                       _FREE_STATE_DTYPES.get(k, torch.float32))
          for k, v in state.items()}
    mo = None
    if moments is not None:
        mo = {"m": tree(moments["m"]), "v": tree(moments["v"]),
              "count": int(np.asarray(moments["count"]))}
    return p, st, mo


def free_gaussians_to_jax(params: dict, state: dict,
                          moments: dict | None = None):
    """The way back: numpy trees (count a 0-d int32 array)."""
    mo = None
    if moments is not None:
        mo = {"m": params_to_numpy(moments["m"]),
              "v": params_to_numpy(moments["v"]),
              "count": np.asarray(moments["count"], np.int32)}
    return params_to_numpy(params), params_to_numpy(state), mo
