"""Adaptive Gaussian-on-Mesh: mesh-constrained densification (port of
holoscene_tpu/models/gom_adaptive.py).

Splatfacto-style refinement under the mesh constraint: positional gradient
norms accumulate per slot, refinement culls transparent slots and splits /
duplicates hot ones, split children at a fresh barycentric position inside
the parent's triangle. As in the counterpart the gaussians live in a fixed
capacity of slots with an alive mask and a per-slot `face_idx`: children
are written into dead slots, shapes never change, and the per-face static
geometry is gathered per slot through face_idx. Random draws (the split
children's barycentric u, v) are arguments or come from a torch.Generator.
"""

from __future__ import annotations

import numpy as np
import torch

from holoscene_tpu_torch import as_tensor
from holoscene_tpu_torch.models.gom import (
    GoMConfig,
    gom_means,
    gom_opacities,
    gom_quats,
    gom_scales,
    init_gom_params,
)
from holoscene_tpu_torch.ops.gaussians import view_matrix
from holoscene_tpu_torch.ops.splat import render_gaussians

_STATIC_PER_FACE = (
    "tri", "radius", "normals", "axis_x", "axis_y",
    "tri2d_a", "tri2d_b", "tri2d_c", "faces_quats", "xyz_radius",
    "features_dc",
)


def gather_static(static: dict, face_idx: torch.Tensor) -> dict:
    """Per-slot view of the per-face static buffers."""
    out = {k: static[k][face_idx] for k in _STATIC_PER_FACE}
    out["num_gaussians"] = int(face_idx.shape[0])
    return out


def init_adaptive_gom(static: dict, cfg: GoMConfig, capacity: int):
    """(params, state): the first F slots alive (one a face), the rest
    dead."""
    n_faces = static["num_gaussians"]
    if capacity < n_faces:
        raise ValueError(f"capacity {capacity} < {n_faces} seed faces")
    dev = static["tri"].device
    face_idx = torch.cat([torch.arange(n_faces, device=dev),
                          torch.zeros(capacity - n_faces, dtype=torch.int64,
                                      device=dev)])
    params = init_gom_params(gather_static(static, face_idx), cfg)
    state = {
        "face_idx": face_idx,
        "alive": torch.arange(capacity, device=dev) < n_faces,
        "grad_accum": torch.zeros(capacity, device=dev),
        "grad_count": torch.zeros(capacity, device=dev),
    }
    return params, state


def adaptive_activations(params, state, static, cfg: GoMConfig,
                         visible_mask=None):
    """(means, quats, scales, opacities), dead slots transparent."""
    gathered = gather_static(static, state["face_idx"])
    vis = state["alive"] if visible_mask is None \
        else state["alive"] & visible_mask
    return (gom_means(params, gathered, cfg), gom_quats(params, gathered, cfg),
            gom_scales(params, gathered, cfg), gom_opacities(params, vis))


def render_adaptive_gom(params, state, static, cfg: GoMConfig, pose_c2w,
                        intrinsics, width: int, height: int, background,
                        visible_mask=None, ortho: bool = False):
    """Top-K render of the alive slots: dict(rgb, depth, accumulation)."""
    dev = static["tri"].device
    means, quats, scales, opac = adaptive_activations(
        params, state, static, cfg, visible_mask)
    colors = torch.cat(
        [params["features_dc"][:, None, :], params["features_rest"]], dim=1)
    out = render_gaussians(
        means, quats, scales, opac, colors, view_matrix(pose_c2w, dev),
        as_tensor(intrinsics, dev), width, height, tile_size=cfg.tile_size,
        max_per_tile=cfg.max_per_tile, sh_degree=cfg.sh_degree,
        background=background, ortho=ortho)
    return {"rgb": torch.clamp(out["rgb"], 0.0, 1.0), "depth": out["depth"],
            "accumulation": out["alpha"]}


@torch.no_grad()
def accumulate_grads(state: dict, means2d_grads) -> dict:
    norms = torch.linalg.vector_norm(means2d_grads, dim=-1)
    return {**state, "grad_accum": state["grad_accum"] + norms,
            "grad_count": state["grad_count"] + (norms > 0)}


def _set_rows(arr, rows, values):
    out = arr.clone()
    out[rows] = values
    return out


@torch.no_grad()
def refine_adaptive(params, state, static, cfg: GoMConfig,
                    cull_alpha_thresh: float = 0.1,
                    densify_grad_thresh: float = 4e-4,
                    densify_size_ratio: float = 0.5, uv=None,
                    generator: torch.Generator | None = None):
    """Cull + split / dup constrained to faces. Split children take a fresh
    barycentric position inside the parent's triangle from the uniform
    draws uv = (u [capacity, 1], v [capacity, 1]) (from `generator` when
    None) and inherit the parent's face; scales shrink as splatfacto's.
    Returns (params, state, stats) with stats["reset_mask"]."""
    alive = state["alive"]
    face_idx = state["face_idx"]
    n_cap = alive.shape[0]
    dev = alive.device
    opac = torch.sigmoid(params["opacities"][:, 0])

    cull = alive & (opac < cull_alpha_thresh)
    alive = alive & ~cull

    gathered = gather_static(static, face_idx)
    scales = gom_scales(params, gathered, cfg)
    big = scales.max(dim=-1).values > densify_size_ratio * gathered["radius"]
    avg_grad = state["grad_accum"] / torch.clamp(state["grad_count"], min=1.0)
    hot = alive & (avg_grad > densify_grad_thresh)
    split = hot & big
    dup = hot & ~big

    prio = torch.where(split, 2.0, torch.where(dup, 1.0, 0.0))
    parent = torch.argsort(-prio, stable=True)
    child = torch.argsort(alive.to(torch.int8), stable=True)
    n_spawn = torch.minimum((prio > 0).sum(), (~alive).sum())
    do_spawn = (torch.arange(n_cap, device=dev) < n_spawn) & (prio[parent] > 0)

    if uv is None:
        gdev = generator.device if generator is not None else "cpu"
        uv = (torch.rand(n_cap, 1, generator=generator, device=gdev),
              torch.rand(n_cap, 1, generator=generator, device=gdev))
    u, v = (as_tensor(x, dev) for x in uv)
    flip = (u + v) > 1
    u = torch.where(flip, 1 - u, u)
    v = torch.where(flip, 1 - v, v)
    pa = gathered["tri2d_a"][parent]
    pb = gathered["tri2d_b"][parent]
    pc = gathered["tri2d_c"][parent]
    child_means2d = pa + u * (pb - pa) + v * (pc - pa)
    parent_is_split = split[parent]
    child_means2d = torch.where(parent_is_split[:, None], child_means2d,
                                params["means_2d"][parent])
    shrink = torch.where(parent_is_split, float(np.log(1.6)), 0.0)

    def spawn(arr, child_vals):
        keep = do_spawn.reshape((-1,) + (1,) * (arr.ndim - 1))
        return _set_rows(arr, child, torch.where(keep, child_vals,
                                                 arr[child]))

    new = {k: v.detach() for k, v in params.items()}
    new["means_2d"] = spawn(new["means_2d"], child_means2d)
    new["scales"] = spawn(new["scales"],
                          params["scales"][parent] - shrink[:, None])
    for name in ("normal_elevates", "quats", "features_dc", "features_rest",
                 "opacities"):
        new[name] = spawn(new[name], params[name][parent])
    new["scales"] = torch.where(split[:, None],
                                new["scales"] - float(np.log(1.6)),
                                new["scales"])

    new_face_idx = _set_rows(face_idx, child, torch.where(
        do_spawn, face_idx[parent], face_idx[child]))
    spawned = _set_rows(torch.zeros(n_cap, dtype=torch.bool, device=dev),
                        child, do_spawn)
    alive = alive | spawned
    new_state = {"face_idx": new_face_idx, "alive": alive,
                 "grad_accum": torch.zeros(n_cap, device=dev),
                 "grad_count": torch.zeros(n_cap, device=dev)}
    stats = {"n_culled": cull.sum(), "n_spawned": spawned.sum(),
             "n_alive": alive.sum(), "reset_mask": spawned | cull}
    return new, new_state, stats
