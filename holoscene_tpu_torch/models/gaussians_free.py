"""Free (unconstrained) 3D Gaussian splatting: model, densification and
SelectiveAdam (port of holoscene_tpu/models/gaussians_free.py).

The model owns a fixed capacity of slots with an `alive` mask, as the
counterpart does: culling clears slots, densification writes split / dup
children into dead slots, MCMC relocation recycles the weakest slots at
high-opacity sites. Shapes never change, so the trainer's cached bins and
the tests can compare slot by slot.

Every random draw is an argument or comes from an explicit
`torch.Generator`: the seed positions of a random init (generator),
refine's normal `eps` (argument) and MCMC's `target_idx` (argument, or
the generator). The tests pass the counterpart's draws.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from holoscene_tpu_torch import as_tensor
from holoscene_tpu_torch.ops import draws
from holoscene_tpu_torch.ops.gaussians import (
    covariance_3d,
    num_sh_bases,
    project_gaussians,
    quat_to_rotmat,
    rgb_to_sh,
    view_matrix,
)
from holoscene_tpu_torch.ops.splat import project_for_render, render_gaussians
from holoscene_tpu_torch.ops.splat_flat import build_flat_bins

@dataclasses.dataclass(frozen=True)
class FreeGaussianConfig:
    capacity: int = 100000
    sh_degree: int = 3
    cull_alpha_thresh: float = 0.1
    cull_scale_thresh: float = 0.5
    densify_grad_thresh: float = 0.0008
    densify_size_thresh: float = 0.01
    n_split_samples: int = 2
    tile_size: int = 16
    max_per_tile: int = 512
    # camera model of the training / eval renders: pinhole | opencv |
    # fisheye (+ dist coefficients); non-pinhole projects through the UT
    camera_model: str = "pinhole"
    dist: tuple | None = None
    # the flat sorted-candidate pipeline (K1/K2) with per-frame cached
    # bins; None = on when the parameters live on the card
    use_flat: bool | None = None
    rebin_every: int = 8


def init_free_gaussians(
    cfg: FreeGaussianConfig,
    points: np.ndarray | None = None,
    colors: np.ndarray | None = None,
    init_scale: float | None = None,
    scene_extent: float = 1.0,
    generator: torch.Generator | None = None,
    device: str | torch.device = "cpu",
) -> tuple[dict, dict]:
    """(params, state) seeded from points (SfM / mesh samples) or, without
    points, from min(capacity, 50000) uniform draws in the cube of half
    side scene_extent (drawn from `generator` on the CPU)."""
    dev = torch.device(device)
    n_cap = cfg.capacity
    if points is None:
        n_seed = min(n_cap, 50000)
        points = (torch.rand(n_seed, 3, generator=generator) * 2.0 - 1.0) \
            * scene_extent
        points = points.numpy()
    points = np.asarray(points)[:n_cap]
    n_seed = len(points)
    if colors is None:
        colors = np.full((n_seed, 3), 0.5)

    if init_scale is None:
        from scipy.spatial import cKDTree

        d, _ = cKDTree(points).query(points, k=min(4, n_seed))
        avg = (d[:, 1:].mean(axis=1) if d.ndim > 1 and d.shape[1] > 1
               else np.full(n_seed, 0.02))
        scales = np.log(np.maximum(avg, 1e-4))[:, None].repeat(3, axis=1)
    else:
        scales = np.full((n_seed, 3), np.log(init_scale))

    def pad(x, fill=0.0):
        out = np.full((n_cap,) + np.shape(x)[1:], fill, dtype=np.float32)
        out[:n_seed] = x
        return as_tensor(out, dev)

    logit_01 = float(torch.logit(torch.tensor(0.1, dtype=torch.float32)))
    quats = np.zeros((n_cap, 4), np.float32)
    quats[:, 0] = 1.0
    params = {
        "means": pad(points),
        "log_scales": pad(scales, fill=np.log(1e-3)),
        "quats": as_tensor(quats, dev),
        "opacity_logits": pad(np.full((n_seed,), logit_01), fill=-12.0),
        "features_dc": pad(rgb_to_sh(as_tensor(colors, torch.device("cpu")))
                           .numpy()),
        "features_rest": torch.zeros(n_cap, num_sh_bases(cfg.sh_degree) - 1,
                                     3, device=dev),
    }
    state = {
        "alive": torch.arange(n_cap, device=dev) < n_seed,
        "grad_accum": torch.zeros(n_cap, device=dev),
        "grad_count": torch.zeros(n_cap, device=dev),
    }
    return params, state


def free_project(params, state, cfg: FreeGaussianConfig, pose_c2w,
                 intrinsics, width: int, height: int):
    """Projected geometry (xy, depth, conic, opacity, valid) as the render
    projects it (EWA in matrix form, or the UT): the flat bins' input."""
    dev = params["means"].device
    viewmat = view_matrix(pose_c2w, dev)
    intr = as_tensor(intrinsics, dev)
    opac = torch.sigmoid(params["opacity_logits"]) * state["alive"]
    scales = torch.exp(params["log_scales"])
    if cfg.camera_model != "pinhole":
        xy, depth, conic, _r, valid = project_for_render(
            params["means"], params["quats"], scales, viewmat, intr, width,
            height, camera_model=cfg.camera_model, dist=cfg.dist)
    else:
        xy, depth, conic, _r, valid = project_gaussians(
            params["means"], covariance_3d(params["quats"], scales), viewmat,
            intr, width, height)
    return xy, depth, conic, opac, valid


@torch.no_grad()
def free_flat_bins(params, state, cfg: FreeGaussianConfig, pose_c2w,
                   intrinsics, width: int, height: int, plan):
    """The cached-binning refresh for free gaussians (one camera)."""
    xy, depth, conic, opac, valid = free_project(
        params, state, cfg, pose_c2w, intrinsics, width, height)
    return build_flat_bins(
        xy, depth, conic, opac, valid, tiles_x=-(-width // cfg.tile_size),
        tiles_y=-(-height // cfg.tile_size), tile_size=cfg.tile_size,
        plan=plan)


def render_free_gaussians(params, state, cfg: FreeGaussianConfig, pose_c2w,
                          intrinsics, width: int, height: int,
                          background=None, flat_plan=None, flat_bins=None):
    """render_gaussians of the alive slots (dead slots are transparent):
    the flat pipeline with a flat_plan, the top-K one at cfg.max_per_tile
    without; non-pinhole cameras through the UT projection."""
    dev = params["means"].device
    opac = torch.sigmoid(params["opacity_logits"]) * state["alive"]
    colors = torch.cat(
        [params["features_dc"][:, None, :], params["features_rest"]], dim=1)
    return render_gaussians(
        params["means"], params["quats"], torch.exp(params["log_scales"]),
        opac, colors, view_matrix(pose_c2w, dev), as_tensor(intrinsics, dev),
        width, height, tile_size=cfg.tile_size,
        max_per_tile=cfg.max_per_tile, sh_degree=cfg.sh_degree,
        background=background, camera_model=cfg.camera_model, dist=cfg.dist,
        flat_plan=flat_plan, flat_bins=flat_bins)


# ---------------------------------------------------------------------------
# densification (fixed capacity, mask-based)
# ---------------------------------------------------------------------------


@torch.no_grad()
def accumulate_positional_grads(state: dict, mean_grads) -> dict:
    """Positional gradient norms summed per slot between refinements."""
    norms = torch.linalg.vector_norm(mean_grads, dim=-1)
    return {**state, "grad_accum": state["grad_accum"] + norms,
            "grad_count": state["grad_count"] + (norms > 0)}


def _set_rows(arr, rows, values):
    out = arr.clone()
    out[rows] = values
    return out


@torch.no_grad()
def refine_gaussians(params, state, cfg: FreeGaussianConfig,
                     scene_extent: float = 1.0, *, eps):
    """Cull + split + dup into dead slots, shapes static. eps [capacity, 3]
    is the standard-normal draw that places split children inside their
    parent (the counterpart draws it from its key). Returns (params,
    state, stats); stats["reset_mask"] marks the slots whose moments
    reset."""
    alive = state["alive"]
    n_cap = alive.shape[0]
    dev = alive.device
    opac = torch.sigmoid(params["opacity_logits"])
    max_scale = torch.exp(params["log_scales"]).max(dim=-1).values

    cull = alive & ((opac < cfg.cull_alpha_thresh)
                    | (max_scale > cfg.cull_scale_thresh * scene_extent))
    alive = alive & ~cull

    avg_grad = state["grad_accum"] / torch.clamp(state["grad_count"], min=1.0)
    hot = alive & (avg_grad > cfg.densify_grad_thresh)
    split = hot & (max_scale > cfg.densify_size_thresh * scene_extent)
    dup = hot & ~split

    # parents best first (split, then dup) spawn into dead slots first
    prio = torch.where(split, 2.0, torch.where(dup, 1.0, 0.0))
    parent = torch.argsort(-prio, stable=True)
    child = torch.argsort(alive.to(torch.int8), stable=True)
    n_spawn = torch.minimum((prio > 0).sum(), (~alive).sum())
    do_spawn = (torch.arange(n_cap, device=dev) < n_spawn) & (prio[parent] > 0)
    parent_is_split = split[parent]

    eps = as_tensor(eps, dev)
    rot = quat_to_rotmat(params["quats"][parent])
    offset = torch.einsum("nij,nj->ni", rot,
                          eps * torch.exp(params["log_scales"][parent]))
    child_means = params["means"][parent] + torch.where(
        parent_is_split[:, None], offset, torch.zeros_like(offset))
    scale_div = torch.where(parent_is_split, float(np.log(1.6)), 0.0)
    child_log_scales = params["log_scales"][parent] - scale_div[:, None]

    def spawn_set(arr, child_vals):
        keep = do_spawn.reshape((-1,) + (1,) * (arr.ndim - 1))
        return _set_rows(arr, child, torch.where(keep, child_vals,
                                                 arr[child]))

    new = dict(params)
    new["means"] = spawn_set(params["means"], child_means)
    new["log_scales"] = spawn_set(params["log_scales"], child_log_scales)
    for name in ("quats", "opacity_logits", "features_dc", "features_rest"):
        new[name] = spawn_set(params[name], params[name][parent])
    # split parents shrink too
    new["log_scales"] = torch.where(split[:, None],
                                    new["log_scales"] - float(np.log(1.6)),
                                    new["log_scales"])

    spawned = _set_rows(torch.zeros(n_cap, dtype=torch.bool, device=dev),
                        child, do_spawn)
    alive = alive | spawned
    new_state = {"alive": alive, "grad_accum": torch.zeros(n_cap, device=dev),
                 "grad_count": torch.zeros(n_cap, device=dev)}
    stats = {"n_culled": cull.sum(), "n_split": (split & alive).sum(),
             "n_spawned": spawned.sum(), "reset_mask": spawned | cull,
             "n_alive": alive.sum()}
    return new, new_state, stats


@torch.no_grad()
def mcmc_relocate(params, state, cfg: FreeGaussianConfig,
                  fraction: float = 0.05, target_idx=None,
                  generator: torch.Generator | None = None):
    """MCMC-style relocation: the weakest `fraction` of the capacity (alive
    slots by opacity) moves to the sites of `target_idx` [n_move], drawn
    with probability proportional to opacity (ops/draws.py::draw_by_weight)
    when None; mover and target share the opacity 1 - sqrt(1 - o)
    (binomial split with n = 2). Returns (params, state, stats) with
    stats["reset_mask"]."""
    alive = state["alive"]
    dev = alive.device
    opac = torch.sigmoid(params["opacity_logits"]) * alive
    n_cap = alive.shape[0]
    n_move = int(n_cap * fraction)

    dead_score = torch.where(alive, opac, torch.full_like(opac, float("inf")))
    move_idx = torch.argsort(dead_score, stable=True)[:n_move]
    if target_idx is None:
        target_idx = draws.draw_by_weight(opac, n_move, generator)
    if not torch.is_tensor(target_idx):
        target_idx = np.array(target_idx)
    target_idx = torch.as_tensor(target_idx, device=dev).long()

    t_opac = torch.sigmoid(params["opacity_logits"][target_idx])
    new_opac = 1.0 - torch.sqrt(torch.clamp(1.0 - t_opac, min=1e-6))
    new_logit = torch.logit(torch.clamp(new_opac, 1e-5, 1 - 1e-5))

    new = dict(params)
    for name in ("means", "quats", "log_scales", "features_dc",
                 "features_rest"):
        new[name] = _set_rows(params[name], move_idx,
                              params[name][target_idx])
    logits = _set_rows(params["opacity_logits"], move_idx, new_logit)
    logits[target_idx] = new_logit
    new["opacity_logits"] = logits
    reset = torch.zeros(n_cap, dtype=torch.bool, device=dev)
    reset[move_idx] = True
    reset[target_idx] = True
    return new, state, {"reset_mask": reset, "n_moved": n_move}


# ---------------------------------------------------------------------------
# SelectiveAdam
# ---------------------------------------------------------------------------


@torch.no_grad()
def selective_adam_update(grads: dict, moments: dict, params: dict,
                          visibility, lr, b1: float = 0.9, b2: float = 0.999,
                          eps: float = 1e-15):
    """Visibility-masked Adam: moments and parameters of visible slots
    update, invisible slots keep theirs (no moment decay). moments =
    {"m": {name: tensor}, "v": {...}, "count": int}; lr a float or a dict
    by name. Returns (params, moments), new tensors."""
    count = int(moments["count"]) + 1
    c1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** count
    c2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** count
    new_p, new_m, new_v = {}, {}, {}
    for name, p in params.items():
        g, m, v = grads[name], moments["m"][name], moments["v"][name]
        vis = visibility.reshape((-1,) + (1,) * (g.ndim - 1))
        m_new = torch.where(vis, b1 * m + (1 - b1) * g, m)
        v_new = torch.where(vis, b2 * v + (1 - b2) * g * g, v)
        m_hat = m_new / c1.to(m.device)
        v_hat = v_new / c2.to(v.device)
        this_lr = lr[name] if isinstance(lr, dict) else lr
        new_p[name] = torch.where(
            vis, p - this_lr * m_hat / (torch.sqrt(v_hat) + eps), p)
        new_m[name], new_v[name] = m_new, v_new
    return new_p, {"m": new_m, "v": new_v, "count": count}


def init_selective_adam(params: dict) -> dict:
    return {"m": {k: torch.zeros_like(v) for k, v in params.items()},
            "v": {k: torch.zeros_like(v) for k, v in params.items()},
            "count": 0}


@torch.no_grad()
def reset_moments(moments: dict, mask) -> dict:
    """Zero the moments of the slots in mask [capacity] bool (refreshed by
    a refine or a relocation)."""
    def z(x):
        m = mask.reshape((-1,) + (1,) * (x.ndim - 1))
        return torch.where(m, torch.zeros_like(x), x)

    return {"m": {k: z(v) for k, v in moments["m"].items()},
            "v": {k: z(v) for k, v in moments["v"].items()},
            "count": moments["count"]}
