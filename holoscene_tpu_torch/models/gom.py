"""Gaussian-on-Mesh appearance model (Stage 4), port of
holoscene_tpu/models/gom.py.

One gaussian per (area-subdivided) mesh face. `seed_gaussians_from_meshes`
builds the STATIC face-geometry tensors (numpy seeding, copied from the
reference), `init_gom_params` the trainable tensors, `gom_means` /
`gom_scales` / `gom_quats` / `gom_opacities` apply the straight-through
constraint reparameterisations, `render_gom` / `gom_loss` close the step.
Params are a dict of leaf tensors with the reference's keys and shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from holoscene_tpu_torch import as_tensor
from holoscene_tpu_torch.ops.gaussians import (
    axis_angle_to_quat,
    num_sh_bases,
    project_gaussians_fused,
    quat_multiply,
    rgb_to_sh,
    rotmat_to_quat,
    view_matrix,
)
from holoscene_tpu_torch.ops.splat import render_gaussians
from holoscene_tpu_torch.ops.splat_flat import build_flat_bins
from holoscene_tpu_torch.ops.ssim import ssim as ssim_fn
from holoscene_tpu_torch.ops.ssim import ssim_chw
from holoscene_tpu_torch.utils.mesh import Mesh


@dataclasses.dataclass(frozen=True)
class GoMConfig:
    sh_degree: int = 3
    upper_scale: float = 2.0
    unconstrained_scale: bool = True
    unconstrained_elevate: bool = True
    face_flat_coef: float = 0.005
    elevate_coef: float = 2.0
    cone_coef: float = 10.0 * np.pi / 180.0
    ssim_lambda: float = 0.2
    acm_lambda: float = 20.0
    rgb_lambda: float = 1.0
    mesh_depth_lambda: float = 10.0
    use_scale_regularization: bool = False
    max_gauss_ratio: float = 10.0
    tile_size: int = 16
    # top-K compositing depth per tile; 0 = picked at trainer start from the
    # scene's p99 tile overlap and a saturation calibration (ops/splat.py)
    max_per_tile: int = 512
    # training renders: None or True = the flat sorted-candidate pipeline
    # (exact, no K truncation; kernels K1/K2), False = the top-K pipeline
    # (kernels K3/K4). Orthographic invisible-view renders and renders at
    # another resolution than the dataset's are top-K either way.
    use_flat: bool | None = None
    # per-frame-VISIT refresh cadence of the cached binning plans
    rebin_every: int = 8
    # > 0: rebin a frame when its render reports more than this many pixels
    # of projected drift since binning (cadence stretches to 8x)
    rebin_drift_px: float = 0.0
    # saturation trim: once every frame reported walked-chunk counts, keep
    # only used + trim_slack chunks per tile
    trim_flat: bool = True
    trim_slack: int = 2
    # JAX's switch between its Pallas tile kernels and plain XLA, kept so a
    # JAX config builds; read nowhere: the port composites with K1-K4
    use_pallas: bool | None = None


# ---------------------------------------------------------------------------
# seeding (host numpy, as the reference)
# ---------------------------------------------------------------------------


def _subdivide_by_area(verts: np.ndarray, faces: np.ndarray,
                       colors: np.ndarray, area_thresh: float):
    """Midpoint-subdivide faces until all areas <= area_thresh
    (shared-edge midpoints welded)."""
    verts = verts.astype(np.float64)
    faces = faces.astype(np.int64)
    colors = colors.astype(np.float64)
    for _ in range(24):
        tri = verts[faces]
        areas = 0.5 * np.linalg.norm(
            np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
        split = areas > area_thresh
        if not split.any():
            break
        fs = faces[split]
        edges = np.concatenate(
            [fs[:, [0, 1]], fs[:, [0, 2]], fs[:, [1, 2]]], axis=0)
        edges = np.sort(edges, axis=1)
        uniq, inv = np.unique(edges, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        mid_ids = len(verts) + np.arange(len(uniq))
        mids = verts[uniq].mean(axis=1)
        verts = np.vstack([verts, mids])
        m = len(fs)
        m01 = mid_ids[inv[:m]]
        m02 = mid_ids[inv[m: 2 * m]]
        m12 = mid_ids[inv[2 * m:]]
        f0 = np.stack([fs[:, 0], m01, m02], axis=1)
        f1 = np.stack([fs[:, 1], m12, m01], axis=1)
        f2 = np.stack([fs[:, 2], m02, m12], axis=1)
        fc = np.stack([m01, m12, m02], axis=1)
        faces = np.vstack([faces[~split], f0, f1, f2, fc])
        colors = np.vstack([colors[~split]] + [colors[split]] * 4)
    return verts, faces, colors


def _circumradius(tri: np.ndarray) -> np.ndarray:
    a = np.linalg.norm(tri[:, 1] - tri[:, 2], axis=1)
    b = np.linalg.norm(tri[:, 2] - tri[:, 0], axis=1)
    c = np.linalg.norm(tri[:, 0] - tri[:, 1], axis=1)
    area = 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
    return a * b * c / np.maximum(4 * area, 1e-12)


def _triangle_2d(tri: np.ndarray):
    """Each triangle in its own 2D frame: A=(0,0), B=(|AB|,0), C by the law
    of cosines."""
    a = np.linalg.norm(tri[:, 1] - tri[:, 2], axis=1)  # |BC|
    b = np.linalg.norm(tri[:, 2] - tri[:, 0], axis=1)  # |CA|
    c = np.linalg.norm(tri[:, 0] - tri[:, 1], axis=1)  # |AB|
    ax = np.zeros((len(tri), 2))
    bx = np.stack([c, np.zeros_like(c)], axis=1)
    cx_x = (b ** 2 + c ** 2 - a ** 2) / np.maximum(2 * c, 1e-12)
    cx_y = np.sqrt(np.maximum(b ** 2 - cx_x ** 2, 0.0))
    return ax, bx, np.stack([cx_x, cx_y], axis=1)


def seed_gaussians_from_meshes(
    meshes: Sequence[Mesh],
    area_to_subdivide: float = 2e-5,
    cfg: GoMConfig = GoMConfig(),
    device: str | torch.device = "cpu",
) -> dict:
    """Static per-gaussian face geometry (float32 tensors on `device`) plus
    `instance_ranges` [(lo, hi)] and `num_gaussians`."""
    all_static = {k: [] for k in (
        "tri", "radius", "normals", "axis_x", "axis_y", "tri2d_a", "tri2d_b",
        "tri2d_c", "features_dc",
    )}
    instance_ranges = []
    offset = 0
    for mesh in meshes:
        colors = (
            np.asarray(mesh.vertex_colors[mesh.faces].mean(axis=1)) / 255.0
            if mesh.vertex_colors is not None
            else np.full((len(mesh.faces), 3), 0.5)
        )
        v, f, colors = _subdivide_by_area(
            mesh.vertices, mesh.faces, colors, area_to_subdivide)
        tri = v[f]
        n = len(f)
        normals = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        normals /= np.maximum(
            np.linalg.norm(normals, axis=1, keepdims=True), 1e-12)
        axis_x = tri[:, 1] - tri[:, 0]
        axis_x /= np.maximum(
            np.linalg.norm(axis_x, axis=1, keepdims=True), 1e-12)
        axis_y = np.cross(normals, axis_x)
        axis_y /= np.maximum(
            np.linalg.norm(axis_y, axis=1, keepdims=True), 1e-12)
        a2, b2, c2 = _triangle_2d(tri)

        all_static["tri"].append(tri)
        all_static["radius"].append(np.abs(_circumradius(tri)))
        all_static["normals"].append(normals)
        all_static["axis_x"].append(axis_x)
        all_static["axis_y"].append(axis_y)
        all_static["tri2d_a"].append(a2)
        all_static["tri2d_b"].append(b2)
        all_static["tri2d_c"].append(c2)
        all_static["features_dc"].append(colors)
        instance_ranges.append((offset, offset + n))
        offset += n

    dev = torch.device(device)
    static = {k: as_tensor(np.concatenate(v).astype(np.float32), dev)
              for k, v in all_static.items()}
    # face-frame quaternion (columns = x, y, n: local->world)
    rot = torch.stack(
        [static["axis_x"], static["axis_y"], static["normals"]], dim=2)
    static["faces_quats"] = rotmat_to_quat(rot)
    xyz_radius = static["radius"][:, None].repeat(1, 3)
    xyz_radius[:, 2] *= cfg.face_flat_coef
    static["xyz_radius"] = xyz_radius
    static["instance_ranges"] = instance_ranges
    static["num_gaussians"] = offset
    return static


def init_gom_params(static: dict, cfg: GoMConfig = GoMConfig()) -> dict:
    """Trainable leaf tensors (requires_grad) on the static's device."""
    n = static["num_gaussians"]
    dev = static["tri"].device
    centroid_2d = (static["tri2d_a"] + static["tri2d_b"]
                   + static["tri2d_c"]) / 3.0

    if cfg.unconstrained_scale:
        from scipy.spatial import cKDTree

        centers = static["tri"].mean(dim=1).cpu().numpy()
        d, _ = cKDTree(centers).query(centers, k=min(4, len(centers)))
        avg = d[:, 1:].mean(axis=1, keepdims=True) if d.shape[1] > 1 else d
        scales = torch.log(as_tensor(np.repeat(avg, 3, axis=1) + 1e-10, dev))
    else:
        scales = torch.zeros(n, 3, device=dev)

    dim_sh = num_sh_bases(cfg.sh_degree)
    logit_01 = float(np.log(0.1 / 0.9))
    params = {
        "means_2d": centroid_2d,
        "normal_elevates": torch.zeros(n, device=dev),
        "scales": scales,
        "quats": torch.zeros(n, 3, device=dev),
        "features_dc": rgb_to_sh(static["features_dc"]),
        "features_rest": torch.zeros(n, dim_sh - 1, 3, device=dev),
        "opacities": torch.full((n, 1), logit_01, device=dev),
    }
    return {k: v.detach().clone().requires_grad_(True)
            for k, v in params.items()}


# ---------------------------------------------------------------------------
# constraint reparameterisations
# ---------------------------------------------------------------------------


def _straight_through(raw, clamped):
    return raw + (clamped - raw).detach()


def _bary_2d(p, a, b, c):
    v0 = b - a
    v1 = c - a
    v2 = p - a
    d00 = torch.sum(v0 * v0, -1)
    d01 = torch.sum(v0 * v1, -1)
    d11 = torch.sum(v1 * v1, -1)
    d20 = torch.sum(v2 * v0, -1)
    d21 = torch.sum(v2 * v1, -1)
    denom = torch.clamp(d00 * d11 - d01 * d01, min=1e-12)
    v = (d11 * d20 - d01 * d21) / denom
    w = (d00 * d21 - d01 * d20) / denom
    return torch.stack([1 - v - w, v, w], dim=-1)


def gom_means(params, static, cfg: GoMConfig) -> torch.Tensor:
    """Triangle-clamped face-frame position + bounded normal elevation."""
    m2 = params["means_2d"]
    a, b, c = static["tri2d_a"], static["tri2d_b"], static["tri2d_c"]
    bary = torch.clamp(_bary_2d(m2, a, b, c), 0.0, 1.0)
    bary = bary / torch.sum(bary, dim=-1, keepdim=True)
    clamped = bary[:, 0:1] * a + bary[:, 1:2] * b + bary[:, 2:3] * c
    m2 = _straight_through(m2, clamped)

    means = (m2[:, 0:1] * static["axis_x"] + m2[:, 1:2] * static["axis_y"]
             + static["tri"][:, 0])
    radius = static["radius"][:, None]
    if cfg.unconstrained_elevate:
        elev = params["normal_elevates"][:, None]
        bound = radius * cfg.elevate_coef
        elev = _straight_through(elev, torch.clamp(elev, -bound, bound))
    else:
        elev = (torch.sigmoid(params["normal_elevates"])[:, None] - 0.5) \
            * radius
    return means + static["normals"] * elev


def gom_scales(params, static, cfg: GoMConfig) -> torch.Tensor:
    """LINEAR scales capped at upper_scale * per-face radius."""
    if cfg.unconstrained_scale:
        real = torch.exp(params["scales"])
        limit = cfg.upper_scale * static["xyz_radius"]
        return _straight_through(real, torch.minimum(real, limit)) + 1e-20
    return (torch.sigmoid(params["scales"]) * static["xyz_radius"]
            * cfg.upper_scale + 1e-20)


def gom_quats(params, static, cfg: GoMConfig) -> torch.Tensor:
    """face frame x cone-limited tilt x in-plane spin."""
    theta = params["quats"][:, 0:1]
    zero = torch.zeros_like(theta)
    spin = axis_angle_to_quat(torch.cat([zero, zero, theta], -1))
    alpha = params["quats"][:, 1]
    phi = params["quats"][:, 2]
    phi = _straight_through(phi, torch.clamp(phi, 0.0, cfg.cone_coef))
    axis = torch.stack(
        [torch.cos(alpha), torch.sin(alpha), torch.zeros_like(alpha)], -1)
    tilt = axis_angle_to_quat(axis * phi[:, None])
    return quat_multiply(static["faces_quats"], quat_multiply(tilt, spin))


def gom_opacities(params, visible_mask=None) -> torch.Tensor:
    """Sigmoid opacity; gaussians outside `visible_mask` [N] bool are pinned
    to sigmoid(logit(1e-6)) ~ 0 and receive no gradient."""
    logits = params["opacities"][:, 0]
    if visible_mask is not None:
        off = float(np.log(1e-6 / (1.0 - 1e-6)))
        logits = torch.where(visible_mask, logits,
                             torch.full_like(logits, off))
    return torch.sigmoid(logits)


def render_gom(
    params, static, cfg: GoMConfig, pose_c2w, intrinsics,
    width: int, height: int, background: torch.Tensor,
    visible_mask=None, ortho: bool = False,
    flat_plan=None, flat_bins: dict | None = None, chw: bool = False,
):
    """Full GoM render: dict(rgb, depth, accumulation) plus the compositor's
    telemetry. chw=True renders rgb as [3,H,W]; visible_mask [N] bool hides
    every other gaussian; ortho=True renders an orthographic view
    (intrinsics hold pixels per world unit). Without a flat_plan the render
    goes through the top-K compositor at cfg.max_per_tile."""
    dev = static["tri"].device
    means = gom_means(params, static, cfg)
    colors = torch.cat(
        [params["features_dc"][:, None, :], params["features_rest"]], dim=1)
    out = render_gaussians(
        means, gom_quats(params, static, cfg), gom_scales(params, static, cfg),
        gom_opacities(params, visible_mask), colors,
        view_matrix(pose_c2w, dev), as_tensor(intrinsics, dev),
        width, height, tile_size=cfg.tile_size,
        max_per_tile=cfg.max_per_tile, sh_degree=cfg.sh_degree,
        background=background, ortho=ortho, flat_plan=flat_plan,
        flat_bins=flat_bins, chw=chw,
    )
    res = {"rgb": torch.clamp(out["rgb"], 0.0, 1.0), "depth": out["depth"],
           "accumulation": out["alpha"]}
    # the walk telemetry MUST survive this layer: the trainer's saturation
    # trim feeds on used_chunks and re-plans on stale/overflow (a dropped
    # used_chunks once capped every tile at trim_slack chunks in the
    # reference — silently truncated renders, diverging training)
    for k in ("overflow", "stale", "used_chunks", "xy_drift"):
        if k in out:
            res[k] = out[k]
    return res


def gom_project(params, static, cfg: GoMConfig, pose_c2w, intrinsics,
                width: int, height: int):
    """Projected splat geometry (xy, depth, conic, valid) for binning."""
    dev = static["tri"].device
    xy, depth, conic, _radius, valid = project_gaussians_fused(
        gom_means(params, static, cfg), gom_quats(params, static, cfg),
        gom_scales(params, static, cfg), view_matrix(pose_c2w, dev),
        as_tensor(intrinsics, dev), width, height)
    return xy, depth, conic, valid


@torch.no_grad()
def gom_flat_bins(params, static, cfg: GoMConfig, pose_c2w, intrinsics,
                  width: int, height: int, plan, used_chunks=None):
    """build_flat_bins over the current GoM state for one camera."""
    xy, depth, conic, valid = gom_project(
        params, static, cfg, pose_c2w, intrinsics, width, height)
    return build_flat_bins(
        xy, depth, conic, gom_opacities(params), valid,
        tiles_x=-(-width // cfg.tile_size),
        tiles_y=-(-height // cfg.tile_size), tile_size=cfg.tile_size,
        plan=plan, used_chunks=used_chunks, trim_slack=cfg.trim_slack)


def gom_loss(outputs, batch, cfg: GoMConfig, with_scale_reg: bool = False,
             scales_linear=None, chw: bool = False):
    """Stage-4 loss: (1-l) L1 + l (1-SSIM) + acm_lambda |alpha - mesh mask|
    + mesh_depth_lambda |depth - mesh depth| (+ scale regularizer).
    batch: image [H,W,3] ([3,H,W] with chw), acm [H,W], optional
    mesh_depth [H,W] and mask [H,W]."""
    gt = batch["image"]
    pred = outputs["rgb"]
    loss_acm = torch.mean(torch.abs(outputs["accumulation"] - batch["acm"])) \
        * cfg.acm_lambda
    if batch.get("mask") is not None:
        m = batch["mask"][None] if chw else batch["mask"][..., None]
        gt = gt * m
        pred = pred * m
    if batch.get("mesh_depth") is not None:
        l1_depth = torch.mean(torch.abs(batch["mesh_depth"]
                                        - outputs["depth"])) \
            * cfg.mesh_depth_lambda
    else:
        l1_depth = pred.new_zeros(())
    l1 = torch.mean(torch.abs(gt - pred))
    simloss = 1.0 - (ssim_chw(gt, pred) if chw else ssim_fn(gt, pred))

    scale_reg = pred.new_zeros(())
    if with_scale_reg and scales_linear is not None:
        s = scales_linear[:, :2]
        ratio = s.amax(dim=-1) / torch.clamp(s.amin(dim=-1), min=1e-12)
        scale_reg = 0.1 * torch.mean(
            torch.clamp(ratio, min=cfg.max_gauss_ratio) - cfg.max_gauss_ratio)

    main = (((1 - cfg.ssim_lambda) * l1 + cfg.ssim_lambda * simloss)
            * cfg.rgb_lambda + loss_acm + l1_depth)
    return {
        "main_loss": main,
        "scale_reg": scale_reg,
        "l1": l1,
        "ssim_loss": simloss,
        "acm_loss": loss_acm,
        "depth_loss": l1_depth,
        "loss": main + scale_reg,
    }


# ---------------------------------------------------------------------------
# export (3DGS-compatible arrays)
# ---------------------------------------------------------------------------


@torch.no_grad()
def compose_for_export(params, static, cfg: GoMConfig, select=None) -> dict:
    """World-space gaussian dict (numpy) for PLY export."""
    scales = gom_scales(params, static, cfg).cpu().numpy()
    out = {
        "means": gom_means(params, static, cfg).cpu().numpy(),
        "quats": gom_quats(params, static, cfg).cpu().numpy(),
        "log_scales": np.log(np.maximum(scales, 1e-20)),
        "opacity_logits": params["opacities"][:, 0].cpu().numpy(),
        "features_dc": params["features_dc"].cpu().numpy(),
        "features_rest": params["features_rest"].cpu().numpy(),
    }
    if select is not None:
        out = {k: v[select] for k, v in out.items()}
    return out


def write_gaussian_ply(path: str, g: dict) -> None:
    """3DGS-convention binary PLY (x,y,z,nx,ny,nz,f_dc_*,f_rest_*,opacity,
    scale_*,rot_*)."""
    n = len(g["means"])
    rest = g["features_rest"].transpose(0, 2, 1).reshape(n, -1)
    fields = [("x", g["means"][:, 0]), ("y", g["means"][:, 1]),
              ("z", g["means"][:, 2])]
    fields += [(f"n{ax}", np.zeros(n)) for ax in "xyz"]
    for i in range(3):
        fields.append((f"f_dc_{i}", g["features_dc"][:, i]))
    for i in range(rest.shape[1]):
        fields.append((f"f_rest_{i}", rest[:, i]))
    fields.append(("opacity", g["opacity_logits"]))
    for i in range(3):
        fields.append((f"scale_{i}", g["log_scales"][:, i]))
    for i in range(4):
        fields.append((f"rot_{i}", g["quats"][:, i]))

    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {name}" for name, _ in fields]
    header += ["end_header"]
    rec = np.empty(n, dtype=[(name, "<f4") for name, _ in fields])
    for name, val in fields:
        rec[name] = val.astype(np.float32)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        f.write(rec.tobytes())


def read_gaussian_ply(path: str) -> dict:
    """Inverse of write_gaussian_ply."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.find(b"end_header\n") + len(b"end_header\n")
    names = []
    n = 0
    for line in data[:end].decode().splitlines():
        parts = line.split()
        if parts[0] == "element":
            n = int(parts[2])
        elif parts[0] == "property":
            names.append(parts[2])
    rec = np.frombuffer(data[end:], dtype=[(nm, "<f4") for nm in names],
                        count=n)
    n_rest = sum(1 for nm in names if nm.startswith("f_rest_"))
    rest = (np.stack([rec[f"f_rest_{i}"] for i in range(n_rest)], axis=-1)
            .reshape(n, 3, n_rest // 3).transpose(0, 2, 1)
            if n_rest else np.zeros((n, 0, 3)))
    return {
        "means": np.stack([rec["x"], rec["y"], rec["z"]], axis=-1),
        "features_dc": np.stack([rec[f"f_dc_{i}"] for i in range(3)], -1),
        "features_rest": rest,
        "opacity_logits": np.asarray(rec["opacity"]),
        "log_scales": np.stack([rec[f"scale_{i}"] for i in range(3)], -1),
        "quats": np.stack([rec[f"rot_{i}"] for i in range(4)], -1),
    }
