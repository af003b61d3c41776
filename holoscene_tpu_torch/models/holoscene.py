"""HoloScene Stage-1 renderer: object-compositional neural-SDF volume
rendering (port of holoscene_tpu/models/holoscene.py: HoloSceneConfig,
init_holoscene, get_beta, scene_sdf_nograd, make_probe_bake, render_rays,
render_bg_patch, the object-subset renders and query_point_colors).

render_rays keeps the shipped fast path of the JAX package: sample
placement from the error-bound sampler (probe grid or H2 probes), top-M
pruning by the sampler's estimated weights, tiered fine levels (the F
highest-weight samples of a ray get every hash level, the tail the coarse
prefix), the fused encode-with-jacobian (H1, packed or raw fetch), and
the eikonal block from one single-table H1 call. The vjp gradient mode
(the JAX default) renders untiered through `implicit_get_outputs` (H1,
exact backward), the jvp mode through `implicit_get_outputs_jvp` (three
tangents from H1's J); the fused mode on a network the fused encode does
not take (no colour grid, no grid features, tetrahedral) falls back to the
vjp mode, as JAX's does. Every random
number is an argument (`RenderDraws`). Stage 2 renders objects in isolation
with render_rays_only_multi_obj (H2 sampler over the subset's SDF, H1
exact); render_rays_multi_obj renders a subset inside the scene. With
the occupancy grid (use_occupancy) each ray's sampling interval is
restricted to its occupied span on the steps that do not update the grid,
and the update steps fold the sampler's probe buffer back into it."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from holoscene_tpu_torch.models.fields import (
    ImplicitNetwork,
    ImplicitNetworkConfig,
    RenderingNetwork,
    RenderingNetworkConfig,
    implicit_all_gradients,
    implicit_get_outputs,
    implicit_get_outputs_fused,
    implicit_get_outputs_jvp,
    implicit_sdf_raw_sampler,
)
from holoscene_tpu_torch.ops.density import laplace_beta, laplace_density
from holoscene_tpu_torch.ops.hashgrid import level_tables
from holoscene_tpu_torch.ops.occupancy import (
    OccGridConfig,
    ray_range,
    update_occ_grid,
)
from holoscene_tpu_torch.ops.probe_grid import bake_probe_grid, probe_sdf_fn
from holoscene_tpu_torch.ops.sampler import (
    SamplerConfig,
    SamplerDraws,
    _near_far,
    error_bound_sample,
    estimate_weights_from_buffer,
)
from holoscene_tpu_torch.ops.volrend import (
    composite,
    composite_depth,
    occlusion_opacity,
    volume_render_weights,
)

GRAD_MODES = ("vjp", "jvp", "fused")
BG_PATCH = 32     # the background patch's side in pixels (JAX make_train_step)


@dataclasses.dataclass(frozen=True)
class HoloSceneConfig:
    implicit: ImplicitNetworkConfig
    rendering: RenderingNetworkConfig
    sampler: SamplerConfig
    scene_bounding_sphere: float = 1.0
    white_bkgd: bool = False
    bg_color: tuple[float, float, float] = (1.0, 1.0, 1.0)
    use_bg_reg: bool = True
    render_bg_iter: int = 10
    beta_init: float = 0.1
    beta_min: float = 1e-4
    sampler_grid_levels: int | None = None
    forward_grad_mode: str = "vjp"
    render_top_m: int = 0
    render_fine_top_f: int = 0
    render_fine_levels: int = 8
    use_occupancy: bool = False
    probe_grid_res: int = 0
    probe_update_every: int = 16
    occupancy: OccGridConfig = dataclasses.field(default_factory=OccGridConfig)

    def __post_init__(self):
        if self.forward_grad_mode not in GRAD_MODES:
            raise ValueError(f"forward_grad_mode must be one of "
                             f"{GRAD_MODES}, got {self.forward_grad_mode!r}")
        if not (self.render_top_m == 0 or self.render_top_m >= 2):
            raise ValueError(f"render_top_m must be 0 or >= 2, got "
                             f"{self.render_top_m}")
        if self.render_fine_top_f:
            if self.render_top_m == 0:
                raise ValueError("render_fine_top_f requires render_top_m")
            if not 2 <= self.render_fine_top_f < self.render_top_m:
                raise ValueError("render_fine_top_f must be in [2, "
                                 "render_top_m)")
            if not 1 <= self.render_fine_levels < self.implicit.num_levels:
                raise ValueError("render_fine_levels must be in [1, "
                                 "num_levels)")
            if self.forward_grad_mode != "fused":
                raise ValueError("render_fine_top_f requires "
                                 "forward_grad_mode='fused'")
            if not self.implicit.fused_ok:
                raise ValueError(
                    "render_fine_top_f requires the fused-encode-eligible "
                    "implicit config (color_grid_feature, use_grid_feature, "
                    "trilinear interp)")

    @property
    def num_semantic(self) -> int:
        return self.implicit.d_out

    @classmethod
    def from_conf(cls, conf) -> "HoloSceneConfig":
        """From the `model` section of a .conf file."""
        fvs = conf.get_int("feature_vector_size", 256)
        sbs = conf.get_float("scene_bounding_sphere", 1.0)
        return cls(
            implicit=ImplicitNetworkConfig.from_conf(
                conf.get_config("implicit_network"), fvs),
            rendering=RenderingNetworkConfig.from_conf(
                conf.get_config("rendering_network"), fvs),
            sampler=SamplerConfig.from_conf(conf.get_config("ray_sampler"),
                                            sbs),
            scene_bounding_sphere=sbs,
            white_bkgd=conf.get_bool("white_bkgd", False),
            bg_color=tuple(conf.get_list("bg_color", [1.0, 1.0, 1.0])),
            use_bg_reg=conf.get_bool("use_bg_reg", False),
            render_bg_iter=conf.get_int("render_bg_iter", 10),
            beta_init=conf.get_float("density.params_init.beta", 0.1),
            beta_min=conf.get_float("density.beta_min", 1e-4),
            sampler_grid_levels=(conf.get_int("sampler_grid_levels")
                                 if "sampler_grid_levels" in conf else None),
            render_top_m=conf.get_int("render_top_m", 0),
            render_fine_top_f=conf.get_int("render_fine_top_f", 0),
            render_fine_levels=conf.get_int("render_fine_levels", 8),
            forward_grad_mode=conf.get_string("forward_grad_mode", "vjp"),
            use_occupancy=conf.get_bool("use_occupancy", False),
            probe_grid_res=conf.get_int("probe_grid_res", 0),
            probe_update_every=conf.get_int("probe_update_every", 16),
            occupancy=OccGridConfig(
                resolution=conf.get_int("occupancy_resolution", 64),
                bound=sbs, taps=conf.get_int("occupancy_taps", 64)),
        )


class HoloSceneModel(nn.Module):
    """implicit + rendering networks and the Laplace density's beta; the
    state_dict keys are the JAX params' paths joined with dots."""

    def __init__(self, cfg: HoloSceneConfig, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.implicit = ImplicitNetwork(cfg.implicit, seed)
        self.rendering = RenderingNetwork(cfg.rendering, seed + 1)
        self.density = nn.ParameterDict({"beta": nn.Parameter(
            torch.tensor(cfg.beta_init, dtype=torch.float32))})


def init_holoscene(cfg: HoloSceneConfig, seed: int = 0,
                   device="cpu") -> HoloSceneModel:
    return HoloSceneModel(cfg, seed).to(device)


def get_beta(model: HoloSceneModel) -> torch.Tensor:
    return laplace_beta(model.density["beta"], model.cfg.beta_min)


def fused_path(cfg: HoloSceneConfig) -> bool:
    """The render runs the fused encode: the fused gradient mode on a
    network it takes (JAX holoscene.py:380); the fused mode on any other
    network renders in the vjp mode, as JAX's does."""
    return cfg.forward_grad_mode == "fused" and cfg.implicit.fused_ok


def fused_mode(cfg: HoloSceneConfig, training: bool) -> str:
    """H1-bwd's mode of the render calls: the sampled backward in training
    when the config asks for it on the fused path with the packed fetch,
    else exact (the vjp and jvp modes and the raw fetch have no sampled
    backward, JAX fields.py:532)."""
    ic = cfg.implicit
    if not (training and ic.color_bwd_sample and fused_path(cfg)
            and ic.fused_fetch == "packed"):
        return "exact"
    return "sampled_all" if ic.sdf_bwd_sample else "sampled"


def fused_calls(cfg: HoloSceneConfig, n_rays: int):
    """(points, levels) of each render-pass H1 call of a training step:
    the fine tier and the tail, or one call untiered."""
    S = cfg.render_top_m or cfg.sampler.n_final
    if cfg.render_fine_top_f:
        F = cfg.render_fine_top_f
        return [(n_rays * F, None), (n_rays * (S - F), cfg.render_fine_levels)]
    return [(n_rays * S, None)]


@dataclasses.dataclass
class RenderDraws:
    """The random numbers of one training render_rays: the sampler's,
    the eikonal uniforms in [-sbs, sbs) [R, 3], the neighbour jitter
    uniforms in [0, 1) [2R, 3], and for each render H1 call (fused_calls
    order) its backward's (u_b [3, Lh, N], u_a [Lh, N]) or None."""

    sampler: SamplerDraws
    eik_uniform: torch.Tensor
    nei: torch.Tensor
    fused: list

    @classmethod
    def make(cls, cfg: HoloSceneConfig, n_rays: int, gen: torch.Generator,
             device) -> "RenderDraws":
        kw = dict(generator=gen, device=device)
        sbs = cfg.scene_bounding_sphere
        sampler = SamplerDraws.make(cfg.sampler, n_rays, gen, device)
        eik = torch.rand(n_rays, 3, **kw) * (2.0 * sbs) - sbs
        nei = torch.rand(2 * n_rays, 3, **kw)
        fused = []
        mode = fused_mode(cfg, True)
        for n, levels in fused_calls(cfg, n_rays):
            lh = level_tables(cfg.implicit.grid_meta, levels).n_hashed
            if mode == "exact":
                fused.append(None)
            else:
                fused.append((torch.rand(3, lh, n, **kw),
                              torch.rand(lh, n, **kw)
                              if mode == "sampled_all" else None))
        return cls(sampler, eik, nei, fused)

    def rows(self, sl: slice, n_rays: int) -> "RenderDraws":
        """The draws of rays sl of an n_rays batch: each per-ray draw's
        rows; nei's two halves (the uniform and the near eikonal points);
        the fused backward's uniforms of those rays' points (each call
        holds a fixed number of points a ray, ray-major)."""

        def cut(u):
            if u is None:
                return None
            k = u.shape[-1] // n_rays
            return u[..., sl.start * k:sl.stop * k].contiguous()

        nei = torch.cat([self.nei[sl],
                         self.nei[n_rays + sl.start:n_rays + sl.stop]])
        fused = [None if f is None else (cut(f[0]), cut(f[1]))
                 for f in self.fused]
        return RenderDraws(self.sampler.rows(sl), self.eik_uniform[sl], nei,
                           fused)


def scene_sdf_nograd(model: HoloSceneModel, cfg: HoloSceneConfig,
                     obj_idxs=None):
    """The sampler's scene SDF: coarse-level probes through H2, no
    gradient; obj_idxs takes the min over those objects only (the
    background patch samples with (0,))."""

    def fn(pts):
        raw = implicit_sdf_raw_sampler(model.implicit, pts,
                                       cfg.sampler_grid_levels)
        if obj_idxs is not None:
            raw = raw[:, list(obj_idxs)]
        return torch.amin(raw, -1)

    return fn


def make_probe_bake(cfg: HoloSceneConfig):
    """bake(model) -> the probe-grid block table [res^3, 8] from the
    current parameters (the sampler's coarse SDF on the corner lattice)."""
    if cfg.probe_grid_res <= 0:
        raise ValueError("probe_grid_res must be set")

    def bake(model: HoloSceneModel) -> torch.Tensor:
        return bake_probe_grid(scene_sdf_nograd(model, cfg), cfg.probe_grid_res,
                               cfg.sampler.scene_bounding_sphere,
                               device=model.density["beta"].device)

    return bake


def _normalize(v):
    return v / torch.sqrt((v * v).sum(-1, keepdim=True) + 1e-12)


def render_rays(model: HoloSceneModel, rays_o, rays_d, depth_scale, w2c_rot,
                draws: RenderDraws | None = None, training: bool = True,
                compute_eikonal: bool = True, probe=None, occ=None,
                update_occ: bool = False, occ_reduce=None) -> dict:
    """Render R rays (rays_o / rays_d [R, 3], depth_scale [R, 1], w2c_rot
    [3, 3]). training=True needs `draws`. probe: a baked probe-grid table
    for the sampler's placement (render and gradients stay exact).

    occ: the occupancy grid (ops/occupancy.py). Without update_occ each
    ray's sampling interval is restricted to its occupied span; with it
    the ray samples its full interval (restricted-only training starves
    the excluded regions of supervision) and the sampler's probe buffer
    refreshes the grid, combined over ranks by occ_reduce (an all-reduce
    MIN) when given. out["occ"] is the grid after the step."""
    cfg = model.cfg
    R = rays_o.shape[0]
    beta_sg = get_beta(model).detach()
    near = far = None
    if occ is not None and not update_occ:
        near0, far0 = _near_far(rays_o, rays_d, cfg.sampler, None, None)
        near, far = ray_range(occ, rays_o, rays_d, near0, far0, beta_sg,
                              cfg.occupancy)
    if probe is not None:
        sampler_sdf = probe_sdf_fn(probe.detach(), cfg.probe_grid_res,
                                   cfg.sampler.scene_bounding_sphere)
    else:
        sampler_sdf = scene_sdf_nograd(model, cfg)
    sdraws = draws.sampler if training else None

    prune_m = cfg.render_top_m if training else 0
    tier_ord = None
    if prune_m > 0 or (occ is not None and update_occ):
        z_vals, z_eik, (z_buf, sdf_buf, beta_buf) = error_bound_sample(
            rays_o, rays_d, sampler_sdf, beta_sg, cfg.sampler, sdraws,
            training=training, return_aux=True, near=near, far=far)
        if 0 < prune_m < z_vals.shape[-1]:
            est_w = estimate_weights_from_buffer(z_vals, z_buf, sdf_buf,
                                                 beta_buf)
            score = est_w.clone()
            score[:, 0] = float("inf")
            score[:, -1] = float("inf")
            # lax.top_k's order: highest first, the lower index among ties
            keep = torch.sort(score, dim=-1, descending=True,
                              stable=True).indices[:, :prune_m]
            keep = torch.sort(keep, -1).values
            z_vals = torch.gather(z_vals, -1, keep)
            if cfg.render_fine_top_f:
                kept_w = torch.gather(score, -1, keep)
                tier_ord = torch.argsort(-kept_w, dim=-1, stable=True)
    else:
        z_vals, z_eik = error_bound_sample(
            rays_o, rays_d, sampler_sdf, beta_sg, cfg.sampler, sdraws,
            training=training, near=near, far=far)
    S = z_vals.shape[-1]

    points = rays_o[:, None, :] + z_vals[..., None] * rays_d[:, None, :]
    points_flat = points.reshape(-1, 3)
    dirs_flat = rays_d[:, None, :].expand(R, S, 3).reshape(-1, 3)

    mode = fused_mode(cfg, training)
    fused = draws.fused if training else [None, None]

    def outputs(pts, u, coarse_levels=None):
        if cfg.forward_grad_mode == "jvp":
            return implicit_get_outputs_jvp(model.implicit, pts)
        if not fused_path(cfg):
            return implicit_get_outputs(model.implicit, pts,
                                        create_graph=training)
        u_b, u_a = u if u is not None else (None, None)
        return implicit_get_outputs_fused(
            model.implicit, pts, mode, u_b, u_a, coarse_levels,
            create_graph=training)

    if tier_ord is not None:
        F = cfg.render_fine_top_f
        inv_ord = torch.argsort(tier_ord, -1)
        pts_perm = torch.gather(points, 1, tier_ord[..., None].expand(R, S, 3))
        o_fine = outputs(pts_perm[:, :F].reshape(-1, 3), fused[0])
        o_tail = outputs(pts_perm[:, F:].reshape(-1, 3), fused[1],
                         cfg.render_fine_levels)

        def reassemble(a, b):
            m = torch.cat([a.reshape((R, F) + a.shape[1:]),
                           b.reshape((R, S - F) + b.shape[1:])], 1)
            idx = inv_ord.reshape((R, S) + (1,) * (m.ndim - 2)).expand(m.shape)
            return torch.gather(m, 1, idx).reshape((R * S,) + a.shape[1:])

        sdf, feature_vectors, gradients, semantic, sdf_raw = (
            reassemble(a, b) for a, b in zip(o_fine, o_tail))
    else:
        sdf, feature_vectors, gradients, semantic, sdf_raw = outputs(
            points_flat, fused[0])
    rgb_flat = model.rendering(points_flat, gradients, dirs_flat,
                               feature_vectors)

    beta = get_beta(model)
    density = laplace_density(sdf.reshape(R, S), beta)
    weights, transmittance, dists = volume_render_weights(z_vals, density)
    obj_density = laplace_density(sdf_raw.reshape(R, S, -1), beta)
    object_opacity = occlusion_opacity(transmittance, dists, obj_density)

    rgb_values = composite(weights, rgb_flat.reshape(R, S, 3))
    semantic_values = composite(weights,
                                semantic.reshape(R, S, cfg.num_semantic))
    depth_values = depth_scale * composite_depth(weights, z_vals)
    if cfg.white_bkgd:
        acc = weights.sum(-1, keepdim=True)
        rgb_values = rgb_values + (1.0 - acc) * torch.tensor(
            cfg.bg_color, device=acc.device)
    normal_map = composite(weights, _normalize(gradients).reshape(R, S, 3))
    normal_map = normal_map @ w2c_rot.T

    out = {
        "rgb_values": rgb_values,
        "semantic_values": semantic_values,
        "object_opacity": object_opacity,
        "depth_values": depth_values,
        "normal_map": normal_map,
        "z_vals": z_vals,
        "sdf": sdf.reshape(R, S),
        "weights": weights,
    }
    if occ is not None:
        out["occ"] = occ
        if update_occ:
            probe_pts = rays_o[:, None, :] + z_buf[..., None] * rays_d[:, None, :]
            out["occ"] = update_occ_grid(occ, probe_pts, sdf_buf,
                                         cfg.occupancy, occ_reduce)
    if training and compute_eikonal:
        eik_pts = torch.cat([draws.eik_uniform, rays_o + z_eik * rays_d])
        nei_pts = eik_pts + (draws.nei - 0.5) * 0.01
        grads_both, raw_both = implicit_all_gradients(
            model.implicit, torch.cat([eik_pts, nei_pts]))
        M = eik_pts.shape[0]
        out["grad_theta"] = grads_both[:M]
        out["grad_theta_nei"] = grads_both[M:]
        out["sample_sdf"] = raw_both[:M]
        out["sample_minsdf"] = torch.amin(raw_both[:M], -1)
    return out


def render_bg_patch(model: HoloSceneModel, rays_o, rays_d, depth_scale,
                    w2c_rot, draws: SamplerDraws | None = None,
                    training: bool = True) -> dict:
    """The background (object 0) render of a pixel patch for the
    smoothness regulariser (JAX render_bg_patch): error-bound sampling
    against the background SDF alone (H2 probes, no probe grid), the vjp
    field on the samples, background and scene weights from the Laplace
    density. Returns bg_depth_values [R, 1] (scaled by depth_scale),
    bg_normal_map [R, 3] (rotated by w2c_rot) and bg_mask [R, 1], the
    argmax of the scene-composited semantics. training=True needs the
    sampler's `draws`."""
    cfg = model.cfg
    R = rays_o.shape[0]
    z_vals, _ = error_bound_sample(
        rays_o, rays_d, scene_sdf_nograd(model, cfg, obj_idxs=(0,)),
        get_beta(model).detach(), cfg.sampler, draws, training=training)
    S = z_vals.shape[-1]
    points_flat = (rays_o[:, None, :] + z_vals[..., None]
                   * rays_d[:, None, :]).reshape(-1, 3)
    sdf_all, _, gradients, semantic, sdf_raw = implicit_get_outputs(
        model.implicit, points_flat, create_graph=training)
    beta = get_beta(model)
    bg_weights, _, _ = volume_render_weights(
        z_vals, laplace_density(sdf_raw[:, 0].reshape(R, S), beta))
    scene_weights, _, _ = volume_render_weights(
        z_vals, laplace_density(sdf_all.reshape(R, S), beta))
    bg_semantic = composite(scene_weights,
                            semantic.reshape(R, S, cfg.num_semantic))
    normals = _normalize(gradients).reshape(R, S, 3)
    return {
        "bg_depth_values": depth_scale * composite_depth(bg_weights, z_vals),
        "bg_normal_map": composite(bg_weights, normals) @ w2c_rot.T,
        "bg_mask": torch.argmax(bg_semantic, -1, keepdim=True),
    }


def _subset_samples(model: HoloSceneModel, rays_o, rays_d, obj_idxs, draws,
                    training: bool, near=None, far=None):
    """The object-subset renders' samples: error-bound sampling of the
    subset's min-SDF (H2 probes), then the field through
    implicit_get_outputs (H1, exact backward) and the rendering MLP at
    them. Returns (z_vals [R, S], implicit_get_outputs' five outputs,
    rgb [R*S, 3])."""
    cfg = model.cfg
    R = rays_o.shape[0]
    z_vals, _ = error_bound_sample(
        rays_o, rays_d, scene_sdf_nograd(model, cfg, obj_idxs=obj_idxs),
        get_beta(model).detach(), cfg.sampler, draws, training=training,
        near=near, far=far)
    S = z_vals.shape[-1]
    points_flat = (rays_o[:, None, :] + z_vals[..., None]
                   * rays_d[:, None, :]).reshape(-1, 3)
    dirs_flat = rays_d[:, None, :].expand(R, S, 3).reshape(-1, 3)
    outs = implicit_get_outputs(model.implicit, points_flat,
                                create_graph=training)
    rgb_flat = model.rendering(points_flat, outs[2], dirs_flat, outs[1])
    return z_vals, outs, rgb_flat


def render_rays_only_multi_obj(model: HoloSceneModel, rays_o, rays_d,
                               depth_scale, w2c_rot, obj_idxs,
                               draws: SamplerDraws | None = None,
                               training: bool = False,
                               detach_rgb_geometry: bool = False) -> dict:
    """Render ONLY the objects obj_idxs, as if nothing else existed (JAX
    render_rays_only_multi_obj; reference forward_only_multi_obj_rays and
    its _detach_rgb_for_geometry variants), for Stage 2's orthographic
    object views and its invisible-view loss: error-bound sampling of the
    subset's min-SDF (H2), the field through implicit_get_outputs (H1,
    exact backward), weights from the subset's min-SDF. training=True needs
    the sampler's `draws`. detach_rgb_geometry stops the gradient of the
    weights into the colour composite only (depth, normals and acc keep
    it). Returns rgb_values, depth_values, normal_map (rotated by w2c_rot),
    acc, weights, z_vals and the subset SDF."""
    R = rays_o.shape[0]
    z_vals, (_, _, gradients, _, sdf_raw), rgb_flat = _subset_samples(
        model, rays_o, rays_d, obj_idxs, draws, training)
    S = z_vals.shape[-1]
    subset_sdf = torch.amin(sdf_raw[:, list(obj_idxs)], -1).reshape(R, S)
    weights, _, _ = volume_render_weights(
        z_vals, laplace_density(subset_sdf, get_beta(model)))
    w_rgb = weights.detach() if detach_rgb_geometry else weights
    normals = _normalize(gradients).reshape(R, S, 3)
    return {
        "rgb_values": composite(w_rgb, rgb_flat.reshape(R, S, 3)),
        "depth_values": depth_scale * composite_depth(weights, z_vals),
        "normal_map": composite(weights, normals) @ w2c_rot.T,
        "acc": weights.sum(-1),
        "weights": weights,
        "z_vals": z_vals,
        "sdf": subset_sdf,
    }


def render_rays_multi_obj(model: HoloSceneModel, rays_o, rays_d, depth_scale,
                          w2c_rot, obj_idxs, draws: SamplerDraws | None = None,
                          training: bool = False, near=None, far=None) -> dict:
    """Object-subset render inside the scene (JAX render_rays_multi_obj;
    reference forward_multi_obj_rays / _subset_all_sdf,
    model/network.py:1092-1235): sampling and the semantic weights use the
    subset's min-SDF, while rgb, depth and normals composite under the
    whole scene's weights (`bg_weights`), so other objects still occlude;
    object_opacity comes from every object's density. The field through
    implicit_get_outputs (H1, exact backward), the sampler's probes through
    H2. training=True needs the sampler's `draws`; near / far [R, 1] bound
    the sampler (default cfg.near and the scene cube)."""
    cfg = model.cfg
    R = rays_o.shape[0]
    z_vals, (sdf_scene, _, gradients, semantic, sdf_raw), rgb_flat = (
        _subset_samples(model, rays_o, rays_d, obj_idxs, draws, training,
                        near, far))
    S = z_vals.shape[-1]
    beta = get_beta(model)
    subset_sdf = torch.amin(sdf_raw[:, list(obj_idxs)], -1).reshape(R, S)
    weights, transmittance, dists = volume_render_weights(
        z_vals, laplace_density(subset_sdf, beta))
    bg_weights, _, _ = volume_render_weights(
        z_vals, laplace_density(sdf_scene.reshape(R, S), beta))
    object_opacity = occlusion_opacity(
        transmittance, dists, laplace_density(sdf_raw.reshape(R, S, -1), beta))
    normals = _normalize(gradients).reshape(R, S, 3)
    return {
        "rgb_values": composite(bg_weights, rgb_flat.reshape(R, S, 3)),
        "semantic_values": composite(
            weights, semantic.reshape(R, S, cfg.num_semantic)),
        "object_opacity": object_opacity,
        "depth_values": depth_scale * composite_depth(bg_weights, z_vals),
        "normal_map": composite(bg_weights, normals) @ w2c_rot.T,
        "weights": weights,
        "bg_weights": bg_weights,
        "subset_weight_sum": weights.sum(-1),
        "z_vals": z_vals,
        "sdf": subset_sdf,
    }


def query_point_colors(model: HoloSceneModel, points, view_dirs):
    """Colours and unit normals of the field at surface points seen along
    view_dirs (JAX query_point_colors; reference
    get_colors_normals_from_point_rays*, model/network.py:1532-1802): the
    field through implicit_get_outputs (H1) and the rendering MLP. Returns
    (rgb [N, 3], normals [N, 3]), differentiable in the parameters."""
    _, feature_vectors, gradients, _, _ = implicit_get_outputs(
        model.implicit, points)
    rgb = model.rendering(points, gradients, view_dirs, feature_vectors)
    return rgb, _normalize(gradients)
