# Frozen copy of holoscene_tpu_torch/models/holoscene.py at commit badb067, for the
# benchmark's plain reference: imports rewired to port_bench.ref_s1, cut to
# the paths the benchmark's Stage-1 configuration runs, in plain PyTorch.
# Do not edit to follow the port.
"""HoloScene Stage-1 renderer (port of holoscene_tpu/models/holoscene.py),
cut to what the benchmark's Stage-1 configuration runs: HoloSceneConfig,
get_beta, scene_sdf_nograd, render_rays in the vjp gradient mode and
render_bg_patch.

render_rays places samples by the error-bound sampler (H2 probes), runs
the field on them untiered through `implicit_get_outputs` (H1, exact
backward) and the eikonal block from one single-table H1 call. Every
random number is an argument (`RenderDraws`). A configuration with another
gradient mode, top-M pruning, tiered levels, the occupancy grid or the
probe grid is refused."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from port_bench.ref_s1.fields import (
    ImplicitNetwork,
    ImplicitNetworkConfig,
    RenderingNetwork,
    RenderingNetworkConfig,
    implicit_all_gradients,
    implicit_get_outputs,
    implicit_sdf_raw_sampler,
)
from port_bench.ref_s1.density import laplace_beta, laplace_density
from port_bench.ref_s1.sampler import (
    SamplerConfig,
    SamplerDraws,
    error_bound_sample,
)
from port_bench.ref_s1.volrend import (
    composite,
    composite_depth,
    occlusion_opacity,
    volume_render_weights,
)

BG_PATCH = 32     # the background patch's side in pixels (JAX make_train_step)
# model keys whose other settings this reference does not run, with the
# value the configuration runs
_RUNS = {"forward_grad_mode": "vjp", "render_top_m": 0,
         "render_fine_top_f": 0, "use_occupancy": False, "probe_grid_res": 0}


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

    @property
    def num_semantic(self) -> int:
        return self.implicit.d_out

    @classmethod
    def from_conf(cls, conf) -> "HoloSceneConfig":
        """From the `model` section of a .conf file."""
        for key, value in _RUNS.items():
            if key in conf and conf.get(key) != value:
                raise NotImplementedError(f"model.{key} = {conf.get(key)!r}")
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


def get_beta(model: HoloSceneModel) -> torch.Tensor:
    return laplace_beta(model.density["beta"], model.cfg.beta_min)


@dataclasses.dataclass
class RenderDraws:
    """The random numbers of one training render_rays: the sampler's,
    the eikonal uniforms in [-sbs, sbs) [R, 3], the neighbour jitter
    uniforms in [0, 1) [2R, 3]."""

    sampler: SamplerDraws
    eik_uniform: torch.Tensor
    nei: torch.Tensor

    def rows(self, sl: slice, n_rays: int) -> "RenderDraws":
        """The draws of rays sl of an n_rays batch: each per-ray draw's
        rows; nei's two halves (the uniform and the near eikonal points)."""
        nei = torch.cat([self.nei[sl],
                         self.nei[n_rays + sl.start:n_rays + sl.stop]])
        return RenderDraws(self.sampler.rows(sl), self.eik_uniform[sl], nei)


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


def _normalize(v):
    return v / torch.sqrt((v * v).sum(-1, keepdim=True) + 1e-12)


def render_rays(model: HoloSceneModel, rays_o, rays_d, depth_scale, w2c_rot,
                draws: RenderDraws) -> dict:
    """Render R training rays (rays_o / rays_d [R, 3], depth_scale [R, 1],
    w2c_rot [3, 3]) with their `draws`."""
    cfg = model.cfg
    R = rays_o.shape[0]
    beta_sg = get_beta(model).detach()
    z_vals, z_eik = error_bound_sample(
        rays_o, rays_d, scene_sdf_nograd(model, cfg), beta_sg, cfg.sampler,
        draws.sampler)
    S = z_vals.shape[-1]

    points = rays_o[:, None, :] + z_vals[..., None] * rays_d[:, None, :]
    points_flat = points.reshape(-1, 3)
    dirs_flat = rays_d[:, None, :].expand(R, S, 3).reshape(-1, 3)
    sdf, feature_vectors, gradients, semantic, sdf_raw = \
        implicit_get_outputs(model.implicit, points_flat)
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
                    w2c_rot, draws: SamplerDraws) -> dict:
    """The background (object 0) render of a pixel patch for the
    smoothness regulariser (JAX render_bg_patch): error-bound sampling
    against the background SDF alone (H2 probes, no probe grid), the vjp
    field on the samples, background and scene weights from the Laplace
    density. Returns bg_depth_values [R, 1] (scaled by depth_scale),
    bg_normal_map [R, 3] (rotated by w2c_rot) and bg_mask [R, 1], the
    argmax of the scene-composited semantics."""
    cfg = model.cfg
    R = rays_o.shape[0]
    z_vals, _ = error_bound_sample(
        rays_o, rays_d, scene_sdf_nograd(model, cfg, obj_idxs=(0,)),
        get_beta(model).detach(), cfg.sampler, draws)
    S = z_vals.shape[-1]
    points_flat = (rays_o[:, None, :] + z_vals[..., None]
                   * rays_d[:, None, :]).reshape(-1, 3)
    sdf_all, _, gradients, semantic, sdf_raw = implicit_get_outputs(
        model.implicit, points_flat)
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
