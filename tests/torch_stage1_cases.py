"""Shared inputs of the Stage-1 port's parity tests: a tiny configuration
built in both packages, its parameters made by the JAX package (with the
hash tables and the first layer randomised so that every parameter gets a
gradient), a ray batch from numpy, and each random draw made with
jax.random in the order the JAX step draws it, handed to the port."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from holoscene_tpu.models import fields as jf
from holoscene_tpu.models import holoscene as jhs
from holoscene_tpu.ops.sampler import SamplerConfig as JSamplerConfig
from holoscene_tpu_torch.convert import stage1_params_from_jax
from holoscene_tpu_torch.models import fields as tf
from holoscene_tpu_torch.models import holoscene as ths
from holoscene_tpu_torch.ops.hashgrid import level_tables
from holoscene_tpu_torch.ops.sampler import SamplerConfig as TSamplerConfig
from holoscene_tpu_torch.ops.sampler import SamplerDraws
from holoscene_tpu_torch.training.stage1 import StepDraws

R = 16            # rays of the tiny step
GRID = dict(num_levels=6, base_size=4, end_size=48, logmap=8)   # 1 dense level


def implicit_cfgs(mode: str = "exact", **kw):
    """(JAX, port) ImplicitNetworkConfig of the tiny width; mode picks the
    fused backward (exact / sampled / sampled_all)."""
    args = dict(feature_vector_size=16, d_out=3, dims=(32, 32), multires=2,
                color_bwd_sample=mode != "exact",
                sdf_bwd_sample=mode == "sampled_all", **GRID)
    args.update(kw)
    return (jf.ImplicitNetworkConfig(fused_dual_grid=True, **args),
            tf.ImplicitNetworkConfig(**args))


def cfgs(mode: str = "exact", probe: bool = False, grad_mode: str = "fused",
         use_bg_reg: bool = False):
    """(JAX, port) HoloSceneConfig: top-10 of 14 samples, tiers 6 / 3
    levels in the fused gradient mode (untiered in vjp), 3 sampler rounds,
    sampler probes at 4 levels, probe grid 8^3 when `probe`."""
    tiers = grad_mode == "fused"
    out = []
    for pkg, ic, S in ((jf, implicit_cfgs(mode)[0], JSamplerConfig),
                       (tf, implicit_cfgs(mode)[1], TSamplerConfig)):
        hs = jhs if pkg is jf else ths
        out.append(hs.HoloSceneConfig(
            implicit=ic,
            rendering=pkg.RenderingNetworkConfig(
                feature_vector_size=16, dims=(32, 32), multires_view=2,
                multires_point=2, multires_normal=2),
            sampler=S(N_samples=8, N_samples_eval=16, N_samples_extra=4,
                      max_total_iters=3, beta_iters=4),
            use_bg_reg=use_bg_reg, sampler_grid_levels=4,
            forward_grad_mode=grad_mode, render_top_m=10,
            render_fine_top_f=6 if tiers else 0,
            render_fine_levels=3 if tiers else 8,
            probe_grid_res=8 if probe else 0))
    return tuple(out)


def jax_params(jc, seed: int = 1):
    """JAX init_holoscene params with uniform(-0.1, 0.1) hash tables (the
    colour grid where the network has one) and a random first SDF layer
    (the geometric init zeroes the grid inputs, so the tables would get no
    gradient on a first step)."""
    params = jhs.init_holoscene(jax.random.PRNGKey(seed), jc)
    rng = np.random.default_rng(seed + 2)
    imp = params["implicit"]
    for k in ("grid", "color_grid"):
        if k in imp:
            imp[k] = jnp.asarray(rng.uniform(-0.1, 0.1, imp[k].shape)
                                 .astype(np.float32))
    v = imp["mlp"]["lin0"]["v"]
    imp["mlp"]["lin0"]["v"] = jnp.asarray(
        rng.normal(0, 0.3, v.shape).astype(np.float32))
    return params


def port_model(tc, params):
    model = ths.init_holoscene(tc)
    model.load_state_dict(stage1_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return model


def batch(seed: int = 0, n: int = R):
    """A ray batch of a 32^2 camera inside the scene cube (numpy)."""
    rng = np.random.default_rng(seed)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.1, 0.05, -0.4]
    return {
        "uv": rng.uniform(0, 32, (n, 2)).astype(np.float32),
        "pose": pose,
        "intrinsics": np.array([[20.0, 0, 16], [0, 20.0, 16], [0, 0, 1]],
                               np.float32),
        "rgb": rng.uniform(0, 1, (n, 3)).astype(np.float32),
        "depth": rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32),
        "normal": rng.normal(size=(n, 3)).astype(np.float32),
        "segs": rng.integers(0, 3, n).astype(np.int32),
        "mask": np.ones((n, 1), np.float32),
    }


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def fused_uniforms(key, meta, n: int, levels=None):
    """(u_b [3, Lh, n], u_a [Lh, n]) as JAX's _hash_fused_bwd draws them
    from the fused call's seed (`key` = the render key folded with 7)."""
    gs = jax.lax.bitcast_convert_type(
        jax.random.bits(key, dtype=jnp.uint32), jnp.float32)
    kb, ka = jax.random.split(jax.random.PRNGKey(
        jax.lax.bitcast_convert_type(gs, jnp.int32)))
    lh = level_tables(meta, levels).n_hashed
    return (_t(jax.random.uniform(kb, (3, lh, n))),
            _t(jax.random.uniform(ka, (lh, n))))


def sampler_draws(key, sc, n_rays: int) -> SamplerDraws:
    """error_bound_sample's draws from its key, in JAX's order."""
    k_strat, k_u, k_extra, k_eik = jax.random.split(key, 4)
    perm = jax.random.permutation(k_extra, sc.max_total_iters
                                  * sc.N_samples_eval)[:sc.N_samples_extra]
    return SamplerDraws(
        _t(jax.random.uniform(k_strat, (n_rays, sc.N_samples_eval))),
        _t(jax.random.uniform(k_u, (n_rays, sc.N_samples))),
        _t(perm, torch.int64),
        _t(jax.random.randint(k_eik, (n_rays, 1), 0, sc.n_final),
           torch.int64))


def step_draws(key, jc, tc, n_rays: int = R, with_bg: bool = False
               ) -> StepDraws:
    """The port's StepDraws holding the draws of JAX make_train_step's
    step(key): jitter, sampler, eikonal, neighbour and fused-backward
    uniforms, and with_bg the patch origin and the patch sampler's."""
    k_jit, k_render, k_bg_uv, k_bg = jax.random.split(key, 4)
    k_sampler, k_eik, k_nei = jax.random.split(k_render, 3)
    sbs = jc.scene_bounding_sphere
    mode = ths.fused_mode(tc, True)
    fused = []
    for n, levels in ths.fused_calls(tc, n_rays):
        if mode == "exact":
            fused.append(None)
            continue
        u_b, u_a = fused_uniforms(jax.random.fold_in(k_render, 7),
                                  tc.implicit.grid_meta, n, levels)
        fused.append((u_b, u_a if mode == "sampled_all" else None))
    render = ths.RenderDraws(
        sampler_draws(k_sampler, jc.sampler, n_rays),
        _t(jax.random.uniform(k_eik, (n_rays, 3), minval=-sbs, maxval=sbs)),
        _t(jax.random.uniform(k_nei, (2 * n_rays, 3))), fused)
    draws = StepDraws(_t(jax.random.uniform(k_jit, (n_rays, 2)) - 0.5),
                      render)
    if with_bg:
        draws.bg_uv = _t(jax.random.uniform(k_bg_uv, (2,)))
        draws.bg_sampler = sampler_draws(k_bg, jc.sampler,
                                         ths.BG_PATCH ** 2)
    return draws
