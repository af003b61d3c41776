"""The Stage-2 object finetune step of the port
(holoscene_tpu_torch/stage2/refine.py::finetune_step) against JAX's
make_object_finetune_step, render_rays_only_multi_obj against JAX's, and
FinetuneConfig.from_conf on every post conf, from identical parameters and
draws at a tiny width on the CPU (the hash-grid kernels' plain versions),
in the vjp gradient mode the post confs train in.

Tolerances. Loss terms: rtol 2e-5 (float32 sums in another order; measured
up to 7.3e-6 relative, on semantic_loss; the Stage-1 test allows 1e-4).
Gradients (a step of SGD with lr 1, so the parameter delta is minus the
gradient) and the parameters after Adam's first step: per tensor, max
|port - JAX| <= 1e-3 of that tensor's largest |JAX| value, the Stage-1
step's tolerance (tests/test_torch_stage1.py: float32 sums in another
order, amplified by the softplus-100 second derivative of the eikonal
path); measured up to 3.6e-4 on the SGD steps' MLP gradients and 2.1e-4
on the hash table's, 5e-6 on the render's. Adam's first
step moves a parameter by about lr sign(grad), so it is compared where
|grad| > 1e-2 of its tensor's largest, as tests/test_torch_stage1.py does
(elsewhere a rounding can flip the sign of a near-zero gradient).
Renders: outputs within 1e-5 absolute + 1e-4 relative."""

import functools
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401
from torch_stage1_cases import R, batch, jax_params, port_model, sampler_draws
from torch_stage2_cases import (
    M,
    P,
    collision,
    finetune_draws,
    gen_view,
    to_torch,
    vjp_cfgs,
)

from holoscene_tpu.config import ConfigFactory as JConfigFactory
from holoscene_tpu.losses.holoscene_loss import LossConfig as JLossConfig
from holoscene_tpu.models import holoscene as jhs
from holoscene_tpu.stage2 import refine as jr
from holoscene_tpu_torch.config import ConfigFactory
from holoscene_tpu_torch.convert import stage1_params_from_jax
from holoscene_tpu_torch.losses.holoscene_loss import LossConfig
from holoscene_tpu_torch.models import holoscene as ths
from holoscene_tpu_torch.stage2 import refine as tr
from holoscene_tpu_torch.training import stage1 as ts1

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 2e-5
PARAM_REL = 1e-3
OUT_ATOL, OUT_RTOL = 1e-5, 1e-4
FT_KW = dict(iters=10, rays_per_step=R, invis_pixels=M, collision_pts=P,
             depth_weight=2.0, nm_l1_weight=1.0, smooth_weight=0.3)
LAMA = dict(lama_rgb_weight=2.0, lama_nm_cos_weight=3.0,
            lama_nm_l1_weight=4.0)


@pytest.mark.parametrize("optim,use_invis,coll_mode,lama", [
    ("adam", True, "contain", True),
    ("sgd", False, "maintain", False),
    ("sgd", True, "match", False),
])
def test_finetune_step_matches_jax(monkeypatch, optim, use_invis, coll_mode,
                                   lama):
    """One finetune step of object 1 on the same state and draws: every
    returned loss term, and the parameters after the step (SGD lr 1: the
    gradients; Adam: the update), against JAX. The cases cover the
    invisible view on and off, each collision mode, and the lama weights
    set and unset."""
    jc, tc = vjp_cfgs()
    params = jax_params(jc)
    before = jax.tree_util.tree_map(np.asarray, params)
    model = port_model(tc, params)
    kw = {**FT_KW, **(LAMA if lama else {})}
    jf, tf_ = jr.FinetuneConfig(**kw), tr.FinetuneConfig(**kw)
    if optim == "sgd":
        monkeypatch.setattr(jr, "make_optimizer",
                            lambda *a: optax.sgd(1.0))
    b, gv = batch(), gen_view()
    pts, sdf = collision()
    key = jax.random.PRNGKey(3)
    step, opt = jr.make_object_finetune_step(jc, JLossConfig(), jf, 1)
    p2, _, jm = step(params, opt.init(params), key,
                     {k: jnp.asarray(v) for k, v in b.items()},
                     {k: jnp.asarray(v) for k, v in gv.items()},
                     jnp.asarray(1.0), jnp.asarray(pts), jnp.asarray(sdf),
                     use_invis=use_invis, coll_mode=coll_mode)
    jd = stage1_params_from_jax(jax.tree_util.tree_map(
        lambda a, c: np.asarray(c) - a, before, p2))

    t_before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    if optim == "sgd":
        opt_t, sched = torch.optim.SGD(model.parameters(), lr=1.0), None
    else:
        opt_t, sched = tr.make_finetune_optimizer(model, tf_)
    draws = finetune_draws(key, jc, use_invis=use_invis)
    tm = tr.finetune_step(
        model, opt_t, sched, LossConfig(), tf_, 1,
        ts1.batch_to_device(b, b, "cpu"),
        to_torch(gv) if use_invis else None, 1.0, torch.tensor(pts),
        torch.tensor(sdf), draws, coll_mode)
    assert set(tm) == set(jm)
    assert ("invis_loss" in tm) == use_invis
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    assert float(tm["collision_loss"]) > 0
    grads = ({k: p.grad for k, p in model.named_parameters()}
             if optim == "adam" else None)
    for k, v in model.state_dict().items():
        ref = jd[k]
        got = v - t_before[k]
        sure = torch.ones_like(ref, dtype=torch.bool)
        if grads is not None:
            g = grads[k].abs()
            sure = g > 1e-2 * float(g.max())
        scale = float(ref.abs().max())
        assert scale > 0, k
        err = float((got - ref)[sure].abs().max())
        assert err <= PARAM_REL * scale, (k, err, scale)


RENDER_CASES = ((True, True), (False, True), (False, False))
RENDER_KEYS = ("rgb_values", "depth_values", "normal_map", "acc", "z_vals")


@functools.lru_cache(maxsize=1)
def _jax_renders():
    """JAX's render_rays_only_multi_obj of objects (1, 2) through an
    orthographic camera in every case of RENDER_CASES, each with the
    gradient of a random functional of its outputs, from one compile:
    (rays, key, coefficients, {case: (outputs, gradients)})."""
    jc, _ = vjp_cfgs()
    params = jax_params(jc)
    gv = gen_view(seed=4, n=R)
    key = jax.random.PRNGKey(9)
    pose = jnp.asarray(gv["pose"])
    rays_o = pose[:3, 3][None] + gv["uv"][:, :1] * 0.6 * pose[:3, 0][None] \
        + gv["uv"][:, 1:] * 0.6 * pose[:3, 1][None]
    rays_d = jnp.broadcast_to(pose[:3, 2][None], rays_o.shape)
    rng = np.random.default_rng(2)
    coef = {"rgb_values": (R, 3), "depth_values": (R, 1),
            "normal_map": (R, 3), "acc": (R,)}
    coef = {k: rng.normal(size=s).astype(np.float32) for k, s in coef.items()}

    def fun(p, detach, training):
        out = jhs.render_rays_only_multi_obj(
            p, jc, key, rays_o, rays_d, jnp.ones((R, 1)), pose[:3, :3].T,
            (1, 2), training=training, detach_rgb_geometry=detach)
        return sum(jnp.sum(out[k] * c) for k, c in coef.items()), out

    @jax.jit
    def all_cases(p):
        return {case: jax.value_and_grad(fun, has_aux=True)(p, *case)
                for case in RENDER_CASES}

    res = {case: (out, grads)
           for case, ((_, out), grads) in all_cases(params).items()}
    return (np.asarray(rays_o), np.asarray(rays_d),
            np.asarray(pose[:3, :3].T)), key, coef, res


@pytest.mark.parametrize("detach,training", RENDER_CASES)
def test_render_rays_only_multi_obj_matches_jax(detach, training):
    """The isolated object render of objects (1, 2) through an
    orthographic camera: every output, and the gradient of every
    parameter of a random functional of them, against JAX (training with
    JAX's sampler draws; eval without)."""
    jc, tc = vjp_cfgs()
    model = port_model(tc, jax_params(jc))
    (rays_o, rays_d, w2c), key, coef, res = _jax_renders()
    jout, jgrads = res[(detach, training)]
    draws = sampler_draws(key, jc.sampler, R) if training else None
    out = ths.render_rays_only_multi_obj(
        model, torch.tensor(rays_o), torch.tensor(rays_d), torch.ones(R, 1),
        torch.tensor(w2c), (1, 2), draws, training=training,
        detach_rgb_geometry=detach)
    for k in RENDER_KEYS:
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(jout[k]), atol=OUT_ATOL,
                                   rtol=OUT_RTOL, err_msg=k)
    if not training:
        return
    sum((out[k] * torch.tensor(c)).sum() for k, c in coef.items()).backward()
    ref = stage1_params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    for k, p in model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        err = float((g - ref[k]).abs().max())
        assert err <= PARAM_REL * float(ref[k].abs().max()) + 1e-9, (k, err)


@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(REPO, "confs", "*_post.conf"))))
def test_finetune_config_from_conf_matches_jax(path):
    want = jr.FinetuneConfig.from_conf(JConfigFactory.parse_file(path))
    got = tr.FinetuneConfig.from_conf(ConfigFactory.parse_file(path))
    assert got.__dict__ == want.__dict__
    assert got.smooth_weight is not None and got.invis_pixels == 1024
    assert tr.FinetuneConfig.from_conf(
        ConfigFactory.parse_file(path), iters=7).iters == 7


def test_sample_collision_points_matches_jax():
    """The constraint points from the same numpy rng and the parent SDF
    target (JAX's packed implicit_sdf_raw; the port's grid evaluator)."""
    jc, tc = vjp_cfgs()
    params = jax_params(jc)
    model = port_model(tc, params)
    center, scale = np.array([0.1, -0.2, 0.05]), np.array([0.3, 0.2, 0.25])
    jp, jt = jr.sample_collision_points(params, jc, center, scale, (0, 2), 64,
                                        np.random.default_rng(5))
    tp, tt = tr.sample_collision_points(model, center, scale, (0, 2), 64,
                                        np.random.default_rng(5))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=OUT_ATOL,
                               rtol=OUT_RTOL)


def test_sdf_constraint_loss_rejects_an_unknown_mode():
    _, tc = vjp_cfgs()
    model = ths.init_holoscene(tc)
    with pytest.raises(ValueError, match="coll_mode"):
        tr.sdf_constraint_loss(model, 1, torch.zeros(4, 3), torch.zeros(4),
                               "push")
