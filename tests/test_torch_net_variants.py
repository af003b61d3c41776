"""The Stage-1 network variants of the JAX package in the port, on the CPU
at tests/torch_stage1_cases.py's tiny width: the tetrahedral stencil, the
fused encode's raw fetch, the jvp gradient mode, a network without a
colour grid (with the nerf rendering head), one without grid features,
fused_dual_grid, and the fused mode on a network the fused encode does not
take (it renders in the vjp mode, as JAX's does). Each against JAX: the
field's outputs and their parameter gradients, one train step, Stage 2's
finetune step, a tetrahedral extraction grid, the converters and a JAX
checkpoint both ways; the CLI on the CPU; and the level_dim refusal with
its reason.

Tolerances are tests/test_torch_stage1.py's and tests/test_torch_fields.py's:
losses rtol 1e-4, a train step's gradients (SGD, lr 1) 1e-3 of the
largest JAX value per tensor, the field's outputs atol 1e-5 + rtol 1e-4,
their parameter gradients 1e-4 of the largest JAX value, SDF values on an
extraction grid 1e-5 of the largest |SDF|."""

import dataclasses

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401
from torch_stage1_cases import (
    batch,
    implicit_cfgs,
    jax_params,
    port_model,
    step_draws,
)

from holoscene_tpu.losses.holoscene_loss import LossConfig as JLossConfig
from holoscene_tpu.models import fields as jf
from holoscene_tpu.models import holoscene as jhs
from holoscene_tpu.ops.sampler import SamplerConfig as JSamplerConfig
from holoscene_tpu.training import checkpoints as jck
from holoscene_tpu.training import stage1 as js1
from holoscene_tpu_torch.convert import (
    read_flax_msgpack,
    stage1_params_from_jax,
    stage1_params_to_jax,
)
from holoscene_tpu_torch.losses.holoscene_loss import LossConfig
from holoscene_tpu_torch.models import fields as tf
from holoscene_tpu_torch.models import holoscene as ths
from holoscene_tpu_torch.ops.sampler import SamplerConfig as TSamplerConfig
from holoscene_tpu_torch.training import checkpoints as tck
from holoscene_tpu_torch.training import stage1 as ts1

LOSS_RTOL = 1e-4
STEP_GRAD_REL = 1e-3
OUT_ATOL, OUT_RTOL = 1e-5, 1e-4
GRAD_REL = 1e-4
SDF_REL = 1e-5
NERF = dict(mode="nerf", d_in=3)
# name: (forward_grad_mode, implicit network keys, rendering network keys)
VARIANTS = {
    "tetrahedral": ("vjp", dict(grid_interp="tetrahedral"), {}),
    "raw": ("fused", dict(fused_fetch="raw"), {}),
    "jvp": ("jvp", {}, {}),
    "jvp_tetrahedral": ("jvp", dict(grid_interp="tetrahedral"), {}),
    "no_colour_grid_nerf": ("vjp", dict(color_grid_feature=False), NERF),
    "no_grid_features": ("vjp", dict(use_grid_feature=False), {}),
    "fused_on_tetrahedral": ("fused", dict(grid_interp="tetrahedral"), {}),
    "tetrahedral_no_colour_grid_nerf": (
        "vjp", dict(grid_interp="tetrahedral", color_grid_feature=False),
        NERF),
}
KEYS = ("loss", "rgb_loss", "eikonal_loss", "smooth_loss", "depth_loss",
        "normal_l1", "normal_cos", "semantic_loss", "psnr")


def variant_cfgs(name: str):
    """(JAX, port) HoloSceneConfig of a variant: the tiny width of
    tests/torch_stage1_cases.py, fused_dual_grid on both sides, the
    sampled backward asked for (the raw fetch and every mode but fused
    take the exact one regardless), tiers where the fused encode runs."""
    grad_mode, ikw, rkw = VARIANTS[name]
    jic, tic = implicit_cfgs("sampled_all", **ikw)
    tic = dataclasses.replace(tic, fused_dual_grid=True)
    tiers = grad_mode == "fused" and tic.fused_ok
    out = []
    for pkg, hs, ic, S in ((jf, jhs, jic, JSamplerConfig),
                           (tf, ths, tic, TSamplerConfig)):
        rend = dict(feature_vector_size=16, dims=(32, 32), multires_view=2,
                    multires_point=2, multires_normal=2, **rkw)
        out.append(hs.HoloSceneConfig(
            implicit=ic, rendering=pkg.RenderingNetworkConfig(**rend),
            sampler=S(N_samples=8, N_samples_eval=16, N_samples_extra=4,
                      max_total_iters=3, beta_iters=4),
            use_bg_reg=False, sampler_grid_levels=4,
            forward_grad_mode=grad_mode, render_top_m=10,
            render_fine_top_f=6 if tiers else 0,
            render_fine_levels=3 if tiers else 8))
    return tuple(out)


def _points(n, seed=0):
    return np.random.default_rng(seed).uniform(
        -0.98, 0.98, (n, 3)).astype(np.float32)


def _close_tree(ref_tree, net_or_state, rel, what):
    """Every tensor of a JAX gradient tree against the port's gradients
    (a module's .grad) within rel of the largest JAX value."""
    ref = stage1_params_from_jax(jax.tree_util.tree_map(np.asarray, ref_tree))
    got = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
           for k, p in net_or_state.named_parameters()}
    assert set(ref) == set(got), what
    for k, r in ref.items():
        err = float((got[k] - r).abs().max())
        assert err <= rel * float(r.abs().max()) + 1e-9, (what, k, err)


@pytest.mark.parametrize("name", ["tetrahedral", "jvp", "jvp_tetrahedral",
                                  "no_colour_grid_nerf", "no_grid_features"])
def test_field_outputs_and_their_gradients_match_jax(name):
    """implicit_get_outputs (vjp) / implicit_get_outputs_jvp against
    JAX's: sdf, feature vectors, the scene-SDF gradient, semantics and raw
    SDFs, and every parameter's gradient of a random linear function of
    them (through the second-order path of H1-bwd)."""
    jc, tc = variant_cfgs(name)
    jic, tic = jc.implicit, tc.implicit
    params = jax_params(jc)["implicit"]
    net = tf.ImplicitNetwork(tic)
    net.load_state_dict(stage1_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    assert (net.color_grid is None) == (not tic.color_grid_feature)
    x = _points(96, seed=3)
    jvp = tc.forward_grad_mode == "jvp"
    jfn = jf.implicit_get_outputs_jvp if jvp else jf.implicit_get_outputs
    ref = jfn(params, jic, jnp.asarray(x))
    rng = np.random.default_rng(4)
    cts = [rng.normal(size=np.shape(r)).astype(np.float32) for r in ref]

    def jloss(p):
        return sum(jnp.sum(o * c) for o, c in zip(jfn(p, jic, jnp.asarray(x)),
                                                  cts))

    jgrads = jax.grad(jloss)(params)
    got = (tf.implicit_get_outputs_jvp(net, torch.tensor(x)) if jvp
           else tf.implicit_get_outputs(net, torch.tensor(x)))
    for r, g, what in zip(ref, got, ("sdf", "features", "gradients",
                                     "semantic", "sdf_raw")):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   atol=OUT_ATOL, rtol=OUT_RTOL, err_msg=what)
    sum((o * torch.tensor(c)).sum() for o, c in zip(got, cts)).backward()
    _close_tree(jgrads, net, GRAD_REL, name)
    if not tic.use_grid_feature:
        assert net.grid.grad is None or not net.grid.grad.any()


def test_nerf_rendering_head_matches_jax():
    """RenderingNetwork in mode nerf (view dirs and features alone)."""
    jc, tc = variant_cfgs("no_colour_grid_nerf")
    params = jax_params(jc)["rendering"]
    net = tf.RenderingNetwork(tc.rendering)
    net.load_state_dict(stage1_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    assert tc.rendering.layer_dims[0] == 3 + 12 + 16
    rng = np.random.default_rng(5)
    ins = [rng.normal(size=(40, d)).astype(np.float32) for d in (3, 3, 3, 16)]
    ref = jf.rendering_forward(params, jc.rendering,
                               *(jnp.asarray(a) for a in ins))
    got = net(*(torch.tensor(a) for a in ins))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=OUT_ATOL, rtol=OUT_RTOL)


@pytest.mark.parametrize("name", ["tetrahedral", "raw", "jvp",
                                  "no_colour_grid_nerf", "no_grid_features",
                                  "fused_on_tetrahedral"])
def test_train_step_matches_jax(name):
    """One Stage-1 train step (SGD, lr 1) from identical parameters and
    draws: the losses and every parameter's gradient against JAX
    make_train_step's."""
    jc, tc = variant_cfgs(name)
    # the sampled backward is asked for; none of these takes it
    assert tc.implicit.color_bwd_sample and ths.fused_mode(tc, True) == "exact"
    params = jax_params(jc)
    before = jax.tree_util.tree_map(np.asarray, params)
    model = port_model(tc, params)
    b = batch()
    key = jax.random.PRNGKey(5)
    draws = step_draws(key, jc, tc)
    opt = optax.sgd(1.0)
    step = js1.make_train_step(jc, JLossConfig(), opt)
    p2, _, jm = step(params, opt.init(params), key,
                     {k: jnp.asarray(v) for k, v in b.items()}, 0,
                     call_reg=False, with_bg=False, probe=None)
    jd = stage1_params_from_jax(jax.tree_util.tree_map(
        lambda a, c: np.asarray(c) - a, before, p2))
    t_before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    tm = ts1.train_step(model, torch.optim.SGD(model.parameters(), lr=1.0),
                        None, LossConfig(), ts1.batch_to_device(b, b, "cpu"),
                        draws, 0, call_reg=False)
    for k in KEYS:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)
    assert float(tm["nonfinite"]) == 0.0
    td = {k: v - t_before[k] for k, v in model.state_dict().items()}
    assert set(jd) == set(td)
    for k, ref in jd.items():
        scale = float(ref.abs().max())
        err = float((td[k] - ref).abs().max())
        assert err <= STEP_GRAD_REL * scale + 1e-9, (k, err, scale)
        # without grid features the SDF table has no gradient, and only then
        assert (scale == 0.0) == (k == "implicit.grid"
                                  and name == "no_grid_features"), k


def test_stage2_finetune_step_matches_jax():
    """Stage 2's object finetune step (stage2/refine.py, its invisible view
    and collision points included) on a tetrahedral field without a colour
    grid (the nerf head), against JAX make_object_finetune_step: every
    loss term at rtol 2e-5 and the SGD step's gradients at 1e-3
    (tests/test_torch_stage2_refine.py's tolerances)."""
    name = "tetrahedral_no_colour_grid_nerf"
    from torch_stage2_cases import (
        M,
        P,
        collision,
        finetune_draws,
        gen_view,
        to_torch,
    )

    from holoscene_tpu.stage2 import refine as jr
    from holoscene_tpu_torch.stage2 import refine as tr

    jc, tc = variant_cfgs(name)
    jc, tc = (dataclasses.replace(c, render_top_m=0) for c in (jc, tc))
    params = jax_params(jc)
    before = jax.tree_util.tree_map(np.asarray, params)
    model = port_model(tc, params)
    kw = dict(iters=10, rays_per_step=16, invis_pixels=M, collision_pts=P,
              depth_weight=2.0, nm_l1_weight=1.0, smooth_weight=0.3)
    b, gv = batch(), gen_view()
    pts, sdf = collision()
    key = jax.random.PRNGKey(3)
    orig = jr.make_optimizer
    jr.make_optimizer = lambda *a: optax.sgd(1.0)
    try:
        step, opt = jr.make_object_finetune_step(
            jc, JLossConfig(), jr.FinetuneConfig(**kw), 1)
    finally:
        jr.make_optimizer = orig
    p2, _, jm = step(params, opt.init(params), key,
                     {k: jnp.asarray(v) for k, v in b.items()},
                     {k: jnp.asarray(v) for k, v in gv.items()},
                     jnp.asarray(1.0), jnp.asarray(pts), jnp.asarray(sdf),
                     use_invis=True, coll_mode="match")
    jd = stage1_params_from_jax(jax.tree_util.tree_map(
        lambda a, c: np.asarray(c) - a, before, p2))
    t_before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    tm = tr.finetune_step(
        model, torch.optim.SGD(model.parameters(), lr=1.0), None,
        LossConfig(), tr.FinetuneConfig(**kw), 1,
        ts1.batch_to_device(b, b, "cpu"), to_torch(gv), 1.0,
        torch.tensor(pts), torch.tensor(sdf),
        finetune_draws(key, jc, use_invis=True), "match")
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-5,
                                   atol=1e-7, err_msg=k)
    for k, v in model.state_dict().items():
        ref, got = jd[k], v - t_before[k]
        scale = float(ref.abs().max())
        assert float((got - ref).abs().max()) <= STEP_GRAD_REL * scale \
            + 1e-9, k


@pytest.mark.parametrize("name", ["tetrahedral", "no_grid_features",
                                  "no_colour_grid_nerf"])
def test_extraction_grid_matches_jax_sdf_raw(name):
    """implicit_sdf_raw_grid (H2 packed; tetrahedral for a tetrahedral
    field, zeros for a network without grid features) against JAX
    implicit_sdf_raw on every point of a 17^3 extraction grid over
    [-1, 1]^3, whose boundary planes sit at x01 = 0 and 1."""
    jc, tc = variant_cfgs(name)
    params = jax_params(jc)["implicit"]
    net = tf.ImplicitNetwork(tc.implicit)
    net.load_state_dict(stage1_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    axis = np.linspace(-1.0, 1.0, 17, dtype=np.float32)
    x = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"),
                 -1).reshape(-1, 3)
    ref = np.asarray(jf.implicit_sdf_raw(params, jc.implicit, jnp.asarray(x)))
    got = tf.implicit_sdf_raw_grid(net, torch.tensor(x)).numpy()
    assert got.shape == ref.shape == (x.shape[0], tc.implicit.d_out)
    err = float(np.abs(got - ref).max())
    assert err <= SDF_REL * float(np.abs(ref).max()), err
    # and the render route (H1) to rounding
    h1 = tf.implicit_sdf_raw(net, torch.tensor(x)).detach().numpy()
    assert float(np.abs(h1 - got).max()) <= SDF_REL * float(np.abs(ref).max())


def test_sampler_reads_the_grid_without_grid_features():
    """A reference fault, kept: with use_grid_feature = false JAX's render
    reads zeros in place of the grid features, while its sampler's SDF
    probes (implicit_sdf_raw_sampler, fields.py:375) still encode the SDF
    grid, so sampler and render see different fields. The port does the
    same (ROADMAP.md queue C)."""
    jc, tc = variant_cfgs("no_grid_features")
    params = jax_params(jc)["implicit"]
    net = tf.ImplicitNetwork(tc.implicit)
    net.load_state_dict(stage1_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    x = _points(80, seed=6)
    from holoscene_tpu.ops.hashgrid import build_dense_block_tables

    blocks = build_dense_block_tables(params["grid"], jc.implicit.grid_meta,
                                      max_levels=4)
    ref = np.asarray(jf.implicit_sdf_raw_sampler(
        params, jc.implicit, jnp.asarray(x), blocks, grid_levels=4))
    got = tf.implicit_sdf_raw_sampler(net, torch.tensor(x), 4).numpy()
    np.testing.assert_allclose(got, ref, atol=OUT_ATOL, rtol=OUT_RTOL)
    render = tf.implicit_sdf_raw(net, torch.tensor(x)).detach().numpy()
    assert float(np.abs(render - got).max()) > 1e-3


def test_converters_and_jax_checkpoint_both_ways(tmp_path):
    """A network without a colour grid with the nerf head: the JAX params
    through stage1_params_from_jax and back are the same tree; the JAX
    package's checkpoint (msgpack params and optax state) loads into the
    port's model and Adam, and the port's state dict written as flax
    msgpack reads back the same."""
    jc, tc = variant_cfgs("no_colour_grid_nerf")
    params = jax_params(jc)
    flat = jax.tree_util.tree_map(np.asarray, params)
    state = stage1_params_from_jax(flat)
    assert not any("color" in k for k in state)
    back = stage1_params_to_jax(state)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, flat)
    opt = js1.make_optimizer(5.0e-4, 20.0, 10)
    path = tmp_path / "checkpoints"
    jck.save_checkpoint(str(path), 3, params, opt.init(params),
                        extra={"step": 3})
    model = ths.init_holoscene(tc, seed=9)
    optimizer, sched = ts1.make_optimizer(model, 5.0e-4, 20.0, 10)
    tck.load_checkpoint(str(path), model, optimizer, sched)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), state[k].numpy(), err_msg=k)
    assert len(optimizer.state) == len(list(model.parameters()))
    blob = flax.serialization.to_bytes(stage1_params_to_jax(
        model.state_dict()))
    again = read_flax_msgpack(blob)
    jax.tree_util.tree_map(np.testing.assert_array_equal, again, flat)
    p2 = port_model(tc, params)
    assert p2.implicit.color_map_mlp is None


def test_level_dim_other_than_two_is_refused_with_its_reason():
    """level_dim 4: every JAX Stage-1 render builds the dense block tables,
    which assert level_dim == 2, so no JAX configuration trains it; the
    port refuses it with that reason, in the network and in the model."""
    _, tic = implicit_cfgs("exact", level_dim=4)
    with pytest.raises(NotImplementedError,
                       match="build_dense_block_tables.*level_dim == 2"):
        tf.ImplicitNetwork(tic)
    _, tc = variant_cfgs("tetrahedral")
    tc = dataclasses.replace(tc, implicit=dataclasses.replace(
        tc.implicit, level_dim=4))
    with pytest.raises(NotImplementedError, match="level_dim 4"):
        ths.init_holoscene(tc)


@pytest.mark.parametrize("model", [
    "forward_grad_mode = jvp\n implicit_network{\n  grid_interp = "
    "tetrahedral\n  fused_dual_grid = true\n }",
    "forward_grad_mode = fused\n implicit_network{\n  fused_fetch = raw\n }",
    "implicit_network{\n  color_grid_feature = false\n  use_grid_feature = "
    "false\n }\n rendering_network{\n  mode = nerf\n  d_in = 3\n }",
], ids=["jvp_tetrahedral_dual", "fused_raw", "no_colour_grid_no_features"])
def test_cli_trains_checkpoints_resumes_and_extracts(tmp_path, model):
    """exp_runner.main on the CPU with the variants' conf keys (the tiny
    conf of tests/test_torch_stage1.py, its model section overridden):
    finite losses, a checkpoint that --is_continue resumes from, an eval
    frame and the extraction of the field's meshes."""
    from test_torch_stage1 import _scene_conf

    from holoscene_tpu_torch.training import exp_runner

    conf = _scene_conf(tmp_path, 3)
    text = conf.read_text()
    at = text.rindex("}")           # the model section's end
    conf.write_text(text[:at] + f" {model}\n" + text[at:])
    if "forward_grad_mode = fused" not in model:
        # the tiers are the fused mode's; the vjp mode where none is named
        conf.write_text(conf.read_text().replace(
            " render_fine_top_f = 6\n", "").replace(
            "forward_grad_mode = fused", "forward_grad_mode = vjp"))
    args = ["--conf", str(conf), "--exps_folder", str(tmp_path / "exps"),
            "--log_every", "1", "--quiet", "--device", "cpu"]
    runner = exp_runner.main(args)
    assert len(runner.history) == 3
    assert all(np.isfinite(h["loss"]) for h in runner.history)
    assert np.isfinite(runner.plot(2)["psnr"])
    meshes = runner.extract_meshes(resolution=16, prune=False, save=False)
    assert len(meshes) == runner.model_cfg.implicit.d_out
    again = exp_runner.main(args + ["--is_continue", "--max_niters", "4"])
    assert [h["iter"] for h in again.history] == [3]
    assert np.isfinite(again.history[0]["loss"])
