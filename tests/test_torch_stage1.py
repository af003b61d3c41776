"""One Stage-1 train step of the port (holoscene_tpu_torch/training/stage1.py)
against the JAX make_train_step, from identical parameters and draws, at a
tiny width on the CPU (the hash-grid kernels' plain versions); the Stage-1
CLI end to end on a generated 32^2 scene; the Stage-1 converter.

Tolerances. Losses: rtol 1e-4 (measured ~1e-6). Gradients (a step of SGD
with lr 1, so the parameter delta is minus the gradient): per tensor,
max |port - JAX| <= 1e-3 max |JAX| (measured up to 2e-4: float32 sums in
another order, amplified by the softplus-100 second derivative of the
eikonal path). Adam's first step moves each parameter by about lr
sign(grad); it is compared where |grad| > 1e-2 max |grad| of its tensor,
to 1e-5 of lr (the float32 rounding of the two Adams' bias corrections;
elsewhere a rounding flips the sign of a near-zero gradient)."""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401
from torch_stage1_cases import (
    batch,
    cfgs,
    jax_params,
    port_model,
    sampler_draws,
    step_draws,
)

from holoscene_tpu.losses.holoscene_loss import LossConfig as JLossConfig
from holoscene_tpu.models import holoscene as jhs
from holoscene_tpu.training import stage1 as js1
from holoscene_tpu_torch.convert import (
    stage1_params_from_jax,
    stage1_params_to_jax,
)
from holoscene_tpu_torch.losses.holoscene_loss import LossConfig
from holoscene_tpu_torch.models import holoscene as ths
from holoscene_tpu_torch.training import stage1 as ts1

LOSS_RTOL = 1e-4
GRAD_REL = 1e-3
KEYS = ("loss", "rgb_loss", "eikonal_loss", "smooth_loss", "depth_loss",
        "normal_l1", "normal_cos", "semantic_loss", "collision_reg_loss",
        "background_reg_loss", "psnr")


def _run_both(mode, probe, call_reg, jax_opt, port_opt, seed=5,
              grad_mode="fused", with_bg=False):
    """(JAX metrics, JAX delta, port metrics, port delta) of one step from
    the same state."""
    jc, tc = cfgs(mode, probe, grad_mode, use_bg_reg=with_bg)
    params = jax_params(jc)
    before = jax.tree_util.tree_map(np.asarray, params)
    model = port_model(tc, params)
    probe_j = jhs.make_probe_bake(jc)(params) if probe else None
    probe_t = ths.make_probe_bake(tc)(model) if probe else None
    b = batch()
    key = jax.random.PRNGKey(seed)
    draws = step_draws(key, jc, tc, with_bg=with_bg)
    opt = jax_opt()
    step = js1.make_train_step(jc, JLossConfig(), opt)
    p2, _, jm = step(params, opt.init(params), key,
                     {k: jnp.asarray(v) for k, v in b.items()}, 0,
                     call_reg=call_reg, with_bg=with_bg, probe=probe_j)
    jdelta = stage1_params_from_jax(jax.tree_util.tree_map(
        lambda a, c: np.asarray(c) - a, before, p2))
    t_before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    optimizer, sched = port_opt(model)
    tb = ts1.batch_to_device(b, b, "cpu")
    tm = ts1.train_step(model, optimizer, sched, LossConfig(), tb, draws, 0,
                        call_reg=call_reg, probe=probe_t)
    tdelta = {k: v - t_before[k] for k, v in model.state_dict().items()}
    return jm, jdelta, tm, tdelta


def _check_losses(jm, tm):
    for k in KEYS:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)
    assert float(tm["nonfinite"]) == 0.0


@pytest.fixture(scope="module")
def sgd_runs():
    """_run_both with SGD (lr 1) by (mode, probe, call_reg), each run once
    in the module: test_adam_step_matches_optax reads the sampled_all
    run's port gradient from test_train_step_matches_jax's."""
    runs = {}

    def get(mode, probe, call_reg):
        if (mode, probe, call_reg) not in runs:
            runs[mode, probe, call_reg] = _run_both(
                mode, probe, call_reg, lambda: optax.sgd(1.0),
                lambda m: (torch.optim.SGD(m.parameters(), lr=1.0), None))
        return runs[mode, probe, call_reg]

    return get


@pytest.mark.parametrize("mode,probe,call_reg", [
    ("exact", False, False),
    ("exact", True, False),
    ("sampled_all", False, False),
    ("sampled_all", True, True),
])
def test_train_step_matches_jax(mode, probe, call_reg, sgd_runs):
    """Losses and the gradient of every parameter (SGD, lr 1) against JAX;
    the sampled backward with JAX's own uniforms."""
    jm, jd, tm, td = sgd_runs(mode, probe, call_reg)
    _check_losses(jm, tm)
    assert set(jd) == set(td)
    moved = 0
    for k, ref in jd.items():
        scale = float(ref.abs().max())
        err = float((td[k] - ref).abs().max())
        assert err <= GRAD_REL * scale + 1e-9, (k, err, scale)
        moved += scale > 0
    assert moved == len(jd), "every parameter has a gradient"
    if call_reg:
        assert float(tm["collision_reg_loss"]) > 0


@pytest.mark.parametrize("mode,grad_mode,with_bg", [
    ("exact", "fused", True),
    ("sampled_all", "fused", True),
    ("exact", "vjp", False),
])
def test_bg_and_vjp_steps_match_jax(mode, grad_mode, with_bg):
    """A background-regulariser step (the patch's render and its loss
    term) in the exact and the sampled_all backward, and a step in the vjp
    gradient mode (untiered, H1 exact), against JAX make_train_step at the
    tolerances above."""
    jm, jd, tm, td = _run_both(
        mode, False, False, lambda: optax.sgd(1.0),
        lambda m: (torch.optim.SGD(m.parameters(), lr=1.0), None),
        grad_mode=grad_mode, with_bg=with_bg)
    _check_losses(jm, tm)
    assert (float(tm["background_reg_loss"]) > 0) == with_bg
    for k, ref in jd.items():
        scale = float(ref.abs().max())
        err = float((td[k] - ref).abs().max())
        assert scale > 0, k
        assert err <= GRAD_REL * scale + 1e-9, (k, err, scale)


def test_render_bg_patch_matches_jax():
    """render_bg_patch on a 32 x 32 patch with JAX's sampler draws: depth,
    normals and the mask, and the gradient of every parameter through a
    random weighting of depth and normals. Depth and normals: 99% within
    1e-5 and all within 1e-4 (the sampler's placement margin)."""
    jc, tc = cfgs("exact", grad_mode="vjp", use_bg_reg=True)
    params = jax_params(jc, seed=3)
    model = port_model(tc, params)
    b = batch()
    key = jax.random.PRNGKey(11)
    k_uv, k_bg = jax.random.split(key)
    u = np.asarray(jax.random.uniform(k_uv, (2,)))
    uv = ts1.bg_patch_uv(torch.tensor(b["intrinsics"]), torch.tensor(u))
    po, pd, ps, pw = ts1.rays_from_batch(uv, torch.tensor(b["pose"]),
                                         torch.tensor(b["intrinsics"]))
    jrays = js1.rays_from_batch(jnp.asarray(uv.numpy()),
                                jnp.asarray(b["pose"]),
                                jnp.asarray(b["intrinsics"]))
    rng = np.random.default_rng(4)
    wd = rng.normal(size=(ths.BG_PATCH ** 2, 1)).astype(np.float32)
    wn = rng.normal(size=(ths.BG_PATCH ** 2, 3)).astype(np.float32)

    def jloss(p):
        o = jhs.render_bg_patch(p, jc, k_bg, *jrays, training=True)
        return (jnp.sum(o["bg_depth_values"] * wd)
                + jnp.sum(o["bg_normal_map"] * wn)), o

    (_, ref), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    out = ths.render_bg_patch(model, po, pd, ps, pw,
                              sampler_draws(k_bg, jc.sampler,
                                            ths.BG_PATCH ** 2))
    for k in ("bg_depth_values", "bg_normal_map"):
        # the sampler's margin (tests/test_torch_sampler.py): an ulp of
        # 1 - exp at ~1e-7 free energies moves a sample by ~1e-4 of a ray
        err = np.abs(out[k].detach().numpy() - np.asarray(ref[k]))
        assert (err <= 1e-5).mean() >= 0.99 and err.max() <= 1e-4, (
            k, err.max())
    np.testing.assert_array_equal(out["bg_mask"].numpy(),
                                  np.asarray(ref["bg_mask"]))
    ((out["bg_depth_values"] * torch.tensor(wd)).sum()
     + (out["bg_normal_map"] * torch.tensor(wn)).sum()).backward()
    ref_g = stage1_params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    names = dict(model.named_parameters())
    for k, r in ref_g.items():
        g = names[k].grad
        g = torch.zeros_like(r) if g is None else g
        err = float((g - r).abs().max())
        assert err <= GRAD_REL * float(r.abs().max()) + 1e-9, (k, err)
    assert names["implicit.grid"].grad.any()


def test_config_defaults_match_jax():
    """Every default the port's HoloSceneConfig / ImplicitNetworkConfig
    share with JAX's is JAX's (use_bg_reg True, forward_grad_mode vjp)."""
    from holoscene_tpu.models import fields as jfields
    from holoscene_tpu_torch.models import fields as tfields

    for jcls, tcls in ((jhs.HoloSceneConfig, ths.HoloSceneConfig),
                       (jfields.ImplicitNetworkConfig,
                        tfields.ImplicitNetworkConfig)):
        ref = {f.name: f.default for f in dataclasses.fields(jcls)}
        for f in dataclasses.fields(tcls):
            if f.default is not dataclasses.MISSING:
                assert f.name in ref and f.default == ref[f.name], f.name
    assert ths.HoloSceneConfig.use_bg_reg is True
    assert ths.HoloSceneConfig.forward_grad_mode == "vjp"


STAGE1_CONFS = sorted(
    p for p in glob.glob(os.path.join(os.path.dirname(__file__), "..",
                                      "confs", "*.conf"))
    if not p.endswith(("_post.conf", "_tex.conf")))


@pytest.mark.parametrize("path", STAGE1_CONFS, ids=os.path.basename)
def test_every_stage1_conf_model_section_is_accepted(path):
    """What Stage1Runner builds from each Stage-1 conf in confs/: the model
    and loss sections parse, the network is one the port runs, and the
    background regulariser is on every render_bg_iter-th step."""
    from holoscene_tpu_torch.config import parse_file
    from holoscene_tpu_torch.models.fields import require_ported

    conf = parse_file(path)
    cfg = ths.HoloSceneConfig.from_conf(conf.get_config("model"))
    require_ported(cfg.implicit)
    LossConfig.from_conf(conf.get_config("loss"))
    assert cfg.use_bg_reg and cfg.render_bg_iter == 10
    assert cfg.forward_grad_mode in ths.GRAD_MODES


def test_adam_step_matches_optax(sgd_runs):
    """make_optimizer (Adam 0.9 / 0.99, eps 1e-15, grid lr x20, decay) one
    step against the JAX make_optimizer's."""
    lr, factor = 5e-4, 20.0
    jm, jd, tm, td = _run_both(
        "sampled_all", False, False,
        lambda: js1.make_optimizer(lr, factor, 100),
        lambda m: ts1.make_optimizer(m, lr, factor, 100))
    _check_losses(jm, tm)
    # the gradient (the port's SGD step from the same state and draws,
    # held to JAX's in test_train_step_matches_jax) says where the sign is
    # certain
    gd = {k: -v for k, v in sgd_runs("sampled_all", False, False)[3].items()}
    for k, ref in jd.items():
        g = gd[k].abs()
        sure = g > 1e-2 * g.max()
        step_lr = lr * (factor if k.endswith("grid") else 1.0)
        assert sure.any(), k
        np.testing.assert_allclose(td[k][sure], ref[sure], rtol=0,
                                   atol=1e-5 * step_lr, err_msg=k)
        assert float(ref[sure].abs().min()) > 0.9 * step_lr


def test_nan_guard_zeroes_grads_and_steps(monkeypatch):
    """A non-finite loss: every gradient is zero (not None), and Adam still
    steps (its state counts the step), as optax does."""
    _, tc = cfgs("exact")
    model = ths.init_holoscene(tc)
    opt, sched = ts1.make_optimizer(model, 5e-4, 20.0, 10)
    b = batch()
    orig = ts1.holoscene_loss

    def nan_loss(*a, **kw):
        out = orig(*a, **kw)
        out["loss"] = out["loss"] * float("nan")
        return out

    monkeypatch.setattr(ts1, "holoscene_loss", nan_loss)
    gen = torch.Generator().manual_seed(0)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    m = ts1.train_step(model, opt, sched, LossConfig(),
                       ts1.batch_to_device(b, b, "cpu"),
                       ts1.StepDraws.make(tc, len(b["uv"]), gen, "cpu"), 0)
    assert float(m["nonfinite"]) == 1.0
    for k, p in model.named_parameters():
        assert p.grad is not None and not p.grad.any(), k
        assert int(opt.state[p]["step"]) == 1, k
        assert torch.equal(p.detach(), before[k]), k


def test_convert_round_trip_and_names():
    """JAX Stage-1 params -> port state dict -> numpy gives the same
    arrays, and every parameter of init_holoscene maps by name and shape."""
    jc, tc = cfgs("exact")
    params = jax.tree_util.tree_map(
        np.asarray, jhs.init_holoscene(jax.random.PRNGKey(0), jc))
    sd = stage1_params_from_jax(params)
    model = ths.init_holoscene(tc)
    own = model.state_dict()
    assert set(sd) == set(own)
    assert all(tuple(sd[k].shape) == tuple(own[k].shape) for k in sd)
    model.load_state_dict(sd)
    back = stage1_params_to_jax(model.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b) == len(sd)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def _scene_conf(tmp_path, iters: int):
    from holoscene_tpu_torch.datasets.synthetic import generate_scene

    generate_scene(str(tmp_path / "data" / "scene_0"), n_images=4,
                   img_res=(32, 32))
    conf = tmp_path / "tiny.conf"
    conf.write_text(f"""
train{{
 expname = tiny_s1
 learning_rate = 5.0e-4
 lr_factor_for_grid = 20.0
 num_pixels = 64
 checkpoint_freq = 1000
 split_n_pixels = 512
 max_total_iters = {iters}
 exact_bwd_from_iter = 3
 add_objectvio_iter = 2
}}
loss{{
 rgb_loss = l1
}}
dataset{{
 data_root_dir = {tmp_path / 'data'}
 data_dir = scene_0
 img_res = [32, 32]
}}
model{{
 feature_vector_size = 16
 scene_bounding_sphere = 1.0
 use_bg_reg = true
 render_bg_iter = 3
 forward_grad_mode = fused
 sampler_grid_levels = 4
 render_top_m = 10
 render_fine_top_f = 6
 render_fine_levels = 3
 probe_grid_res = 8
 probe_update_every = 2
 implicit_network{{
  dims = [32, 32]
  multires = 2
  num_levels = 6
  base_size = 4
  end_size = 48
  logmap = 8
 }}
 rendering_network{{
  dims = [32, 32]
  multires_view = 2
  multires_point = 2
  multires_normal = 2
 }}
 ray_sampler{{
  N_samples = 8
  N_samples_eval = 16
  N_samples_extra = 4
  max_total_iters = 3
  beta_iters = 4
 }}
}}
""")
    return conf


def test_cli_trains_checkpoints_and_resumes(tmp_path):
    """exp_runner.main on the CPU: finite losses, probe bakes on the
    cadence, the exact backward from its iteration, the collision term
    from add_objectvio_iter, the background regulariser on its cadence, a
    checkpoint, an eval frame; --is_continue resumes at the saved step
    with the saved state."""
    from holoscene_tpu_torch.training import exp_runner

    conf = _scene_conf(tmp_path, 4)
    args = ["--conf", str(conf), "--exps_folder", str(tmp_path / "exps"),
            "--log_every", "1", "--quiet", "--device", "cpu"]
    runner = exp_runner.main(args)
    hist = runner.history
    assert len(hist) == 4 and all(np.isfinite(h["loss"]) for h in hist)
    assert runner.probe_bakes == [0, 2]
    assert not runner.model_cfg.implicit.color_bwd_sample   # exact from 3
    assert hist[0]["collision_reg_loss"] == 0.0
    bg = [h["background_reg_loss"] > 0 for h in hist]
    assert bg == [True, False, False, True]       # steps 0 and 3
    assert runner.model_cfg.implicit.d_out == len(runner.dataset.label_mapping)
    ck = os.path.join(runner.checkpoints_path, "ModelParameters", "latest.pth")
    assert os.path.exists(ck)
    assert os.path.exists(os.path.join(runner.rundir, "metrics.jsonl"))
    psnr = runner.plot(3)["psnr"]
    assert np.isfinite(psnr)
    state = {k: v.clone() for k, v in runner.model.state_dict().items()}

    again = exp_runner.main(args + ["--is_continue", "--max_niters", "6"])
    assert again.rundir == runner.rundir
    assert [h["iter"] for h in again.history] == [4, 5]
    from holoscene_tpu_torch.training.checkpoints import load_checkpoint

    probe = ths.init_holoscene(again.model_cfg)
    meta, _ = load_checkpoint(runner.checkpoints_path, probe,
                              checkpoint="3")
    assert meta["step"] == 4
    for k, v in probe.state_dict().items():
        assert torch.equal(v, state[k]), k
