"""The free-Gaussian model and trainer of the port (models/gaussians_free.py,
training/gs_trainer.py, training/gs_train.py) against the JAX package's on
the same numpy-seeded inputs and the same draws (JAX's, handed to the
port): capacity 64, SH degree 1, 16^2 / 32^2 frames.

Tolerances: the model ops are the same float32 formulas (1e-6; init 0);
renders 2e-4 (the compositor's); after 8 trainer steps with two refines
1e-4 in the parameters (Adam with eps 1e-15 divides tiny moments, so a
last-bit difference of a gradient moves a parameter by up to ~lr), the
alive mask and the spawn order exactly."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_gs_datasets import _write_colmap_scene, _write_nerf_scene
from test_torch_threads import few_torch_threads  # noqa: F401

from holoscene_tpu.datasets.gs_datasets import NerfSyntheticDataset as JDS
from holoscene_tpu.models import gaussians_free as jgf
from holoscene_tpu.training.gs_trainer import GSTrainer as JTrainer
from holoscene_tpu_torch.convert import (
    free_gaussians_from_jax,
    free_gaussians_to_jax,
)
from holoscene_tpu_torch.datasets.gs_datasets import (
    NerfSyntheticDataset as TDS,
)
from holoscene_tpu_torch.models import gaussians_free as tgf
from holoscene_tpu_torch.ops import gaussians as tg
from holoscene_tpu_torch.training import gs_train
from holoscene_tpu_torch.training.gs_trainer import GSTrainer

KW = dict(capacity=64, sh_degree=1, max_per_tile=64, rebin_every=2,
          densify_grad_thresh=1e-5)
TRAIN = dict(warmup=3, refine_every=4, seed=1, quiet=True)
N_SEED, STEPS = 48, 8


def _seeds():
    rng = np.random.default_rng(0)
    return rng.uniform(-0.6, 0.6, (N_SEED, 3)), rng.uniform(0, 1, (N_SEED, 3))


def _model(n_live=48):
    pts, cols = _seeds()
    jp, js = jgf.init_free_gaussians(jax.random.PRNGKey(0),
                                     jgf.FreeGaussianConfig(**KW), pts, cols)
    rng = np.random.default_rng(7)
    jp = {k: jnp.asarray(np.asarray(v) + rng.normal(0, 0.1, v.shape)
                         .astype(np.float32)) for k, v in jp.items()}
    js = {**js, "alive": jnp.arange(64) < n_live,
          "grad_accum": jnp.asarray(rng.uniform(0, 4e-3, 64)
                                    .astype(np.float32)),
          "grad_count": jnp.asarray(rng.integers(0, 3, 64)
                                    .astype(np.float32))}
    return jp, js


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _close(got: dict, ref: dict, atol, exact=("alive",)):
    for k, v in ref.items():
        a = got[k].detach().cpu().numpy() if torch.is_tensor(got[k]) \
            else np.asarray(got[k])
        if k in exact:
            np.testing.assert_array_equal(a, np.asarray(v), err_msg=k)
        else:
            np.testing.assert_allclose(a, np.asarray(v), atol=atol,
                                       err_msg=k)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("gsfree") / "lego"
    os.makedirs(root)
    _write_nerf_scene(root, n=3, res=32)
    return root


class _Replay:
    """JAX GSTrainer's key stream: one split at init, then one a step (the
    background) and one a refine (eps from its first half)."""

    def __init__(self, seed: int):
        self.key = jax.random.split(jax.random.PRNGKey(seed))[0]

    def next(self):
        self.key, k = jax.random.split(self.key)
        return k

    def background(self):
        return torch.tensor(np.asarray(jax.random.uniform(self.next(), (3,))))

    def eps(self):
        k1 = jax.random.split(self.next())[0]
        return torch.tensor(np.asarray(jax.random.normal(k1, (64, 3))))


@pytest.fixture(scope="module", params=[False, True], ids=["topk", "flat"])
def trainers(request, scene):
    """(JAX trainer, port trainer) after STEPS steps from the same seed
    points, the port given JAX's draws."""
    pts, cols = _seeds()
    kw = dict(KW, use_flat=request.param)
    jt = JTrainer(JDS(str(scene)), jgf.FreeGaussianConfig(**kw),
                  seed_points=pts, seed_colors=cols, **TRAIN)
    jt.run(STEPS, log_every=1)
    tt = GSTrainer(TDS(str(scene)), tgf.FreeGaussianConfig(**kw),
                   seed_points=pts, seed_colors=cols, device="cpu", **TRAIN)
    replay = _Replay(TRAIN["seed"])
    tt.draw_background = replay.background
    tt.draw_refine_eps = replay.eps
    tt.run(STEPS, log_every=1)
    return jt, tt


def test_init_matches_jax():
    pts, cols = _seeds()
    cfg = jgf.FreeGaussianConfig(**KW)
    jp, js = jgf.init_free_gaussians(jax.random.PRNGKey(0), cfg, pts, cols)
    tp, ts = tgf.init_free_gaussians(tgf.FreeGaussianConfig(**KW), pts, cols)
    _close(tp, _np(jp), 0.0)
    _close(ts, _np(js), 0.0)
    # without points: min(capacity, 50000) uniform seeds in the cube
    rp, rs = tgf.init_free_gaussians(tgf.FreeGaussianConfig(**KW),
                                     generator=torch.Generator()
                                     .manual_seed(0), scene_extent=0.5)
    assert int(rs["alive"].sum()) == 64
    assert float(rp["means"].abs().max()) <= 0.5


def test_render_and_projection_match_jax():
    jp, js = _model()
    tp, ts, _ = free_gaussians_from_jax(_np(jp), _np(js))
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = -2.5
    intr = np.array([[30.0, 0, 16], [0, 30.0, 16], [0, 0, 1]], np.float32)
    bg = np.array([0.2, 0.5, 0.7], np.float32)
    for cam, dist in (("pinhole", None), ("fisheye", (0.05, 0.01, 0, 0))):
        jc = jgf.FreeGaussianConfig(**KW, camera_model=cam, dist=dist)
        tc = tgf.FreeGaussianConfig(**KW, camera_model=cam, dist=dist)
        ref = jgf.render_free_gaussians(jp, js, jc, pose, intr, 32, 32,
                                        background=jnp.asarray(bg))
        got = tgf.render_free_gaussians(tp, ts, tc, pose, intr, 32, 32,
                                        background=torch.tensor(bg))
        for k in ("rgb", "alpha"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                       atol=2e-4, err_msg=f"{cam} {k}")
        assert float(got["alpha"].max()) > 0.1
        refp = jgf.free_project(jp, js, jc, pose, intr, 32, 32)
        gotp = tgf.free_project(tp, ts, tc, pose, intr, 32, 32)
        np.testing.assert_array_equal(gotp[4].numpy(), np.asarray(refp[4]))
        for a, b in zip(gotp[:4], refp[:4]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-5)


def test_refine_matches_jax_with_the_same_eps():
    jp, js = _model(40)
    cfg = jgf.FreeGaussianConfig(**KW)
    key = jax.random.PRNGKey(11)
    rp, rs, rst = jgf.refine_gaussians(key, jp, js, cfg, 1.0)
    eps = np.asarray(jax.random.normal(jax.random.split(key)[0], (64, 3)))
    tp, ts, _ = free_gaussians_from_jax(_np(jp), _np(js))
    gp, gs, gst = tgf.refine_gaussians(tp, ts, tgf.FreeGaussianConfig(**KW),
                                       1.0, eps=eps)
    assert int(rst["n_spawned"]) > 0 and int(rst["n_culled"]) > 0
    _close(gp, _np(rp), 1e-6)
    _close(gs, _np(rs), 0.0)
    for k in ("n_culled", "n_split", "n_spawned", "n_alive", "reset_mask"):
        np.testing.assert_array_equal(gst[k].numpy(), np.asarray(rst[k]))


def test_mcmc_relocate_matches_jax_with_the_same_targets():
    jp, js = _model(56)
    cfg = jgf.FreeGaussianConfig(**KW)
    key = jax.random.PRNGKey(5)
    rp, rs, rst = jgf.mcmc_relocate(key, jp, js, cfg, fraction=0.1)
    opac = jax.nn.sigmoid(jp["opacity_logits"]) * js["alive"]
    targets = np.asarray(jax.random.choice(
        key, 64, (6,), p=opac / jnp.maximum(opac.sum(), 1e-9)))
    tp, ts, _ = free_gaussians_from_jax(_np(jp), _np(js))
    gp, gs, gst = tgf.mcmc_relocate(tp, ts, tgf.FreeGaussianConfig(**KW),
                                    fraction=0.1, target_idx=targets)
    _close(gp, _np(rp), 1e-6)
    np.testing.assert_array_equal(gst["reset_mask"].numpy(),
                                  np.asarray(rst["reset_mask"]))
    assert int(gs["alive"].sum()) == int(ts["alive"].sum())
    # targets drawn by the port: the alive count is kept as well
    hp, hs, _ = tgf.mcmc_relocate(tp, ts, tgf.FreeGaussianConfig(**KW),
                                  generator=torch.Generator().manual_seed(0))
    assert int(hs["alive"].sum()) == 56


def test_selective_adam_matches_jax():
    jp, js = _model()
    rng = np.random.default_rng(3)
    vis = rng.uniform(size=64) > 0.4
    jm = jgf.init_selective_adam(jp)
    tp, _, _ = free_gaussians_from_jax(_np(jp), _np(js))
    tm = tgf.init_selective_adam(tp)
    lrs = {"means": 1e-2, "log_scales": 5e-3, "quats": 1e-3,
           "opacity_logits": 5e-2, "features_dc": 2.5e-3,
           "features_rest": 1e-4}
    for i in range(3):
        grads = {k: rng.normal(0, 1, v.shape).astype(np.float32)
                 for k, v in jp.items()}
        jp, jm = jgf.selective_adam_update(
            {k: jnp.asarray(v) for k, v in grads.items()}, jm, jp,
            jnp.asarray(vis), lrs)
        tp, tm = tgf.selective_adam_update(
            {k: torch.tensor(v) for k, v in grads.items()}, tm, tp,
            torch.tensor(vis), lrs)
        if i == 1:
            mask = rng.uniform(size=64) > 0.7
            jm = jgf.reset_moments(jm, jnp.asarray(mask))
            tm = tgf.reset_moments(tm, torch.tensor(mask))
    _close(tp, _np(jp), 1e-6)
    for part in ("m", "v"):
        _close(tm[part], _np(jm[part]), 1e-7)
    assert tm["count"] == int(jm["count"]) == 3
    # invisible slots never moved
    p0, _, _ = free_gaussians_from_jax(_np(_model()[0]), _np(js))
    np.testing.assert_array_equal(tp["means"][~torch.tensor(vis)].numpy(),
                                  p0["means"][~torch.tensor(vis)].numpy())
    back, _, mo = free_gaussians_to_jax(tp, {"alive": torch.tensor(vis)}, tm)
    assert mo["count"] == 3 and back["means"].dtype == np.float32


def test_trainer_matches_jax_slot_by_slot(trainers):
    """8 steps of each path (flat: K1/K2, cached bins rebuilt every second
    visit; top-K: K3/K4) with refines after steps 3 and 7, which spawn
    into the dead slots: the same losses, alive slots, accumulators and
    SelectiveAdam moments."""
    jt, tt = trainers
    jl = [h["loss"] for h in jt.history]
    tl = [h["loss"] for h in tt.history]
    np.testing.assert_allclose(tl, jl, atol=1e-5)
    assert len(tt.refines) == 2 and tt.refines[-1]["n_alive"] == 64
    assert int(tt.state["alive"].sum()) > N_SEED
    _close(tt.state, _np(jt.state), 1e-5)
    _close(tt.params, _np(jt.params), 1e-4)
    for part in ("m", "v"):
        _close(tt.moments[part], _np(jt.moments[part]), 1e-6)
    assert tt.moments["count"] == int(jt.moments["count"]) == STEPS
    if tt.use_flat:
        assert all(a <= 4 for a in tt._bins_age.values())


def test_checkpoint_resume_is_exact(scene, tmp_path):
    pts, cols = _seeds()

    def make():
        return GSTrainer(TDS(str(scene)), tgf.FreeGaussianConfig(**KW),
                         seed_points=pts, seed_colors=cols, device="cpu",
                         **dict(TRAIN, warmup=1, refine_every=2))

    straight = make()
    straight.run(4)
    first = make()
    first.run(2)
    path = first.save_checkpoint(str(tmp_path / "ckpt.pkl"))
    resumed = make().load_checkpoint(path)
    assert resumed.iter_step == 2
    resumed.run(2)
    for k in straight.params:
        assert torch.equal(straight.params[k], resumed.params[k]), k
    assert torch.equal(straight.state["alive"], resumed.state["alive"])
    assert straight.moments["count"] == resumed.moments["count"] == 4


def test_gs_train_cli_resume_and_exports(scene, tmp_path):
    out = tmp_path / "out"
    common = ["--dataset", "nerf", "--data_root", str(scene), "--out",
              str(out), "--capacity", "64", "--sh_degree", "1", "--quiet",
              "--device", "cpu"]
    t1 = gs_train.main(common + ["--iters", "6", "--warmup", "2",
                                 "--refine_every", "2", "--eval_every", "3"])
    assert np.isfinite(t1.metrics["psnr"]) and t1.iter_step == 6
    for name in ("eval.json", "scene.ply", "ckpt.pkl"):
        assert (out / name).exists(), name
    assert any("eval_psnr" in h for h in t1.history)
    t2 = gs_train.main(common + ["--iters", "9", "--resume", "--export",
                                 "scene.ingp"])
    assert t2.iter_step == 9 and (out / "scene.ingp").exists()
    t3 = gs_train.main(common + ["--iters", "9", "--resume", "--export",
                                 "scene.usdz"])
    assert abs(t3.metrics["psnr"] - t2.metrics["psnr"]) < 1e-4
    from holoscene_tpu_torch.export.gs_ingp import read_gaussians_ingp

    g = read_gaussians_ingp(str(out / "scene.ingp"))
    assert len(g["means"]) == int(t2.state["alive"].sum())


def test_gs_train_on_distorted_colmap_and_mcmc(tmp_path):
    _write_colmap_scene(tmp_path, model="OPENCV_FISHEYE")
    tr = gs_train.main([
        "--dataset", "colmap", "--data_root", str(tmp_path), "--out",
        str(tmp_path / "out"), "--iters", "4", "--capacity", "64",
        "--sh_degree", "1", "--warmup", "1", "--refine_every", "2",
        "--strategy", "mcmc", "--quiet", "--device", "cpu"])
    assert tr.cfg.camera_model == "fisheye" and tr.cfg.dist is not None
    assert np.isfinite(tr.metrics["psnr"])
    assert [r["n_alive"] for r in tr.refines] == [r["n_alive"] for r in
                                                 tr.refines[:1]] * 2
    # the UT projection is what the fisheye camera trains through
    xy_ut = tgf.free_project(tr.params, tr.state, tr.cfg,
                             tr.dataset.pose_all[0],
                             tr.dataset.intrinsics[:3, :3], 16, 16)[0]
    pin = tgf.FreeGaussianConfig(**{**KW, "capacity": 64})
    xy_pin = tgf.free_project(tr.params, tr.state, pin,
                              tr.dataset.pose_all[0],
                              tr.dataset.intrinsics[:3, :3], 16, 16)[0]
    assert not torch.allclose(xy_ut, xy_pin)
    assert tg.camera_project is not None


def test_eval_split_matches_jax(trainers):
    """eval_split renders through the top-K compositor at cfg.max_per_tile,
    as JAX's does: on JAX's trained state (converted) the port's metrics
    agree with JAX's, within 0.01 dB PSNR and 1e-4 SSIM (the renders
    differ by the compositors' 2e-4)."""
    import copy

    jt, tt = trainers
    ev = copy.copy(tt)
    ev.params, ev.state, _ = free_gaussians_from_jax(_np(jt.params),
                                                     _np(jt.state))
    ref = jt.eval_split("train", max_frames=3)
    got = ev.eval_split("train", max_frames=3)
    assert set(got) == set(ref)
    np.testing.assert_allclose(got["psnr"], ref["psnr"], atol=1e-2)
    np.testing.assert_allclose(got["ssim"], ref["ssim"], atol=1e-4)
    assert np.isfinite(got["psnr"])
