"""Multi-rank execution of the port (holoscene_tpu_torch/parallel) on the
CPU: one gloo group of two spawned processes runs

  * a Stage-1 step at dp 2 (each rank renders half the rays and half the
    background patch, the occupancy grid updated from both halves' probes)
    and at model 2 (the hash tables and the MLP rows JAX's rules shard
    stored as row shards, SGD; then two Adam steps whose reassembled
    optimizer state is the single process's), each against the
    single-process step on the same global batch and draws. The batch has
    a depth prior, so the batch-wide scale-and-shift solve runs; the draws
    are the sampled backward's, so the fused calls' uniforms are split too.
    Tolerances (tests/test_multichip.py's for JAX's mesh): loss rtol 2e-5,
    atol 2e-6; every gradient (SGD, lr 1) within 5e-5 x max(max |g|, 1e-3)
    of its tensor, but the 0-d beta's within 5e-4 of it: its gradient is one
    cancelling sum over every sample, and a rank's half of the rays meets
    the field's matmuls in other row counts, which moves a SDF by an ulp.
    The single-process step on the same batch with its two halves swapped
    moves beta's gradient by 1.0e-4 of it (measured; every other tensor's
    by under 1e-5); the dp-2 step by 1.4e-4. The grid within 1e-6 where
    both probed;
  * the Stage-4 dp step at dp 2 (each rank one frame of a flat-path scene)
    against the single-process mean of the two frames' gradients, one SGD
    step: parameters rtol 2e-4, atol 2e-6 (tests/test_stage4_dp.py's).

param_sharding's sharded set is held to JAX's _TP_RULES on the tiny
Stage-1 model, through convert.py's names, with the raise on a large
parameter no rule covers."""

import dataclasses
import socket
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from test_torch_threads import few_torch_threads  # noqa: F401
from torch_parallel_cases import (
    STAGE4_LR,
    run_worker,
    stage1_runner,
    stage1_step,
    stage4_params,
)
from test_torch_stage1 import _scene_conf
from torch_stage1_cases import batch, cfgs, jax_params, port_model, step_draws

from holoscene_tpu.parallel import mesh as jmesh
from holoscene_tpu_torch.convert import stage1_params_from_jax
from holoscene_tpu_torch.datasets.ns_dataset import NSDataset
from holoscene_tpu_torch.datasets.synthetic import generate_scene, scene_meshes
from holoscene_tpu_torch.models.gom import GoMConfig
from holoscene_tpu_torch.ops.occupancy import OccGridConfig
from holoscene_tpu_torch.parallel import mesh as tmesh
from holoscene_tpu_torch.parallel.stage4_dp import frame_loss
from holoscene_tpu_torch.training import stage1 as ts1
from holoscene_tpu_torch.training.stage4 import Stage4Runner

WORLD = 2
LOSS_RTOL, LOSS_ATOL, GRAD_REL, SCALAR_REL = 2e-5, 2e-6, 5e-5, 5e-4
S4_RTOL, S4_ATOL = 2e-4, 2e-6


def _stage1_inputs():
    jc, tc = cfgs("sampled_all", use_bg_reg=True)
    tc = type(tc)(**{**tc.__dict__, "use_occupancy": True,
                     "occupancy": OccGridConfig(resolution=8, taps=16)})
    params = jax_params(jc)
    b = batch()
    return {"cfg": tc,
            "state": port_model(tc, params).state_dict(),
            "batch": ts1.batch_to_device(b, b, "cpu"),
            "draws": step_draws(jax.random.PRNGKey(5), jc, tc, with_bg=True)}


def _stage4_inputs(root):
    generate_scene(str(root / "scene_0"), n_images=4, img_res=(32, 32))
    ds = NSDataset(str(root), "scene_0", img_res=(32, 32))
    runner = Stage4Runner(scene_meshes(12), ds,
                          cfg=GoMConfig(sh_degree=1, tile_size=16,
                                        use_flat=True),
                          area_to_subdivide=5e-3, max_total_iters=10,
                          out_dir=str(root / "out"), quiet=True,
                          device="cpu")
    gen = torch.Generator().manual_seed(7)
    frames = []
    for f in range(WORLD):
        pose, intr = runner._pose_intr(f)
        acm, depth = runner._frame_mesh_raster(f)
        frames.append({
            "pose": pose, "intr": intr, "acm": acm, "mesh_depth": depth,
            "image": torch.tensor(ds.rgb_images[f].reshape(32, 32, 3)
                                  .transpose(2, 0, 1)).contiguous(),
            "bins": runner._get_bins(f, pose, intr),
            "bg": torch.rand(3, generator=gen)})
    flat = {"params": {k: v.detach() for k, v in runner.params.items()},
            "static": runner.static, "cfg": runner.cfg,
            "plan": runner.flat_plan, "loss_scale": runner.loss_scale,
            "width": 32, "height": 32, "frames": frames}
    topk = {**flat, "cfg": dataclasses.replace(runner.cfg, use_flat=False),
            "plan": None,
            "frames": [{**f, "bins": None} for f in frames]}
    return flat, topk


RUNNER_STEPS = 3


def _runner_conf(root):
    """test_torch_stage1.py's tiny scene and conf (the background patch on
    step 0, probe bakes on 0 and 2, the collision term from step 2) with
    the occupancy grid on, updated every other step."""
    conf = _scene_conf(root, RUNNER_STEPS)
    text = conf.read_text().replace(
        " use_bg_reg = true", " use_bg_reg = true\n use_occupancy = true\n"
        " occupancy_resolution = 8\n occupancy_taps = 16").replace(
        " num_pixels = 64", " num_pixels = 64\n occ_update_every = 2")
    conf.write_text(text)
    return str(conf)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results and the single-process references (one torch
    thread on both sides)."""
    root = tmp_path_factory.mktemp("par")
    flat, topk = _stage4_inputs(root)
    inp = {"stage1": _stage1_inputs(),
           "stage1_occ": torch.zeros(8 ** 3),
           "stage4": flat, "stage4_topk": topk,
           "runner_conf": _runner_conf(root / "runner"),
           "runner_steps": RUNNER_STEPS}
    torch.save(inp, root / "in.pt")
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mp.spawn(run_worker, args=(WORLD, _free_port(), str(root / "in.pt"),
                                   str(root)), nprocs=WORLD, join=True)
        ranks = [torch.load(root / f"rank{r}.pt", weights_only=False)
                 for r in range(WORLD)]
        s1 = inp["stage1"]
        ref = {"stage1_dp": stage1_step({**s1, "occ": inp["stage1_occ"]}),
               "stage1_model": stage1_step(s1),
               "stage1_model_adam": stage1_step(s1, adam_steps=2),
               "runner": stage1_runner(inp["runner_conf"],
                                       str(root / "exps_single"),
                                       RUNNER_STEPS)}
    finally:
        torch.set_num_threads(before)
    return inp, ranks, ref


def _check_stage1(inp, got, want):
    m, w = got["metrics"], want["metrics"]
    for k in ("loss", "rgb_loss", "eikonal_loss", "smooth_loss",
              "depth_loss", "normal_l1", "normal_cos", "semantic_loss",
              "background_reg_loss", "psnr"):
        np.testing.assert_allclose(m[k], w[k], rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL, err_msg=k)
    assert w["depth_loss"] > 0 and w["background_reg_loss"] > 0
    state0 = inp["stage1"]["state"]
    for k, v in want["state"].items():
        g_ref, g = state0[k] - v, state0[k] - got["state"][k]
        scale = float(g_ref.abs().max())
        assert scale > 0, k
        err = float((g - g_ref).abs().max())
        rel = GRAD_REL if v.dim() else SCALAR_REL
        assert err <= rel * max(scale, 1e-3), (k, err, scale)


@pytest.mark.parametrize("case", ["stage1_dp", "stage1_model"])
def test_stage1_step_matches_single_process(runs, case):
    inp, ranks, ref = runs
    for r in ranks:
        _check_stage1(inp, r[case], ref[case])
    for k, v in ranks[0][case]["state"].items():
        assert torch.equal(v, ranks[1][case]["state"][k]), k


def test_stage1_dp_occupancy_update_is_the_single_process_grid(runs):
    _, ranks, ref = runs
    want = ref["stage1_dp"]["occ"]
    assert float(want.max()) > 0
    for r in ranks:
        got = r["stage1_dp"]["occ"]
        both = (got > 0) & (want > 0)
        assert torch.equal(got > 0, want > 0)
        np.testing.assert_allclose(got[both].numpy(), want[both].numpy(),
                                   rtol=0, atol=1e-6)
    assert torch.equal(ranks[0]["stage1_dp"]["occ"],
                       ranks[1]["stage1_dp"]["occ"])


def test_stage1_model_sharded_adam_state_is_the_single_process_state(runs):
    inp, ranks, ref = runs
    assert ranks[1]["mesh"] == ({"data": 1, "model": 2}, 0, 1)
    want = ref["stage1_model_adam"]["opt"]
    names = [n for n, _ in port_model_names(inp)]
    for r in ranks:
        got = r["stage1_model_adam"]["opt"]
        assert got["param_groups"] == want["param_groups"]
        assert got["state"].keys() == want["state"].keys()
        for i, st in want["state"].items():
            for k in ("exp_avg", "exp_avg_sq"):
                a, b = got["state"][i][k], st[k]
                assert a.shape == b.shape, (names[i], k)
                tol = GRAD_REL * float(b.abs().max()) + 1e-30
                assert float((a - b).abs().max()) <= tol, (names[i], k)
            assert float(got["state"][i]["step"]) == 2.0


def port_model_names(inp):
    """The optimizer's parameter order (make_optimizer: grid tables, then
    the rest) as names."""
    named = list(inp["stage1"]["state"].items())
    grid = [(n, v) for n, v in named if n.endswith("grid")]
    return grid + [(n, v) for n, v in named if not n.endswith("grid")]


@pytest.mark.parametrize("path", ["stage4", "stage4_topk"])
def test_stage4_dp_matches_single_process_gradient_mean(runs, path):
    """The flat path (K1/K2's plain versions) and, without a flat plan,
    the top-K path (K3/K4's)."""
    inp, ranks, _ = runs
    s4 = inp[path]
    params = stage4_params(s4)
    grads = []
    for f in s4["frames"]:
        total, _, _ = frame_loss(params, s4["static"], s4["cfg"], s4["plan"],
                                 s4["loss_scale"], s4["width"], s4["height"],
                                 f["pose"], f["intr"], f["image"], f["acm"],
                                 f["mesh_depth"], f["bins"], f["bg"])
        grads.append(torch.autograd.grad(total, list(params.values())))
    want = {k: p.detach() - STAGE4_LR * (g0 + g1) / 2
            for (k, p), g0, g1 in zip(params.items(), *grads)}
    n_g = s4["static"]["num_gaussians"]
    for r in ranks:
        got = r["stage4_dp" if path == "stage4" else "stage4_dp_topk"]
        assert np.isfinite(got["metrics"]["loss"])
        assert got["used"].shape[0] == WORLD and got["stale"].shape == (WORLD,)
        assert (int(got["used"].max()) >= 1) == (path == "stage4")
        for k, v in want.items():
            np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(),
                                       rtol=S4_RTOL, atol=S4_ATOL,
                                       err_msg=k)
    assert n_g >= 100
    moved = sum(float((want[k] - s4["params"][k]).abs().max()) > 0
                for k in want)
    assert moved == len(want)


def test_param_sharding_matches_jax_rules():
    jc, tc = cfgs("exact")
    params = jax_params(jc)
    jax_mesh = jmesh.make_mesh(n_data=4, n_model=2)
    spec = jmesh.param_sharding(jax_mesh, params)
    want = {k for k, v in stage1_params_from_jax(jax.tree_util.tree_map(
        lambda s: np.zeros(()), spec)).items()}
    sharded_jax = set()
    for path, s in jax.tree_util.tree_flatten_with_path(
            spec, is_leaf=lambda x: hasattr(x, "spec"))[0]:
        if len(s.spec) and s.spec[0] == "model":
            sharded_jax.add(".".join(str(p.key) for p in path))
    model = port_model(tc, params)
    mesh = tmesh.Mesh(n_data=4, n_model=2, rank=1, data_group=None,
                      model_group=None)
    got = tmesh.param_sharding(mesh, model.named_parameters())
    assert set(got) == want
    sharded = {k for k, s in got.items() if s == tmesh.MODEL_SHARDED}
    assert sharded == sharded_jax
    assert {"implicit.grid", "implicit.color_grid"} <= sharded
    one = tmesh.Mesh(4, 1, 0, None, None)
    assert not any(tmesh.param_sharding(one, model.named_parameters())
                   .values())
    shards = tmesh.shard_params(mesh, model)
    assert set(shards) == sharded
    g = model.implicit.grid
    assert torch.equal(shards["implicit.grid"],
                       g.detach()[g.shape[0] // 2:])
    big = [("implicit.extra", torch.zeros(1 << 16))]
    with pytest.raises(ValueError, match="no tensor-parallel rule"):
        tmesh.param_sharding(mesh, big)
    params["implicit"]["extra"] = np.zeros(1 << 16, np.float32)
    with pytest.raises(ValueError, match="no tensor-parallel rule"):
        jmesh.param_sharding(jax_mesh, params)


@pytest.mark.parametrize("n_model", [1, WORLD])
def test_stage1_runner_over_ranks_matches_single_process(runs, n_model):
    """Stage1Runner on the group (dp 2, then model 2 with row-sharded
    tables) against the runner in one process on the same conf and seed:
    the same losses step by step (the occupancy grid, the background patch,
    the probe bakes and the collision term on), the same occupancy grid,
    and one run directory, rank 0's, whose checkpoint loads into the
    single-process runner's model and optimizer."""
    from holoscene_tpu_torch.config import ConfigFactory
    from holoscene_tpu_torch.training.checkpoints import load_checkpoint

    inp, ranks, ref = runs
    want = ref["runner"]
    key = f"runner_model{n_model}"
    for rank, r in enumerate(ranks):
        got = r[key]
        assert got["is_main"] == (rank == 0)
        assert got["mesh"] == {"data": WORLD // n_model, "model": n_model}
        assert len(got["history"]) == len(want["history"]) == RUNNER_STEPS
        for h, w in zip(got["history"], want["history"]):
            for k in ("loss", "rgb_loss", "depth_loss", "collision_reg_loss",
                      "background_reg_loss", "psnr"):
                np.testing.assert_allclose(h[k], w[k], rtol=LOSS_RTOL,
                                           atol=LOSS_ATOL, err_msg=k)
        both = (got["occ"] > 0) & (want["occ"] > 0)
        assert torch.equal(got["occ"] > 0, want["occ"] > 0)
        np.testing.assert_allclose(got["occ"][both].numpy(),
                                   want["occ"][both].numpy(), rtol=0,
                                   atol=1e-6)
    assert want["history"][-1]["collision_reg_loss"] > 0
    runs_written = list((Path(ranks[0][key]["checkpoints"])
                         .parents[2]).glob("*/*"))
    assert len(runs_written) == 1
    single = ts1.Stage1Runner(
        ConfigFactory.parse_file(inp["runner_conf"]),
        exps_folder=str(Path(ranks[0][key]["checkpoints"]).parents[3]
                        / f"load{n_model}"),
        max_total_iters=RUNNER_STEPS, quiet=True, device="cpu")
    meta, _ = load_checkpoint(ranks[0][key]["checkpoints"], single.model,
                              single.optimizer, single.scheduler)
    assert meta["step"] == RUNNER_STEPS
    for k, v in single.model.state_dict().items():
        assert torch.equal(v, ranks[0][key]["state"][k]), k
    moments = {id(p): st for p, st in single.optimizer.state.items()}
    names = dict(single.model.named_parameters())
    for name, p in names.items():
        st = moments[id(p)]
        assert st["exp_avg"].shape == p.shape and float(st["step"]) == 3.0
        assert float(st["exp_avg_sq"].abs().max()) > 0, name
