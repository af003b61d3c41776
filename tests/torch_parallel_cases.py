"""Worker side of tests/test_torch_parallel.py: the steps that run on each
rank of a two-process gloo group on the CPU, and the same steps without a
mesh for the single-process references. Imports torch and the port only
(the spawned workers never import jax)."""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

from holoscene_tpu_torch.losses.holoscene_loss import LossConfig
from holoscene_tpu_torch.models import holoscene as ths
from holoscene_tpu_torch.parallel.mesh import (
    full_optimizer_state,
    make_mesh,
    shard_optimizer,
    shard_params,
)
from holoscene_tpu_torch.parallel.stage4_dp import make_stage4_dp_step
from holoscene_tpu_torch.training import stage1 as ts1

STAGE4_LR = 1e-3


def stage1_step(inp: dict, mesh=None, adam_steps: int = 0) -> dict:
    """One SGD (lr 1) Stage-1 step from inp's state on its global batch
    and draws (its occupancy grid updated when inp["occ"] is set), over
    `mesh` or in one process; with adam_steps, that many Adam steps
    (make_optimizer) instead, and the optimizer state as a single process
    holds it. Returns the metrics, the state dict after the step(s), the
    grid."""
    model = ths.init_holoscene(inp["cfg"])
    model.load_state_dict(inp["state"])
    shards = shard_params(mesh, model) if mesh is not None else {}
    if adam_steps:
        opt, sched = ts1.make_optimizer(model, 5e-4, 20.0, 100)
    else:
        opt, sched = torch.optim.SGD(model.parameters(), lr=1.0), None
    if mesh is not None:
        shard_optimizer(mesh, opt, model, shards)
    occ = inp.get("occ")
    for it in range(max(adam_steps, 1)):
        res = ts1.train_step(model, opt, sched, LossConfig(), inp["batch"],
                             inp["draws"], it, occ=occ,
                             update_occ=occ is not None, mesh=mesh,
                             shards=shards)
        if occ is not None:
            res, occ = res
    out = {"metrics": {k: float(v) for k, v in res.items()},
           "state": {k: v.detach().clone()
                     for k, v in model.state_dict().items()}, "occ": occ}
    if adam_steps:
        out["opt"] = (full_optimizer_state(mesh, opt, model, shards)
                      if mesh is not None else opt.state_dict())
    return out


def stage4_params(inp: dict) -> dict:
    return {k: v.detach().clone().requires_grad_(True)
            for k, v in inp["params"].items()}


def stage4_step(inp: dict, mesh, frame: int) -> dict:
    """The dp step (SGD, lr STAGE4_LR) on `frame` of inp's frames."""
    params = stage4_params(inp)
    opt = torch.optim.SGD(params.values(), lr=STAGE4_LR)
    step = make_stage4_dp_step(mesh, opt, inp["static"], inp["cfg"],
                               inp["plan"], inp["loss_scale"], inp["width"],
                               inp["height"])
    f = inp["frames"][frame]
    metrics, used, stale = step(params, f["pose"], f["intr"], f["image"],
                                f["acm"], f["mesh_depth"], f["bins"],
                                f["bg"])
    return {"params": {k: v.detach() for k, v in params.items()},
            "metrics": {k: float(v) for k, v in metrics.items()},
            "used": used, "stale": stale}


def stage1_runner(conf_path: str, exps: str, steps: int,
                  n_model: int = 1) -> dict:
    """`steps` steps of Stage1Runner on the CPU from conf_path (on the
    initialised process group's mesh when there is one)."""
    from holoscene_tpu_torch.config import ConfigFactory

    runner = ts1.Stage1Runner(ConfigFactory.parse_file(conf_path),
                              exps_folder=exps, max_total_iters=steps,
                              quiet=True, device="cpu", n_model=n_model)
    runner.run(log_every=1)
    return {"history": runner.history, "is_main": runner.is_main,
            "mesh": None if runner.mesh is None else runner.mesh.shape,
            "occ": runner.occ, "checkpoints": runner.checkpoints_path,
            "state": {k: v.detach().clone()
                      for k, v in runner.model.state_dict().items()}}


def run_worker(rank: int, world: int, port: int, in_path: str,
               out_dir: str) -> None:
    """Rank `rank` of a gloo group on 127.0.0.1:port: the dp-2 Stage-1
    step (occupancy update included), the model-2 step (SGD, then two Adam
    steps), the dp-2 Stage-4 step on the flat and the top-K path, and
    Stage1Runner over the group at dp 2 and at model 2; results to
    out_dir/rank{rank}.pt."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        inp = torch.load(in_path, weights_only=False)
        dp = make_mesh(world, 1)
        mp = make_mesh(1, world)
        res = {
            "stage1_dp": stage1_step({**inp["stage1"],
                                      "occ": inp["stage1_occ"]}, dp),
            "stage1_model": stage1_step(inp["stage1"], mp),
            "stage1_model_adam": stage1_step(inp["stage1"], mp,
                                             adam_steps=2),
            "stage4_dp": stage4_step(inp["stage4"], dp, rank),
            "stage4_dp_topk": stage4_step(inp["stage4_topk"], dp, rank),
            "mesh": (mp.shape, mp.data_index, mp.model_index),
        }
        for n_model in (1, world):
            res[f"runner_model{n_model}"] = stage1_runner(
                inp["runner_conf"], f"{out_dir}/exps_model{n_model}",
                inp["runner_steps"], n_model)
        torch.save(res, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()
