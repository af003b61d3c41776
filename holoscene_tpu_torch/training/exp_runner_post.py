"""Stage-2 CLI of the port (counterpart of
holoscene_tpu/training/exp_runner_post.py; reference
training/exp_runner_post.py).

    python -m holoscene_tpu_torch.training.exp_runner_post \
        --conf confs/replica_room0_post.conf [--exps_folder exps] \
        [--timestamp latest] [--checkpoint latest] [--data_root DIR] \
        [--finetune_iters N] [--mesh_resolution 256] [--quiet] \
        [--device cuda]

Loads the Stage-1 checkpoint from
<exps_folder>/<train.expname>/<timestamp>/checkpoints (written by `python
-m holoscene_tpu_torch.training.exp_runner` as .pth, or by the JAX
package's exp_runner as .msgpack; training/checkpoints.py reads both) and
runs Stage 2;
the artifacts land in the run's plots dir (coarse_recon_obj_{i}.ply,
vis_info_{i}.pkl, bg_info.pkl, graph_node_dict.pkl, translation_dict.pkl,
scene_settle.json — the reference layout). --finetune_iters 0 or absent
runs the conf's iterations (FinetuneConfig.iters, 500), as JAX does.
--device defaults to cuda (the hand-written kernels; it fails without a
card); --device cpu runs their plain versions. The physics provider is
HOLOSCENE_PHYSICS's (auto: MuJoCo where it imports, else quasi-static).
"""

from __future__ import annotations

import argparse
import os

from holoscene_tpu_torch import resolve_device
from holoscene_tpu_torch.config import ConfigFactory
from holoscene_tpu_torch.datasets.ns_dataset import NSDataset
from holoscene_tpu_torch.losses.holoscene_loss import LossConfig
from holoscene_tpu_torch.models.holoscene import HoloSceneConfig, init_holoscene
from holoscene_tpu_torch.stage2.refine import FinetuneConfig
from holoscene_tpu_torch.stage2.runner import Stage2Runner
from holoscene_tpu_torch.training import checkpoints as ckpt_lib


def add_run_args(parser: argparse.ArgumentParser,
                 mesh_resolution: int) -> None:
    """The flags that pick a Stage-1 run and build a Stage2Runner on it
    (shared with stage2/mv_predict.py)."""
    parser.add_argument("--conf", type=str, required=True)
    parser.add_argument("--exps_folder", type=str, default="exps")
    parser.add_argument("--timestamp", type=str, default="latest")
    parser.add_argument("--checkpoint", type=str, default="latest")
    parser.add_argument("--data_root", type=str, default=None)
    parser.add_argument("--mesh_resolution", type=int,
                        default=mesh_resolution)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="torch device; 'cuda' launches the hand-written kernels and "
             "fails without a card, 'cpu' runs their plain versions")


def build_stage2_runner(args, tag: str = "stage2"
                        ) -> tuple[Stage2Runner, str]:
    """(Stage2Runner on the port's Stage-1 checkpoint that `args` of
    add_run_args picks, that run's directory)."""
    device = resolve_device(args.device)
    conf = ConfigFactory.parse_file(args.conf)
    dataset_conf = conf.get_config("dataset").as_plain_dict()
    if args.data_root:
        dataset_conf["data_root_dir"] = args.data_root
    dataset_conf.pop("depth_type", None)
    dataset = NSDataset(**dataset_conf)
    conf.put("model.implicit_network.d_out", len(dataset.label_mapping))

    expname = conf.get_string("train.expname", "holoscene")
    expdir = os.path.join(args.exps_folder, expname)
    timestamp = (ckpt_lib.latest_timestamp(expdir)
                 if args.timestamp == "latest" else args.timestamp)
    if not timestamp:
        raise FileNotFoundError(f"no Stage-1 run found under {expdir}")
    rundir = os.path.join(expdir, timestamp)

    model_cfg = HoloSceneConfig.from_conf(conf.get_config("model"))
    model = init_holoscene(model_cfg, 0, device)
    meta, _ = ckpt_lib.load_checkpoint(
        os.path.join(rundir, "checkpoints"), model, checkpoint=args.checkpoint)
    if not args.quiet:
        print(f"[{tag}] loaded Stage-1 checkpoint step="
              f"{meta.get('step', '?')} on {device}", flush=True)

    runner = Stage2Runner(
        model, model_cfg, dataset,
        out_dir=os.path.join(rundir, "plots"),
        loss_cfg=LossConfig.from_conf(conf.get_config("loss")),
        finetune_cfg=FinetuneConfig.from_conf(conf),
        mesh_resolution=args.mesh_resolution,
        quiet=args.quiet,
        device=device,
    )
    return runner, rundir


def main(argv=None) -> Stage2Runner:
    """Runs Stage 2; returns the runner, its run's result in
    `runner.result` and the wall table by part in `runner.timer`."""
    parser = argparse.ArgumentParser()
    add_run_args(parser, mesh_resolution=256)
    parser.add_argument("--finetune_iters", type=int, default=None)
    args = parser.parse_args(argv)
    runner, _ = build_stage2_runner(args)
    runner.result = runner.run(finetune_iters=args.finetune_iters)
    if not args.quiet:
        print(f"[stage2] physics {runner.result['physics']}; wall s by "
              f"part:\n{runner.timer.table()}", flush=True)
    return runner


if __name__ == "__main__":
    main()
