"""Stage-3 CLI of the port (counterpart of
holoscene_tpu/training/exp_runner_texture.py; reference
training/exp_runner_texture.py).

    python -m holoscene_tpu_torch.training.exp_runner_texture \
        --conf confs/replica_room0_tex.conf [--exps_folder exps] \
        [--timestamp latest] [--data_root DIR] [--max_niters 5000] \
        [--texture_res 2048] [--quiet] [--device cuda]

Loads the Stage-2 meshes (coarse_recon_obj_{i}.ply, which
`python -m holoscene_tpu_torch.training.exp_runner_post` writes) from
<exps_folder>/<train.expname>/<timestamp>/plots, trains each object's
colour field (the background --max_niters iterations, each object a tenth)
and bakes surface_{i}.obj/.mtl/.png there. --device defaults to cuda (the
hand-written kernels; it fails without a card); --device cpu runs their
plain versions.
"""

from __future__ import annotations

import argparse
import glob
import os

from holoscene_tpu_torch.config import ConfigFactory
from holoscene_tpu_torch.datasets.ns_dataset import NSDataset
from holoscene_tpu_torch.training import checkpoints as ckpt_lib
from holoscene_tpu_torch.training.stage3 import Stage3Runner
from holoscene_tpu_torch.utils.mesh import read_ply


def main(argv=None) -> Stage3Runner:
    """Runs Stage 3; returns the runner (the written paths in
    `runner.paths`, the wall table by part in `runner.timer`)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--conf", type=str, required=True)
    parser.add_argument("--exps_folder", type=str, default="exps")
    parser.add_argument("--timestamp", type=str, default="latest")
    parser.add_argument("--data_root", type=str, default=None)
    parser.add_argument("--max_niters", type=int, default=5000)
    parser.add_argument("--texture_res", type=int, default=2048)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="torch device; 'cuda' launches the hand-written kernels and "
             "fails without a card, 'cpu' runs their plain versions")
    args = parser.parse_args(argv)

    conf = ConfigFactory.parse_file(args.conf)
    dataset_conf = conf.get_config("dataset").as_plain_dict()
    if args.data_root:
        dataset_conf["data_root_dir"] = args.data_root
    dataset = NSDataset(**dataset_conf)

    expname = conf.get_string("train.expname", "holoscene")
    expdir = os.path.join(args.exps_folder, expname)
    timestamp = (
        ckpt_lib.latest_timestamp(expdir)
        if args.timestamp == "latest"
        else args.timestamp
    )
    plots_dir = os.path.join(expdir, timestamp, "plots")

    mesh_paths = sorted(
        glob.glob(os.path.join(plots_dir, "coarse_recon_obj_*.ply")),
        key=lambda p: int(p.rsplit("_", 1)[1].split(".")[0]),
    )
    assert mesh_paths, f"no Stage-2 meshes under {plots_dir}"
    meshes = [read_ply(p) for p in mesh_paths]
    print(f"[stage3] {len(meshes)} meshes from {plots_dir}")

    runner = Stage3Runner(
        meshes, dataset,
        lr=conf.get_float("train.learning_rate", 5e-4),
        lr_factor_for_grid=conf.get_float("train.lr_factor_for_grid", 20.0),
        max_total_iters=args.max_niters,
        out_dir=plots_dir,
        texture_res=args.texture_res,
        quiet=args.quiet,
        device=args.device,
    )
    runner.paths = runner.run()
    return runner


if __name__ == "__main__":
    main()
