"""Stage-4 CLI of the port (counterpart of
holoscene_tpu/training/exp_runner_gaussian.py).

Loads Stage-3 textured meshes (surface_{i}.obj, else the Stage-2
coarse_recon_obj_{i}.ply) from exps/<expname>/<timestamp>/plots, trains
Gaussian-on-Mesh appearance on --device (default cuda; there is no CPU
fallback), prints test PSNR/SSIM/LPIPS and exports gauss_obj_{i}.ply,
gauss_scene.ply and gauss_scene.usdz next to the meshes.

    python -m holoscene_tpu_torch.training.exp_runner_gaussian \
        --conf confs/synthetic.conf --exps_folder exps --max_niters 2000
"""

from __future__ import annotations

import argparse
import glob
import os

from holoscene_tpu_torch.config import ConfigFactory
from holoscene_tpu_torch.datasets.ns_dataset import NSDataset
from holoscene_tpu_torch.models.gom import GoMConfig
from holoscene_tpu_torch.training.checkpoints import latest_timestamp
from holoscene_tpu_torch.training.stage4 import Stage4Runner
from holoscene_tpu_torch.utils.mesh import read_obj, read_ply


def _sorted_by_index(paths):
    return sorted(paths, key=lambda p: int(p.rsplit("_", 1)[1].split(".")[0]))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--conf", type=str, required=True)
    parser.add_argument("--exps_folder", type=str, default="exps")
    parser.add_argument("--timestamp", type=str, default="latest")
    parser.add_argument("--data_root", type=str, default=None)
    parser.add_argument("--max_niters", type=int, default=None)
    parser.add_argument("--area_to_subdivide", type=float, default=1e-5)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument(
        "--use_pallas", default=None, action="store_true",
        help="accepted so that the JAX package's command line runs; a "
             "no-op: the kernels K1-K4 are the port's one compositor")
    parser.add_argument(
        "--max_per_tile", type=int, default=0,
        help="top-K compositing depth per tile; 0 = auto-pick (p99 tile "
             "overlap + saturation calibration; 256 for the invisible-view "
             "renders of the flat trainer)")
    parser.add_argument("--log_every", type=int, default=20,
                        help="record (and print) the metrics every N steps")
    parser.add_argument(
        "--rebin_every", type=int, default=8,
        help="flat-path per-frame-visit bin refresh cadence")
    parser.add_argument(
        "--rebin_drift_px", type=float, default=0.0,
        help="adaptive rebinning: rebin on > this many px of measured "
             "projected drift (0 = fixed cadence)")
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
    timestamp = (latest_timestamp(expdir) if args.timestamp == "latest"
                 else args.timestamp)
    if timestamp is None:
        raise FileNotFoundError(f"no run directory under {expdir}")
    plots_dir = os.path.join(expdir, timestamp, "plots")

    obj_paths = _sorted_by_index(
        glob.glob(os.path.join(plots_dir, "surface_*.obj")))
    if obj_paths:
        meshes = [read_obj(p) for p in obj_paths]
    else:  # untextured Stage-2 meshes
        ply_paths = _sorted_by_index(
            glob.glob(os.path.join(plots_dir, "coarse_recon_obj_*.ply")))
        if not ply_paths:
            raise FileNotFoundError(f"no meshes under {plots_dir}")
        meshes = [read_ply(p) for p in ply_paths]
    print(f"[stage4] {len(meshes)} meshes from {plots_dir}")

    runner = Stage4Runner(
        meshes, dataset,
        cfg=GoMConfig(use_pallas=args.use_pallas,
                      max_per_tile=args.max_per_tile,
                      rebin_every=args.rebin_every,
                      rebin_drift_px=args.rebin_drift_px),
        area_to_subdivide=args.area_to_subdivide,
        max_total_iters=args.max_niters,
        out_dir=plots_dir,
        quiet=args.quiet,
        device=args.device,
    )
    runner.run(log_every=args.log_every)
    runner.test_metrics = runner.eval_split("test")
    print(f"[stage4] test: {runner.test_metrics}")
    runner.export()
    return runner


if __name__ == "__main__":
    main()
