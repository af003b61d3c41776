"""Standalone free-Gaussian-splatting trainer CLI (port of
holoscene_tpu/training/gs_train.py): dataset in, trained gaussians, eval
metrics and an exported artifact out, with checkpoint / resume.

    python -m holoscene_tpu_torch.training.gs_train --dataset nerf \
        --data_root path/to/lego --iters 3000 --out out_dir \
        [--strategy mcmc] [--capacity 100000] [--export scene.ply|.usdz|.ingp]
        [--resume]            # continue from out_dir/ckpt.pkl
        [--device cpu]        # default cuda: the hand-written kernels

`--iters` counts from 0: with `--resume` the run continues from the
checkpoint's iteration up to `--iters`. A COLMAP reconstruction with a
distortion model (OPENCV, OPENCV_FISHEYE, ...) trains through it (the
unscented-transform projection).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from holoscene_tpu_torch.training.gs_render import load_dataset


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", choices=["nerf", "colmap", "ns"],
                    default="nerf")
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--out", default="gs_out")
    ap.add_argument("--iters", type=int, default=3000)
    ap.add_argument("--capacity", type=int, default=100_000)
    ap.add_argument("--strategy", choices=["splatfacto", "mcmc"],
                    default="splatfacto")
    ap.add_argument("--sh_degree", type=int, default=3)
    ap.add_argument("--refine_every", type=int, default=100)
    ap.add_argument("--warmup", type=int, default=500)
    ap.add_argument("--eval_every", type=int, default=0)
    ap.add_argument("--log_every", type=int, default=50,
                    help="steps between history entries (loss, PSNR)")
    ap.add_argument("--ckpt_every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--export", default="scene.ply",
                    help=".ply / .usdz / .ingp (the extension picks the "
                         "backend)")
    ap.add_argument("--max_num_images", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument(
        "--device", type=str, default="cuda",
        help="torch device; 'cuda' launches the hand-written kernels and "
             "fails without a card, 'cpu' runs their plain versions")
    return ap.parse_args(argv)


def build_trainer(args: argparse.Namespace):
    """The dataset and a fresh GSTrainer as the command line's arguments
    set them up (seed points from the dataset where it has them)."""
    from holoscene_tpu_torch.models.gaussians_free import FreeGaussianConfig
    from holoscene_tpu_torch.training.gs_trainer import GSTrainer

    ds = load_dataset(args.dataset, args.data_root, args.max_num_images)
    seed_pts = seed_cols = None
    # COLMAP reconstructions without points3D.bin fall back to random init
    if hasattr(ds, "seed_points") and \
            getattr(ds, "points_xyz", True) is not None:
        seed_pts, seed_cols = ds.seed_points(min(args.capacity, 50_000))

    # a COLMAP camera's distortion model is trained through (UT)
    cam = getattr(ds, "camera_model", "pinhole")
    dist = getattr(ds, "dist", None)
    if cam != "pinhole" and not args.quiet:
        print(f"[gs_train] dataset camera: {cam} dist={dist}")
    trainer = GSTrainer(
        ds, FreeGaussianConfig(capacity=args.capacity,
                               sh_degree=args.sh_degree,
                               camera_model=cam, dist=dist),
        seed_points=seed_pts, seed_colors=seed_cols,
        warmup=args.warmup, refine_every=args.refine_every,
        strategy=args.strategy, seed=args.seed, quiet=args.quiet,
        device=args.device,
    )
    return trainer, ds


def main(argv=None):
    args = parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    trainer, ds = build_trainer(args)
    ckpt = os.path.join(args.out, "ckpt.pkl")
    if args.resume and os.path.exists(ckpt):
        trainer.load_checkpoint(ckpt)
        print(f"[gs_train] resumed at iter {trainer.iter_step}")

    remaining = max(args.iters - trainer.iter_step, 0)
    if remaining:
        trainer.run(remaining, log_every=args.log_every,
                    eval_every=args.eval_every, ckpt_every=args.ckpt_every,
                    ckpt_path=ckpt)
    trainer.save_checkpoint(ckpt)

    metrics = trainer.eval_split("test" if ds.test else "train")
    with open(os.path.join(args.out, "eval.json"), "w") as f:
        json.dump(metrics, f, indent=1)
    art = trainer.export(os.path.join(args.out, args.export))
    n_alive = int(np.asarray(trainer.state["alive"].cpu()).sum())
    print(f"[gs_train] done: {n_alive} gaussians, "
          f"psnr {metrics['psnr']:.2f} ssim {metrics['ssim']:.3f} -> {art}")
    trainer.metrics = metrics
    return trainer


if __name__ == "__main__":
    main()
