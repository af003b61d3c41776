"""Standalone gaussian renderer CLI (counterpart of
holoscene_tpu/training/gs_render.py).

Loads a 3DGS checkpoint PLY and a dataset, renders the chosen split, writes
PNGs and a metrics JSON.

    python -m holoscene_tpu_torch.training.gs_render --ply scene.ply \
        --dataset ns --data_root path/to/scene_0 [--split test] [--out out/]
        [--renderer raster|trace] [--camera pinhole|opencv|fisheye]
        [--dist k1 k2 ...] [--max_hits 128] [--device cpu]

`--renderer raster` (default) goes through the top-K tile splat renderer
(K3 on the card); non-pinhole cameras, given with `--camera` / `--dist` or
carried by a COLMAP dataset, project through the unscented transform.
`--renderer trace` ray-traces the gaussians (ops/gs_trace.py, hit selection
by kernel T1 on the card) with pinhole or equidistant fisheye rays.
"""

from __future__ import annotations

import argparse
import json
import os
import warnings

import numpy as np
import torch
from PIL import Image

from holoscene_tpu_torch import as_tensor, resolve_device
from holoscene_tpu_torch.models.gom import read_gaussian_ply
from holoscene_tpu_torch.ops.gaussians import view_matrix
from holoscene_tpu_torch.ops.splat import (
    auto_max_per_tile,
    calibrate_max_per_tile,
    render_gaussians,
    tile_overlap_counts,
)
from holoscene_tpu_torch.utils.eval_rgb import eval_rgb


def gaussian_tensors(g: dict, dev: torch.device):
    """A gaussian dict (read_gaussian_ply) as the renderer's tensors:
    (means, quats, linear scales, opacities, SH [N, B, 3] with DC first)."""
    sh = as_tensor(np.concatenate(
        [np.asarray(g["features_dc"])[:, None, :],
         np.asarray(g["features_rest"])], axis=1), dev)
    return (as_tensor(g["means"], dev), as_tensor(g["quats"], dev),
            torch.exp(as_tensor(g["log_scales"], dev)),
            torch.sigmoid(as_tensor(g["opacity_logits"], dev).reshape(-1)),
            sh)


@torch.no_grad()
def pick_max_per_tile(means, quats, scales, opac, sh, viewmat, intr, w: int,
                      h: int, sh_degree: int, camera_model: str = "pinhole",
                      dist=None) -> int:
    """The compositing depth for one representative view: its p99 tile
    overlap (EWA, as the counterpart's probe), then the saturation
    calibration below that bound (through the view's own camera model)."""
    counts = tile_overlap_counts(means, quats, scales, viewmat, intr, w, h)
    return calibrate_max_per_tile(
        lambda k: render_gaussians(
            means, quats, scales, opac, sh, viewmat, intr, width=w, height=h,
            max_per_tile=int(k), sh_degree=sh_degree,
            camera_model=camera_model, dist=dist)["rgb"],
        hi=auto_max_per_tile(counts))


@torch.no_grad()
def render_views(g: dict, poses, intrinsics, img_res, sh_degree: int = 3,
                 max_per_tile: int = 0, camera_model: str = "pinhole",
                 dist=None, intrinsics_all=None,
                 device: str | torch.device = "cuda"):
    """Render [N,4,4] c2w poses of a gaussian dict (read_gaussian_ply) on a
    white background; yields [H,W,3] numpy images. max_per_tile <= 0 picks
    the compositing depth from view 0 (`pick_max_per_tile`). camera_model
    opencv / fisheye (coefficients in dist) projects through the unscented
    transform. intrinsics_all [N,3,3] renders each view with its own camera
    matrix (heterogeneous COLMAP reconstructions)."""
    dev = resolve_device(device)
    h, w = img_res
    means, quats, scales, opac, sh = gaussian_tensors(g, dev)
    intr = as_tensor(intrinsics, dev)
    if max_per_tile <= 0:
        max_per_tile = pick_max_per_tile(
            means, quats, scales, opac, sh, view_matrix(poses[0], dev), intr,
            w, h, sh_degree, camera_model, dist)

    white = torch.ones(3, device=dev)
    for vi, pose in enumerate(poses):
        k = intr if intrinsics_all is None \
            else as_tensor(intrinsics_all[vi], dev)
        out = render_gaussians(
            means, quats, scales, opac, sh, view_matrix(pose, dev), k,
            width=w, height=h, max_per_tile=max_per_tile,
            sh_degree=sh_degree, background=white,
            camera_model=camera_model, dist=dist)
        yield out["rgb"].cpu().numpy()


def trace_views(g: dict, poses, intrinsics, img_res, sh_degree: int = 3,
                camera: str = "pinhole", max_hits: int = 128,
                device: str | torch.device = "cuda"):
    """Ray-trace [N,4,4] c2w poses of a gaussian dict (ops/gs_trace.py,
    pinhole or equidistant fisheye rays); yields [H,W,3] numpy images
    (black where no gaussian is hit, as the counterpart)."""
    from holoscene_tpu_torch.ops.gs_trace import trace_image

    h, w = img_res
    for pose in poses:
        yield trace_image(g, pose, intrinsics, w, h, sh_degree=sh_degree,
                          camera=camera, max_hits=max_hits,
                          device=device)["rgb"]


def load_dataset(kind: str, data_root: str, max_num_images: int = -1):
    if kind == "nerf":
        from holoscene_tpu_torch.datasets.gs_datasets import (
            NerfSyntheticDataset,
        )

        return NerfSyntheticDataset(data_root, split="train",
                                    max_num_images=max_num_images)
    if kind == "colmap":
        from holoscene_tpu_torch.datasets.gs_datasets import ColmapDataset

        return ColmapDataset(data_root, max_num_images=max_num_images)
    from holoscene_tpu_torch.datasets.ns_dataset import NSDataset

    # NSDataset does not resize and wants the resolution named: take it
    # from the first image on disk
    root, name = os.path.split(os.path.normpath(data_root))
    images = sorted(os.listdir(os.path.join(data_root, "images")))
    if not images:
        raise FileNotFoundError(f"no images under {data_root}/images")
    with Image.open(os.path.join(data_root, "images", images[0])) as im:
        width, height = im.size
    return NSDataset(root, name, img_res=(height, width),
                     max_num_images=max_num_images)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ply", required=True)
    ap.add_argument("--dataset", choices=["nerf", "colmap", "ns"],
                    default="nerf")
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--split", default="test")
    ap.add_argument("--out", default="renders")
    ap.add_argument("--sh_degree", type=int, default=3)
    ap.add_argument("--max_per_tile", type=int, default=0,
                    help="0 = auto from p99 tile overlap")
    ap.add_argument("--max_num_images", type=int, default=-1)
    ap.add_argument("--renderer", choices=["raster", "trace"],
                    default="raster")
    ap.add_argument("--camera", choices=["pinhole", "opencv", "fisheye"],
                    default="pinhole",
                    help="raster routes non-pinhole models through the "
                         "unscented-transform projection; trace supports "
                         "pinhole and fisheye ray generation")
    ap.add_argument("--dist", type=float, nargs="*", default=None,
                    help="distortion coefficients: opencv k1 k2 p1 p2 [k3]; "
                         "fisheye k1 k2 k3 k4")
    ap.add_argument("--max_hits", type=int, default=128,
                    help="tracer hits per ray")
    ap.add_argument(
        "--device", type=str, default="cuda",
        help="torch device; 'cuda' launches the hand-written kernels and "
             "fails without a card, 'cpu' runs their plain versions")
    args = ap.parse_args(argv)
    if args.camera == "opencv" and args.renderer == "trace":
        ap.error("--camera opencv is raster-only (trace supports fisheye)")
    auto_camera = args.camera == "pinhole" and args.dist is None

    ds = load_dataset(args.dataset, args.data_root, args.max_num_images)
    if args.split == "test" and getattr(ds, "test", None):
        poses = ds.test["pose_all"]
        gts = ds.test["rgb_images"]
        intr_all = ds.test.get("intrinsics_all") \
            if isinstance(ds.test, dict) else None
    else:
        poses = ds.pose_all
        gts = ds.rgb_images
        intr_all = getattr(ds, "intrinsics_all", None)
    # heterogeneous per-view intrinsics only matter when they differ
    if intr_all is not None and np.allclose(intr_all, intr_all[0], rtol=1e-6):
        intr_all = None

    g = read_gaussian_ply(args.ply)
    os.makedirs(args.out, exist_ok=True)
    h, w = ds.img_res
    if args.renderer == "trace":
        if getattr(ds, "camera_model", "pinhole") != "pinhole":
            warnings.warn(
                f"dataset carries a {ds.camera_model} distortion model the "
                "trace renderer does not apply (trace supports pinhole and "
                "coefficient-free equidistant fisheye rays); metrics against "
                "the distorted ground truth will be depressed; use "
                "--renderer raster for the UT-projected distortion")
        images = trace_views(
            g, poses, ds.intrinsics[:3, :3], ds.img_res, args.sh_degree,
            args.camera, args.max_hits, device=args.device)
    else:
        camera = args.camera
        dist = tuple(args.dist) if args.dist else None
        if auto_camera and \
                getattr(ds, "camera_model", "pinhole") != "pinhole":
            # a COLMAP reconstruction carries its distortion model
            camera, dist = ds.camera_model, ds.dist
            print(f"[gs_render] dataset camera: {camera} dist={dist}")
        images = render_views(
            g, poses, ds.intrinsics[:3, :3], ds.img_res, args.sh_degree,
            args.max_per_tile, camera_model=camera, dist=dist,
            intrinsics_all=intr_all, device=args.device)
    metrics = []
    for i, img in enumerate(images):
        Image.fromarray(
            np.clip(img * 255, 0, 255).astype(np.uint8)
        ).save(os.path.join(args.out, f"render_{i:04d}.png"))
        m = eval_rgb(img, np.asarray(gts[i]).reshape(h, w, 3),
                     device=args.device)
        metrics.append(m)
        print(f"[{i}] psnr={m['psnr']:.2f} ssim={m['ssim']:.3f}")
    summary = {k: float(np.mean([m[k] for m in metrics]))
               for k in metrics[0]}
    with open(os.path.join(args.out, "metrics.json"), "w") as f:
        json.dump({"per_view": metrics, "mean": summary}, f, indent=2)
    print("mean:", summary)
    return summary


if __name__ == "__main__":
    main()
