"""Standalone multiview prediction (port of holoscene_tpu/stage2/mv_predict.py,
the analog of the reference's top-level `run_mv_prediction.py` :316-808):
precompute each object's novel views off the training loop and write them
as vis_info caches that `CachedArtifactNovelViewProvider` (and Stage 2
through HOLOSCENE_VIEW_CACHE) replays later.

    python -m holoscene_tpu_torch.stage2.mv_predict \
        --conf confs/replica_room0_post.conf [--exps_folder exps] \
        [--timestamp latest] [--checkpoint latest] [--data_root DIR] \
        [--mesh_resolution 64] [--out <rundir>/plots/mv_cache] \
        [--seeds 42 3 7] [--objects 1 2] [--quiet] [--device cuda]

Loads the port's own Stage-1 checkpoint and builds a Stage2Runner on it
with training/exp_runner_post.py's `build_stage2_runner`, on --device (default cuda: the hand-written
kernels, no CPU fallback; --device cpu runs their plain versions),
extracts the per-object meshes and asks whichever novel-view provider is
attached (default_providers: the live Wonder3D+ denoiser behind
HOLOSCENE_W3D_CKPT, a recorded cache, or the model-render fallback) for
each object's views of the Wonder3D rig.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from holoscene_tpu_torch.stage2.providers import save_vis_info
from holoscene_tpu_torch.training.exp_runner_post import (
    add_run_args, build_stage2_runner)


def main(argv=None) -> list[str]:
    """Writes <out>/vis_info_{i}.pkl for every object with a mesh (or
    those of --objects) whose provider returned views; returns the paths
    written."""
    ap = argparse.ArgumentParser()
    add_run_args(ap, mesh_resolution=64)
    ap.add_argument("--out", default=None,
                    help="cache dir (default <rundir>/plots/mv_cache)")
    ap.add_argument("--seeds", type=int, nargs="+", default=[42, 3, 7])
    ap.add_argument("--objects", type=int, nargs="*", default=None)
    args = ap.parse_args(argv)
    runner, rundir = build_stage2_runner(args, tag="mv_predict")
    runner.seeds = list(args.seeds)

    out_dir = args.out or os.path.join(rundir, "plots", "mv_cache")
    os.makedirs(out_dir, exist_ok=True)

    meshes = runner.extract_meshes()
    obj_ids = args.objects or [
        i for i in range(1, len(meshes)) if meshes[i] is not None]
    written = []
    for obj_i in obj_ids:
        mesh = meshes[obj_i]
        if mesh is None:
            continue
        b = mesh.bounds
        half_extent = float(np.linalg.norm(b[1] - b[0]) / 2 * 1.3)
        packs = runner.generate_novel_views(obj_i, mesh, half_extent)
        if not packs:
            print(f"[mv_predict] obj {obj_i}: provider returned no views")
            continue
        path = os.path.join(out_dir, f"vis_info_{obj_i}.pkl")
        save_vis_info(path, packs)
        written.append(path)
        if not args.quiet:
            print(f"[mv_predict] obj {obj_i}: {len(packs)} views -> {path}")

    print(f"[mv_predict] wrote {len(written)} caches to {out_dir} "
          f"(replay via HOLOSCENE_VIEW_CACHE={out_dir})")
    return written


if __name__ == "__main__":
    main()
