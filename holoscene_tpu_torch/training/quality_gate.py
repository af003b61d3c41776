"""The 2500-iteration synthetic quality gate of Stage 1 (the port's
counterpart of scripts/tpu_quality_run.py with the stack that
scripts/tpu_queue_r5c.sh's `gate_probe` run passes it): train on the
synthetic scene, then report the eval PSNR of frame 0 and the chamfer of
the extracted background mesh against the analytic room.

    python -m holoscene_tpu_torch.training.quality_gate [--iters 2500] \
        [--res 128] [--work DIR] [--device cuda] [--seed 0]

The scene: 16 images at --res^2 (datasets/synthetic.py::generate_scene,
written once under --work). The model: confs/synthetic.conf at 12 levels,
logmap 17, end 512, MLPs 128 x 2, feature 128, 1024 rays a step; the
sampler 48 / 96 / 24 with 4 rounds and probes at 8 levels; top-56
samples, the fine tier 32 at 6 levels, the fused gradient mode with the
colour and SDF tables' sampled backward, the probe grid 128^3 re-baked
every 16 steps; --seed seeds the model's init, the rays' draws and the
pixel batches (the scene is the same at every seed). Then plot(it=iters)
(eval PSNR), extract_meshes(resolution 96, no pruning, nothing written)
and calc_3d_metric of mesh 0 against the room, -(max|x| - 1/1.3) on a
64^3 grid, without alignment.

Printed on lines of their own: the loss every 250 steps, "train wall: S s",
"FINAL eval psnr: P", "bg chamfer: {...}" and "mesh k: F faces". main
returns {"psnr", "chamfer", "faces", "train_seconds", "history"}.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

from holoscene_tpu_torch.config import ConfigFactory
from holoscene_tpu_torch.datasets.synthetic import generate_scene
from holoscene_tpu_torch.training.stage1 import Stage1Runner
from holoscene_tpu_torch.utils.eval_geometry import calc_3d_metric
from holoscene_tpu_torch.utils.mc import marching_tetrahedra
from holoscene_tpu_torch.utils.mesh import Mesh

CONF = Path(__file__).resolve().parents[2] / "confs" / "synthetic.conf"
ROOM_SCALE = 1.3     # the synthetic scene's normalisation (room half 1/1.3)

# the gate's widths (scripts/tpu_quality_run.py) and its shipped stack
# (scripts/tpu_queue_r5c.sh gate_probe), as conf keys
GATE_CONF = {
    "train.num_pixels": 1024,
    "train.checkpoint_freq": 500,
    "model.implicit_network.num_levels": 12,
    "model.implicit_network.logmap": 17,
    "model.implicit_network.end_size": 512,
    "model.implicit_network.dims": [128, 128],
    "model.implicit_network.feature_vector_size": 128,
    "model.feature_vector_size": 128,
    "model.rendering_network.dims": [128, 128],
    "model.ray_sampler.N_samples": 48,
    "model.ray_sampler.N_samples_eval": 96,
    "model.ray_sampler.N_samples_extra": 24,
    "model.ray_sampler.max_total_iters": 4,
    "model.sampler_grid_levels": 8,
    "model.render_top_m": 56,
    "model.render_fine_top_f": 32,
    "model.render_fine_levels": 6,
    "model.forward_grad_mode": "fused",
    "model.implicit_network.grid_interp": "trilinear",
    "model.implicit_network.fused_fetch": "packed",
    "model.implicit_network.color_bwd_sample": True,
    "model.implicit_network.sdf_bwd_sample": True,
    "model.implicit_network.dense_max_res": 0,
    "model.probe_grid_res": 128,
    "model.probe_update_every": 16,
}


def analytic_room() -> Mesh:
    """The synthetic scene's room as the JAX gate builds it: marching
    tetrahedra of -(max|x| - 1/1.3) on a 64^3 grid over [-1, 1]^3."""
    ax = np.linspace(-1, 1, 64)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    room = -(np.maximum.reduce([abs(x), abs(y), abs(z)]) - 1.0 / ROOM_SCALE)
    v, f = marching_tetrahedra(room, origin=(-1,) * 3, spacing=(2 / 63,) * 3)
    return Mesh(v, f)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--iters", type=int, default=2500)
    parser.add_argument("--res", type=int, default=128,
                        help="image resolution of the synthetic scene")
    parser.add_argument("--work", type=str, default="quality_gate_work",
                        help="directory for the scene and the run")
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="torch device; 'cuda' launches the hand-written kernels and "
             "fails without a card, 'cpu' runs their plain versions")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the model's init and the draws")
    args = parser.parse_args(argv)

    work = Path(args.work).resolve()
    data = work / "data"
    if not (data / "scene_0" / "transforms.json").exists():
        generate_scene(str(data / "scene_0"), n_images=16,
                       img_res=(args.res, args.res))
    conf = ConfigFactory.parse_file(str(CONF))
    conf.put("dataset.img_res", [args.res, args.res])
    for key, value in GATE_CONF.items():
        conf.put(key, value)
    runner = Stage1Runner(conf, exps_folder=str(work / "exps"),
                          data_root_override=str(data), device=args.device,
                          seed=args.seed)
    cfg = runner.model_cfg
    print(f"quality run: top_m={cfg.render_top_m} "
          f"grad_mode={cfg.forward_grad_mode} "
          f"fine={cfg.render_fine_top_f}/{cfg.render_fine_levels} "
          f"color_bwd_sample={cfg.implicit.color_bwd_sample} "
          f"sdf_bwd_sample={cfg.implicit.sdf_bwd_sample} "
          f"probe_grid={cfg.probe_grid_res}/{cfg.probe_update_every} "
          f"device={runner.device} seed={args.seed}", flush=True)

    t0 = time.time()
    runner.run(n_iters=args.iters, log_every=250)
    train_seconds = time.time() - t0
    print(f"train wall: {train_seconds:.0f}s", flush=True)
    psnr = runner.plot(it=args.iters)["psnr"]
    print(f"FINAL eval psnr: {psnr:.2f}", flush=True)

    meshes = runner.extract_meshes(resolution=96, prune=False, save=False)
    chamfer = None
    if meshes[0] is not None:
        chamfer = calc_3d_metric(meshes[0], analytic_room(), n_samples=30000,
                                 align=False)
        print(f"bg chamfer: {chamfer}", flush=True)
    faces = [None if m is None else len(m.faces) for m in meshes]
    for i, n in enumerate(faces):
        print(f"mesh {i}: {'None' if n is None else n} faces", flush=True)
    return {"psnr": psnr, "chamfer": chamfer, "faces": faces,
            "train_seconds": train_seconds, "history": runner.history}


if __name__ == "__main__":
    main()
