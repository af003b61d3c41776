#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (holoscene_tpu_torch) runs on an
NVIDIA GPU: builds the hand-written kernels, holds each against its plain
PyTorch version, then drives the Stage-4 Gaussian-on-Mesh paths through their
entry points at full width (512^2 frames, >= 100k gaussians, SH degree 3),
the Stage-1 neural-SDF trainer through its CLI at the flagship width, the
mesh extraction of its run, the synthetic quality gate's path, the
multiview prediction (mv_predict) and Stage 2 (per-object refinement
checked by physics) through their CLIs on a Stage-1 run's checkpoint,
Stage 3 (per-object texture baking) through its CLI on Stage 2's output,
the scene export CLI on the result, and the rest of the chain: Stage 0's
priors and Stage 4 on Stage 3's textured meshes, with the chain record;
then the free-Gaussian trainer (gs_train) at its CLI's defaults, the
Gaussian ray tracer behind gs_render --renderer trace with its kernel T1,
the unscented-transform camera and the viewer; last the camera refinement,
the physics grid and LPIPS against the CPU, the Stage-1 occupancy grid
through the CLI, and Stage 1 and Stage 4 over torch.distributed ranks
against the single-process steps; and the Stage-1 network variants (the
tetrahedral stencil and its extraction, the raw fetch, the jvp gradient
mode, no colour grid with the nerf head) through the CLI; and last that
two runs of Stage 1 and of a Stage-2 finetune from one seed give the same
bits.

    python3 chip_smoke.py        # from the repository root, one GPU

Phases, one '== ' line each:
  1 environment  torch / CUDA versions and the card (nvidia-smi name, power
                 limit); refuses to run without CUDA
  2 build        nvcc csrc/*.cu -> holoscene_tpu_torch/build (seconds)
  3 kernels      K1-K4 vs their plain versions on a random 128^2 scene
  4 flat slice   exp_runner_gaussian.main on a generated 512^2 scene: every
                 loss finite, l1 falls, K1/K2 launched every step, eval PSNR
                 finite, exports written; steps/s and splats/s
  5 top-K slice  Stage4Runner(GoMConfig(use_flat=False, max_per_tile=0)) on
                 the same scene: the calibrated K, every loss finite, l1
                 falls, K3/K4 launched every step; steps/s and splats/s
  6 invisible    analytic orthographic 256^2 packs of the two spheres loaded
                 into a flat runner: K1/K2 and K3/K4 launched every
                 iteration, the invisible-view l1 finite, and falling on
                 fixed probe views (each step's own l1 is taken against a
                 random background, whose draw moves it more than training
                 does)
  7 gs_render    the renderer CLI on the exported gauss_scene.ply: PNGs and
                 metrics.json written, PSNR finite, K3 launched per view
  8 kernels      K1-K4 vs plain again, at one training frame's shapes (max
                 abs error, kernel ms beside plain ms and the card's bound;
                 for every kernel the time of the walk its redesign
                 replaced, and the histogram of chunks walked per tile),
                 and K3/K4 vs plain on the lists of the two other
                 paths that launch them: one orthographic pack view as the
                 invisible-view step renders it (one object's gaussians
                 visible) and one gs_render view of the exported ply at its
                 calibrated K
  9 hash kernels H1-fwd, H1-bwd (exact / sampled / sampled_all) and H2 vs
                 their plain versions on random tables at a 6-level meta
                 and at the flagship meta (16 levels, 2^19 rows); H1 in
                 exact mode at the background patch's 100,352 points
 10 Stage-1 CLI  exp_runner.main on a generated 512^2 scene (8 images) with
                 the flagship model (bench.py::flagship_config, d_out from
                 the scene) and the train values of
                 confs/replica_room0_tpu.conf (the background regulariser
                 every 10th step, as that conf sets it), 100 steps: every
                 loss finite, rgb_loss falls, background_reg_loss > 0 on
                 the background steps whose patch sees an object (0 by its
                 definition where none does) and 0 on the other steps,
                 probe grid baked at steps 0
                 and 64, H1-fwd and H1-bwd launched three times a step (fine
                 tier, tail, eikonal) plus once a background step (the
                 patch), H2 on every bake chunk and in each patch's sampler;
                 then one eval frame (PSNR finite, H2 and H1-fwd launched);
                 rays/s
 10b conf defaults the same scene through the CLI with the model section of
                 confs/replica_room0.conf (the vjp gradient mode, untiered,
                 no probe grid, 5 sampler rounds, the background
                 regulariser) at the flagship widths, 40 steps: every loss
                 finite, rgb_loss falls, H1-bwd in exact mode on every call,
                 two H1 calls a step plus the patch's; rays/s; then H2
                 against plain at the run's first sampler call (1024 rays
                 x 129 points, 16 levels): kernel ms, plain ms, bound
 12 meshes      right after phase 10's eval frame, on its trained runner:
                 Stage1Runner.extract_meshes() at the conf's
                 plot.resolution 512 (confs/replica_room0_tpu.conf's plot
                 section), pruning on: the coarse 64^3 sweep and each
                 object's fine grid evaluated through H2 (packed), launched
                 exactly once per 262,144-point chunk and H1 never; marching
                 tetrahedra on the host (C++), visibility pruning in the 8
                 training views; surface_100_{k}.ply and bbox/bbox_{k}.json
                 written, the room's mesh non-empty; the room's chamfer
                 against the analytic room (printed, no threshold after 100
                 steps); the wall table of the parts and the peak device
                 memory; H2's time summed over the extraction's launches,
                 its grid evaluations replayed after it (CUDA events around
                 each launch, after a spin of the card that outlasts the
                 host's enqueue), so the wall table is untimed. Then H2
                 (packed) against plain on chunk 256 of the 512^3 grid (a
                 mid-grid x-plane) and on its last chunk (the x01 = 1
                 plane) at the flagship meta (kernel ms, plain ms, bound,
                 and at the last chunk the time of the kernel its redesign
                 replaced), and the grid evaluator against
                 implicit_sdf_raw (H1-fwd) on the last chunk, within 1e-5
                 of the largest |SDF|
 11 bench shapes the train step at bench.py's flagship_config (d_out 32,
                 a random batch as bench.py::make_batch draws it): 3
                 warm-up + 20 timed steps, rays/s; the device's idle share
                 from torch.profiler over 3 steps; H1-fwd / H1-bwd at the
                 fine tier's captured points and H2 at a probe-bake chunk:
                 kernel ms, plain ms, bound, and the time of the kernels
                 their redesign replaced; then H1-fwd / H1-bwd at every H1 call of the last
                 warm-up step, a background step (fine tier, tail, eikonal,
                 patch), with the step's own cotangents: kernel ms and
                 bound
 13 quality gate the 2500-iteration synthetic gate's code path, short:
                 training/quality_gate.main at 200 iterations on the card
                 (16 images at 128^2, the gate's widths and stack): eval
                 PSNR finite and above iteration 0's training PSNR, the
                 background chamfer finite, H1-fwd / H1-bwd / H2 launched
 14a mv_predict  stage2/mv_predict.main on phase 10b's checkpoint with the
                 post conf's sections (as phase 14), --mesh_resolution
                 128, --seeds 42 3 7, the model-render novel-view provider:
                 a cache written for every object with a mesh, each
                 loading six views with pose, rgb, normal and mask; H2 and
                 H1-fwd launched, H1-bwd never; wall time and launches.
                 H1-fwd / H1-bwd (exact) at the renders' first H1 call and
                 H2 at their first unpacked sampler call, recorded in the
                 run, against plain: kernel ms, plain ms, bound.
                 Then DiffusersNovelViewProvider (the TorchScript joint
                 denoiser route) with a scripted stand-in denoiser on the
                 card against the CPU from a cache's front view: rgb and
                 normals within 1e-5, masks apart on at most 0.1% of the
                 pixels. Phase 14 does not replay these caches
 14 Stage 2      training/exp_runner_post.main on phase 10b's checkpoint
                 (its model section is the post conf's: vjp, no probe
                 grid, 5 sampler rounds) with the loss, invis_loss and
                 model sections of confs/replica_room0_post.conf, the
                 dataset pointed at the generated 512^2 scene (d_out from
                 it), --mesh_resolution 128 (half the CLI's default, a
                 cut to stay in time, as phase 14a's), --finetune_iters 60
                 of the conf's 500 an object (a cut to stay in time),
                 physics quasi-static (set here, so nothing
                 downgrades silently): every finetune loss finite,
                 invis_loss and collision_loss on the object steps, H1-fwd
                 and H1-bwd launched 3 times a background step and 4 an
                 object step (render, eikonal points, [invisible render,]
                 collision points), H2 in every step and once a grid chunk,
                 every artifact written, each accepted mesh non-empty and
                 inside the runner's sanity radius, translations finite;
                 the wall table by part, ms a finetune step, the peak
                 device memory and the physics provider; then H1-fwd /
                 H1-bwd / H2 against plain at one object step's invisible
                 render and collision points (kernel ms, plain ms, bound)
 15 Stage 3      training/exp_runner_texture.main on phase 14's run (its
                 coarse_recon_obj_{i}.ply) with the train section of
                 confs/replica_room0_tex.conf, the dataset pointed at the
                 generated 512^2 scene, ColorFieldConfig's defaults (16
                 levels 16-2048, 2^19 rows, hidden 256), 4096 pixels a
                 step, --max_niters 5000 (5000 background iterations, 500
                 an object) and --texture_res 2048: every step's loss
                 finite, each object's MSE falling, H2 and H1-bwd (no
                 jacobian term) launched once an image step and H1-fwd
                 never, H2 once a bake chunk, surface_{i}.obj/.mtl/.png for
                 every mesh with one UV a vertex and a non-constant
                 texture; the wall table by part, ms an image step, the
                 peak device memory. Then train_object of one object for 50
                 iterations with its Stage-2 packs (vis_info_{k}.pkl): an
                 image step and an invisible-view step an iteration, H2 and
                 H1-bwd each launched by both. Then export/cli.py glb, usd
                 and gs (on phase 4's gauss_scene.ply), read back with
                 load_scene: the mesh count and every translation of
                 translation_dict.pkl. Then H2 (packed) and H1-bwd (no
                 jacobian) against plain at a colour step's captured points
                 (4096 x 16) and at the background's first bake chunk
                 (65,536 x 16): kernel ms, plain ms, bound
 16 the chain    (a) stage0/priors.main with scripted toy depth and normal
                 models on a copy of phase 10b's scene, on the card and on
                 the CPU: the files equal (depth within 1e-6). (b)
                 training/exp_runner_gaussian.main on phase 15's run (its
                 surface_{i}.obj: the room and both spheres, never cut)
                 with the dataset's test split, --max_niters 120 (a fifth
                 of the CLI's default of 200 a mesh, cut for time): every loss
                 finite, K1 and K2 launched on every step, gauss_scene.ply
                 and .usdz written, the test PSNR and SSIM finite; the
                 gaussians by object, steps/s, splats/s, the l1 in thirds
                 (whether it falls is printed, not checked) and the
                 export's wall time; K1 / K2 against plain on the run's
                 training frame 0 (its flat bins, tiles far longer than
                 phase 8's): kernel ms, plain ms, bound. (c) the chain record as one JSON line
                 (CHAIN_r05.json's shape: each stage's wall s, Stage 1's
                 eval PSNR at the end of phase 10b, Stage 2's meshes and
                 failed objects, Stage 3's textured count, Stage 4's PSNR,
                 SSIM, gaussians, iterations and loss quartile medians)
                 with a geometry column: calc_3d_metric (accuracy,
                 completion, completion ratio; no alignment) of each
                 object's mesh against the synthetic scene's analytic mesh
                 for Stage 1 (phase 14's input extraction at 128), Stage 2
                 (the accepted meshes) and Stage 3 (surface_{i}.obj)
 17 free gaussians (a) training/gs_train.main --dataset ns on phase 10b's
                 512^2 scene at the CLI's defaults (capacity 100,000, SH 3,
                 splatfacto every 100 steps after 500), 700 steps with the
                 export scene.ply: every loss finite, the PSNR rising from
                 the first third to the last, K1 and K2 launched on every
                 step, the alive count changing at both refines, eval PSNR /
                 SSIM finite (the views through K3 at max_per_tile, as the
                 JAX CLI renders them); steps/s, ms a step, splats/s; K1/K2
                 against plain on the trainer's training frame 0 (its flat
                 plan and bins over all 100,000 slots, the dead ones at
                 opacity 0). (b) --resume for 10 more
                 steps from the checkpoint's iteration (K2 ten times). (c)
                 --strategy mcmc, 200 steps, relocations every 50 after
                 50: the alive count kept at each. (d) an OPENCV_FISHEYE
                 COLMAP reconstruction of the scene written here (its
                 images and poses, 20,000 surface points), 60 steps
                 through the UT projection, --export scene.ingp read back.
                 (e) training/gs_render.main --renderer trace on phase 4's
                 gauss_scene.ply, pinhole and fisheye: PNGs and metrics
                 written, T1 launched once a 65,536-ray selection (4 a
                 512^2 view; composites 4096 rays at a time); the trace of
                 view 0 on white against the raster render above 20 dB
                 PSNR; gs_render --camera opencv --dist (UT raster, K3),
                 and K3 against plain on the top-K lists of its view 0
                 (UT-projected, at its calibrated K).
                 (f) T1 against plain on the middle 65,536-ray selection
                 of view 0 (plain 4096 rays at a time): pinhole rays in
                 trace_image's tile order and row-major, and fisheye rays
                 in tile order (as (e) traces them): indices equal plain's, two
                 launches the same bits, the composite of the hits within
                 1e-5; survivors a block and exact pairs tested (the
                 cull's plain mirror); kernel ms, plain ms, the bound and
                 the all-pairs bound. (g) one viewer orbit frame (K3)
                 on the card
 18 last modules (a) models/cam_opt.py::exp_map_so3xr3 and its gradient
                 on 4096 tangents (64 of them zero, the deltas' initial
                 value: finite), ops/phygrid.py at 256^3 with 2^20 points
                 (splat bitwise, sample and smooth within 1e-6) and
                 utils/lpips.py on random weights at 512^2 (relative
                 1e-4), each on the card against the CPU. (b) exp_runner
                 on phase 10's scene and conf with use_occupancy = true,
                 40 steps: every loss finite, rgb_loss falls, H1 three
                 times a step plus the patch's, H2 at the bakes and in the
                 patches' samplers (the step's sampler reads the probe
                 grid, as in phase 10); the mean (far' - near') / (far -
                 near) of the restricted steps below 1; ms a step beside
                 phase 10's. (c) Stage 1 over torch.distributed at the
                 flagship width (random tables, 1024 rays and the 32 x 32
                 background patch, SGD lr 1): one NCCL world-size-1 step in
                 this process, then two gloo ranks spawned on the one card
                 (NCCL refuses two ranks on one device) at dp 2 and at
                 model 2 (row-sharded tables), each against the
                 single-process step on the same global batch and draws:
                 loss rtol 2e-5 atol 2e-6, every gradient within 5e-5 x
                 max |g| of its tensor (the 0-d beta 5e-4). (d) the Stage-4
                 dp step at dp 2 in the same two ranks, each rendering one
                 of phase 4's 512^2 frames through K1/K2: the parameters
                 after one SGD step (lr 1e-3) against the single-process
                 step on the two frames' gradient mean, rtol 2e-4 atol
                 2e-6. (e) python -m torch.distributed.run, two ranks,
                 -m holoscene_tpu_torch.training.exp_runner on phase 10's
                 conf with --dist_backend gloo, 5 steps: every loss
                 finite, step 0's the single-process run's (phase 10's
                 step 0, rtol 2e-5; step 1's printed beside phase 10's),
                 one run directory with rank 0's metrics and checkpoint
 19 variants     the Stage-1 network variants through exp_runner.main at
                 the flagship width on phase 10's scene: (a)
                 replica_room0.conf's vjp model with grid_interp =
                 tetrahedral, 40 steps; (e) (a)'s extraction at 256; (b)
                 replica_room0_tpu.conf's fused model with fused_fetch =
                 raw, 40 steps; (c) forward_grad_mode = jvp, 20 steps; (d)
                 color_grid_feature = false with the nerf head, 20 steps:
                 every loss finite, rgb_loss falling, H1 on every step,
                 the new instantiations launched (H1-fwd / H1-bwd
                 tetrahedral on every H1 call of (a), H2 tetrahedral on
                 every grid chunk of (e), H1-fwd raw on every step of
                 (b)), ms a step and the first / last loss; H1-fwd and
                 H1-bwd tetrahedral, H1-fwd raw and H2 packed tetrahedral
                 against plain on inputs captured from those runs (kernel
                 ms, plain ms, bound)
 20 repeatability two runs from one seed, each pair bitwise equal (the
                 largest absolute difference printed; any nonzero one
                 fails): (a) phase 10b's conf, 10 steps twice through
                 exp_runner.main, every parameter after every step and
                 both checkpoints; (b) object 1's Stage-2 finetune, 20
                 iterations twice from phase 10b's checkpoint on fresh
                 runners, then its extraction at 128 twice (vertices and
                 faces); (c) H1-bwd at phase 11's fine-tier call, twice
                 and with the points, cotangents and uniforms permuted,
                 beside the difference float atomics make over the same
                 contributions (the noise the fixed point removed)
Wherever a kernel is held against plain (phases 3, 8, 9, 11, 12, 14a, 14,
15, 16, 17 and 19) it is
launched twice on the same inputs and the two results must be the same bits
(K1-K4, H1-fwd, H1-bwd, H2, T1; H1-bwd sums in fixed point, so the order
of its atomics does not change its bits).
The launch counts are set to 0 just before each of the paths 4-7, 10,
10b, 12, 13, 14a, 14, 15 (its CLI run and its invisible-view run), 16
(its Stage-4 run), 17 (each gs_train run, each gs_render run, the
viewer frame), 18 (the occupancy run, each rank's step) and 19 (each
run and the extraction) and read just after. Then the kernel table as one JSON line
and last the device line {"ok": true, "device": {...}}. Any failure exits
non-zero before it.

The bound of a kernel is the larger of two times, both from this run's
inputs. Bytes: the candidate rows of the chunks the walk really took (8 KB
each), the per-tile ints and tile blocks it reads, and every output byte
written once (K2/K4: all of the zero-initialised gradient array), over
3.35 TB/s. Operations: per (candidate, pixel) pair of the walked chunks the
17 float32 operations up to the 1/255 test (quadratic form, one exp, the
clamp), counting real candidates and in-image pixels only (not the padding
that fills a tile's last chunk, a list's dead entries or its K-padding), and
per live pair (alpha >= 1/255) 13 more in the forward (exp of the running
sum, weight, four multiply-adds unfused, log1p) or 51 more in the backward
(log1p, exp, the closed form, ten gradient terms and their ten sums over the
tile's pixels), each special function counted as ONE operation, over the
card's 67 TFLOP/s float32 rate. No PyTorch call computes any of the four
functions, so library_ms is null.

The bound of a hash-grid kernel, from the same launch's inputs. Bytes: the
inputs read once (points, cotangents, uniforms), the outputs written once
(H1-bwd: each whole gradient table written once; its fixed-point
accumulation's int64 buffer, zero-filled, added into by atomics and read
by the conversion, is the implementation's cost, not the function's, and
phase 11 prints that traffic's own time beside the bound), and for
H1-fwd and H2 per level the lesser of its table's bytes and the 32-byte
sectors its corner gathers touch (8-byte rows, per table); over 3.35 TB/s.
Operations: per (in-range point, level) 18 for the smoothstep weights and their derivatives plus per corner 31
(H1-fwd: weight, jacobian weights, the multiply-adds of a, J and b), 27
(H1-bwd: weight, jacobian weights, the fused cotangents; 4 without the
jacobian term, whose [L*2, 3, N] cotangent is then not read either) or 6
(H2), over 67 TFLOP/s. No single PyTorch call computes a hash-grid encode: library_ms
is null.

The bound of T1, from phase 17 (f)'s selection (tile order). The work
depends on the data, so it counts what these inputs need. Operations: per
(ray, gaussian) pair whose ray meets the gaussian's exact sphere (the
world sphere outside which the acceptance test cannot pass, no margins;
counted by the cull's plain mirror) the 65 float32 operations up to the
acceptance test (T1_OPS_PAIR, counted from the source; sqrt, divisions and
the exp one each), over 67 TFLOP/s. Bytes: the rays (24 B each) and the
packed gaussians (52 B) read once, the indices and counts written once,
over 3.35 TB/s; the cull spheres are the kernel's own intermediate, made
from the packed rows, and not counted. The all-pairs bound, of the
kernel's first design that tested every pair, counts every (ray,
gaussian) pair whose opacity can pass 1/255: it stands beside the new one
as all_pairs_bound_ms. No PyTorch call selects
the K nearest accepted hits of a ray against a gaussian mixture:
library_ms is null.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

FWD_ATOL = 2e-4               # K1/K3 vs plain (all 8 output channels)
BWD_ATOL, BWD_RTOL = 5e-4, 5e-3   # K2/K4 vs plain's float64 sums
RES = 512
N_IMAGES = 8
MESH_RES = 32                 # marching-tetrahedra grid of the analytic meshes
AREA = 2e-4                   # face-area cap: ~123k gaussians at MESH_RES 32
# 30 steps move the per-step l1 less than its frame-to-frame noise at 512^2
# (first/last-third means 0.1934 -> 0.1977 over 30 steps, 0.1780 -> 0.1543
# over 150, on an H100 80GB HBM3 at 700 W); 100 steps show the trend
STEPS = 100
TOPK_STEPS = 90
INVIS_ITERS = 60
PACK_RES, PACK_VIEWS = 256, 4
SMALL_RES, SMALL_N, SMALL_K = 128, 5000, 256
MEM_BYTES_S = 3.35e12         # H100 SXM HBM3
FP32_OPS_S = 67e12            # H100 SXM float32 outside the tensor cores
OPS_TEST, OPS_LIVE_FWD, OPS_LIVE_BWD = 17, 13, 51
# each walk before its redesign, this script's phase 8 on an NVIDIA H100
# 80GB HBM3 at 700.00 W: the backward walks with shared-memory atomics, the
# forward walks that evaluated every alpha without a look-ahead
EARLIER_MS = {"K1": 0.174, "K2": 0.823, "K3": 0.210, "K4": 0.883}

KERNELS = {
    "K1": dict(name="K1 splat_flat_fwd", route="cuda",
               source="holoscene_tpu_torch/csrc/splat_flat_fwd.cu",
               replaces="holoscene_tpu/ops/splat_flat.py:601"),
    "K2": dict(name="K2 splat_flat_bwd", route="cuda",
               source="holoscene_tpu_torch/csrc/splat_flat_bwd.cu",
               replaces="holoscene_tpu/ops/splat_flat.py:710"),
    "K3": dict(name="K3 splat_topk_fwd", route="cuda",
               source="holoscene_tpu_torch/csrc/splat_topk_fwd.cu",
               replaces="holoscene_tpu/ops/splat_pallas.py:49"),
    "K4": dict(name="K4 splat_topk_bwd", route="cuda",
               source="holoscene_tpu_torch/csrc/splat_topk_bwd.cu",
               replaces="holoscene_tpu/ops/splat_pallas.py:166"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def reset_counts() -> None:
    from holoscene_tpu_torch.ops import gs_trace
    from holoscene_tpu_torch.ops import hashgrid as hg
    from holoscene_tpu_torch.ops import splat_flat as sf
    from holoscene_tpu_torch.ops import splat_topk as st

    sf.flat_fwd.launches = sf.flat_bwd.launches = 0
    st.composite_fwd.launches = st.composite_bwd.launches = 0
    hg.fused_fwd.launches = hg.fused_bwd.launches = 0
    hg.sampler_fwd.launches = 0
    hg.reset_variant_counts()
    gs_trace.select_hits.launches = 0


def read_counts() -> dict:
    import torch

    from holoscene_tpu_torch.ops import splat_flat as sf
    from holoscene_tpu_torch.ops import splat_topk as st

    torch.cuda.synchronize()
    return {"K1": sf.flat_fwd.launches, "K2": sf.flat_bwd.launches,
            "K3": st.composite_fwd.launches, "K4": st.composite_bwd.launches}


def read_hash_counts() -> dict:
    import torch

    from holoscene_tpu_torch.ops import hashgrid as hg

    torch.cuda.synchronize()
    return {"H1-fwd": hg.fused_fwd.launches, "H1-bwd": hg.fused_bwd.launches,
            "H2": hg.sampler_fwd.launches}


def walk_work(chunks, real, cs, used, px, py, in_img):
    """What a walk over these inputs needs: (chunks walked, (candidate,
    pixel) pairs, live pairs with alpha >= 1/255). A pair is a real
    candidate (`real` [n_chunks, 128] bool: no padding, no dead entry) of a
    walked chunk at an in-image pixel of its tile."""
    from holoscene_tpu_torch.ops import splat_flat as sf

    cs, used = cs.long(), used.long()
    n_pix = in_img.sum(1)
    pairs = live = 0
    for j in range(int(used.max()) if used.numel() else 0):
        act = j < used
        idx = (cs + j)[act]
        pairs += int((real[idx].sum(1) * n_pix[act]).sum())
        keep = sf._chunk_alpha(px[act], py[act], chunks[idx])[6]
        live += int((keep & real[idx][:, None, :]
                     & in_img[act][:, :, None]).sum())
    return int(used.sum()), pairs, live


def exact_note(r):
    """A backward's errors against plain's float64 sums, for a log line."""
    if "max_abs_err_exact" not in r:
        return ""
    return (f" (vs exact sums {r['max_abs_err_exact']:.3g}, worst "
            f"{r['tolerance_share']:.3g} of its tolerance; float32 plain "
            f"{r['plain_max_abs_err_exact']:.3g})")


def bound_ms(n_bytes: int, n_ops: int):
    by_bytes = n_bytes / MEM_BYTES_S * 1e3
    by_ops = n_ops / FP32_OPS_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def compare_walks(names, chunks, real, cs, pixels, fwd, fwd_plain, bwd,
                  bwd_plain, bwd_exact, extra_in_bytes, seed, timed):
    """One forward/backward kernel pair vs plain on the card; raises on
    disagreement. pixels = (px, py, in_img) of the tiles; fwd() -> (out
    [T,P,8], used [T]); bwd(out, used, v) -> d cand; bwd_exact the same
    plain backward with float64 sums. The forward is held against plain
    within FWD_ATOL, the backward against bwd_exact within BWD_ATOL +
    BWD_RTOL |exact|; bwd None holds the forward alone (a path that only
    renders). Returns {name: dict(max_abs_err (vs float32 plain), ms,
    plain_ms, bound_ms, bound_by)} (the times None unless timed), the
    backward's also max_abs_err_exact and plain_max_abs_err_exact."""
    import torch

    kf, kb = names
    ref, ref_used = fwd_plain()
    out, used = fwd()
    again, used_again = fwd()
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise RuntimeError(f"{kf} output is not finite")
    if not (torch.equal(out, again) and torch.equal(used, used_again)):
        raise RuntimeError(f"{kf}: two launches on the same inputs differ "
                           f"(max abs {float((out - again).abs().max())})")
    if not torch.equal(used.long(), ref_used.long()):
        raise RuntimeError(f"{kf} walked other chunk counts than plain")
    err_f = float((out - ref).abs().max())
    if err_f > FWD_ATOL:
        bad = (out - ref).abs().amax(dim=(1,))   # per tile, per channel
        raise RuntimeError(f"{kf} disagrees with plain: max abs err {err_f} "
                           f"> {FWD_ATOL}; worst channel errors "
                           f"{bad.amax(0).tolist()}")
    walked, pairs, live = walk_work(chunks, real, cs, ref_used, *pixels)
    vals, tiles = torch.unique(ref_used.long(), return_counts=True)
    read = walked * chunks[0].numel() * 4 + extra_in_bytes
    block = out.numel() * 4
    res = {kf: dict(max_abs_err=err_f, ms=None, plain_ms=None)}
    res[kf]["bound_ms"], res[kf]["bound_by"] = bound_ms(
        read + block, pairs * OPS_TEST + live * OPS_LIVE_FWD)
    work = dict(walked_chunks=walked, candidate_pixels=pairs,
                live_candidate_pixels=live, library_ms=None,
                tiles_by_walked_chunks=dict(zip(vals.tolist(),
                                                tiles.tolist())))
    res[kf].update(work)
    if timed:
        # the candidate rows (tens of MB) are left warm in the 50 MB L2, as
        # the gather that precedes each walk in a training step leaves them
        res[kf]["ms"] = cuda_ms(fwd, 20)
        res[kf]["plain_ms"] = cuda_ms(fwd_plain, 3)
    if bwd is None:
        return res
    gen = torch.Generator(device=out.device).manual_seed(seed)
    v = torch.randn(ref.shape, generator=gen, device=out.device)
    v[..., 5:] = 0.0   # the diagnostics channels carry no cotangent
    dref = bwd_plain(ref, ref_used, v)
    dker = bwd(ref, ref_used, v)
    again = bwd(ref, ref_used, v)
    torch.cuda.synchronize()
    if not torch.equal(dker, again):
        raise RuntimeError(f"{kb}: two launches on the same inputs differ "
                           f"(max abs {float((dker - again).abs().max())})")
    # the reference: plain's closed form with float64 sums over the same
    # float32 alphas and masks; both float32 walks round their long sums
    # (thousands of candidates a pixel on the chain's tiles) their own way
    del again
    exact = bwd_exact(ref, ref_used, v)
    # the float64 differences a slice of rows at a time: at the chain's
    # frame one float64 copy of the gradient array is ~20 GiB
    step = max(1, (1 << 27) // max(1, dker[0].numel()))
    over, max_x, plain_x, err_b, share = 0, 0.0, 0.0, 0.0, 0.0
    for i in range(0, dker.shape[0], step):
        e, k, p = exact[i:i + step], dker[i:i + step], dref[i:i + step]
        x = (k.double() - e).abs()
        tol = BWD_ATOL + BWD_RTOL * e.abs()
        over += int((x > tol).sum())
        share = max(share, float((x / tol).max()))
        max_x = max(max_x, float(x.max()))
        plain_x = max(plain_x, float((p.double() - e).abs().max()))
        err_b = max(err_b, float((k - p).abs().max()))
    if not torch.isfinite(dker).all() or over:
        raise RuntimeError(f"{kb} disagrees with plain's exact sums: {over} "
                           f"values outside atol {BWD_ATOL} rtol {BWD_RTOL}; "
                           f"max abs err {max_x}, worst {share:.3f} of its "
                           f"tolerance (float32 plain {plain_x}, kernel vs "
                           f"float32 plain {err_b})")
    res[kb] = dict(max_abs_err=err_b, max_abs_err_exact=max_x,
                   tolerance_share=share, plain_max_abs_err_exact=plain_x,
                   ms=None, plain_ms=None, **work)
    res[kb]["bound_ms"], res[kb]["bound_by"] = bound_ms(
        read + 2 * block + dker.numel() * 4,
        pairs * OPS_TEST + live * OPS_LIVE_BWD)
    if timed:
        res[kb]["ms"] = cuda_ms(lambda: bwd(ref, ref_used, v), 20)
        res[kb]["plain_ms"] = cuda_ms(lambda: bwd_plain(ref, ref_used, v), 3)
    return res


def compare_flat(cand, cs, cc, tiles_x, width, height, seed, timed):
    import torch

    from holoscene_tpu_torch.ops import splat_flat as sf

    geom = (tiles_x, 16, width, height)
    pixels = sf._tile_pixels(cs.shape[0], *geom, cand.device)
    chunks = cand.reshape(-1, sf.CHUNK, sf.CAND_ROWS)

    def with_used(out):
        return out, out[:, 0, 5].int()

    return compare_walks(
        # padding slots and the per-tile dummy gather the all-zero trash row
        ("K1", "K2"), chunks, chunks[..., 10] > 0, cs, pixels,
        lambda: with_used(sf.flat_fwd(cand, cs, cc, *geom)),
        lambda: with_used(sf.flat_fwd_plain(cand, cs, cc, *geom)),
        lambda o, _u, v: sf.flat_bwd(cand, cs, o, v, *geom),
        lambda o, _u, v: sf.flat_bwd_plain(cand, cs, o, v, *geom),
        lambda o, _u, v: sf.flat_bwd_plain(cand, cs, o, v, *geom,
                                           acc=torch.float64),
        2 * cs.numel() * 4, seed, timed)


def compare_topk(cand, origins, counts, width, height, seed, timed,
                 fwd_only=False):
    import torch

    from holoscene_tpu_torch.ops import splat_flat as sf
    from holoscene_tpu_torch.ops import splat_topk as st

    geom = (16, width, height)
    pixels = sf.tile_pixels_at(origins, *geom)
    n_tiles, k = cand.shape[0], cand.shape[1]
    cs = torch.arange(n_tiles, device=cand.device) * (k // sf.CHUNK)
    real = torch.arange(k, device=cand.device)[None, :] < counts[:, None]
    return compare_walks(
        ("K3", "K4"), cand.reshape(-1, sf.CHUNK, sf.CAND_ROWS),
        real.reshape(-1, sf.CHUNK), cs, pixels,
        lambda: st.composite_fwd(cand, origins, counts, *geom),
        lambda: st.composite_fwd_plain(cand, origins, counts, *geom),
        None if fwd_only else
        lambda o, u, v: st.composite_bwd(cand, origins, u, o, v, *geom),
        lambda o, u, v: st.composite_bwd_plain(cand, origins, u, o, v, *geom),
        lambda o, u, v: st.composite_bwd_plain(cand, origins, u, o, v, *geom,
                                               acc=torch.float64),
        origins.numel() * 4 + counts.numel() * 4, seed, timed)


def topk_lists(xy, depth, conic, radius, valid, opac, rgb, width, height, k):
    """The top-K walk's inputs as render_gaussians builds them: gated,
    K-padded cand [T,K,16], origins [T,2], counts [T] int32."""
    import torch

    from holoscene_tpu_torch.ops import splat_flat as sf
    from holoscene_tpu_torch.ops.splat import select_topk
    from holoscene_tpu_torch.ops.splat_topk import gate_and_pad

    k = min(k, xy.shape[0])
    top_idx, live, origins = select_topk(xy, depth, radius, valid, width,
                                         height, 16, k)
    cand = sf.gather_payload(xy, depth, conic, opac, rgb,
                             top_idx.reshape(-1)).reshape(-1, k, sf.CAND_ROWS)
    return (gate_and_pad(cand, live.float()), origins,
            live.sum(1).to(torch.int32))


def random_scene(dev):
    """A random 128^2 scene of SMALL_N projected gaussians."""
    import numpy as np
    import torch

    from holoscene_tpu_torch.ops.gaussians import project_gaussians_fused

    rng = np.random.default_rng(0)
    n, res = SMALL_N, SMALL_RES
    means = np.stack([rng.uniform(-0.7, 0.7, n), rng.uniform(-0.7, 0.7, n),
                      rng.uniform(1.2, 3.0, n)], -1)
    f32 = dict(dtype=torch.float32, device=dev)
    xy, depth, conic, radius, valid = project_gaussians_fused(
        torch.as_tensor(means, **f32),
        torch.as_tensor(rng.normal(size=(n, 4)), **f32),
        torch.as_tensor(rng.uniform(0.01, 0.05, (n, 3)), **f32),
        torch.eye(4, device=dev),
        torch.tensor([[res * 0.8, 0, res / 2], [0, res * 0.8, res / 2],
                      [0, 0, 1.0]], device=dev), res, res)
    opac = torch.as_tensor(rng.uniform(0.2, 0.95, n), **f32)
    rgb = torch.as_tensor(rng.uniform(0, 1, (n, 3)), **f32)
    return xy, depth, conic, radius, valid, opac, rgb


def flat_inputs(xy, depth, conic, valid, opac, rgb, res):
    from holoscene_tpu_torch.ops import splat_flat as sf

    tiles = res // 16
    plan = sf.plan_flat(xy, conic, opac, valid, tiles, tiles, 16)
    bins = sf.build_flat_bins(xy, depth, conic, opac, valid, tiles_x=tiles,
                              tiles_y=tiles, tile_size=16, plan=plan)
    cand = sf.gather_payload(xy, depth, conic, opac, rgb, bins["gidx"])
    return cand, bins["tile_chunk_start"], bins["tile_chunk_cnt"], tiles


def projection(means, quats, scales, opac, colors, viewmat, intr, w, h,
               sh_degree, ortho=False, camera_model="pinhole", dist=None):
    """Projected, shaded gaussians as render_gaussians makes them: (xy,
    depth, conic, radius, valid, opac, rgb); opencv / fisheye cameras
    through the unscented transform."""
    import torch

    from holoscene_tpu_torch.ops.splat import project_for_render, shade

    with torch.no_grad():
        xy, depth, conic, radius, valid = project_for_render(
            means, quats, scales, viewmat, intr, w, h, ortho=ortho,
            camera_model=camera_model, dist=dist)
        rgb = shade(means, colors, viewmat, sh_degree)
    return xy, depth, conic, radius, valid, opac, rgb


def gom_projection(runner, pose, intr, w, h, visible_mask=None, ortho=False):
    """`projection` of a runner's gaussians with render_gom's own inputs."""
    import torch

    from holoscene_tpu_torch.models import gom
    from holoscene_tpu_torch.ops.gaussians import view_matrix

    p, st, cfg = runner.params, runner.static, runner.cfg
    with torch.no_grad():
        colors = torch.cat([p["features_dc"][:, None], p["features_rest"]], 1)
        return projection(
            gom.gom_means(p, st, cfg), gom.gom_quats(p, st, cfg),
            gom.gom_scales(p, st, cfg), gom.gom_opacities(p, visible_mask),
            colors, view_matrix(pose, pose.device), intr, w, h,
            cfg.sh_degree, ortho)


def pack_camera(pack, dev):
    """(pose, intrinsics, w, h) of a generated orthographic pack view, as
    the invisible-view step sets them up."""
    import torch

    from holoscene_tpu_torch import as_tensor

    h, w = pack["mask"].shape
    half = float(pack["half_extent"])
    intr = torch.tensor([[w / (2 * half), 0.0, w / 2.0],
                         [0.0, h / (2 * half), h / 2.0],
                         [0.0, 0.0, 1.0]], device=dev)
    return as_tensor(pack["pose"], dev), intr, w, h


def write_slice_inputs(work: Path):
    """Synthetic 512^2 scene + its analytic meshes as Stage-3 surface_{i}.obj
    + a conf. Returns (conf path, plots dir)."""
    from holoscene_tpu_torch.datasets.synthetic import (
        generate_scene,
        scene_meshes,
        write_stage3_meshes,
    )

    generate_scene(str(work / "data" / "scene_0"), n_images=N_IMAGES,
                   img_res=(RES, RES))
    plots = work / "exps" / "smoke_s4" / "run0" / "plots"
    plots.mkdir(parents=True)
    write_stage3_meshes(str(plots), scene_meshes(MESH_RES))
    conf = work / "smoke.conf"
    conf.write_text(
        "train{\n expname = smoke_s4\n}\n"
        f"dataset{{\n data_root_dir = {work / 'data'}\n data_dir = scene_0\n"
        f" img_res = [{RES}, {RES}]\n test_split = True\n}}\n")
    return conf, plots


def invis_probe_l1(runner) -> float:
    """The invisible-view l1 without the noise of the random background:
    every object's first two pack views rendered as the invisible-view step
    renders them, on mid-grey."""
    import torch

    from holoscene_tpu_torch import as_tensor
    from holoscene_tpu_torch.models.gom import render_gom

    dev = runner.device
    bg = torch.full((3,), 0.5, device=dev)
    vals = []
    with torch.no_grad():
        for obj_i, packs in enumerate(runner.vis_info_list):
            for pack in packs[:2]:
                pose, intr, w, h = pack_camera(pack, dev)
                out = render_gom(
                    runner.params, runner.static, runner.cfg, pose, intr, w,
                    h, bg, visible_mask=runner._visible_mask(obj_i),
                    ortho=True)
                m = as_tensor(pack["mask"], dev)[..., None]
                gt = as_tensor(pack["rgb"], dev) * m + (1 - m) * bg
                vals.append(float((out["rgb"] - gt).abs().mean()))
    return sum(vals) / len(vals)


def finite(x: float) -> bool:
    return x == x and abs(x) != float("inf")


def thirds(hist, keys):
    """Means of the first and the last third of the logged steps: each step
    draws a random frame and background, so single steps are noisy."""
    third = max(len(hist) // 3, 1)
    return {k: (sum(h[k] for h in hist[:third]) / third,
                sum(h[k] for h in hist[-third:]) / third) for k in keys}


def check_training(tag, runner, hist, steps, launches, per_step, card):
    """The checks shared by the training paths; logs rates. per_step: the
    kernels that must have launched at least once per step."""
    n_gauss = runner.static["num_gaussians"]
    if len(hist) != steps or not all(finite(h["loss"]) for h in hist):
        raise RuntimeError(f"{tag}: {len(hist)} logged steps for {steps}, or "
                           f"a non-finite loss: {[h['loss'] for h in hist]}")
    trend = thirds(hist, ("loss", "l1", "acm_loss", "depth_loss", "psnr"))
    log("   first/last third means: " + ", ".join(
        f"{k} {a:.4f} -> {b:.4f}" for k, (a, b) in trend.items()))
    if not (trend["l1"][1] < trend["l1"][0]
            and trend["loss"][1] < trend["loss"][0]):
        raise RuntimeError(f"{tag}: l1 or loss did not fall over "
                           f"{len(hist)} logged steps: {trend}")
    if n_gauss < 100_000 or runner.cfg.sh_degree != 3:
        raise RuntimeError(f"{tag}: not the full-width slice: {n_gauss} "
                           f"gaussians, sh_degree {runner.cfg.sh_degree}")
    if any(launches[k] < steps for k in per_step):
        raise RuntimeError(f"{tag}: kernels {per_step} not on the path: "
                           f"{launches} launches for {steps} steps")
    steps_s = steps / runner.run_seconds
    steady_s = (steps - 1) / (hist[-1]["elapsed_s"] - hist[0]["elapsed_s"])
    log(f"   {n_gauss} gaussians, sh_degree 3, {RES}^2, {steps} steps in "
        f"{runner.run_seconds:.3f} s: {steps_s:.3f} steps/s, "
        f"{n_gauss * steps_s:.6g} splats/s (first step included); steps "
        f"2..{steps}: {steady_s:.3f} steps/s, {1e3 / steady_s:.2f} ms/step, "
        f"{n_gauss * steady_s:.6g} splats/s; on {card}")
    return trend


# ---------------------------------------------------------------------------
# Stage 1: the hash-grid kernels and the neural-SDF train step
# ---------------------------------------------------------------------------

S1_RES, S1_IMAGES, S1_STEPS = 512, 8, 100
S1B_STEPS = 40        # phase 10b: the vjp mode's heavier untiered step
PLOT_RES = 512        # phase 12: confs/replica_room0_tpu.conf's resolution
EXTRACT_CHUNK = 1 << 18   # utils/plots.py::extract_object_meshes' chunk
COARSE_RES = 64       # and its coarse sweep
GATE_ITERS = 200      # phase 13: the quality gate's code path, short
BENCH_RAYS, BENCH_WARMUP, BENCH_TIMED, PROFILED = 1024, 3, 20, 3
H_REL = 1e-5          # hash kernels vs plain, relative to the largest value
BAKE_CHUNK = 1 << 18  # ops/probe_grid.py bake_probe_grid's chunk
# float32 operations per (point, level) and per corner, counted from the
# sources (csrc/hash_*.cu): the smoothstep weights and their derivatives
# (18), then per corner its weight (2), the jacobian weights (9) and the
# multiply-adds of the forward (2 channels of a, 6 of J, 2 of b: 20), of
# the backward (the two fused cotangents 14, b's 2) or of H2 (4)
OPS_POINT_LEVEL = 18
OPS_CORNER = {"H1-fwd": 2 + 9 + 20, "H1-bwd": 2 + 9 + 16, "H2": 2 + 4}
# the tetrahedral stencil (csrc/hash_grid.cuh::tet_rows): per (point,
# level) the three comparisons, three ranks (6), the sorted fractions (6)
# and four weights (4); per corner (4 of them) its jacobian weights (9)
# and the same multiply-adds (no weight product)
OPS_POINT_LEVEL_TET = 3 + 6 + 6 + 4
OPS_CORNER_TET = {"H1-fwd": 9 + 20, "H1-bwd": 9 + 16, "H2": 4}
# H1-bwd with no jacobian term (the packed encode's transpose): the
# corner's weight (2) and its two products with the feature cotangent (2)
OPS_CORNER_NO_J = 2 + 2
# The kernels before their redesign (one thread per (point, level)) on an
# NVIDIA H100 80GB HBM3 at 700.00 W: H1 (commit 43206f0) at the fine tier
# of this script's phase 11, H2 (commit 2c8f867) at phase 11's bake chunk
# and (H2_EARLIER_EXTRACT_MS) at phase 12's chunk of the x01 = 1 plane
HASH_EARLIER_MS = {"H1-fwd": 0.0820, "H1-bwd": 0.3737, "H2": 0.0564}
H2_EARLIER_EXTRACT_MS = 0.2782
# phase 11's fine-tier H1-bwd call (its arguments), for phase 20 (c)
FINE_BWD: list = []
HASH_KERNELS = {
    "H1-fwd": dict(name="H1-fwd hash_fused_fwd", route="cuda",
                   source="holoscene_tpu_torch/csrc/hash_fused_fwd.cu",
                   replaces="holoscene_tpu/ops/hashgrid.py:965"),
    "H1-bwd": dict(name="H1-bwd hash_fused_bwd", route="cuda",
                   source="holoscene_tpu_torch/csrc/hash_fused_bwd.cu",
                   replaces="holoscene_tpu/ops/hashgrid.py:1003"),
    "H2": dict(name="H2 hash_sampler_fwd", route="cuda",
               source="holoscene_tpu_torch/csrc/hash_sampler_fwd.cu",
               replaces="holoscene_tpu/ops/hashgrid.py:625"),
}


def flagship_cfg(d_out: int):
    """bench.py::flagship_config in the port's classes (the shipped
    defaults)."""
    from holoscene_tpu_torch.models.fields import (
        ImplicitNetworkConfig,
        RenderingNetworkConfig,
    )
    from holoscene_tpu_torch.models.holoscene import HoloSceneConfig
    from holoscene_tpu_torch.ops.sampler import SamplerConfig

    return HoloSceneConfig(
        implicit=ImplicitNetworkConfig(
            feature_vector_size=256, d_out=d_out, dims=(256, 256), multires=6,
            num_levels=16, level_dim=2, base_size=16, end_size=2048,
            logmap=19, color_grid_feature=True, divide_factor=1.0,
            sigmoid=10.0, dense_max_res=0, fused_fetch="packed",
            color_bwd_sample=True, sdf_bwd_sample=True),
        rendering=RenderingNetworkConfig(
            feature_vector_size=256, dims=(256, 256), multires_view=4,
            multires_point=4, multires_normal=4),
        sampler=SamplerConfig(N_samples=64, N_samples_eval=128,
                              N_samples_extra=32, eps=0.1, beta_iters=10,
                              max_total_iters=4),
        use_bg_reg=False, sampler_grid_levels=8, forward_grad_mode="fused",
        render_top_m=56, render_fine_top_f=32, render_fine_levels=6,
        use_occupancy=False, probe_grid_res=128, probe_update_every=64)


# the model sections of the two Stage-1 runs: phase 10 the flagship fast
# path with the background regulariser (confs/replica_room0_tpu.conf's
# values), phase 10b the conf defaults (confs/replica_room0.conf: the vjp
# gradient mode, untiered, no probe grid, 5 sampler rounds)
S1_MODEL_TPU = """
 use_bg_reg = true
 render_bg_iter = 10
 use_occupancy = false
 forward_grad_mode = fused
 sampler_grid_levels = 8
 render_top_m = 56
 render_fine_top_f = 32
 render_fine_levels = 6
 probe_grid_res = 128
 probe_update_every = 64
 implicit_network{
  dense_max_res = 0
  fused_fetch = packed
  color_bwd_sample = True
  sdf_bwd_sample = True
 }
 ray_sampler{
  max_total_iters = 4
 }
"""
S1_MODEL_DEFAULT = """
 use_bg_reg = true
 render_bg_iter = 10
 ray_sampler{
  max_total_iters = 5
 }
"""


def stage1_conf(work: Path, name: str, model: str,
                exact_bwd_from_iter: int = -1) -> Path:
    """A generated 512^2 scene (written once) and a conf of the flagship
    widths with the train values of confs/replica_room0*.conf and `model`
    merged into the model section."""
    from holoscene_tpu_torch.datasets.synthetic import generate_scene

    if not (work / "data_s1" / "scene_0").exists():
        generate_scene(str(work / "data_s1" / "scene_0"), n_images=S1_IMAGES,
                       img_res=(S1_RES, S1_RES))
    conf = work / f"{name}.conf"
    conf.write_text(f"""
train{{
 expname = {name}
 learning_rate = 5.0e-4
 lr_factor_for_grid = 20.0
 num_pixels = 1024
 checkpoint_freq = 100000
 split_n_pixels = 4096
 add_objectvio_iter = 25000
 max_total_iters = 200000
 exact_bwd_from_iter = {exact_bwd_from_iter}
}}
loss{{
 rgb_loss = l1
 eikonal_weight = 0.1
 smooth_weight = 0.005
 depth_weight = 0.5
 normal_l1_weight = 0.05
 normal_cos_weight = 0.05
 use_obj_opacity = True
 semantic_weight = 5.0
 reg_vio_weight = 0.01
 bg_reg_weight = 0.01
}}
plot{{
 resolution = {PLOT_RES}
 grid_boundary = [-1.0, 1.0]
}}
dataset{{
 data_root_dir = {work / 'data_s1'}
 data_dir = scene_0
 img_res = [{S1_RES}, {S1_RES}]
}}
model{{
 feature_vector_size = 256
 scene_bounding_sphere = 1.0
 implicit_network{{
  d_in = 3
  dims = [256, 256]
  geometric_init = True
  bias = 0.9
  multires = 6
  divide_factor = 1.0
  sigmoid = 10
  color_grid_feature = True
  num_levels = 16
  level_dim = 2
  base_size = 16
  end_size = 2048
  logmap = 19
 }}
 rendering_network{{
  mode = idr
  d_in = 9
  d_out = 3
  dims = [256, 256]
  multires_view = 4
  multires_point = 4
  multires_normal = 4
 }}
 density{{
  params_init{{
   beta = 0.1
  }}
  beta_min = 0.0001
 }}
 ray_sampler{{
  near = 0.0
  N_samples = 64
  N_samples_eval = 128
  N_samples_extra = 32
  eps = 0.1
  beta_iters = 10
 }}
{model}}}
""")
    return conf


def bench_batch(gen, dev, n: int, res: int = 512) -> dict:
    """bench.py::make_batch with a torch generator: a 512^2 camera at
    (0.4, 0.1, -0.4), uniform pixels, random targets, one class."""
    import numpy as np
    import torch

    f = 0.5 * res / np.tan(np.radians(35.0))
    pose = torch.eye(4, device=dev)
    pose[:3, 3] = torch.tensor([0.4, 0.1, -0.4], device=dev)
    normal = torch.randn(n, 3, generator=gen, device=dev)
    normal = (normal - normal.mean(-1, keepdim=True)) / torch.sqrt(
        normal.var(-1, unbiased=False, keepdim=True) + 1e-5)
    return {
        "uv": torch.rand(n, 2, generator=gen, device=dev) * res,
        "pose": pose,
        "intrinsics": torch.tensor([[f, 0.0, res / 2], [0.0, f, res / 2],
                                    [0.0, 0.0, 1.0]], device=dev),
        "rgb": torch.rand(n, 3, generator=gen, device=dev),
        "depth": 0.5 + 1.5 * torch.rand(n, 1, generator=gen, device=dev),
        "normal": normal,
        "segs": torch.zeros(n, dtype=torch.int64, device=dev),
        "mask": torch.ones(n, 1, device=dev),
    }


def _gather_bytes(x01, lt, n_tables: int, interp: str = "trilinear") -> int:
    """Per level, the lesser of its table's bytes and the 32-byte sectors
    its corner gathers touch (8-byte rows of each table; the tetrahedral
    stencil's 4 corners), in-range points only."""
    import torch

    from holoscene_tpu_torch.ops import hashgrid as hg

    x = x01[~((x01 < 0) | (x01 > 1)).any(-1)]
    if not x.shape[0]:
        return 0
    rows = (hg._tet_stencil(x, lt)[0] if interp == "tetrahedral"
            else hg._fused_rows_frac(x, lt)[0])
    total = 0
    for lvl in range(lt.n_levels):
        sectors = torch.unique(rows[lvl] // 4).numel() * 32
        total += min(sectors, int(lt.sizes[lvl]) * 8)
    return total * n_tables


def hash_bound(kernel: str, x01, lt, n_rows: int = 0, has_b: bool = True,
               mode: str = "exact", has_j: bool = True,
               interp: str = "trilinear"):
    """(bound ms, "bytes" | "operations") of one launch on these inputs:
    the bytes are the inputs read once, the outputs written once and the
    table sectors gathered (H1-bwd: its draws read once and each gradient
    table written once instead of the gathers);
    the operations OPS_POINT_LEVEL + 8 OPS_CORNER a (point, level) of an
    in-range point (tetrahedral: OPS_POINT_LEVEL_TET + 4 OPS_CORNER_TET).
    has_j False: H1-bwd without the jacobian cotangent (OPS_CORNER_NO_J a
    corner, no [L*2, 3, N] cotangent read)."""
    n, L = x01.shape[0], lt.n_levels
    valid = int((~((x01 < 0) | (x01 > 1)).any(-1)).sum())
    tables = 2 if has_b else 1
    if interp == "tetrahedral":
        ops = valid * L * (OPS_POINT_LEVEL_TET + 4 * OPS_CORNER_TET[kernel])
    else:
        corner = OPS_CORNER[kernel] if has_j else OPS_CORNER_NO_J
        ops = valid * L * (OPS_POINT_LEVEL + 8 * corner)
    feats = n * L * 2 * 4
    if kernel == "H1-fwd":
        nbytes = n * 12 + feats * tables + n * L * 6 * 4 \
            + _gather_bytes(x01, lt, tables, interp)
    elif kernel == "H2":
        nbytes = n * 12 + feats + _gather_bytes(x01, lt, 1, interp)
    else:
        cts = feats * tables + (n * L * 6 * 4 if has_j else 0)
        draws = {"exact": 0, "sampled": 3, "sampled_all": 4}[mode] \
            * n * lt.n_hashed * 4
        nbytes = n * 12 + cts + draws + n_rows * 8 * tables
    return bound_ms(nbytes, ops)


def same_bits(a, b) -> bool:
    """Two float32 tensors hold the same bits (NaN payloads included)."""
    import torch

    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def h1_bwd_accumulation_ms(x01, lt, n_rows: int, has_b: bool = True,
                           has_j: bool = True) -> float:
    """The time at the memory rate of what H1-bwd's fixed-point
    accumulation moves beyond the function's bound (hash_bound): the int64
    [tables, n_rows, 2] buffer written by the zero-fill and read by the
    conversion (32 bytes a row and table), and the maxima pass's read of
    the cotangents."""
    n, L = x01.shape[0], lt.n_levels
    tables = 2 if has_b else 1
    cts = n * L * 2 * 4 * tables + (n * L * 6 * 4 if has_j else 0)
    return (32 * n_rows * tables + cts) / MEM_BYTES_S * 1e3


def _check_close(name, got, ref, rel=H_REL) -> float:
    import torch

    if not torch.isfinite(got).all():
        raise RuntimeError(f"{name}: output not finite")
    err = float((got - ref).abs().max())
    if err > rel * float(ref.abs().max()) + 1e-7:
        raise RuntimeError(f"{name} disagrees with plain: max abs err {err}, "
                           f"largest value {float(ref.abs().max())}")
    return err


def compare_h1(x01, emb_a, emb_b, lt, seed: int, timed: bool = False,
               modes=("exact", "sampled", "sampled_all"),
               interp: str = "trilinear", fetch: str = "packed"):
    """H1-fwd and H1-bwd (each mode) against their plain versions on these
    inputs (emb_b None: the single-table call, exact mode only), in the
    instantiation of `interp` and `fetch`. Each kernel: two launches give
    the same bits (H1-bwd's fixed-point sums do not depend on the order of
    its atomics), plain within H_REL of the largest value; the pairs whose
    sampled corner can flip in the last bit carry zero cotangents. Returns
    {kernel: dict(max_abs_err, and when timed ms / plain_ms / bound_ms /
    bound_by, H1-bwd's in the last mode)}; modes () holds H1-fwd alone."""
    import torch

    from holoscene_tpu_torch.ops import hashgrid as hg

    n, L, rows = x01.shape[0], lt.n_levels, emb_a.shape[0]
    has_b = emb_b is not None
    res = {}
    fargs = (x01, emb_a, emb_b, lt, interp, fetch)
    ref = hg.fused_fwd_plain(*fargs)
    out, again = (hg.fused_fwd(*fargs) for _ in range(2))
    torch.cuda.synchronize()
    if not all(a is b or torch.equal(a, b) for a, b in zip(out, again)):
        raise RuntimeError("H1-fwd: two launches on the same inputs differ")
    res["H1-fwd"] = dict(max_abs_err=max(
        _check_close(f"H1-fwd {k}", o, r)
        for k, o, r in zip(("feats_a", "J", "feats_b"), out, ref)
        if o is not None))
    if timed:
        res["H1-fwd"].update(
            ms=cuda_ms(lambda: hg.fused_fwd(*fargs), 20),
            plain_ms=cuda_ms(lambda: hg.fused_fwd_plain(*fargs), 3))
        res["H1-fwd"]["bound_ms"], res["H1-fwd"]["bound_by"] = hash_bound(
            "H1-fwd", x01, lt, has_b=has_b, interp=interp)
    gen = torch.Generator(device=x01.device).manual_seed(seed)
    errs = []
    for mode in modes:
        cts = [torch.randn(n, 2 * L, generator=gen, device=x01.device),
               torch.randn(2 * L, 3, n, generator=gen, device=x01.device),
               torch.randn(n, 2 * L, generator=gen, device=x01.device)
               if has_b else None]
        u_b = torch.rand(3, lt.n_hashed, n, generator=gen, device=x01.device)
        u_a = torch.rand(lt.n_hashed, n, generator=gen, device=x01.device)
        if mode != "exact" and lt.n_hashed:
            keep = torch.ones(L, n, dtype=torch.bool, device=x01.device)
            keep[lt.n_dense:] = ~hg.near_flip_pairs(x01, lt, cts[0], cts[1],
                                                    u_b, u_a, mode)
            cts[0] = cts[0] * keep.T.repeat_interleave(2, 1)
            cts[1] = cts[1] * keep.repeat_interleave(2, 0)[:, None, :]
            cts[2] = cts[2] * keep.T.repeat_interleave(2, 1)
        args = (x01, rows, *cts, lt, mode, u_b, u_a)
        ref = hg.fused_bwd_plain(*args, interp=interp)[:2]
        got, again = (hg.fused_bwd(*args, interp=interp) for _ in range(2))
        for g, a, r, t in zip(got, again, ref, "ab"):
            if g is None:
                continue
            errs.append(_check_close(f"H1-bwd {mode} table {t}", g, r))
            if not same_bits(a, g):
                raise RuntimeError(f"H1-bwd {mode} table {t}: two launches "
                                   "on the same inputs differ")
        if timed and mode == modes[-1]:
            res["H1-bwd"] = dict(
                ms=cuda_ms(lambda: hg.fused_bwd(*args, interp=interp), 20),
                plain_ms=cuda_ms(lambda: hg.fused_bwd_plain(
                    *args, interp=interp), 3))
            res["H1-bwd"]["bound_ms"], res["H1-bwd"]["bound_by"] = \
                hash_bound("H1-bwd", x01, lt, rows, has_b=has_b, mode=mode,
                           interp=interp)
    if errs:
        res.setdefault("H1-bwd", {})["max_abs_err"] = max(errs)
    return res


def compare_h2(x01, emb, lt, timed: bool = False, packed: bool = False,
               interp: str = "trilinear") -> dict:
    """H2 (packed: its mesh-extraction mode, trilinear or tetrahedral)
    against its plain version: two launches give the same bits, plain
    within H_REL of the largest value."""
    import torch

    from holoscene_tpu_torch.ops import hashgrid as hg

    args = (x01, emb, lt, packed, interp)
    ref = hg.sampler_fwd_plain(*args)
    out, again = (hg.sampler_fwd(*args) for _ in range(2))
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise RuntimeError("H2: two launches on the same inputs differ")
    res = dict(max_abs_err=_check_close("H2", out, ref))
    if timed:
        res.update(ms=cuda_ms(lambda: hg.sampler_fwd(*args), 20),
                   plain_ms=cuda_ms(lambda: hg.sampler_fwd_plain(*args), 3))
        res["bound_ms"], res["bound_by"] = hash_bound("H2", x01, lt,
                                                      interp=interp)
    return res


def random_hash_inputs(meta, n: int, dev, seed: int):
    """n random points in [0.01, 0.99]^3 (the first three outside [0, 1])
    and two uniform(-0.5, 0.5) tables of `meta`."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = 0.01 + 0.98 * torch.rand(n, 3, generator=gen, device=dev)
    x[:3] = torch.tensor([[1.2, 0.5, 0.5], [-0.1, 0.3, 0.3],
                          [0.5, 0.5, 1.01]], device=dev)
    ea, eb = (torch.rand(meta.table_rows, 2, generator=gen, device=dev) - 0.5
              for _ in range(2))
    return x, ea, eb


def device_kernels(prof):
    """(busy ms, {kernel name: ms}) of a torch.profiler run from its device
    events alone (the operator events carry their kernels' time too): busy
    is the union of the kernels' intervals."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        spans.append((ev.time_range.start, ev.time_range.end))
        by_name[ev.name] = by_name.get(ev.name, 0.0) \
            + (ev.time_range.end - ev.time_range.start) / 1e3
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, by_name


def record_hash(fn, names, keep=lambda name, args: args):
    """fn() with the hash-kernel wrappers `names` of ops/hashgrid.py
    ("fused_fwd", "fused_bwd", "sampler_fwd") wrapped to record keep(name,
    args) of each call, the positional arguments as the caller passed them
    (the encodes pass interp / fetch after the tables' four): (fn's result,
    {name: [records] in call order}).
    The wrapped calls still launch, and their launches are counted on the
    kernels' own wrappers."""
    from holoscene_tpu_torch.ops import hashgrid as hg

    origs = {k: getattr(hg, k) for k in names}
    records = {k: [] for k in names}

    def wrap(name):
        def wrapped(*args, **kwargs):
            records[name].append(keep(name, args))
            return origs[name](*args, **kwargs)

        wrapped.launches = 0
        return wrapped

    wrappers = {k: wrap(k) for k in names}
    for k, w in wrappers.items():
        setattr(hg, k, w)
    try:
        out = fn()
    finally:
        # a kernel wrapper counts its launches on the name it is bound to,
        # which was the recording wrapper meanwhile
        for k, o in origs.items():
            setattr(hg, k, o)
            o.launches += wrappers[k].launches
    return out, records


def capture_h1(step_fn) -> list:
    """Run step_fn(): [(fwd args, bwd args or None)] of its H1 calls in
    forward order, a call's backward found by its points tensor."""
    import torch

    _, rec = record_hash(step_fn, ("fused_fwd", "fused_bwd"))
    fwd, bwd = rec["fused_fwd"], rec["fused_bwd"]
    torch.cuda.synchronize()
    by_points = {a[0].data_ptr(): a for a in bwd}
    return [(a, by_points.get(a[0].data_ptr())) for a in fwd]


def h1_at_capture(fargs, bargs, reps: int = 20) -> dict:
    """H1-fwd and H1-bwd timed on one captured call (the step's own
    cotangents), with their bounds: {kernel: dict(ms, bound_ms,
    bound_by)}, and the call's shape."""
    from holoscene_tpu_torch.ops import hashgrid as hg

    x01, emb_a, emb_b, lt = fargs[:4]
    emb_a = emb_a.detach()
    emb_b = None if emb_b is None else emb_b.detach()
    out = {"points": x01.shape[0], "levels": lt.n_levels,
           "tables": 1 if emb_b is None else 2}
    out["H1-fwd"] = dict(ms=cuda_ms(lambda: hg.fused_fwd(x01, emb_a, emb_b,
                                                         lt), reps))
    out["H1-fwd"]["bound_ms"], out["H1-fwd"]["bound_by"] = hash_bound(
        "H1-fwd", x01, lt, has_b=emb_b is not None)
    if bargs is not None:
        mode = bargs[6]
        out["mode"] = mode
        out["H1-bwd"] = dict(ms=cuda_ms(lambda: hg.fused_bwd(*bargs), reps))
        out["H1-bwd"]["bound_ms"], out["H1-bwd"]["bound_by"] = hash_bound(
            "H1-bwd", x01, lt, bargs[1], has_b=bargs[4] is not None,
            mode=mode)
    return out


def check_stage1_run(tag, runner, steps, launches, bg_every, per_step,
                     card) -> dict:
    """Every loss finite, rgb_loss falling over the run's thirds, the
    background loss > 0 on its steps (where the patch sees an object) and
    0 on the others, H1-fwd / H1-bwd launched
    per_step times a step plus once a background step, and H2 in each
    background patch's sampler (once, then once a round some ray has not
    converged). Returns the ms a step after the first."""
    hist = runner.history
    keys = ("loss", "rgb_loss", "eikonal_loss", "background_reg_loss",
            "psnr")
    if len(hist) != steps or not all(finite(h[k]) for h in hist
                                     for k in keys):
        raise RuntimeError(f"{tag}: {len(hist)} logged steps for {steps}, "
                           "or a non-finite loss")
    bg_steps = [h["iter"] for h in hist if h["iter"] % bg_every == 0]
    bg_loss = [h["background_reg_loss"] for h in hist
               if h["iter"] % bg_every == 0]
    # the term is 0 by its definition on a patch where no pixel composites
    # to an object (its mask is empty), and on every other step
    if not any(v > 0 for v in bg_loss) or any(
            h["background_reg_loss"] for h in hist
            if h["iter"] % bg_every):
        raise RuntimeError(f"{tag}: background_reg_loss {bg_loss} on the "
                           f"background steps {bg_steps}, expected > 0 on "
                           "some and 0 on every other step")
    trend = thirds(hist, ("loss", "rgb_loss", "eikonal_loss", "psnr"))
    steady = (steps - 1) / (hist[-1]["elapsed_s"] - hist[0]["elapsed_s"])
    log("   first/last third means: " + ", ".join(
        f"{k} {a:.4f} -> {b:.4f}" for k, (a, b) in trend.items())
        + "; background_reg_loss on steps " + ", ".join(
            f"{i}: {v:.5f}" for i, v in zip(bg_steps, bg_loss)))
    log(f"   {steps} steps of {runner.num_pixels} rays in "
        f"{runner.run_seconds:.3f} s: {steps * runner.num_pixels / runner.run_seconds:.1f} rays/s "
        f"(first step included); steps 2..{steps}: {steady:.3f} steps/s, "
        f"{1e3 / steady:.2f} ms/step, {steady * runner.num_pixels:.1f} "
        f"rays/s; launches {launches}; d_out "
        f"{runner.model_cfg.implicit.d_out}; on {card}")
    if not trend["rgb_loss"][1] < trend["rgb_loss"][0]:
        raise RuntimeError(f"{tag}: rgb_loss did not fall: {trend}")
    want = per_step * steps + len(bg_steps)
    if launches["H1-fwd"] != want or launches["H1-bwd"] != want:
        raise RuntimeError(f"{tag}: H1 launches {launches}, expected {want}: "
                           f"{per_step} a step plus one a background step")
    return 1e3 / steady


# a spin of the card (~0.11 ms at 1.755 GHz) before each timed H2 launch
# of phase 12: longer than the host takes to enqueue the launch
SPIN_CYCLES = 200_000


def h2_launch_times(fn):
    """fn() with every H2 launch timed alone: (fn's result, [ms of each
    launch]). CUDA events bracket the launch, after a spin of the card
    (torch.cuda._sleep) that keeps it busy while the host enqueues the
    start event and the launch, so the pair times the kernel and not the
    host."""
    import torch

    from holoscene_tpu_torch.ops import hashgrid as hg

    orig = hg.sampler_fwd
    events = []

    def sampler_fwd(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        out = orig(*args, **kwargs)
        end.record()
        events.append((start, end))
        return out

    # the kernel wrapper counts its launches on the name it is bound to
    sampler_fwd.launches = 0
    hg.sampler_fwd = sampler_fwd
    try:
        out = fn()
    finally:
        hg.sampler_fwd = orig
        orig.launches += sampler_fwd.launches
    torch.cuda.synchronize()
    return out, [a.elapsed_time(b) for a, b in events]


def stage1_meshes(runner, dev, card: str) -> dict:
    """Phase 12 on phase 10's trained runner. Returns H2's extraction
    readings: launches, its device ms summed over the extraction, and on
    the last chunk of the 512^3 grid (x01 = 1) and on its chunk 256 (a
    mid-grid x-plane) max abs err / ms / plain ms / bound."""
    import numpy as np
    import torch

    from holoscene_tpu_torch.models import fields as fl
    from holoscene_tpu_torch.ops import hashgrid as hg
    from holoscene_tpu_torch.training import quality_gate
    from holoscene_tpu_torch.utils import plots
    from holoscene_tpu_torch.utils.eval_geometry import calc_3d_metric

    # the extraction runs untimed; its grid evaluations are recorded (no
    # device work) and replayed after it with each H2 launch timed
    grids = []
    evaluate_grid = plots.evaluate_grid

    def record_grid(*args):
        grids.append(args)
        return evaluate_grid(*args)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base_mem = torch.cuda.memory_allocated(dev)
    reset_counts()
    plots.evaluate_grid = record_grid
    try:
        meshes = runner.extract_meshes()
    finally:
        plots.evaluate_grid = evaluate_grid
    launches = read_hash_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    fine_res = runner.extract_fine_res
    res = runner.conf.get_int("plot.resolution")
    epoch = runner.start_iter
    want = -(-COARSE_RES ** 3 // EXTRACT_CHUNK) + sum(
        -(-r ** 3 // EXTRACT_CHUNK) for r in fine_res)
    faces = [None if m is None else len(m.faces) for m in meshes]
    secs = runner.extract_seconds
    log(f"== 12 meshes of phase 10's run (runner.extract_meshes at the conf's "
        f"plot.resolution {res}, pruning on): fine grids {fine_res}, faces "
        f"{faces}; wall s " + ", ".join(f"{k} {v:.3f}"
                                          for k, v in secs.items())
        + f"; peak device memory {peak / 2**30:.2f} GiB ("
        f"{(peak - base_mem) / 2**30:.2f} GiB above the runner's "
        f"{base_mem / 2**30:.2f}); launches {launches}; on {card}")
    if res != PLOT_RES or launches["H2"] != want or launches["H1-fwd"] \
            or launches["H1-bwd"]:
        raise RuntimeError(f"extraction at {res}: launches {launches}, "
                           f"expected H2 {want} (one a chunk of the coarse "
                           f"{COARSE_RES}^3 sweep and of the fine grids "
                           f"{fine_res}) and no H1")
    _, h2_ms = h2_launch_times(
        lambda: [evaluate_grid(*args) for args in grids])
    if len(h2_ms) != launches["H2"]:
        raise RuntimeError(f"the replayed grid evaluations timed "
                           f"{len(h2_ms)} H2 launches, the extraction made "
                           f"{launches['H2']}")
    h2_sum = sum(h2_ms)
    log(f"   H2 over the extraction's {len(grids)} grid evaluations, "
        f"replayed (CUDA events around each launch): "
        f"{h2_sum:.3f} ms over {len(h2_ms)} launches, "
        f"{h2_sum / len(h2_ms):.4f} ms a launch (fastest {min(h2_ms):.4f}, "
        f"slowest {max(h2_ms):.4f})")
    if meshes[0] is None or not len(meshes[0].faces):
        raise RuntimeError(f"the room's mesh is empty: faces {faces}")
    plots_dir = Path(runner.plots_dir)
    for k, m in enumerate(meshes):
        arts = [plots_dir / f"surface_{epoch}_{k}.ply",
                plots_dir / "bbox" / f"bbox_{k}.json"]
        if [a.exists() for a in arts] != [m is not None] * 2:
            raise RuntimeError(f"object {k} (faces {faces[k]}): artifacts "
                               f"{[(str(a), a.exists()) for a in arts]}")
    t0 = time.perf_counter()
    chamfer = calc_3d_metric(meshes[0], quality_gate.analytic_room(),
                             n_samples=30000, align=False)
    log(f"   room vs the analytic room ({time.perf_counter() - t0:.1f} s): "
        f"{chamfer}")
    if not all(finite(v) for v in chamfer.values()):
        raise RuntimeError(f"room chamfer not finite: {chamfer}")

    # H2 at two extraction chunks of the 512^3 grid: chunk 256 (the plane
    # x01 = 256/511, as most chunks are) and the last (the x01 = 1 plane,
    # every point in one x cell a level), where the grid evaluator is also
    # held against the H1 route
    net = runner.model.implicit
    n = res ** 3
    axis = torch.as_tensor(np.linspace(-1.0, 1.0, res, dtype=np.float32),
                           device=dev)
    lt = hg.level_tables(net.cfg.grid_meta)
    h2 = {"launches": launches["H2"], "sum_ms": h2_sum}
    for tag, start in (("mid", min(res // 2 * res * res, n - EXTRACT_CHUNK)),
                       ("last", max(n - EXTRACT_CHUNK, 0))):
        i = torch.arange(start, start + EXTRACT_CHUNK, device=dev)
        x = torch.stack([axis[i // (res * res)], axis[(i // res) % res],
                         axis[i % res]], -1)
        x01 = ((x / net.cfg.divide_factor + 1.0) * 0.5).contiguous()
        h2[tag] = compare_h2(x01, net.grid.detach(), lt, timed=True,
                             packed=True)
        r = h2[tag]
        earlier = (f"; the kernel it replaced: {H2_EARLIER_EXTRACT_MS:.4f} "
                   f"ms, {H2_EARLIER_EXTRACT_MS / r['ms']:.2f}x"
                   if tag == "last" else "")
        log(f"   H2 (packed) at extraction chunk {start // EXTRACT_CHUNK} "
            f"({x.shape[0]} points x {lt.n_levels} levels, x01 = "
            f"{float(x01[0, 0]):.5f}): kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']} ({100 * r['bound_ms'] / r['ms']:.1f}% of it); "
            f"max abs err {r['max_abs_err']:.3g}, two launches bitwise "
            f"equal{earlier}; on {card}")
    got = fl.implicit_sdf_raw_grid(net, x)
    ref = fl.implicit_sdf_raw(net, x).detach()
    sdf_err = _check_close("grid evaluator vs implicit_sdf_raw (H1)", got,
                           ref)
    log(f"   grid evaluator vs implicit_sdf_raw (H1-fwd) on chunk "
        f"{start // EXTRACT_CHUNK}: max abs err {sdf_err:.3g} of largest "
        f"|SDF| {float(ref.abs().max()):.4f}")
    return h2


def gate_phase(work: Path, card: str) -> dict:
    """Phase 13: the quality gate's code path at GATE_ITERS iterations.
    Returns its launches."""
    from holoscene_tpu_torch.training import quality_gate

    reset_counts()
    t0 = time.perf_counter()
    out = quality_gate.main(["--iters", str(GATE_ITERS), "--work",
                             str(work / "gate"), "--device", "cuda"])
    launches = read_hash_counts()
    first = out["history"][0]["psnr"]
    log(f"== 13 quality gate, {GATE_ITERS} iterations, in "
        f"{time.perf_counter() - t0:.1f} s (training "
        f"{out['train_seconds']:.1f} s): eval PSNR {out['psnr']:.3f} (iteration 0's training PSNR "
        f"{first:.3f}), bg chamfer {out['chamfer']}, faces {out['faces']}; "
        f"launches {launches}; on {card}")
    chamfer = out["chamfer"] or {}
    if not (finite(out["psnr"]) and out["psnr"] > first) or not chamfer \
            or not all(finite(v) for v in chamfer.values()) \
            or min(launches.values()) < 1:
        raise RuntimeError(f"quality gate: PSNR {out['psnr']} (iteration 0: "
                           f"{first}), chamfer {out['chamfer']}, launches "
                           f"{launches}")
    return launches


# phase 14: finetune iterations a finetune (conf: 500; 100 before phase
# 19 joined the script)
S2_ITERS = 60
# phases 14a / 14: exp_runner_post's and mv_predict's --mesh_resolution,
# half the default 256 since phase 19 joined the script: the room's mesh
# from this extraction sets the host's work in Stage 2's intersection,
# Stage 3's OBJ writing and the export, and the chain's Stage-4 gaussians
# (at 256 those took ~550 s of a 1149 s call on a slow host)
S2_MESH_RES = 128
POST_CONF = Path(__file__).resolve().parent / "confs" / "replica_room0_post.conf"


def stage2_conf(work: Path) -> Path:
    """confs/replica_room0_post.conf with its dataset pointed at phase
    10b's generated 512^2 scene and its expname at phase 10b's run (whose
    checkpoint the CLI loads); d_out comes from the scene."""
    import re

    text = POST_CONF.read_text()
    text = re.sub(r"expname = \S+", "expname = smoke_s1_vjp", text)
    text = re.sub(r"dataset\s*\{[^}]*\}", f"""dataset{{
 data_root_dir = {work / 'data_s1'}
 data_dir = scene_0
 img_res = [{S1_RES}, {S1_RES}]
}}""", text)
    conf = work / "smoke_s2_post.conf"
    conf.write_text(text)
    return conf


def stage2_phase(work: Path, dev, card: str, chain: dict) -> dict:
    """Phase 14: exp_runner_post on phase 10b's checkpoint (the conf
    defaults' model, which the post conf's model section shares). Returns
    {H kernel: {launches, and at the invisible render's / the collision
    points' call: max_abs_err, ms, plain_ms, bound_ms, bound_by}}."""
    import numpy as np
    import torch

    from holoscene_tpu_torch.ops import hashgrid as hg
    from holoscene_tpu_torch.physics import sim
    from holoscene_tpu_torch.stage2 import runner as s2runner
    from holoscene_tpu_torch.stage2.providers import load_vis_info
    from holoscene_tpu_torch.training import exp_runner_post
    from holoscene_tpu_torch.utils import mc, plots

    conf = stage2_conf(work)
    os.environ["HOLOSCENE_PHYSICS"] = "quasistatic"
    sim._PROVIDER = None
    # each finetune step's launches, and each grid evaluation's chunks
    # beside its H2 launches (host-side counters: no device work)
    steps, grids, extracted = [], [], []
    step_fn, grid_fns = s2runner.finetune_step, (mc.evaluate_grid,
                                                 plots.evaluate_grid)
    extract_fn = s2runner.Stage2Runner.extract_meshes

    def recorded_extract(self):
        extracted.append(extract_fn(self))   # the chain record's Stage 1
        return extracted[-1]

    def counted_step(model, *args, **kw):
        before = read_hash_counts()          # each reading synchronizes
        t0 = time.perf_counter()
        out = step_fn(model, *args, **kw)
        after = read_hash_counts()
        steps.append({k: after[k] - before[k] for k in after})
        steps[-1]["ms"] = 1e3 * (time.perf_counter() - t0)
        return out

    def counted_grid(fn):
        def wrapped(f, axes, chunk=EXTRACT_CHUNK, device="cuda"):
            h2 = hg.sampler_fwd.launches
            out = fn(f, axes, chunk, device)
            n = int(np.prod([len(a) for a in axes]))
            grids.append((-(-n // chunk), hg.sampler_fwd.launches - h2))
            return out
        return wrapped

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    s2runner.finetune_step = counted_step
    s2runner.Stage2Runner.extract_meshes = recorded_extract
    mc.evaluate_grid, plots.evaluate_grid = (counted_grid(f)
                                             for f in grid_fns)
    t0 = time.perf_counter()
    try:
        runner = exp_runner_post.main([
            "--conf", str(conf), "--exps_folder", str(work / "exps_s1b"),
            "--mesh_resolution", str(S2_MESH_RES), "--finetune_iters",
            str(S2_ITERS), "--quiet", "--device", "cuda"])
    finally:
        s2runner.finetune_step = step_fn
        s2runner.Stage2Runner.extract_meshes = extract_fn
        mc.evaluate_grid, plots.evaluate_grid = grid_fns
    wall = time.perf_counter() - t0
    chain["stage1_meshes"] = extracted[0]
    chain["stage2"] = {"wall_s": wall, "meshes": sum(
        m is not None for m in runner.result["meshes"]),
        "failed": list(runner.result["failed_objects"]),
        "accepted": runner.result["meshes"]}
    launches = read_hash_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    res = runner.result
    hist = runner.finetune_history
    order = runner.object_order
    timer = runner.timer.seconds
    ft_s = sum(v for k, v in timer.items() if k.endswith("finetune"))
    n_steps = len(hist)
    log(f"== 14 Stage 2 (exp_runner_post on phase 10b's checkpoint, "
        f"{POST_CONF.name}'s loss / invis_loss / model sections, "
        f"--mesh_resolution {S2_MESH_RES}, --finetune_iters {S2_ITERS} of the "
        f"conf's 500, physics {res['physics']}) in {wall:.1f} s: objects "
        f"{order}, {n_steps} finetune steps, {1e3 * ft_s / max(n_steps, 1):.2f}"
        f" ms a step ({100 * ft_s / wall:.1f}% of the phase), peak device "
        f"memory {peak / 2**30:.2f} GiB; launches {launches}; on {card}")
    log("   wall s by part: " + ", ".join(f"{k} {v:.3f}"
                                          for k, v in timer.items()))

    # every loss finite; the object steps carry the invisible view and the
    # collision loss; H1 on every step (render, eikonal, [invisible
    # render,] collision points, each with its exact backward), H2 in the
    # samplers and the collision target; H2 once a grid chunk
    want_steps = S2_ITERS * (1 + len(order))
    if n_steps != want_steps or len(steps) != n_steps:
        raise RuntimeError(f"Stage 2: {n_steps} finetune steps ({len(steps)} "
                           f"counted), expected {want_steps}")
    bad = [h for h in hist if not all(finite(float(v)) for k, v in h.items()
                                      if k != "obj")]
    obj_steps = [h for h in hist if h["obj"]]
    if bad or not obj_steps or not all(
            "invis_loss" in h and "collision_loss" in h for h in obj_steps):
        raise RuntimeError(f"Stage 2 finetune: {len(bad)} steps with a "
                           "non-finite loss, or object steps without "
                           "invis_loss / collision_loss")
    per_kind = {}
    for h, c in zip(hist, steps):
        kind = "object" if h["obj"] else "background"
        want_h1 = 4 if h["obj"] else 3
        if c["H1-fwd"] != want_h1 or c["H1-bwd"] != want_h1 \
                or c["H2"] < want_h1 - 2:
            raise RuntimeError(f"Stage 2 {kind} step launches {c}, expected "
                               f"H1-fwd / H1-bwd {want_h1} and H2 >= "
                               f"{want_h1 - 2}")
        per_kind.setdefault(kind, []).append(c)
    if not grids or any(n != h2 for n, h2 in grids):
        raise RuntimeError(f"Stage 2 grid evaluations (chunks, H2 "
                           f"launches): {grids}")
    log("   a finetune step, its first excluded (between synchronizations): "
        + "; ".join(
            f"{k} {np.mean([c['ms'] for c in v[1:]]):.2f} ms (median "
            f"{np.median([c['ms'] for c in v[1:]]):.2f}, first "
            f"{v[0]['ms']:.1f}), H1-fwd / H1-bwd {v[0]['H1-fwd']}, H2 "
            f"{min(c['H2'] for c in v)}-{max(c['H2'] for c in v)} (mean "
            f"{np.mean([c['H2'] for c in v]):.2f})"
            for k, v in per_kind.items())
        + f"; {len(grids)} grid evaluations, {sum(n for n, _ in grids)} "
        f"chunks, H2 once a chunk")

    # artifacts, meshes, translations
    plots_dir = Path(runner.out_dir)
    meshes = res["meshes"]
    want_files = ["graph_node_dict.pkl", "translation_dict.pkl",
                  "scene_settle.json"] + [
        f"coarse_recon_obj_{i}.ply" for i, m in enumerate(meshes)
        if m is not None] + [f"vis_info_{i}.pkl" for i in order]
    missing = [f for f in want_files if not (plots_dir / f).exists()]
    sane = runner.sanity_radius
    extents = [None if m is None else float(np.abs(m.vertices).max())
               for m in meshes]
    if missing or meshes[0] is None or any(
            m is not None and (not len(m.faces) or e > sane)
            for m, e in zip(meshes, extents)) \
            or not all(np.isfinite(t).all()
                       for t in res["translations"].values()):
        raise RuntimeError(f"Stage 2 artifacts missing {missing}; mesh faces "
                           f"{[None if m is None else len(m.faces) for m in meshes]}"
                           f", extents {extents} (sanity radius {sane}); "
                           f"translations {res['translations']}")
    with open(plots_dir / "scene_settle.json") as f:
        settle = json.load(f)
    log(f"   artifacts {sorted(p.name for p in plots_dir.iterdir() if p.is_file())}; "
        f"accepted faces {[None if m is None else len(m.faces) for m in meshes]}"
        f", largest |coordinate| {extents} (sanity radius {sane}); "
        f"failed objects {res['failed_objects']}; translations "
        + ", ".join(f"{i}: {np.round(t, 4).tolist()}"
                    for i, t in res["translations"].items())
        + f"; scene_settle stable {settle['stable']}, physics "
        f"{settle['physics']}")
    if res["physics"] != {"provider": "quasistatic"}:
        raise RuntimeError(f"Stage 2 physics {res['physics']}")
    # the generative steps that the runner guards with a catch-all (as JAX
    # does): every object that asked for novel views got some from the
    # seed ladder, and coarse_recon made a candidate of them
    report = runner.object_report
    asked = [i for i in order if report.get(i, {}).get("novel_views")
             is not None]
    log(f"   novel views and coarse_recon by object: {report}")
    if not asked or any(not report[i]["novel_views"]
                        or not report[i]["coarse_recon"] for i in asked) \
            or any(e.startswith("coarse_recon") for r in report.values()
                   for e in r["errors"]):
        raise RuntimeError(f"Stage 2 novel views / coarse_recon: objects "
                           f"{order}, report {report}")

    # H1 / H2 against plain at one object finetune step's shapes: one more
    # step of the last object, its calls recorded (after the counts above)
    obj = order[-1]
    mesh = meshes[obj]
    b = mesh.bounds
    _, rec = record_hash(lambda: runner.finetune_object(
        obj, load_vis_info(str(plots_dir / f"vis_info_{obj}.pkl")),
        (b[0] + b[1]) / 2, (b[1] - b[0]) / 2 + 0.05, (0,), n_iters=1),
        ("fused_fwd", "fused_bwd", "sampler_fwd"))
    fwd = rec["fused_fwd"]
    n_inv = runner.fcfg.invis_pixels * runner.cfg.sampler.n_final
    n_coll = runner.fcfg.collision_pts
    if len(fwd) != 4 or [a[0].shape[0] for a in fwd[2:]] != [n_inv, n_coll]:
        raise RuntimeError(f"object step H1 calls {[a[0].shape for a in fwd]}"
                           f", expected the invisible render's {n_inv} "
                           f"points and the {n_coll} collision points last")
    e = runner.cfg.sampler.N_samples_eval + 1
    h2_inv = [a for a in rec["sampler_fwd"]
              if a[0].shape[0] == runner.fcfg.invis_pixels * e]
    out = {k: {"launches": launches[k]} for k in HASH_KERNELS}
    for tag, (x01, emb_a, emb_b, lt) in (("invisible_render", fwd[2][:4]),
                                         ("collision", fwd[3][:4])):
        got = compare_h1(x01, emb_a.detach(),
                         None if emb_b is None else emb_b.detach(), lt,
                         40, timed=True, modes=("exact",))
        for k in ("H1-fwd", "H1-bwd"):
            out[k][f"stage2_{tag}"] = got[k]
        log(f"   {tag} ({x01.shape[0]} points x {lt.n_levels} levels, "
            f"{1 if emb_b is None else 2} table(s)): " + "; ".join(
                f"{k} kernel {got[k]['ms']:.4f} ms, plain "
                f"{got[k]['plain_ms']:.3f} ms, bound {got[k]['bound_ms']:.4f}"
                f" ms by {got[k]['bound_by']} "
                f"({100 * got[k]['bound_ms'] / got[k]['ms']:.1f}%), max abs "
                f"err {got[k]['max_abs_err']:.3g}" for k in ("H1-fwd",
                                                             "H1-bwd"))
            + f"; on {card}")
    x01, emb, lt, packed = h2_inv[0][:4]
    r = compare_h2(x01, emb.detach(), lt, timed=True, packed=packed)
    out["H2"]["stage2_invisible_render"] = r
    log(f"   H2 at the invisible render's first sampler call "
        f"({x01.shape[0]} points x {lt.n_levels} levels): kernel "
        f"{r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, bound "
        f"{r['bound_ms']:.4f} ms by {r['bound_by']} "
        f"({100 * r['bound_ms'] / r['ms']:.1f}%), max abs err "
        f"{r['max_abs_err']:.3g}; on {card}")
    return out


S3_ITERS = 5000       # phase 15: exp_runner_texture's --max_niters default
S3_TEX_RES = 2048     # and its --texture_res
S3_INVIS_ITERS = 50   # the invisible-view run of one object
S3_CHUNK = 1 << 16    # Stage3Runner.export_mesh_texture's bake chunk
TEX_CONF = Path(__file__).resolve().parent / "confs" / "replica_room0_tex.conf"


def stage3_conf(work: Path, test_split: bool = False) -> Path:
    """confs/replica_room0_tex.conf with its dataset pointed at the
    generated 512^2 scene and its expname at phase 14's run (phase 10b's,
    whose plots dir holds Stage 2's meshes), as stage2_conf does;
    test_split holds frames out of training (phase 16's Stage 4)."""
    import re

    text = TEX_CONF.read_text()
    text = re.sub(r"expname = \S+", "expname = smoke_s1_vjp", text)
    split = " test_split = True\n" if test_split else ""
    text = re.sub(r"dataset\s*\{[^}]*\}", f"""dataset{{
 data_root_dir = {work / 'data_s1'}
 data_dir = scene_0
 img_res = [{S1_RES}, {S1_RES}]
{split}}}""", text)
    conf = work / f"smoke_s3_tex{'_split' if test_split else ''}.conf"
    conf.write_text(text)
    return conf


def compare_h1_bwd_no_j(x01, n_rows, lt, seed: int) -> dict:
    """H1-bwd with no jacobian term (one table, exact mode: the packed
    encode's table gradient) against plain on a random cotangent: two
    launches give the same bits, plain within H_REL of the largest
    gradient; kernel ms, plain ms, bound."""
    import torch

    from holoscene_tpu_torch.ops import hashgrid as hg

    ct = torch.randn(x01.shape[0], 2 * lt.n_levels, device=x01.device,
                     generator=torch.Generator(x01.device).manual_seed(seed))
    args = (x01, n_rows, ct, None, None, lt, "exact")
    ref = hg.fused_bwd_plain(*args)[0]
    got, again = hg.fused_bwd(*args)[0], hg.fused_bwd(*args)[0]
    res = dict(max_abs_err=_check_close("H1-bwd (no jacobian)", got, ref))
    if not same_bits(again, got):
        raise RuntimeError("H1-bwd (no jacobian): two launches on the same "
                           "inputs differ")
    res.update(ms=cuda_ms(lambda: hg.fused_bwd(*args), 20),
               plain_ms=cuda_ms(lambda: hg.fused_bwd_plain(*args), 3))
    res["bound_ms"], res["bound_by"] = hash_bound(
        "H1-bwd", x01, lt, n_rows, has_b=False, has_j=False)
    return res


def stage3_phase(work: Path, dev, card: str, gauss_ply: Path,
                 chain: dict) -> dict:
    """Phase 15: exp_runner_texture on phase 14's run, an invisible-view
    run of one object, and the export CLI on the result. Returns {H
    kernel: {launches, and at the colour step's / a bake chunk's inputs:
    max_abs_err, ms, plain_ms, bound_ms, bound_by}}."""
    import pickle
    import shutil

    import numpy as np
    import torch
    from PIL import Image

    from holoscene_tpu_torch.export import cli as export_cli
    from holoscene_tpu_torch.export.load_scene import load_scene
    from holoscene_tpu_torch.ops import hashgrid as hg
    from holoscene_tpu_torch.stage2.providers import load_vis_info
    from holoscene_tpu_torch.training import exp_runner_texture
    from holoscene_tpu_torch.training import stage3 as s3

    conf = stage3_conf(work)
    steps, chunks, bake_pts = [], [], []
    step_fn, query_fn = s3.color_step, s3._query_color_field

    def counted_step(*args):
        before = read_hash_counts()          # each reading synchronizes
        t0 = time.perf_counter()
        loss = step_fn(*args)
        after = read_hash_counts()
        steps.append({k: after[k] - before[k] for k in after})
        steps[-1]["ms"] = 1e3 * (time.perf_counter() - t0)
        steps[-1]["loss"] = loss
        steps[-1]["covered"] = bool(args[4])   # valid_any: a pixel to fit
        return loss

    def counted_query(field, pts, chunk):
        h2 = hg.sampler_fwd.launches
        out = query_fn(field, pts, chunk)
        chunks.append((-(-len(pts) // chunk), hg.sampler_fwd.launches - h2))
        if not bake_pts:
            bake_pts.append(np.array(pts[:chunk], dtype=np.float32))
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    s3.color_step, s3._query_color_field = counted_step, counted_query
    t0 = time.perf_counter()
    try:
        runner = exp_runner_texture.main([
            "--conf", str(conf), "--exps_folder", str(work / "exps_s1b"),
            "--max_niters", str(S3_ITERS), "--texture_res", str(S3_TEX_RES),
            "--quiet", "--device", "cuda"])
    finally:
        s3.color_step, s3._query_color_field = step_fn, query_fn
    wall = time.perf_counter() - t0
    launches = read_hash_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    plots = Path(runner.out_dir)
    n_obj = len(runner.meshes)
    want_steps = S3_ITERS + (n_obj - 1) * (S3_ITERS // 10)
    timer = runner.timer.seconds
    train_s = sum(v for k, v in timer.items() if k.endswith("training"))
    chain["stage3"] = {
        "wall_s": wall, "textured": len(list(plots.glob("surface_*.obj"))),
        "px_per_s": runner.pixels_per_step * len(steps) / train_s}
    log(f"== 15 Stage 3 (exp_runner_texture on phase 14's run, "
        f"{TEX_CONF.name}'s train section, ColorFieldConfig's defaults: 16 "
        f"levels 16-2048, 2^19 rows, hidden 256; {runner.pixels_per_step} "
        f"pixels a step, --max_niters {S3_ITERS}, --texture_res "
        f"{S3_TEX_RES}) in {wall:.1f} s: {n_obj} meshes (faces "
        f"{[len(m.faces) for m in runner.meshes]}), {len(steps)} image steps "
        f"({100 * train_s / wall:.1f}% of the phase in training), peak device "
        f"memory {peak / 2**30:.2f} GiB; launches {launches}; on {card}")
    log("   wall s by part: " + ", ".join(f"{k} {v:.3f}"
                                          for k, v in timer.items()))

    # every step: finite loss, H2 and H1-bwd once, H1-fwd never; each
    # object's MSE falls; H2 once a bake chunk
    if len(steps) != want_steps or any(
            runner.steps[i] != {"image": S3_ITERS if i == 0
                                else S3_ITERS // 10, "invisible": 0}
            for i in range(n_obj)):
        raise RuntimeError(f"Stage 3: {len(steps)} steps, expected "
                           f"{want_steps}; by object {runner.steps}")
    bad = [c for c in steps if (c["H2"], c["H1-bwd"], c["H1-fwd"])
           != (1, 1, 0)]
    losses = torch.stack([c["loss"] for c in steps]).cpu()
    if bad or not torch.isfinite(losses).all():
        raise RuntimeError(f"Stage 3 steps: {len(bad)} with launches other "
                           f"than H2 1 / H1-bwd 1 / H1-fwd 0 ({bad[:3]}), "
                           f"finite losses {bool(torch.isfinite(losses).all())}")
    # an object whose mesh covers no pixel of its instance mask in any
    # frame has nothing to fit: every step's loss is 0 by the step's
    # definition (JAX's where(n_valid > 0, mse, 0)); every other object's
    # MSE falls, and the background and at least one object train
    spans, pos = {}, 0
    for i in range(n_obj):
        spans[i] = steps[pos:pos + runner.steps[i]["image"]]
        pos += len(spans[i])
    covered = {i: sum(c["covered"] for c in span) / len(span)
               for i, span in spans.items()}
    falls = {i: (l[0], l[-1]) for i, l in runner.losses.items()}
    idle = [i for i in range(n_obj) if not covered[i]]
    if any(not (np.isfinite(a) and b < a) for i, (a, b) in falls.items()
           if covered[i]) \
            or any(float(c["loss"]) for i in idle for c in spans[i]) \
            or not covered[0] or len(idle) > n_obj - 2:
        raise RuntimeError(f"Stage 3 MSE did not fall: {falls}; share of "
                           f"steps with a pixel to fit by object {covered}")
    if not chunks or any(n != h2 for n, h2 in chunks):
        raise RuntimeError(f"Stage 3 bake (chunks, H2 launches): {chunks}")
    ms = [c["ms"] for c in steps[1:]]
    log(f"   an image step, the first excluded (between synchronizations): "
        f"{np.mean(ms):.3f} ms (median {np.median(ms):.3f}, first "
        f"{steps[0]['ms']:.1f}), H2 / H1-bwd / H1-fwd 1 / 1 / 0 each; MSE "
        f"first -> last by object: "
        + ", ".join(f"{i}: {a:.5f} -> {b:.5f}" for i, (a, b) in falls.items())
        + "; share of steps with a pixel to fit by object: "
        + ", ".join(f"{i}: {c:.3f}" for i, c in covered.items())
        + (f" (object(s) {idle}: the Stage-2 mesh covers no pixel of the "
           f"instance mask in any frame, every loss 0)" if idle else "")
        + f"; bake: {sum(n for n, _ in chunks)} chunks of <= {S3_CHUNK} "
        f"points, H2 once a chunk")

    # the artifacts: every object's surface_{i}.obj/.mtl/.png, one UV a
    # vertex, a non-constant texture
    report = []
    for i in range(n_obj):
        text = (plots / f"surface_{i}.obj").read_text()
        n_v, n_vt = text.count("\nv "), text.count("\nvt ")
        tex = np.asarray(Image.open(plots / f"surface_{i}.png"))
        if not (plots / f"surface_{i}.mtl").exists() or n_v != n_vt \
                or n_v != 3 * len(runner.meshes[i].faces) \
                or not np.ptp(tex):
            raise RuntimeError(f"Stage 3 surface_{i}: {n_v} vertices, {n_vt} "
                               f"UVs, texture {tex.shape} range "
                               f"{np.ptp(tex.reshape(-1, 3), 0)}")
        report.append(f"{i}: {tex.shape[0]}^2, {n_v} vertices, mean rgb "
                      f"{np.round(tex.reshape(-1, 3).mean(0), 1).tolist()}")
    log("   surfaces: " + "; ".join(report))

    # the invisible-view step on the card: one object, its Stage-2 packs
    with_packs = [i for i in range(1, n_obj)
                  if (plots / f"vis_info_{i}.pkl").exists()]
    obj = next((i for i in with_packs if covered[i]), with_packs[0])
    packs = load_vis_info(str(plots / f"vis_info_{obj}.pkl"))
    counts0 = dict(runner.steps[obj])
    reset_counts()
    t0 = time.perf_counter()
    _, rec = record_hash(lambda: runner.train_object(
        obj, n_iters=S3_INVIS_ITERS, vis_info=packs),
        ("sampler_fwd", "fused_bwd"))
    invis_s = time.perf_counter() - t0
    inv_launches = read_hash_counts()
    got = {k: runner.steps[obj][k] - counts0[k] for k in counts0}
    n_calls = 2 * S3_INVIS_ITERS
    if got != {"image": S3_INVIS_ITERS, "invisible": S3_INVIS_ITERS} \
            or inv_launches != {"H1-fwd": 0, "H1-bwd": n_calls,
                                "H2": n_calls} \
            or not all(np.isfinite(runner.losses[obj])):
        raise RuntimeError(f"Stage 3 invisible-view run: steps {got}, "
                           f"launches {inv_launches}, losses "
                           f"{runner.losses[obj]}")
    log(f"   invisible-view run: object {obj}, {len(packs)} packs of "
        f"{packs[0]['rgb'].shape[0]}^2, {S3_INVIS_ITERS} iterations (image "
        f"step + invisible-view step) in {invis_s:.2f} s, launches "
        f"{inv_launches}, MSE {runner.losses[obj][0]:.5f} -> "
        f"{runner.losses[obj][-1]:.5f}")

    # the export CLI on the run, read back
    if gauss_ply.exists():
        shutil.copy(gauss_ply, plots / "gauss_scene.ply")
    argv = ["--conf", str(conf), "--exps_folder", str(work / "exps_s1b")]
    export_s = {}
    for what in ("glb", "usd", "gs"):
        if what == "gs" and not gauss_ply.exists():
            continue
        t0 = time.perf_counter()
        export_cli.main([what, *argv])
        export_s[f"export {what}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene = load_scene(str(plots))
    export_s["load_scene"] = time.perf_counter() - t0
    with open(plots / "translation_dict.pkl", "rb") as f:
        trans = {int(k): np.asarray(v) for k, v in pickle.load(f).items()}
    prims = scene["usd"]["prims"] if scene["usd"] else {}
    moved = {i: prims.get(f"object_{i}", {}).get("translate")
             for i in range(n_obj)}
    if scene["glb"] is None or len(scene["glb"]["meshes"]) != n_obj \
            or len(prims) != n_obj or any(
                t is None or not np.allclose(t, trans.get(i, np.zeros(3)),
                                             atol=1e-5)
                for i, t in moved.items()):
        raise RuntimeError(f"export: glb meshes "
                           f"{None if scene['glb'] is None else len(scene['glb']['meshes'])}"
                           f", usd prims {sorted(prims)}, translations "
                           f"{moved} (run: {trans})")
    if "export gs" in export_s and not (plots / "scene_gs.usdz").exists():
        raise RuntimeError("export gs: scene_gs.usdz missing")
    log("   export wall s: " + ", ".join(f"{k} {v:.3f}"
                                         for k, v in export_s.items())
        + f"; scene.glb {len(scene['glb']['meshes'])} meshes "
        f"({len(scene['glb'].get('images', []))} textured), usd/ "
        f"{len(prims)} prims, translations as translation_dict.pkl "
        f"({ {i: np.round(t, 4).tolist() for i, t in trans.items()} })")

    # H2 (packed) and H1-bwd (no jacobian) against plain at the colour
    # step's captured inputs and at a bake chunk
    x01, emb, lt, packed = rec["sampler_fwd"][0][:4]
    bx01, n_rows, ct = rec["fused_bwd"][0][:3]
    if not packed or bx01.data_ptr() != x01.data_ptr() \
            or lt.n_levels != 16 or rec["fused_bwd"][0][3] is not None:
        raise RuntimeError("Stage 3 capture: not the packed encode of the "
                           "colour step")
    emb = emb.detach()
    pts = torch.as_tensor(bake_pts[0], device=dev)
    bake_x01 = ((pts / runner.cfg.divide_factor + 1.0) * 0.5).contiguous()
    out = {k: {"launches": launches[k]} for k in HASH_KERNELS}
    for tag, x in (("stage3_color_step", x01), ("stage3_bake_chunk",
                                                 bake_x01)):
        out["H2"][tag] = compare_h2(x, emb, lt, timed=True, packed=True)
        out["H1-bwd"][tag] = compare_h1_bwd_no_j(x, n_rows, lt, 50)
        log(f"   {tag} ({x.shape[0]} points x {lt.n_levels} levels, "
            f"{n_rows} rows): " + "; ".join(
                f"{k} kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, "
                f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
                f"({100 * r['bound_ms'] / r['ms']:.1f}%), max abs err "
                f"{r['max_abs_err']:.3g}"
                for k, r in (("H2 packed", out["H2"][tag]),
                             ("H1-bwd no jacobian", out["H1-bwd"][tag])))
            + f"; on {card}")
    return out


MV_SEEDS = (42, 3, 7)  # phase 14a: mv_predict's --seeds
W3D_ATOL = 1e-5       # the Wonder3D+ provider on the card vs the CPU
# phase 16: the chamfers' samples a mesh and the analytic meshes' grid
CHAMFER_SAMPLES, GT_MESH_RES = 30000, 64
# phase 16b's Stage-4 iterations: a fifth of the CLI's default (200 a
# mesh, 600 here), cut to keep the script in its time as phases 17-19
# joined it (300 with phase 17, 200 with phase 18)
CHAIN_S4_ITERS = 120


def w3d_stand_in(path: Path) -> str:
    """A scripted stand-in of the Wonder3D+ joint denoiser contract (no
    weights): model(imgs_in [2Nv,3,H,W], cam [2Nv,7], noise) -> [2Nv,3,H,W]
    in [0,1], the first Nv normal-domain (+z in the conditioning frame),
    the last Nv colours darkened by the azimuth plus a little noise."""
    import torch

    class StandInW3D(torch.nn.Module):
        def forward(self, imgs, cam, noise):
            az = cam[:, 2].view(-1, 1, 1, 1)
            is_normal = cam[:, 5].view(-1, 1, 1, 1)
            colors = 1.0 - (1.0 - imgs) * (0.5 + 0.4 * torch.cos(az))
            colors = colors + 0.01 * noise
            normal01 = torch.zeros_like(imgs)
            normal01[:, 0] = 0.5
            normal01[:, 1] = 0.5
            normal01[:, 2] = 1.0
            return torch.clamp(is_normal * normal01
                               + (1.0 - is_normal) * colors, 0.0, 1.0)

    torch.jit.script(StandInW3D()).save(str(path))
    return str(path)


def prior_stand_ins(work: Path) -> tuple[str, str]:
    """Scripted toy depth / normal models of the Stage-0 contract
    (model(image [1,3,H,W] in [0,1]) -> depth [1,1,H,W] / normals
    [1,3,H,W]): (depth path, normal path)."""
    import torch

    class ToyDepth(torch.nn.Module):
        def forward(self, image):
            h = image.shape[2]
            ramp = torch.arange(h, dtype=image.dtype,
                                device=image.device).view(1, 1, h, 1) / h
            return image.mean(dim=1, keepdim=True) * 2.0 + 0.5 + ramp

    class ToyNormal(torch.nn.Module):
        def forward(self, image):
            n = image * 2.0 - 1.0
            return torch.cat([n[:, :2], -(1.0 + image[:, 2:3])], dim=1)

    paths = (str(work / "toy_depth.pt"), str(work / "toy_normal.pt"))
    for module, path in zip((ToyDepth(), ToyNormal()), paths):
        torch.jit.script(module).save(path)
    return paths


def mv_predict_phase(work: Path, dev, card: str, chain: dict) -> dict:
    """Phase 14a: stage2/mv_predict.py on phase 10b's checkpoint, then the
    live Wonder3D+ provider with a scripted stand-in denoiser on the card
    against the CPU. Returns {H kernel: {launches of the CLI run, and at
    the renders' first H1-fwd / unpacked H2 call: max_abs_err, ms,
    plain_ms, bound_ms, bound_by}}."""
    import numpy as np

    from holoscene_tpu_torch.stage2 import mv_predict
    from holoscene_tpu_torch.stage2 import providers as prov
    from holoscene_tpu_torch.stage2 import runner as s2runner

    conf = stage2_conf(work)
    meshes = []
    extract_fn = s2runner.Stage2Runner.extract_meshes

    def recorded_extract(self):
        meshes.append(extract_fn(self))
        return meshes[-1]

    # the first H1-fwd call and the first unpacked H2 call (the extraction's
    # grid chunks are packed): the novel-view renders' first chunk
    first = {}

    def keep_first(name, args):
        if name == "fused_fwd" or not args[3]:
            first.setdefault(name, args)

    out_dir = work / "mv_cache"
    reset_counts()
    s2runner.Stage2Runner.extract_meshes = recorded_extract
    t0 = time.perf_counter()
    try:
        written, _ = record_hash(lambda: mv_predict.main([
            "--conf", str(conf), "--exps_folder", str(work / "exps_s1b"),
            "--mesh_resolution", str(S2_MESH_RES), "--seeds",
            *map(str, MV_SEEDS), "--out", str(out_dir), "--quiet",
            "--device", "cuda"]), ("fused_fwd", "sampler_fwd"), keep_first)
    finally:
        s2runner.Stage2Runner.extract_meshes = extract_fn
    launches = read_hash_counts()
    wall = time.perf_counter() - t0
    chain["mv_predict"] = {"wall_s": wall, "caches": len(written)}
    with_mesh = [i for i, m in enumerate(meshes[0]) if i and m is not None]
    log(f"== 14a mv_predict (stage2/mv_predict.py on phase 10b's checkpoint, "
        f"--mesh_resolution {S2_MESH_RES}, --seeds {list(MV_SEEDS)}, the "
        f"model-render provider) in {wall:.1f} s: objects with a mesh "
        f"{with_mesh} (faces {[None if m is None else len(m.faces) for m in meshes[0]]})"
        f", caches {[Path(p).name for p in written]}; launches {launches}; "
        f"on {card}")
    if written != [str(out_dir / f"vis_info_{i}.pkl") for i in with_mesh] \
            or not written:
        raise RuntimeError(f"mv_predict wrote {written}; objects with a "
                           f"mesh {with_mesh}")
    for path in written:
        views = prov.load_vis_info(path)
        if len(views) != 6 or any(
                not {"pose", "rgb", "normal", "mask"} <= set(v)
                or not np.isfinite(v["rgb"]).all()
                or not np.isfinite(v["normal"]).all() for v in views):
            raise RuntimeError(f"mv_predict cache {path}: {len(views)} views "
                               f"with keys {[sorted(v) for v in views]}")
    # H2 in the extraction's grid chunks and the renders' samplers, H1-fwd
    # in the renders' field (no backward: H1-bwd never)
    if launches["H1-fwd"] < 1 or launches["H2"] < 1 or launches["H1-bwd"]:
        raise RuntimeError(f"mv_predict launches {launches}")
    if set(first) != {"fused_fwd", "sampler_fwd"}:
        raise RuntimeError(f"mv_predict's renders made no H1-fwd or unpacked "
                           f"H2 call: {sorted(first)}")

    # H1 / H2 against plain at the renders' first chunk (after the counts)
    out = {k: {"launches": launches[k]} for k in HASH_KERNELS}
    x01, emb_a, emb_b, lt = first["fused_fwd"][:4]
    got = compare_h1(x01, emb_a.detach(),
                     None if emb_b is None else emb_b.detach(), lt, 41,
                     timed=True, modes=("exact",))
    x2, emb2, lt2, packed = first["sampler_fwd"][:4]
    got["H2"] = compare_h2(x2, emb2.detach(), lt2, timed=True, packed=packed)
    shapes = {"H1-fwd": (x01, lt), "H1-bwd": (x01, lt), "H2": (x2, lt2)}
    for k in HASH_KERNELS:
        out[k]["mv_predict_render"] = got[k]
    log("   the renders' first chunk vs plain: " + "; ".join(
        f"{k} ({shapes[k][0].shape[0]} points x {shapes[k][1].n_levels} "
        f"levels) kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, "
        f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
        f"({100 * r['bound_ms'] / r['ms']:.1f}%), max abs err "
        f"{r['max_abs_err']:.3g}" for k, r in got.items()) + f"; on {card}")

    # the live Wonder3D+ provider (TorchScript joint denoiser) on the card
    # against the same provider on the CPU, from a cache's front view
    ckpt = w3d_stand_in(work / "w3d_stand_in.pt")
    front = prov.load_vis_info(written[0])[0]
    poses = [v["pose"] for v in prov.load_vis_info(written[0])]
    views = {}
    t0 = time.perf_counter()
    for d in (dev, "cpu"):
        provider = prov.DiffusersNovelViewProvider(
            ckpt, d, fg_extractor=prov.ThresholdForegroundExtractor())
        views[str(d)] = provider.generate_views(front["rgb"], front["mask"],
                                                poses, seed=MV_SEEDS[0])
    got, ref = views[str(dev)], views["cpu"]
    err = max(float(np.abs(g[k] - r[k]).max()) for g, r in zip(got, ref)
              for k in ("rgb", "normal"))
    mask_share = max(float((g["mask"] != r["mask"]).mean())
                     for g, r in zip(got, ref))
    log(f"   DiffusersNovelViewProvider (scripted stand-in, img_size "
        f"{provider.img_size}) on {dev} vs the CPU, {len(got)} views of "
        f"{got[0]['rgb'].shape}: max abs err {err:.3g} (within {W3D_ATOL}), "
        f"mask pixels apart {mask_share:.3g}, {time.perf_counter() - t0:.1f}"
        f" s for both")
    if len(got) != 6 or not err <= W3D_ATOL or mask_share > 1e-3:
        raise RuntimeError(f"Wonder3D+ provider on the card: max abs err "
                           f"{err}, mask share apart {mask_share}")
    return out


def _quartile_medians(values):
    import numpy as np

    return [float(np.median(q)) for q in np.array_split(np.asarray(values),
                                                        4)]


def chain_phase(work: Path, dev, card: str, chain: dict) -> dict:
    """Phase 16: Stage 0 with scripted toy models on a copy of the scene
    (card vs CPU), Stage 4 (exp_runner_gaussian) on phase 15's textured
    meshes, and the chain record with the geometry of stages 1-3 against
    the analytic scene. Returns (K1-K4's launches of the Stage-4 run, K1/K2
    against plain on its training frame 0: compare_flat's result)."""
    import shutil

    import numpy as np
    import torch
    from PIL import Image

    from holoscene_tpu_torch.datasets.synthetic import scene_meshes
    from holoscene_tpu_torch.ops import splat_flat as sf
    from holoscene_tpu_torch.stage0 import priors
    from holoscene_tpu_torch.training import exp_runner_gaussian
    from holoscene_tpu_torch.training import stage4 as s4
    from holoscene_tpu_torch.utils.eval_geometry import calc_3d_metric

    # 16a Stage 0 on copies of the generated scene (data_s1 stays as is)
    depth_ckpt, normal_ckpt = prior_stand_ins(work)
    written, secs = {}, {}
    for d in ("cuda", "cpu"):
        root = work / ("data_s0" if d == "cuda" else "data_s0_cpu")
        shutil.copytree(work / "data_s1" / "scene_0", root / "scene_0")
        t0 = time.perf_counter()
        written[d] = priors.main([
            "--scene_dir", str(root / "scene_0"), "--depth_checkpoint",
            depth_ckpt, "--normal_checkpoint", normal_ckpt, "--overwrite",
            "--device", d])
        secs[d] = time.perf_counter() - t0
    (d_gpu, n_gpu), (d_cpu, n_cpu) = written["cuda"], written["cpu"]
    depth_err = max(float(np.abs(np.load(a) - np.load(b)).max())
                    for a, b in zip(d_gpu, d_cpu))
    normals_equal = all(np.array_equal(np.asarray(Image.open(a)),
                                       np.asarray(Image.open(b)))
                        for a, b in zip(n_gpu, n_cpu))
    log(f"== 16 the chain: (a) Stage 0 (stage0/priors.py, scripted toy depth "
        f"and normal models) on a copy of the {S1_IMAGES} x {S1_RES}^2 scene "
        f"in {secs['cuda']:.2f} s on {dev} ({secs['cpu']:.2f} s on the CPU): "
        f"{len(d_gpu)} depth + {len(n_gpu)} normal files; depth max abs err "
        f"vs the CPU run {depth_err:.3g} (within 1e-6), normal PNGs equal "
        f"{normals_equal}")
    if len(d_gpu) != S1_IMAGES or not depth_err <= 1e-6 \
            or not normals_equal:
        raise RuntimeError(f"Stage 0: {len(d_gpu)} files, depth err "
                           f"{depth_err}, normals equal {normals_equal}")

    # 16b Stage 4 on phase 15's textured meshes (surface_{i}.obj)
    conf = stage3_conf(work, test_split=True)
    step_launches, export_s = [], []
    step_fn, export_fn = s4.Stage4Runner._step, s4.Stage4Runner.export

    def counted_step(self, *args):
        k1, k2 = sf.flat_fwd.launches, sf.flat_bwd.launches
        out = step_fn(self, *args)
        step_launches.append((sf.flat_fwd.launches - k1,
                              sf.flat_bwd.launches - k2))
        return out

    def timed_export(self):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = export_fn(self)
        export_s.append(time.perf_counter() - t)
        return out

    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    s4.Stage4Runner._step, s4.Stage4Runner.export = counted_step, timed_export
    t0 = time.perf_counter()
    try:
        runner = exp_runner_gaussian.main(
            ["--conf", str(conf), "--exps_folder", str(work / "exps_s1b"),
             "--max_niters", str(CHAIN_S4_ITERS), "--log_every", "1",
             "--quiet", "--device", "cuda"])
    finally:
        s4.Stage4Runner._step, s4.Stage4Runner.export = step_fn, export_fn
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    hist, iters = runner.history, runner.max_total_iters
    n_gauss = runner.static["num_gaussians"]
    per_obj = [hi - lo for lo, hi in runner.instance_ranges]
    plots = Path(runner.out_dir)
    test = runner.test_metrics
    trend = thirds(hist, ("loss", "l1", "psnr"))
    steps_s = iters / runner.run_seconds
    steady_s = (iters - 1) / (hist[-1]["elapsed_s"] - hist[0]["elapsed_s"])
    log(f"   (b) Stage 4 (exp_runner_gaussian on phase 15's run: "
        f"{len(runner.meshes)} meshes, faces "
        f"{[len(m.faces) for m in runner.meshes]}) in {wall:.1f} s: "
        f"{n_gauss} gaussians (by object {per_obj}), SH "
        f"{runner.cfg.sh_degree}, {iters} steps in {runner.run_seconds:.3f} s:"
        f" {steps_s:.3f} steps/s, {n_gauss * steps_s:.6g} splats/s (first "
        f"step included); steps 2..{iters}: {steady_s:.3f} steps/s, "
        f"{1e3 / steady_s:.2f} ms/step, {n_gauss * steady_s:.6g} splats/s; "
        f"rebins {runner.rebin_count}, stale steps {runner.stale_steps}; "
        f"peak device memory {peak / 2**30:.2f} GiB; launches {launches}; "
        f"on {card}")
    log("   first/last third means: " + ", ".join(
        f"{k} {a:.4f} -> {b:.4f}" for k, (a, b) in trend.items())
        + f" (l1 {'fell' if trend['l1'][1] < trend['l1'][0] else 'did not fall'}"
        f", reported, not checked); test {test}; export (gauss_obj_{{i}}.ply"
        f"/.npz, gauss_scene.ply, gauss_scene.usdz) "
        f"{export_s[0] if export_s else float('nan'):.3f} s")
    if len(hist) != iters or not all(finite(h["loss"]) and finite(h["l1"])
                                     for h in hist):
        raise RuntimeError(f"Stage 4 on the chain: {len(hist)} logged steps "
                           f"for {iters}, or a non-finite loss")
    if len(step_launches) != iters or any(k1 < 1 or k2 < 1
                                          for k1, k2 in step_launches):
        raise RuntimeError(f"Stage 4 on the chain: K1/K2 not launched every "
                           f"step ({len(step_launches)} steps counted)")
    missing = [n for n in ("gauss_scene.ply", "gauss_scene.usdz")
               if not (plots / n).exists()]
    if missing or not (finite(test["psnr"]) and finite(test["ssim"])):
        raise RuntimeError(f"Stage 4 on the chain: missing {missing}, test "
                           f"{test}")
    # K1/K2 against plain on the chain run's training frame 0 (after the
    # counts), at the tile lengths of its gaussians
    h, w = runner.dataset.img_res
    pose, intr = runner._pose_intr(0)
    xy, depth, conic, _, _, opac, rgb = gom_projection(runner, pose, intr,
                                                       w, h)
    bins = runner._get_bins(0, pose, intr)
    cand = sf.gather_payload(xy, depth, conic, opac, rgb, bins["gidx"])
    walks = compare_flat(cand, bins["tile_chunk_start"],
                         bins["tile_chunk_cnt"], -(-w // 16), w, h, 7,
                         timed=True)
    longest = max(walks["K1"]["tiles_by_walked_chunks"])
    log(f"   K1/K2 vs plain, the chain's training frame 0 "
        f"({cand.shape[0] // sf.CHUNK} flat chunks, "
        f"{walks['K1']['walked_chunks']} walked, at most {longest} a tile; "
        f"{walks['K1']['live_candidate_pixels']} of "
        f"{walks['K1']['candidate_pixels']} candidate-pixels live): "
        + "; ".join(f"{k} max abs err {r['max_abs_err']:.3g}"
                    f"{exact_note(r)}, kernel "
                    f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
                    f"{r['bound_ms']:.4f} ms by {r['bound_by']}"
                    for k, r in walks.items()) + f"; on {card}")
    chain["stage4"] = {
        "wall_s": wall, "psnr": test["psnr"], "ssim": test["ssim"],
        "lpips": test["lpips"] if finite(test["lpips"]) else None,
        "gaussians": n_gauss, "iters": iters,
        "stale_steps": runner.stale_steps,
        "loss_quartile_medians": _quartile_medians([h["loss"]
                                                    for h in hist]),
        "l1_quartile_medians": _quartile_medians([h["l1"] for h in hist])}

    # 16c the chain record: each stage's meshes against the analytic scene
    t0 = time.perf_counter()
    truth = scene_meshes(GT_MESH_RES)
    stages = {"stage1": chain.pop("stage1_meshes"),
              "stage2": chain["stage2"].pop("accepted"),
              "stage3": runner.meshes}
    geometry = {
        stage: {str(i): {k: float(v) for k, v in calc_3d_metric(
            m, truth[i], n_samples=CHAMFER_SAMPLES, align=False).items()}
            for i, m in enumerate(meshes)
            if m is not None and i < len(truth) and len(m.faces)}
        for stage, meshes in stages.items()}
    record = dict(chain)
    record["geometry"] = geometry
    record["total"] = {"wall_s": sum(v["wall_s"] for v in chain.values())}
    bad = [f"{st}/{i}" for st, g in geometry.items() for i, m in g.items()
           if not all(finite(v) for v in m.values())]
    if bad or not geometry["stage3"]:
        raise RuntimeError(f"chain geometry: non-finite chamfers {bad} or "
                           f"none for Stage 3: {geometry}")
    log(f"   (c) chain record (geometry: calc_3d_metric of each object's "
        f"mesh against the analytic scene at {GT_MESH_RES}^3, "
        f"{CHAMFER_SAMPLES} samples, no alignment; "
        f"{time.perf_counter() - t0:.1f} s):")
    log(json.dumps(record))
    return launches, walks


# ---------------------------------------------------------------------------
# phase 17: the free-Gaussian trainer and the Gaussian ray tracer
# ---------------------------------------------------------------------------

FREE_CAPACITY, FREE_WARMUP, FREE_REFINE, FREE_ITERS = 100_000, 500, 100, 700
FREE_RESUME = 10          # (b): iterations after the checkpoint's
MCMC_ITERS, MCMC_WARMUP, MCMC_EVERY = 200, 50, 50
COLMAP_ITERS, COLMAP_POINTS = 60, 20_000
COLMAP_FISHEYE = (0.02, 0.004, -0.001, 0.0002)   # OPENCV_FISHEYE k1..k4
UT_DIST = ("0.02", "0.005", "0.001", "-0.001")    # gs_render --camera opencv
TRACE_HITS = 128          # gs_render --max_hits' default
# T1's K, min_kernel, min_alpha, near and kernel degree: trace_image's
T1_ARGS = (TRACE_HITS, 0.0113, 1.0 / 255.0, 1e-4, 2)
TRACE_PSNR_MIN = 20.0     # trace vs raster of one view (the JAX test: 24 dB
                          # on a random cloud of round particles)
T1_ATOL = 1e-5            # composite of T1's hits vs plain's
# float32 operations per (ray, gaussian) pair up to T1's acceptance test
# (kernel degree 2, counted from csrc/gs_trace_select.cu): o - mu 3, the
# two 3x3 transforms 30, |grdu| 7 (with the sqrt and the clamp), grd 3,
# t_proj 6, the cross product 9 and its square 5, the response 2 (one exp),
# alpha 2, the three tests 3; the bound counts it for each pair whose ray
# meets the gaussian's exact sphere (the pairs the function needs tested)
T1_OPS_PAIR = 65


def free_frame_walks(tr, frame: int, timed: bool) -> dict:
    """K1/K2 against plain on a GSTrainer's training frame as its step
    hands them over (free_frame_inputs)."""
    return compare_flat(*free_frame_inputs(tr, frame), 8, timed=timed)


def free_frame_inputs(tr, frame: int) -> tuple:
    """K1's inputs at a GSTrainer's training frame as its step hands them
    over: the trainer's flat plan and bins (_get_bins) over every slot of
    its capacity, dead slots at opacity 0, the candidates gathered from the
    current parameters. Returns (cand, cs, cc, tiles_x, width, height)."""
    import torch

    from holoscene_tpu_torch.ops import splat_flat as sf
    from holoscene_tpu_torch.ops.gaussians import view_matrix

    p, cfg = tr.params, tr.cfg
    h, w = tr.dataset.img_res
    pose, intr = tr._pose_intr(tr.dataset.pose_all[frame])
    with torch.no_grad():
        bins = tr._get_bins(frame, pose, intr)
        colors = torch.cat([p["features_dc"][:, None, :],
                            p["features_rest"]], dim=1)
        opac = torch.sigmoid(p["opacity_logits"]) * tr.state["alive"]
        xy, depth, conic, _, _, opac, rgb = projection(
            p["means"], p["quats"], torch.exp(p["log_scales"]), opac, colors,
            view_matrix(pose, pose.device), intr, w, h, cfg.sh_degree,
            camera_model=cfg.camera_model, dist=cfg.dist)
        cand = sf.gather_payload(xy, depth, conic, opac, rgb, bins["gidx"])
    return (cand, bins["tile_chunk_start"], bins["tile_chunk_cnt"],
            -(-w // cfg.tile_size), w, h)


def walk_note(walks: dict, card: str) -> str:
    return "; ".join(f"{k} max abs err {r['max_abs_err']:.3g}"
                     f"{exact_note(r)}, kernel {r['ms']:.3f} ms, plain "
                     f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
                     f"by {r['bound_by']}" for k, r in walks.items()) \
        + f"; on {card}"


def write_colmap_scene(src: Path, dst: Path, camera: tuple) -> Path:
    """An OPENCV_FISHEYE COLMAP reconstruction (cameras / images /
    points3D.bin) of a generated scene: its images and poses, the
    distortion coefficients `camera`, and COLMAP_POINTS points sampled on
    the analytic scene's surfaces as its sparse cloud."""
    import shutil
    import struct

    import numpy as np

    from holoscene_tpu_torch.datasets.synthetic import scene_meshes
    from holoscene_tpu_torch.training.gs_render import load_dataset

    ds = load_dataset("ns", str(src))
    h, w = ds.img_res
    k = ds.intrinsics
    sparse = dst / "sparse" / "0"
    sparse.mkdir(parents=True)
    shutil.copytree(src / "images", dst / "images")
    names = sorted(p.name for p in (dst / "images").iterdir())
    with open(sparse / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 5, w, h))
        f.write(struct.pack("<8d", k[0, 0], k[1, 1], k[0, 2], k[1, 2],
                            *camera))
    with open(sparse / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", len(names)))
        for i, (name, c2w) in enumerate(zip(names, ds.pose_all)):
            rot = c2w[:3, :3].T.astype(np.float64)      # world to camera
            tvec = -rot @ c2w[:3, 3]
            qw = np.sqrt(max(1.0 + np.trace(rot), 1e-12)) / 2
            qvec = (qw, (rot[2, 1] - rot[1, 2]) / (4 * qw),
                    (rot[0, 2] - rot[2, 0]) / (4 * qw),
                    (rot[1, 0] - rot[0, 1]) / (4 * qw))
            f.write(struct.pack("<i4d3di", i + 1, *qvec, *tvec, 1))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", 0))
    rng = np.random.default_rng(0)
    pts = np.concatenate([m.sample_surface(COLMAP_POINTS // 3, rng)
                          for m in scene_meshes(32)])
    with open(sparse / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        for i, xyz in enumerate(pts):
            f.write(struct.pack("<Q3d3BdQ", i + 1, *xyz, 128, 128, 128,
                                0.5, 0))
    return dst


def t1_inputs(g: dict, ds, dev):
    """T1's inputs at view 0 of `ds`: the gaussian tensors as trace_image
    makes them (means, unit quats, scales, opacities, SH), packed, and the
    view's row-major pinhole rays."""
    import torch

    from holoscene_tpu_torch.ops import gs_trace
    from holoscene_tpu_torch.training import gs_render

    means, quats, scales, opac, sh = gs_render.gaussian_tensors(g, dev)
    quats = quats / torch.linalg.vector_norm(quats, dim=-1, keepdim=True)
    h, w = ds.img_res
    rays = gs_trace.pinhole_rays(ds.pose_all[0], ds.intrinsics[:3, :3], w,
                                 h, dev)
    return ((means, quats, scales, opac, sh),
            gs_trace.pack_gaussians(means, quats, scales, opac), *rays)


def t1_work(g13, ro, rd) -> dict:
    """T1's work on one selection, from the cull's plain mirror: each
    block's survivors, the exact pairs the kernel tests, the pairs whose ray
    meets the exact sphere (the work the function needs), and the bound."""
    import torch

    from holoscene_tpu_torch.ops import gs_trace

    k, min_kernel, min_alpha, near, degree = T1_ARGS
    cut = (min_kernel, min_alpha, degree)
    bundles = gs_trace.ray_bundles(ro, rd, near)
    keep = gs_trace.bundle_survivors(gs_trace.cull_spheres(g13, ro, *cut),
                                     bundles)
    met = gs_trace.ray_sphere_pairs(
        gs_trace.cull_spheres(g13, ro, *cut, exact=True), ro, rd, keep)
    per_block = keep.sum(1)
    n = ro.shape[0]
    rays_in = torch.clamp(n - torch.arange(per_block.numel(),
                                           device=ro.device)
                          * gs_trace.CULL_RAYS, max=gs_trace.CULL_RAYS)
    bound, by = bound_ms(n * (24 + 4 * k + 4) + g13.shape[0] * 52,
                         met * T1_OPS_PAIR)
    return {"blocks": per_block.numel(),
            "culling_blocks": int(bundles["cull"].sum()),
            "survivors_mean": float(per_block.float().mean()),
            "survivors_max": int(per_block.max()),
            "exact_pairs": int((per_block * rays_in).sum()),
            "sphere_pairs": met, "bound": bound, "by": by}


def t1_against_plain(g: dict, ds, dev, card: str) -> dict:
    """Phase 17 (f): T1 against plain on the middle 65,536-ray selection of
    view 0 of `ds` (a gaussian dict g): pinhole rays in trace_image's tile
    order and row-major, and fisheye rays (as phase 17 (e) traces them,
    rays past theta = pi/2 included) in tile order. For each: bitwise
    indices, two launches, the composite, the cull's survivors (plain
    mirror), kernel ms and both bounds; plain ms for the pinhole tiles.
    Returns {"tile": ..., "row": ..., "fisheye": ...} and the all-pairs
    bound in "all_pairs"."""
    import torch

    from holoscene_tpu_torch.ops import gs_trace

    h, w = ds.img_res
    gt, g13, ro_all, rd_all = t1_inputs(g, ds, dev)
    means, quats, scales, opac, sh = gt
    n_sel = min(gs_trace.SELECT_RAYS, h * w)
    mid = (h * w // n_sel // 2) * n_sel
    tiles = gs_trace.tile_order(w, h, dev)[mid:mid + n_sel]
    fish = gs_trace.fisheye_rays(ds.pose_all[0], ds.intrinsics[:3, :3], w,
                                 h, dev)
    sels = {"tile": (ro_all, rd_all, tiles),
            "row": (ro_all, rd_all, torch.arange(mid, mid + n_sel,
                                                 device=dev)),
            "fisheye": (*fish, tiles)}
    args = T1_ARGS
    n_live = int((opac > 1.0 / 255.0).sum())
    # the all-pairs bound: every (ray, live gaussian) pair, packed rows only
    all_pairs = bound_ms(n_sel * (24 + 4 * TRACE_HITS + 4) + g13.numel() * 4,
                         n_sel * n_live * T1_OPS_PAIR)[0]
    t1 = {}
    for order, (o_all, d_all, sel) in sels.items():
        ro, rd = o_all[sel].contiguous(), d_all[sel].contiguous()
        idx, cnt = gs_trace.select_hits(g13, ro, rd, *args)
        idx2, cnt2 = gs_trace.select_hits(g13, ro, rd, *args)
        ref_i, ref_c = gs_trace.select_hits_plain(g13, ro, rd, *args)
        got = gs_trace.composite_hits(means, quats, scales, opac, sh, ro, rd,
                                      idx, cnt, 3)
        want = gs_trace.composite_hits(means, quats, scales, opac, sh, ro,
                                       rd, ref_i, ref_c, 3)
        r = t1[order] = {
            "same_bits": torch.equal(idx, idx2) and torch.equal(cnt, cnt2),
            "equal_plain": torch.equal(idx, ref_i) and torch.equal(cnt,
                                                                   ref_c),
            "mismatches": int((idx != ref_i).sum() + (cnt != ref_c).sum()),
            "err": max(float((got[k] - want[k]).abs().max()) for k in got),
            "hits": float(cnt.float().mean()), "max_hits": int(cnt.max()),
            "ms": cuda_ms(lambda: gs_trace.select_hits(g13, ro, rd, *args),
                          10),
            **t1_work(g13, ro, rd)}
        if order == "tile":
            r["plain_ms"] = cuda_ms(
                lambda: gs_trace.select_hits_plain(g13, ro, rd, *args), 2)
        log(f"   (f) T1 vs plain, {order}, {n_sel} rays x "
            f"{g13.shape[0]} gaussians ({n_live} can pass 1/255), K "
            f"{TRACE_HITS}: indices equal plain's {r['equal_plain']}, two "
            f"launches bitwise {r['same_bits']}, hits a ray {r['hits']:.1f} "
            f"(max {r['max_hits']}), composite max abs err {r['err']:.3g}; "
            f"survivors a block {r['survivors_mean']:.1f} (max "
            f"{r['survivors_max']}; {r['culling_blocks']} of "
            f"{r['blocks']} blocks cull), exact pairs tested "
            f"{r['exact_pairs']} of {n_sel * g13.shape[0]} "
            f"({r['exact_pairs'] / (n_sel * g13.shape[0]):.3%}), pairs "
            f"meeting the exact sphere {r['sphere_pairs']}; kernel "
            f"{r['ms']:.3f} ms"
            + (f", plain {r['plain_ms']:.3f} ms" if "plain_ms" in r else "")
            + f", bound {r['bound']:.4f} ms by {r['by']} "
            f"({r['bound'] / r['ms']:.1%}; the all-pairs bound "
            f"{all_pairs:.4f} ms, {all_pairs / r['ms']:.1%}); on {card}")
    bad = {o: r for o, r in t1.items() if not (
        r["same_bits"] and r["equal_plain"] and r["err"] <= T1_ATOL)}
    if bad:
        raise RuntimeError(f"T1 vs plain: {bad}")
    t1["all_pairs"] = all_pairs
    return t1



def free_gaussian_phase(work: Path, dev, card: str, gauss_ply: Path,
                        paths: dict, other: dict) -> dict:
    """Phase 17: gs_train (splatfacto, resume, MCMC, a distorted COLMAP
    scene), gs_render's ray tracer and UT camera on phase 4's export, T1
    against plain, one viewer frame. Fills paths["gs_train"] with K1-K4's
    launches of (a), other["gs_train"] with K1/K2 against plain on (a)'s
    training frame and other["ut_raster"] with K3 against plain on the UT
    raster's lists; returns T1's kernel-table row (its launches: the
    two traced runs of (e))."""
    import numpy as np
    import torch

    from holoscene_tpu_torch import viewer
    from holoscene_tpu_torch.export.gs_ingp import read_gaussians_ingp
    from holoscene_tpu_torch.models.gom import read_gaussian_ply
    from holoscene_tpu_torch.ops import gs_trace
    from holoscene_tpu_torch.ops.gaussians import view_matrix
    from holoscene_tpu_torch.training import gs_render, gs_train

    def t1_count():
        torch.cuda.synchronize()
        return gs_trace.select_hits.launches

    wall = {}
    scene = work / "data_s1" / "scene_0"
    out = work / "gs_free"
    common = ["--dataset", "ns", "--data_root", str(scene), "--out",
              str(out), "--capacity", str(FREE_CAPACITY), "--sh_degree", "3",
              "--warmup", str(FREE_WARMUP), "--refine_every",
              str(FREE_REFINE), "--quiet", "--device", "cuda"]

    # (a) splatfacto at the CLI's defaults, two refine events
    reset_counts()
    t0 = time.perf_counter()
    tr = gs_train.main(common + ["--iters", str(FREE_ITERS), "--export",
                                 "scene.ply", "--log_every", "1"])
    wall["a splatfacto"] = time.perf_counter() - t0
    paths["gs_train"] = launches = read_counts()
    hist = [h for h in tr.history if "loss" in h]
    trend = thirds(hist, ("loss", "psnr"))
    steps_s = FREE_ITERS / tr.run_seconds
    n_alive = int(tr.state["alive"].sum())
    log(f"== 17 free gaussians: (a) gs_train --dataset ns on the {S1_IMAGES}"
        f" x {S1_RES}^2 scene, capacity {FREE_CAPACITY}, SH 3, splatfacto "
        f"every {FREE_REFINE} after {FREE_WARMUP}: {FREE_ITERS} steps in "
        f"{tr.run_seconds:.3f} s ({steps_s:.3f} steps/s, "
        f"{1e3 / steps_s:.2f} ms/step, {n_alive * steps_s:.6g} splats/s at "
        f"the final {n_alive} alive; first step and refines included), "
        f"wall {wall['a splatfacto']:.1f} s; first/last third means: "
        + ", ".join(f"{k} {a:.4f} -> {b:.4f}" for k, (a, b) in trend.items())
        + f"; refines {tr.refines}; eval {tr.metrics}; launches "
        f"{launches}; flat plan {tr.flat_plan}; on {card}")
    if len(hist) != FREE_ITERS or not all(finite(h["loss"]) for h in hist):
        raise RuntimeError(f"gs_train: {len(hist)} logged steps or a "
                           "non-finite loss")
    if not trend["psnr"][1] > trend["psnr"][0]:
        raise RuntimeError(f"gs_train: PSNR did not rise: {trend}")
    if launches["K1"] < FREE_ITERS or launches["K2"] < FREE_ITERS:
        raise RuntimeError(f"gs_train: K1/K2 not on every step: {launches}")
    events = [it for it in range(FREE_WARMUP, FREE_ITERS)
              if (it + 1) % FREE_REFINE == 0]
    if [r["iter"] for r in tr.refines] != events or any(
            r["n_alive"] == r["n_alive_before"] for r in tr.refines):
        raise RuntimeError(f"gs_train: alive did not change at each refine "
                           f"(after steps {events}): {tr.refines}")
    if not (finite(tr.metrics["psnr"]) and finite(tr.metrics["ssim"])) \
            or launches["K3"] < 1 or not (out / "scene.ply").exists():
        raise RuntimeError(f"gs_train: eval {tr.metrics}, K3 "
                           f"{launches['K3']} or no export")
    other["gs_train"] = walks = free_frame_walks(tr, 0, timed=True)
    log(f"   K1/K2 vs plain, gs_train's training frame 0 after step "
        f"{FREE_ITERS} ({walks['K1']['walked_chunks']} chunks walked, "
        f"{walks['K1']['live_candidate_pixels']} of "
        f"{walks['K1']['candidate_pixels']} candidate-pixels live): "
        + walk_note(walks, card))

    # (b) resume from the checkpoint's iteration
    reset_counts()
    t0 = time.perf_counter()
    tr_b = gs_train.main(common + ["--iters", str(FREE_ITERS + FREE_RESUME),
                                   "--resume", "--log_every", "1"])
    wall["b resume"] = time.perf_counter() - t0
    res_launch = read_counts()
    new = [h["iter"] for h in tr_b.history if "loss" in h][-FREE_RESUME:]
    log(f"   (b) --resume for {FREE_RESUME} more: iterations {new[0]}.."
        f"{new[-1]}, iter_step {tr_b.iter_step}, launches {res_launch}, "
        f"wall {wall['b resume']:.1f} s")
    # K1/K2 once a step, K3 once an eval view
    if new != list(range(FREE_ITERS, FREE_ITERS + FREE_RESUME)) \
            or res_launch["K2"] != FREE_RESUME:
        raise RuntimeError(f"resume: iterations {new}, {res_launch}")

    # (c) MCMC: relocation keeps the alive count
    reset_counts()
    t0 = time.perf_counter()
    tr_c = gs_train.main(
        ["--dataset", "ns", "--data_root", str(scene), "--out",
         str(work / "gs_mcmc"), "--capacity", str(FREE_CAPACITY),
         "--strategy", "mcmc", "--warmup", str(MCMC_WARMUP),
         "--refine_every", str(MCMC_EVERY), "--iters", str(MCMC_ITERS),
         "--quiet", "--device", "cuda"])
    wall["c mcmc"] = time.perf_counter() - t0
    log(f"   (c) --strategy mcmc, {MCMC_ITERS} steps in "
        f"{tr_c.run_seconds:.3f} s: relocations {tr_c.refines}, eval "
        f"{tr_c.metrics}, launches {read_counts()}, wall "
        f"{wall['c mcmc']:.1f} s")
    if not tr_c.refines or any(r["n_alive"] != r["n_alive_before"]
                               or r["n_moved"] == 0 for r in tr_c.refines):
        raise RuntimeError(f"mcmc: {tr_c.refines}")

    # (d) a distorted COLMAP capture, trained through the UT projection
    colmap = write_colmap_scene(scene, work / "colmap_fisheye",
                                COLMAP_FISHEYE)
    reset_counts()
    t0 = time.perf_counter()
    tr_d = gs_train.main(
        ["--dataset", "colmap", "--data_root", str(colmap), "--out",
         str(work / "gs_colmap"), "--capacity", str(FREE_CAPACITY),
         "--iters", str(COLMAP_ITERS), "--export", "scene.ingp", "--quiet",
         "--device", "cuda"])
    wall["d colmap"] = time.perf_counter() - t0
    d_launch = read_counts()
    ingp = read_gaussians_ingp(str(work / "gs_colmap" / "scene.ingp"))
    log(f"   (d) OPENCV_FISHEYE COLMAP scene ({COLMAP_POINTS} points, "
        f"k {COLMAP_FISHEYE}): camera {tr_d.cfg.camera_model} "
        f"{tr_d.cfg.dist}, {COLMAP_ITERS} steps in {tr_d.run_seconds:.3f} "
        f"s, eval {tr_d.metrics}, launches {d_launch}; scene.ingp read back "
        f"with {len(ingp['means'])} gaussians; wall {wall['d colmap']:.1f} s")
    if tr_d.cfg.camera_model != "fisheye" or min(
            d_launch["K1"], d_launch["K2"]) < COLMAP_ITERS \
            or len(ingp["means"]) != int(tr_d.state["alive"].sum()):
        raise RuntimeError(f"colmap run: {tr_d.cfg}, {d_launch}, "
                           f"{len(ingp['means'])} read back")

    # (e) gs_render: the tracer (pinhole, fisheye), the UT raster camera
    data = work / "data" / "scene_0"
    ds = gs_render.load_dataset("ns", str(data))
    h, w = ds.img_res
    per_view = -(-h * w // gs_trace.SELECT_RAYS)
    trace_launch = {}
    for camera in ("pinhole", "fisheye"):
        reset_counts()
        t0 = time.perf_counter()
        summary = gs_render.main(
            ["--ply", str(gauss_ply), "--dataset", "ns", "--data_root",
             str(data), "--split", "train", "--out",
             str(work / f"trace_{camera}"), "--renderer", "trace",
             "--camera", camera, "--device", "cuda"])
        wall[f"e trace {camera}"] = time.perf_counter() - t0
        trace_launch[camera] = t1_count()
        pngs = list((work / f"trace_{camera}").glob("render_*.png"))
        log(f"   (e) gs_render --renderer trace --camera {camera}: "
            f"{len(pngs)} views in {wall[f'e trace {camera}']:.1f} s, mean "
            f"{summary}, T1 launches {trace_launch[camera]}")
        if len(pngs) != ds.n_images or not finite(summary["psnr"]) \
                or trace_launch[camera] != ds.n_images * per_view:
            raise RuntimeError(f"trace {camera}: {len(pngs)} PNGs, "
                               f"{summary}, {trace_launch[camera]} launches")
    g = read_gaussian_ply(str(gauss_ply))
    traced = gs_trace.trace_image(g, ds.pose_all[0], ds.intrinsics[:3, :3],
                                  w, h, sh_degree=3, device="cuda")
    on_white = traced["rgb"] + (1.0 - traced["alpha"][..., None])
    raster = next(gs_render.render_views(
        g, ds.pose_all[:1], ds.intrinsics[:3, :3], ds.img_res, 3,
        device="cuda"))
    mse = float(np.mean((on_white - raster) ** 2))
    trace_psnr = -10.0 * np.log10(max(mse, 1e-12))
    reset_counts()
    t0 = time.perf_counter()
    ut = gs_render.main(
        ["--ply", str(gauss_ply), "--dataset", "ns", "--data_root",
         str(data), "--split", "train", "--out", str(work / "ut_render"),
         "--camera", "opencv", "--dist", *UT_DIST, "--device", "cuda"])
    wall["e ut raster"] = time.perf_counter() - t0
    ut_launch = read_counts()
    log(f"   trace vs raster of view 0 (white background): PSNR "
        f"{trace_psnr:.2f} dB (gate {TRACE_PSNR_MIN}); gs_render --camera "
        f"opencv --dist {' '.join(UT_DIST)}: mean {ut}, launches "
        f"{ut_launch}, wall {wall['e ut raster']:.1f} s")
    if not trace_psnr > TRACE_PSNR_MIN:
        raise RuntimeError(f"trace vs raster PSNR {trace_psnr}")
    if ut_launch["K3"] < ds.n_images or not finite(ut["psnr"]):
        raise RuntimeError(f"UT raster: {ut}, {ut_launch}")
    # K3 vs plain on the UT raster's view 0, at the K it calibrated (the
    # path renders and takes no gradient: K4 is not on it)
    gt = gs_render.gaussian_tensors(g, dev)
    vm0 = view_matrix(ds.pose_all[0], dev)
    intr0 = torch.as_tensor(ds.intrinsics[:3, :3], dtype=torch.float32,
                            device=dev)
    dist = tuple(float(x) for x in UT_DIST)
    k_ut = gs_render.pick_max_per_tile(*gt, vm0, intr0, w, h, 3, "opencv",
                                       dist)
    lists = topk_lists(*projection(*gt, vm0, intr0, w, h, 3,
                                   camera_model="opencv", dist=dist),
                       w, h, k_ut)
    other["ut_raster"] = walks = compare_topk(*lists, w, h, 9, timed=True,
                                              fwd_only=True)
    log(f"   K3 vs plain, the UT raster's view 0 at its calibrated K "
        f"{k_ut}, {tuple(lists[0].shape)}: " + walk_note(walks, card))

    # (f) T1 vs plain on one selection of view 0: pinhole in both ray
    # orders, fisheye in tile order
    t1 = t1_against_plain(g, ds, dev, card)
    all_pairs = t1.pop("all_pairs")

    # (g) one viewer frame on the card
    reset_counts()
    t0 = time.perf_counter()
    frame = viewer.GaussianOrbitRenderer(str(gauss_ply), device="cuda") \
        .render(35.0, 20.0, 1.0, RES)
    wall["g viewer"] = time.perf_counter() - t0
    v_launch = read_counts()
    log(f"   (g) viewer orbit frame {frame.shape}: mean {frame.mean():.4f}, "
        f"std {frame.std():.4f}, launches {v_launch}, "
        f"{wall['g viewer']:.2f} s; phase 17 wall s by part: "
        + ", ".join(f"{k} {v:.1f}" for k, v in wall.items()))
    if not np.isfinite(frame).all() or frame.std() < 1e-3 \
            or v_launch["K3"] < 1:
        raise RuntimeError(f"viewer frame: std {frame.std()}, {v_launch}")
    return {"name": "T1 gs_trace_select", "route": "cuda",
            "source": "holoscene_tpu_torch/csrc/gs_trace_select.cu",
            "replaces": "holoscene_tpu/ops/gs_trace.py:133",
            "launches": sum(trace_launch.values()),
            "max_abs_err": max(r["err"] for r in t1.values()),
            "ms": t1["tile"]["ms"], "plain_ms": t1["tile"]["plain_ms"],
            "bound_ms": t1["tile"]["bound"], "bound_by": t1["tile"]["by"],
            "library_ms": None, "launches_by_path": dict(trace_launch),
            "row_order_ms": t1["row"]["ms"],
            "fisheye_ms": t1["fisheye"]["ms"],
            "all_pairs_bound_ms": all_pairs,
            "survivors_per_block": [t1["tile"]["survivors_mean"],
                                    t1["tile"]["survivors_max"]],
            "index_mismatches": sum(r["mismatches"] for r in t1.values())}


def stage1_phases(work: Path, dev, card: str, chain: dict) -> dict:
    """Phases 9-11; phase 10b's run opens the chain record `chain`.
    Returns {H kernel: its row of the kernel table}."""
    import torch

    from holoscene_tpu_torch.models import holoscene as hs
    from holoscene_tpu_torch.ops import hashgrid as hg
    from holoscene_tpu_torch.training import exp_runner
    from holoscene_tpu_torch.training import stage1 as s1

    # 9 the hash kernels vs plain: a small meta and the flagship meta, and
    # the background patch's exact-mode call (1024 rays x 98 samples)
    small_meta = hg.HashGridMeta(num_levels=6, level_dim=2, base_resolution=4,
                                 log2_hashmap_size=8, desired_resolution=48)
    flag_cfg = flagship_cfg(32)
    flag_meta = flag_cfg.implicit.grid_meta
    errs = {k: [] for k in HASH_KERNELS}
    t0 = time.perf_counter()
    for i, (meta, n) in enumerate(((small_meta, 3001), (flag_meta, 8192))):
        x, ea, eb = random_hash_inputs(meta, n, dev, 10 + i)
        for levels in (None, min(6, meta.num_levels - 1)):
            got = compare_h1(x, ea, eb, hg.level_tables(meta, levels), 20 + i)
            for k, r in got.items():
                errs[k].append(r["max_abs_err"])
        errs["H2"].append(compare_h2(x, ea, hg.level_tables(
            meta, min(8, meta.num_levels - 2)))["max_abs_err"])
        del ea, eb
    n_patch = hs.BG_PATCH ** 2 * flag_cfg.sampler.n_final
    x, ea, eb = random_hash_inputs(flag_meta, n_patch, dev, 12)
    got = compare_h1(x, ea, eb, hg.level_tables(flag_meta), 22,
                     modes=("exact",))
    for k, r in got.items():
        errs[k].append(r["max_abs_err"])
    del x, ea, eb
    log(f"== 9 hash kernels vs plain (random tables, {small_meta.num_levels}-"
        f"level meta at 3001 points and the flagship meta at 8192; all "
        f"levels and a coarse prefix; H1-bwd exact / sampled / sampled_all; "
        f"H2 at 4 / 8 levels; H1 exact at the background patch's {n_patch} "
        f"points) in {time.perf_counter() - t0:.1f} s: max abs err "
        + ", ".join(f"{k} {max(v):.3g}" for k, v in errs.items())
        + f" (within {H_REL} of the largest value; each kernel's two "
        "launches bitwise equal)")

    # 10 the Stage-1 CLI at the flagship width on a generated 512^2 scene
    t0 = time.perf_counter()
    conf = stage1_conf(work, "smoke_s1", S1_MODEL_TPU, 80000)
    log(f"== 10 Stage-1 CLI: scene {S1_IMAGES} x {S1_RES}^2 written in "
        f"{time.perf_counter() - t0:.1f} s")
    reset_counts()
    runner = exp_runner.main(
        ["--conf", str(conf), "--exps_folder", str(work / "exps_s1"),
         "--max_niters", str(S1_STEPS), "--log_every", "1", "--quiet",
         "--device", "cuda"])
    launches = read_hash_counts()
    splat = read_counts()
    cfg10 = runner.model_cfg
    STEP_MS["10"] = check_stage1_run("Stage-1 run", runner, S1_STEPS,
                                     launches, cfg10.render_bg_iter, 3, card)
    PHASE10_LOSSES[:] = [h["loss"] for h in runner.history[:CLI_RANK_STEPS]]
    n_bg = len(range(0, S1_STEPS, cfg10.render_bg_iter))
    per_bake = -(-(cfg10.probe_grid_res + 1) ** 3 // BAKE_CHUNK)
    bake_h2 = len(runner.probe_bakes) * per_bake
    log(f"   probe bakes at {runner.probe_bakes}; splat kernels {splat}")
    if runner.probe_bakes[:2] != [0, cfg10.probe_update_every]:
        raise RuntimeError(f"probe bakes at {runner.probe_bakes}")
    if not n_bg <= launches["H2"] - bake_h2 \
            <= n_bg * cfg10.sampler.max_total_iters or any(splat.values()):
        raise RuntimeError(f"Stage-1 launches {launches} (splat {splat}): "
                           f"H2 on every bake chunk ({bake_h2}) and in each "
                           f"of the {n_bg} patches' samplers")
    reset_counts()
    t0 = time.perf_counter()
    psnr = runner.plot(S1_STEPS - 1)["psnr"]
    eval_launches = read_hash_counts()
    log(f"   eval frame 0 ({S1_RES}^2, chunks of {runner.split_n_pixels} "
        f"rays) in {time.perf_counter() - t0:.1f} s: PSNR {psnr:.3f}; "
        f"launches {eval_launches}")
    if not finite(psnr) or eval_launches["H2"] < 1 \
            or eval_launches["H1-fwd"] < 1 or eval_launches["H1-bwd"]:
        raise RuntimeError(f"eval render: PSNR {psnr}, launches "
                           f"{eval_launches}")
    # 12 the meshes of this run
    h2_extract = stage1_meshes(runner, dev, card)
    del runner

    # 10b the conf defaults: the vjp gradient mode, untiered
    conf = stage1_conf(work, "smoke_s1_vjp", S1_MODEL_DEFAULT)
    reset_counts()
    t0 = time.perf_counter()
    # H1-bwd's modes and H2's calls recorded
    runner, rec = record_hash(lambda: exp_runner.main(
        ["--conf", str(conf), "--exps_folder", str(work / "exps_s1b"),
         "--max_niters", str(S1B_STEPS), "--log_every", "1", "--quiet",
         "--device", "cuda"]), ("fused_bwd", "sampler_fwd"),
        keep=lambda name, args: args[6] if name == "fused_bwd" else args)
    launches_b = read_hash_counts()
    modes = set(rec["fused_bwd"])
    cfg10b = runner.model_cfg
    log(f"== 10b conf defaults (confs/replica_room0.conf's model section: "
        f"forward_grad_mode {cfg10b.forward_grad_mode}, render_top_m "
        f"{cfg10b.render_top_m}, probe grid {cfg10b.probe_grid_res}, "
        f"{cfg10b.sampler.max_total_iters} sampler rounds, use_bg_reg "
        f"{cfg10b.use_bg_reg}): {S1B_STEPS} steps, H1-bwd modes "
        f"{sorted(modes)}")
    if cfg10b.forward_grad_mode != "vjp" or modes != {"exact"}:
        raise RuntimeError(f"10b: grad mode {cfg10b.forward_grad_mode}, "
                           f"H1-bwd modes {modes}: expected vjp, exact")
    check_stage1_run("vjp run", runner, S1B_STEPS, launches_b,
                     cfg10b.render_bg_iter, 2, card)
    if launches_b["H2"] < S1B_STEPS:
        raise RuntimeError(f"10b: H2 launches {launches_b}")
    # the chain record's Stage 1 (phases 14-16 continue this run): its
    # wall time, and an eval frame after the phase's counts were read
    chain["stage1"] = {"iters": S1B_STEPS, "wall_s": time.perf_counter() - t0,
                       "eval_psnr": runner.plot(S1B_STEPS - 1)["psnr"]}
    del runner
    # H2 at the run's first sampler call (the first step's rays)
    x01, emb, lt, packed = rec["sampler_fwd"][0][:4]
    h2_vjp = compare_h2(x01, emb, lt, timed=True, packed=packed)
    h2_vjp["shape"] = (x01.shape[0], lt.n_levels, packed)
    del rec
    log(f"   H2 at the first sampler call ({x01.shape[0]} points x "
        f"{lt.n_levels} levels, packed {packed}): kernel "
        f"{h2_vjp['ms']:.4f} ms, plain {h2_vjp['plain_ms']:.3f} ms, bound "
        f"{h2_vjp['bound_ms']:.4f} ms by {h2_vjp['bound_by']} "
        f"({100 * h2_vjp['bound_ms'] / h2_vjp['ms']:.1f}% of it); max abs "
        f"err {h2_vjp['max_abs_err']:.3g}, two launches bitwise equal; on "
        f"{card}")

    # 11 the train step at bench.py's shapes (d_out 32, random batch)
    cfg = flag_cfg
    torch.cuda.reset_peak_memory_stats(dev)
    model = hs.init_holoscene(cfg, 0, dev)
    opt, sched = s1.make_optimizer(model, 5e-4, 20.0, 200000)
    gen = torch.Generator(device=dev).manual_seed(0)
    bake = hs.make_probe_bake(cfg)
    from holoscene_tpu_torch.losses.holoscene_loss import LossConfig

    lcfg = LossConfig(depth_weight=0.5, semantic_weight=5.0,
                      reg_vio_weight=0.01, bg_reg_weight=0.01)
    batch = bench_batch(gen, dev, BENCH_RAYS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probe = bake(model)
    torch.cuda.synchronize()
    bake_ms = 1e3 * (time.perf_counter() - t0)

    def step(i, with_bg=False):
        draws = s1.StepDraws.make(cfg, BENCH_RAYS, gen, dev, with_bg)
        return s1.train_step(model, opt, sched, lcfg, batch, draws, i,
                             probe=probe)

    # the last warm-up step is a background step, with its H1 calls
    # captured: fine tier, tail, eikonal, patch (at the first step the
    # geometric init gives the SDF grid zero cotangents)
    for i in range(BENCH_WARMUP - 1):
        step(i)
    captured = capture_h1(lambda: step(BENCH_WARMUP - 1, with_bg=True))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(BENCH_TIMED):
        m = step(BENCH_WARMUP + i)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not finite(float(m["loss"])):
        raise RuntimeError(f"bench-shape step: loss {float(m['loss'])}")
    rays_s = BENCH_TIMED * BENCH_RAYS / dt
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(PROFILED):
            step(100 + i)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    busy_ms, by_name = device_kernels(prof)
    top_s = ", ".join(f"{k[:56]} {v / PROFILED:.3f}" for k, v in sorted(
        by_name.items(), key=lambda kv: -kv[1])[:12])
    idle = ("not measured (the profiler saw no device time)" if busy_ms <= 0
            else f"{100 * (1 - busy_ms / wall_ms):.1f}% of the profiled "
                 f"steps, {100 * (1 - busy_ms / PROFILED / (1e3 * dt / BENCH_TIMED)):.1f}% "
                 f"of an unprofiled one")
    log(f"== 11 bench shapes (bench.py flagship_config, d_out 32, "
        f"{BENCH_RAYS} rays of a random 512^2 batch): {BENCH_TIMED} steps "
        f"after {BENCH_WARMUP} warm-up in {dt:.3f} s, {1e3 * dt / BENCH_TIMED:.2f} "
        f"ms/step, {rays_s:.1f} rays/s (probe bake {bake_ms:.1f} ms, not in "
        f"the timed steps, every 64th step in training); under the profiler "
        f"{wall_ms / PROFILED:.2f} ms/step, device busy {busy_ms / PROFILED:.2f} "
        f"ms/step (union of the kernels), idle {idle}; peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; on {card}")
    log(f"   device ms/step by kernel ({len(by_name)} kernels, "
        f"{sum(1 for ev in prof.events() if ev.device_type == DeviceType.CUDA) // PROFILED} "
        f"launches a step): {top_s}")

    # the kernels at the step's shapes: the fine tier's H1 call as captured
    # (random cotangents, as the earlier kernels were timed), H2 on the first bake chunk
    if len(captured) != 4 or any(b is None for _, b in captured):
        raise RuntimeError(f"background step: {len(captured)} H1 calls "
                           "captured, expected 4 with their backwards")
    x01, emb_a, emb_b, lt = captured[0][0][:4]     # the fine tier's call
    emb_a, emb_b = emb_a.detach(), emb_b.detach()
    FINE_BWD[:] = captured[0][1]                   # phase 20 (c)'s inputs
    mode = hs.fused_mode(cfg, True)
    timed = compare_h1(x01, emb_a, emb_b, lt, 30, timed=True,
                       modes=("exact", mode))
    n = cfg.probe_grid_res + 1
    axis = torch.linspace(-1.0, 1.0, n, device=dev)
    grid = torch.stack(torch.meshgrid(axis, axis, axis, indexing="ij"), -1)
    chunk = ((grid.reshape(-1, 3)[:BAKE_CHUNK] + 1.0) * 0.5).contiguous()
    timed["H2"] = compare_h2(chunk, model.implicit.grid.detach(),
                             hg.level_tables(cfg.implicit.grid_meta,
                                             cfg.sampler_grid_levels),
                             timed=True)
    log(f"   kernels at the step's shapes on {card}: fine tier "
        f"{x01.shape[0]} points x {lt.n_levels} levels (H1-bwd timed in "
        f"{mode} mode as the step runs it, random cotangents), bake chunk "
        f"{chunk.shape[0]} points x {cfg.sampler_grid_levels} levels:")
    rows = {}
    for k, meta in HASH_KERNELS.items():
        r = timed[k]
        r["max_abs_err"] = max([r["max_abs_err"]] + errs[k])
        earlier = (f"; the kernel it replaced: {HASH_EARLIER_MS[k]:.4f} ms, "
                   f"{HASH_EARLIER_MS[k] / r['ms']:.2f}x"
                   if k in HASH_EARLIER_MS else "")
        log(f"   {k}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, "
            f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
            f"({100 * r['bound_ms'] / r['ms']:.1f}% of it); max abs err "
            f"{r['max_abs_err']:.3g}; launches on the Stage-1 path "
            f"{launches[k]}{earlier}")
        if k == "H1-bwd":
            r["accumulation_ms"] = h1_bwd_accumulation_ms(
                x01, lt, emb_a.shape[0])
            log(f"   H1-bwd's fixed-point accumulation moves more than the "
                f"function must: int64 zero-fill, conversion read, maxima "
                f"pass {r['accumulation_ms']:.4f} ms at the memory rate "
                f"(bound + that: {r['bound_ms'] + r['accumulation_ms']:.4f}"
                f" ms, {100 * (r['bound_ms'] + r['accumulation_ms']) / r['ms']:.1f}% of the kernel)")
        rows[k] = {**meta, "launches": launches[k],
                   "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                   "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                   "bound_by": r["bound_by"], "library_ms": None,
                   **({"accumulation_ms": r["accumulation_ms"]}
                      if "accumulation_ms" in r else {}),
                   "launches_by_path": {"stage1": launches[k],
                                        "stage1_eval": eval_launches[k],
                                        "stage1_vjp": launches_b[k]}}
    # H2's other shapes: the extraction chunks (phase 12), the vjp run's
    # sampler call (phase 10b)
    h2 = rows["H2"]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")
    for tag, r in (("extraction_chunk_last", h2_extract["last"]),
                   ("extraction_chunk_mid", h2_extract["mid"]),
                   ("vjp_sampler", h2_vjp)):
        h2["max_abs_err"] = max(h2["max_abs_err"], r["max_abs_err"])
        h2[tag] = {k: r[k] for k in keys}
    h2["vjp_sampler"]["shape"] = h2_vjp["shape"]
    h2["launches_by_path"]["stage1_meshes"] = h2_extract["launches"]
    h2["extraction_sum_ms"] = h2_extract["sum_ms"]
    log("   H1 at every call of a background step (the step's own "
        "cotangents):")
    for tag, (fargs, bargs) in zip(("fine tier", "tail", "eikonal", "patch"),
                                   captured):
        r = h1_at_capture(fargs, bargs)
        log(f"   {tag}: {r['points']} points x {r['levels']} levels, "
            f"{r['tables']} table(s), backward {r['mode']}: " + "; ".join(
                f"{k} {r[k]['ms']:.4f} ms, bound {r[k]['bound_ms']:.4f} ms "
                f"by {r[k]['bound_by']} ({100 * r[k]['bound_ms'] / r[k]['ms']:.1f}%)"
                for k in ("H1-fwd", "H1-bwd")))
    return rows


# ---------------------------------------------------------------------------
# phase 18: camera refinement, the physics grid, LPIPS, the occupancy grid,
# multi-rank Stage 1 and Stage 4
# ---------------------------------------------------------------------------

CAM_TANGENTS = 4096
PHY_RES, PHY_POINTS = 256, 1 << 20    # reference model/PhyGrid.py's 256^3
LPIPS_RES = 512
OCC_STEPS = 40
RANKS, RANK_RAYS = 2, 1024
CLI_RANK_STEPS = 5     # (e): exp_runner under torchrun, phase 10's conf
RANK_DEVICE = "cuda"
PHASE10_LOSSES: list = []   # phase 10's first CLI_RANK_STEPS losses
# a multi-rank step against the single-process step on the same global
# batch (tests/test_multichip.py's tolerances; 0-d beta's gradient, one
# cancelling sum over every sample, at 5e-4: tests/test_torch_parallel.py)
S1_LOSS_RTOL, S1_LOSS_ATOL, S1_GRAD_REL, S1_SCALAR_REL = 2e-5, 2e-6, 5e-5, 5e-4
S4_RTOL, S4_ATOL, S4_LR = 2e-4, 2e-6, 1e-3   # tests/test_stage4_dp.py's
STEP_MS: dict = {}    # ms a step of the Stage-1 runs, by phase


def small_modules_phase(dev, card: str) -> None:
    """Phase 18 (a): exp_map_so3xr3 and its gradient, the dense grid at
    256^3 and LPIPS at 512^2, each on the card against the CPU."""
    import torch

    from holoscene_tpu_torch.models.cam_opt import exp_map_so3xr3
    from holoscene_tpu_torch.ops import phygrid
    from holoscene_tpu_torch.utils import lpips

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(18)
    tan = torch.randn(CAM_TANGENTS, 6, generator=gen) * 0.5
    tan[:64] = 0.0                      # the pose deltas' initial value
    tan[64:128, 3:] *= 1e-7             # the small-angle branch
    w = torch.randn(CAM_TANGENTS, 3, 4, generator=gen)
    res = []
    for d in ("cpu", dev):
        x = tan.to(d).clone().requires_grad_(True)
        y = exp_map_so3xr3(x)
        (y * w.to(d)).sum().backward()
        res.append((y.detach().cpu(), x.grad.cpu()))
    (yc, gc), (yg, gg) = res
    cam = (float((yg - yc).abs().max()), float((gg - gc).abs().max()))
    if not (bool(torch.isfinite(gg).all()) and cam[0] <= 1e-6
            and cam[1] <= 1e-5):
        raise RuntimeError(f"exp_map_so3xr3 card vs CPU: value / gradient "
                           f"errors {cam}, finite {torch.isfinite(gg).all()}")

    pts = torch.rand(PHY_POINTS, 3, generator=gen) * 2.2 - 1.1
    vals = torch.rand(PHY_POINTS, generator=gen)
    q = torch.rand(PHY_POINTS, 3, generator=gen) * 2.2 - 1.1
    out, ms = [], {}
    for d in ("cpu", dev):
        g = phygrid.grid_splat_max(phygrid.init_dense_grid(PHY_RES, 1.0, d),
                                   pts.to(d), vals.to(d))
        out.append((g["values"].cpu(), phygrid.grid_sample(g, q.to(d)).cpu(),
                    phygrid.grid_smooth(g)["values"].cpu()))
    g = phygrid.init_dense_grid(PHY_RES, 1.0, dev)
    pd, vd, qd = pts.to(dev), vals.to(dev), q.to(dev)
    ms["splat"] = cuda_ms(lambda: phygrid.grid_splat_max(g, pd, vd), 5)
    g = phygrid.grid_splat_max(g, pd, vd)
    ms["sample"] = cuda_ms(lambda: phygrid.grid_sample(g, qd), 5)
    ms["smooth"] = cuda_ms(lambda: phygrid.grid_smooth(g), 5)
    (vc, sc, mc), (vg, sg, mg) = out
    phy = (bool(torch.equal(vg, vc)), float((sg - sc).abs().max()),
           float((mg - mc).abs().max()))
    if not (phy[0] and phy[1] <= 1e-6 and phy[2] <= 1e-6):
        raise RuntimeError(f"phygrid card vs CPU: splat bitwise {phy[0]}, "
                           f"sample / smooth errors {phy[1:]}")

    params = lpips.init_random_params(0)
    a = torch.rand(LPIPS_RES, LPIPS_RES, 3, generator=gen)
    b = (a + 0.1 * torch.randn(a.shape, generator=gen)).clamp(0, 1)
    lp = [float(lpips.lpips_pair(lpips.params_to_torch(params, d), a.to(d),
                                 b.to(d))) for d in ("cpu", dev)]
    on_card = (lpips.params_to_torch(params, dev), a.to(dev), b.to(dev))
    lp_ms = cuda_ms(lambda: lpips.lpips_pair(*on_card), 5)
    rel = abs(lp[1] - lp[0]) / abs(lp[0])
    if not (finite(lp[1]) and rel <= 1e-4):
        raise RuntimeError(f"LPIPS card {lp[1]} vs CPU {lp[0]}: relative "
                           f"{rel:.3g} > 1e-4")
    log(f"== 18 (a) small modules in {time.perf_counter() - t0:.1f} s: "
        f"exp_map_so3xr3 on {CAM_TANGENTS} tangents (64 zero, 64 in the "
        f"small-angle branch) card vs CPU: value {cam[0]:.3g}, gradient "
        f"{cam[1]:.3g}, finite; phygrid {PHY_RES}^3 with {PHY_POINTS} "
        f"points: splat bitwise {phy[0]}, sample {phy[1]:.3g}, smooth "
        f"{phy[2]:.3g}, card ms splat {ms['splat']:.3f} sample "
        f"{ms['sample']:.3f} smooth {ms['smooth']:.3f}; LPIPS "
        f"(init_random_params) {LPIPS_RES}^2 card {lp[1]:.6f} CPU "
        f"{lp[0]:.6f}, relative {rel:.3g}, {lp_ms:.3f} ms on the card; on "
        f"{card}")


def occupancy_phase(work: Path, card: str) -> dict:
    """Phase 18 (b): phase 10's scene and conf with use_occupancy, through
    the CLI. Returns the hash kernels' launches."""
    import torch

    from holoscene_tpu_torch.models import holoscene as hs
    from holoscene_tpu_torch.ops.occupancy import occupied_mask
    from holoscene_tpu_torch.training import exp_runner

    model = S1_MODEL_TPU.replace("use_occupancy = false",
                                 "use_occupancy = true")
    conf = stage1_conf(work, "smoke_s1_occ", model, 80000)
    ratios = []
    plain_range = hs.ray_range

    def recording(occ, ro, rd, near, far, beta, cfg):
        nr, fr = plain_range(occ, ro, rd, near, far, beta, cfg)
        ok = far > near
        ratios.append(float(((fr - nr)[ok] / (far - near)[ok]).mean()))
        return nr, fr

    hs.ray_range = recording
    reset_counts()
    try:
        runner = exp_runner.main(
            ["--conf", str(conf), "--exps_folder", str(work / "exps_occ"),
             "--max_niters", str(OCC_STEPS), "--log_every", "1", "--quiet",
             "--device", "cuda"])
    finally:
        hs.ray_range = plain_range
    launches = read_hash_counts()
    cfg = runner.model_cfg
    if not cfg.use_occupancy or runner.occ is None:
        raise RuntimeError("occupancy run: the grid is not on")
    log(f"== 18 (b) occupancy grid ({cfg.occupancy.resolution}^3, "
        f"{cfg.occupancy.taps} taps, updated every "
        f"{runner.occ_update_every}th step) on phase 10's scene and conf, "
        f"{OCC_STEPS} steps through the CLI:")
    ms = check_stage1_run("occupancy run", runner, OCC_STEPS, launches,
                          cfg.render_bg_iter, 3, card)
    n_upd = len(range(0, OCC_STEPS, runner.occ_update_every))
    n_bg = len(range(0, OCC_STEPS, cfg.render_bg_iter))
    per_bake = -(-(cfg.probe_grid_res + 1) ** 3 // BAKE_CHUNK)
    bake_h2 = len(runner.probe_bakes) * per_bake
    beta = runner.model.density["beta"].detach().abs() + cfg.beta_min
    occupied = float(occupied_mask(runner.occ, beta, cfg.occupancy)
                     .float().mean())
    mean_ratio = sum(ratios) / max(len(ratios), 1)
    log(f"   restricted steps {len(ratios)} (the other {n_upd} update the "
        f"grid): mean (far' - near') / (far - near) {mean_ratio:.4f} "
        f"(by step: first {ratios[0]:.4f}, last {ratios[-1]:.4f}); "
        f"occupied cells at the end {100 * occupied:.1f}%; "
        f"{ms:.2f} ms/step beside phase 10's {STEP_MS['10']:.2f}; H2 "
        f"{launches['H2']} (bakes {bake_h2}, the rest in the {n_bg} patches' "
        f"samplers: the step's sampler reads the probe grid); on {card}")
    if len(ratios) != OCC_STEPS - n_upd or not mean_ratio < 1.0:
        raise RuntimeError(f"occupancy run: {len(ratios)} restricted steps "
                           f"for {OCC_STEPS - n_upd}, mean ratio "
                           f"{mean_ratio}")
    if not n_bg <= launches["H2"] - bake_h2 \
            <= n_bg * cfg.sampler.max_total_iters:
        raise RuntimeError(f"occupancy run: H2 launches {launches}")
    del runner
    torch.cuda.empty_cache()
    return launches


def s1_rank_step(inp: dict, mesh=None) -> tuple:
    """One SGD (lr 1) Stage-1 step of inp's model on its global batch and
    draws, over `mesh` or in one process: (metrics, {name: gradient})."""
    import torch

    from holoscene_tpu_torch.losses.holoscene_loss import LossConfig
    from holoscene_tpu_torch.models.holoscene import init_holoscene
    from holoscene_tpu_torch.parallel.mesh import shard_optimizer, shard_params
    from holoscene_tpu_torch.training import stage1 as s1

    dev = inp["batch"]["uv"].device
    model = init_holoscene(inp["cfg"], device=dev)
    model.load_state_dict(inp["state"])
    shards = shard_params(mesh, model) if mesh is not None else {}
    opt = torch.optim.SGD(model.parameters(), lr=1.0)
    if mesh is not None:
        shard_optimizer(mesh, opt, model, shards)
    m = s1.train_step(model, opt, None, LossConfig(), inp["batch"],
                      inp["draws"], 0, mesh=mesh, shards=shards)
    grads = {k: inp["state"][k] - v.detach()
             for k, v in model.state_dict().items()}
    return {k: float(v) for k, v in m.items()}, grads


def s1_errors(m, grads, ref) -> dict:
    """A step's deviations from the single-process step `ref`: the loss's
    relative error and the worst gradient deviation as a share of its
    tolerance (<= 1 passes), test_multichip.py's atol 5e-5 x max(max |g|,
    1e-3) of each tensor (the 0-d beta 5e-4)."""
    m_ref, g_ref = ref
    worst, name, worst_scale = 0.0, "", 0.0
    for k, g in g_ref.items():
        scale = float(g.abs().max())
        tol = (S1_GRAD_REL if g.dim() else S1_SCALAR_REL) * max(scale, 1e-3)
        share = float((grads[k] - g).abs().max()) / tol
        if share > worst:
            worst, name, worst_scale = share, k, scale
    loss_err = abs(m["loss"] - m_ref["loss"])
    return {"loss": m["loss"], "loss_rel": loss_err / abs(m_ref["loss"]),
            "loss_ok": loss_err <= S1_LOSS_ATOL + S1_LOSS_RTOL
            * abs(m_ref["loss"]),
            "grad_share": worst, "grad_worst": name,
            "grad_worst_max": worst_scale}


def swap_halves(s1: dict) -> dict:
    """s1's batch and draws with the two halves of its rays swapped (the
    background patch as it is): the same loss, its sums taken in another
    order; the single-process step on it measures the float noise the
    multi-rank steps are held to."""
    import dataclasses

    import torch

    n = s1["batch"]["uv"].shape[0]
    perm = torch.cat([torch.arange(n // 2, n), torch.arange(n // 2)]).to(
        s1["batch"]["uv"].device)

    def per_ray(u):
        if u is None:
            return None
        k = u.shape[-1] // n
        return u.reshape(*u.shape[:-1], n, k)[..., perm, :] \
            .reshape(u.shape).contiguous()

    d = s1["draws"]
    r = d.render
    sampler = dataclasses.replace(r.sampler, t_rand=r.sampler.t_rand[perm],
                                  u=r.sampler.u[perm],
                                  eik_idx=r.sampler.eik_idx[perm])
    render = dataclasses.replace(
        r, sampler=sampler, eik_uniform=r.eik_uniform[perm],
        nei=torch.cat([r.nei[:n][perm], r.nei[n:][perm]]),
        fused=[None if f is None else tuple(per_ray(u) for u in f)
               for f in r.fused])
    batch = {k: (v[perm] if v.dim() and v.shape[0] == n else v)
             for k, v in s1["batch"].items()}
    return {**s1, "batch": batch,
            "draws": dataclasses.replace(d, jitter=d.jitter[perm],
                                         render=render)}


def s4_errors(params, ref) -> dict:
    """Post-step parameters against the reference: the worst violation of
    |a - b| <= atol + rtol |b| as a share of its bound."""
    worst, name = 0.0, ""
    for k, b in ref.items():
        share = float(((params[k] - b).abs()
                       / (S4_ATOL + S4_RTOL * b.abs())).max())
        if share > worst:
            worst, name = share, k
    return {"share": worst, "worst": name}


def rank_worker(rank: int, port: int, in_path: str, out_dir: str) -> None:
    """Rank `rank` of a gloo group of RANKS processes on card 0: the dp
    and the model-sharded Stage-1 steps, then the dp Stage-4 step on frame
    `rank`, each held to the single-process references in the input."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=RANKS, rank=rank,
                            timeout=datetime.timedelta(seconds=600))
    try:
        from holoscene_tpu_torch.parallel.mesh import make_mesh
        from holoscene_tpu_torch.parallel.stage4_dp import make_stage4_dp_step

        inp = torch.load(in_path, map_location="cuda:0", weights_only=False)
        dp, mp = make_mesh(RANKS, 1), make_mesh(1, RANKS)
        res = {}
        for tag, mesh in (("dp", dp), ("model", mp)):
            reset_counts()
            t0 = time.perf_counter()
            m, grads = s1_rank_step(inp["s1"], mesh)
            torch.cuda.synchronize()
            res[tag] = {**s1_errors(m, grads, inp["s1_ref"]),
                        "s": time.perf_counter() - t0,
                        "launches": read_hash_counts()}
            del grads
        s4 = inp["s4"]
        params = {k: v.clone().requires_grad_(True)
                  for k, v in s4["params"].items()}
        opt = torch.optim.SGD(params.values(), lr=S4_LR)
        step = make_stage4_dp_step(dp, opt, s4["static"], s4["cfg"],
                                   s4["plan"], s4["loss_scale"], s4["width"],
                                   s4["height"])
        f = s4["frames"][rank]
        reset_counts()
        t0 = time.perf_counter()
        metrics, used, stale = step(params, f["pose"], f["intr"], f["image"],
                                    f["acm"], f["mesh_depth"], f["bins"],
                                    f["bg"])
        torch.cuda.synchronize()
        res["s4"] = {**s4_errors({k: v.detach() for k, v in params.items()},
                                 s4["ref"]),
                     "loss": float(metrics["loss"]),
                     "used": tuple(used.shape), "stale": stale.tolist(),
                     "s": time.perf_counter() - t0, "launches": read_counts()}
        torch.save(res, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def multirank_phase(work: Path, dev, card: str, s4runner) -> dict:
    """Phase 18 (c) and (d): multi-rank Stage 1 (dp 2 and model 2 over
    gloo on the one card, one NCCL world-size-1 step) and Stage 4 (dp 2
    over gloo on phase 4's scene), each against the single-process step.
    Returns the launches by path."""
    import dataclasses

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as tmp

    from holoscene_tpu_torch.models.holoscene import init_holoscene
    from holoscene_tpu_torch.parallel.mesh import make_mesh
    from holoscene_tpu_torch.parallel.stage4_dp import frame_loss
    from holoscene_tpu_torch.training.stage1 import StepDraws

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(flagship_cfg(3), use_bg_reg=True)
    model = init_holoscene(cfg, 18, dev)
    gen = torch.Generator(device=dev).manual_seed(18)
    with torch.no_grad():
        # tables and the first layer random (the geometric init gives the
        # tables no gradient on a first step)
        for t in (model.implicit.grid, model.implicit.color_grid):
            t.copy_((torch.rand(t.shape, generator=gen, device=dev) - 0.5)
                    * 0.2)
        v = model.implicit.mlp.lin0.v
        v.copy_(torch.randn(v.shape, generator=gen, device=dev) * 0.3)
    n = RANK_RAYS
    s1 = {"cfg": cfg,
          "state": {k: v.detach().clone()
                    for k, v in model.state_dict().items()},
          "batch": bench_batch(gen, dev, n),
          "draws": StepDraws.make(cfg, n, gen, dev, with_bg=True)}
    del model
    reset_counts()
    t0 = time.perf_counter()
    ref = s1_rank_step(s1)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    ref_launches = read_hash_counts()
    floor = s1_errors(*s1_rank_step(swap_halves(s1)), ref)

    # (c) one NCCL world-size-1 step in this process
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        nccl = s1_errors(*s1_rank_step(s1, make_mesh(1, 1)), ref)
    finally:
        dist.destroy_process_group()
    if not (nccl["loss_ok"] and nccl["grad_share"] <= 1.0):
        raise RuntimeError(f"NCCL world-size-1 step vs single process: "
                           f"{nccl}")

    # (d) the Stage-4 reference: the mean of frames 0 and 1's gradients
    r = s4runner
    frames = []
    bg_gen = torch.Generator(device=dev).manual_seed(19)
    h, w = r.dataset.img_res
    for fi in range(RANKS):
        pose, intr = r._pose_intr(fi)
        acm, depth = r._frame_mesh_raster(fi)
        frames.append({
            "pose": pose, "intr": intr, "acm": acm, "mesh_depth": depth,
            "image": torch.tensor(r.dataset.rgb_images[fi].reshape(h, w, 3)
                                  .transpose(2, 0, 1), device=dev)
            .contiguous(),
            "bins": r._get_bins(fi, pose, intr),
            "bg": torch.rand(3, generator=bg_gen, device=dev)})
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in r.params.items()}
    grads = []
    for f in frames:
        total, _, _ = frame_loss(params, r.static, r.cfg, r.flat_plan,
                                 r.loss_scale, w, h, f["pose"], f["intr"],
                                 f["image"], f["acm"], f["mesh_depth"],
                                 f["bins"], f["bg"])
        grads.append(torch.autograd.grad(total, list(params.values())))
    s4 = {"params": {k: v.detach() for k, v in params.items()},
          "static": r.static, "cfg": r.cfg, "plan": r.flat_plan,
          "loss_scale": r.loss_scale, "width": w, "height": h,
          "frames": frames,
          "ref": {k: p.detach() - S4_LR * (g0 + g1) / 2
                  for (k, p), g0, g1 in zip(params.items(), *grads)}}
    del grads, params
    in_path = work / "ranks_in.pt"
    torch.save({"s1": s1, "s1_ref": ref, "s4": s4}, in_path)
    ref_loss = ref[0]["loss"]
    del s1, s4, ref
    torch.cuda.empty_cache()

    # the two gloo ranks on this card
    t0 = time.perf_counter()
    tmp.start_processes(rank_worker, args=(_free_port(), str(in_path),
                                           str(work)),
                        nprocs=RANKS, join=True, start_method="spawn")
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(work / f"rank{i}.pt", weights_only=False)
             for i in range(RANKS)]
    for i, res in enumerate(ranks):
        for tag in ("dp", "model"):
            e = res[tag]
            if not (e["loss_ok"] and e["grad_share"] <= 1.0):
                raise RuntimeError(f"rank {i} Stage-1 {tag}-{RANKS} step vs "
                                   f"single process: {e}")
        if not (ranks[i]["s4"]["share"] <= 1.0
                and ranks[i]["s4"]["used"][0] == RANKS):
            raise RuntimeError(f"rank {i} Stage-4 dp step: {res['s4']}")
    s1_launch = {k: sum(res[t]["launches"][k] for res in ranks
                        for t in ("dp", "model")) for k in ref_launches}
    s4_launch = {k: sum(res["s4"]["launches"][k] for res in ranks)
                 for k in ranks[0]["s4"]["launches"]}
    if min(res[t]["launches"][k] for res in ranks for t in ("dp", "model")
           for k in ("H1-fwd", "H1-bwd", "H2")) < 1 \
            or min(res["s4"]["launches"][k] for res in ranks
                   for k in ("K1", "K2")) < 1:
        raise RuntimeError(f"multi-rank steps: launches {s1_launch} "
                           f"{s4_launch}")
    fmt = "; ".join(
        f"rank {i}: " + ", ".join(
            f"{t} loss rel {res[t]['loss_rel']:.2g}, gradients "
            f"{res[t]['grad_share']:.3f} of tolerance (worst "
            f"{res[t]['grad_worst']}, max |g| "
            f"{res[t]['grad_worst_max']:.3g}), {res[t]['s']:.2f} s"
            for t in ("dp", "model"))
        + f", Stage-4 {res['s4']['share']:.3f} of tolerance (worst "
        f"{res['s4']['worst']}), {res['s4']['s']:.2f} s"
        for i, res in enumerate(ranks))
    log(f"== 18 (c, d) multi-rank: the flagship model (d_out 3), {n} rays + "
        f"the {32 * 32}-pixel patch; single-process step {ref_s:.2f} s, "
        f"loss {ref_loss:.6f}, launches {ref_launches}; the same step on "
        f"the batch with its halves swapped: loss rel "
        f"{floor['loss_rel']:.2g}, gradients {floor['grad_share']:.3f} of "
        f"tolerance (worst {floor['grad_worst']}, max |g| "
        f"{floor['grad_worst_max']:.3g}); NCCL "
        f"world-size-1 step loss rel {nccl['loss_rel']:.2g}, gradients "
        f"{nccl['grad_share']:.3f} of tolerance; two gloo ranks on the card "
        f"({spawn_s:.1f} s, process start included): {fmt}; Stage 4 on "
        f"phase 4's scene ({r.static['num_gaussians']} gaussians, "
        f"{w}x{h}, flat); launches Stage 1 {s1_launch}, Stage 4 "
        f"{s4_launch}; phase (c, d) {time.perf_counter() - t_phase:.1f} s; "
        f"on {card}")
    return {"stage1_ranks": s1_launch, "stage4_dp": s4_launch}


def torchrun_phase(work: Path, card: str) -> None:
    """Phase 18 (e): the Stage-1 CLI on phase 10's conf under torchrun,
    two ranks on the one card over gloo: every step's loss finite, step
    0's the single-process run's (phase 10; the same seed, batch and
    draws), one run directory, rank 0's, with its metrics and checkpoint."""
    exps = work / "exps_torchrun"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
           str(RANKS), "--master_addr", "127.0.0.1", "--master_port",
           str(_free_port()), "-m", "holoscene_tpu_torch.training.exp_runner",
           "--conf", str(work / "smoke_s1.conf"), "--exps_folder", str(exps),
           "--max_niters", str(CLI_RANK_STEPS), "--log_every", "1", "--quiet",
           "--device", RANK_DEVICE, "--dist_backend", "gloo"]
    t0 = time.perf_counter()
    done = subprocess.run(cmd, cwd=Path(__file__).resolve().parent,
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if done.returncode != 0:
        raise RuntimeError(f"torchrun exp_runner exit {done.returncode}:\n"
                           f"{done.stdout[-4000:]}\n{done.stderr[-4000:]}")
    rundirs = list(exps.glob("*/*"))
    if len(rundirs) != 1:
        raise RuntimeError(f"torchrun exp_runner: run directories {rundirs}")
    rec = [json.loads(line) for line in
           (rundirs[0] / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in rec]
    ckpt = rundirs[0] / "checkpoints" / "ModelParameters" / "latest.pth"
    # steps 0 and 1 are the same computation as phase 10's; from step 2
    # on the learning rate decays over --max_niters (5 here, 100 there)
    dev = [abs(a - b) / abs(b) for a, b in zip(losses[:2], PHASE10_LOSSES)]
    log(f"== 18 (e) exp_runner under torchrun, {RANKS} ranks over gloo on "
        f"the card, phase 10's conf, {CLI_RANK_STEPS} steps in {wall:.1f} s "
        f"(process start included): losses "
        + ", ".join(f"{v:.5f}" for v in losses)
        + "; steps 0 / 1 relative to phase 10's " + " / ".join(
            f"{d:.2g}" for d in dev)
        + f" (step 0 held to rtol {S1_LOSS_RTOL}; later steps not compared: "
        f"the schedule decays over 5 steps here, 100 in phase 10); "
        f"checkpoint {ckpt.exists()}; on {card}")
    if len(losses) != CLI_RANK_STEPS or not all(finite(v) for v in losses) \
            or not ckpt.exists():
        raise RuntimeError(f"torchrun exp_runner: losses {losses}, "
                           f"checkpoint {ckpt.exists()}")
    if abs(losses[0] - PHASE10_LOSSES[0]) > S1_LOSS_ATOL + S1_LOSS_RTOL \
            * abs(PHASE10_LOSSES[0]):
        raise RuntimeError(f"torchrun exp_runner step 0 loss {losses[0]} "
                           f"vs the single-process {PHASE10_LOSSES[0]}")


# ---------------------------------------------------------------------------
# phase 19: the Stage-1 network variants
# ---------------------------------------------------------------------------

S19_EXTRACT_RES = 256
# the runs of phase 19 at the flagship width on the 512^2 scene: (what,
# steps, the model section merged into stage1_conf's, the H1 instantiation
# the run is there for (interp, fetch), or None)
S19_RUNS = {
    "a": ("tetrahedral, replica_room0.conf's vjp model", 40,
          S1_MODEL_DEFAULT + """
 implicit_network{
  grid_interp = tetrahedral
 }
""", ("tetrahedral", "packed")),
    "b": ("fused_fetch = raw, replica_room0_tpu.conf's fused model", 40,
          S1_MODEL_TPU + """
 implicit_network{
  fused_fetch = raw
 }
""", ("trilinear", "raw")),
    "c": ("forward_grad_mode = jvp", 20,
          S1_MODEL_DEFAULT + "\n forward_grad_mode = jvp\n", None),
    "d": ("color_grid_feature = false, rendering_network.mode = nerf", 20,
          S1_MODEL_DEFAULT + """
 implicit_network{
  color_grid_feature = false
 }
 rendering_network{
  mode = nerf
  d_in = 3
 }
""", None),
}
# the kernel table's rows of the new instantiations: (row key, kernel,
# instantiation key in ops/hashgrid.py's variant_launches, JAX source)
S19_ROWS = {
    "H1-fwd tetrahedral": ("H1-fwd", ("tetrahedral", "packed"),
                           "holoscene_tpu/ops/hashgrid.py:453"),
    "H1-fwd raw": ("H1-fwd", ("trilinear", "raw"),
                   "holoscene_tpu/ops/hashgrid.py:877"),
    "H1-bwd tetrahedral": ("H1-bwd", ("tetrahedral", "exact"),
                           "holoscene_tpu/ops/hashgrid.py:453"),
    "H2 packed tetrahedral": ("H2", ("tetrahedral", True),
                              "holoscene_tpu/ops/hashgrid.py:453"),
}


def _first_calls(n: int):
    """A record_hash `keep` that keeps the arguments of each wrapper's
    first n calls (None after)."""
    seen: dict = {}

    def keep(name, args):
        seen[name] = seen.get(name, 0) + 1
        return args if seen[name] <= n else None

    return keep


def variant_counts() -> dict:
    """The per-instantiation launch counts of H1-fwd, H1-bwd and H2:
    {kernel: {instantiation key: launches}}."""
    import torch

    from holoscene_tpu_torch.ops import hashgrid as hg

    torch.cuda.synchronize()
    out = {"H1-fwd": {}, "H1-bwd": {}, "H2": {}}
    names = {"fused_fwd": "H1-fwd", "fused_bwd": "H1-bwd",
             "sampler_fwd": "H2"}
    for (name, key), n in hg.variant_launches.items():
        out[names[name]][key] = n
    return out


def variants_phase(work: Path, card: str) -> dict:
    """Phase 19: the Stage-1 network variants at the flagship width through
    the exp_runner CLI on phase 10's 512^2 scene: (a) tetrahedral, (e) the
    extraction of (a)'s field at S19_EXTRACT_RES, (b) the raw fetch, (c) the
    jvp gradient mode, (d) no colour grid with the nerf head. Each run's
    launch counts are reset before it and read after it; every loss finite,
    rgb_loss falling over the run's thirds, the new instantiations launched
    (H1-fwd / H1-bwd tetrahedral on every step of (a), H2 tetrahedral on
    every grid chunk of (e), H1-fwd raw on every step of (b)). H1-fwd /
    H1-bwd tetrahedral and H1-fwd raw are held against plain on the first
    render call of their run, H2 tetrahedral on (e)'s first grid chunk,
    and timed (CUDA events). Returns the kernel table's rows S19_ROWS."""
    from holoscene_tpu_torch.ops import hashgrid as hg
    from holoscene_tpu_torch.training import exp_runner

    t_phase = time.perf_counter()
    found, counts, notes = {}, {}, []
    for tag in ("a", "b", "c", "d"):
        what, steps, model, inst = S19_RUNS[tag]
        conf = stage1_conf(work, f"smoke_s19{tag}", model)
        reset_counts()
        t0 = time.perf_counter()
        runner, rec = record_hash(lambda: exp_runner.main(
            ["--conf", str(conf), "--exps_folder", str(work / "exps_s19"),
             "--max_niters", str(steps), "--log_every", "1", "--quiet",
             "--device", "cuda"]), ("fused_fwd",), keep=_first_calls(1))
        wall = time.perf_counter() - t0
        counts[tag] = variant_counts()
        launches = read_hash_counts()
        hist = runner.history
        keys = ("loss", "rgb_loss", "eikonal_loss")
        if len(hist) != steps or not all(finite(h[k]) for h in hist
                                         for k in keys):
            raise RuntimeError(f"19 ({tag}): {len(hist)} logged steps for "
                               f"{steps}, or a non-finite loss")
        trend = thirds(hist, ("loss", "rgb_loss"))
        steady = (steps - 1) / (hist[-1]["elapsed_s"] - hist[0]["elapsed_s"])
        cfg = runner.model_cfg
        log(f"== 19 ({tag}) {what}: {steps} steps in {wall:.1f} s (CLI, "
            f"process start excluded), steps 2..{steps} {1e3 / steady:.2f} "
            f"ms/step; loss {hist[0]['loss']:.5f} at step 0, "
            f"{hist[-1]['loss']:.5f} at step {steps - 1}; first/last third "
            + ", ".join(f"{k} {a:.4f} -> {b:.4f}" for k, (a, b) in
                        trend.items())
            + f"; launches {launches}, by instantiation {counts[tag]}; "
            f"grid_interp {cfg.implicit.grid_interp}, fused_fetch "
            f"{cfg.implicit.fused_fetch}, forward_grad_mode "
            f"{cfg.forward_grad_mode}, colour grid "
            f"{cfg.implicit.color_grid_feature}, rendering "
            f"{cfg.rendering.mode}; on {card}")
        notes.append(f"({tag}) {wall:.1f} s")
        if not trend["rgb_loss"][1] < trend["rgb_loss"][0]:
            raise RuntimeError(f"19 ({tag}): rgb_loss did not fall: {trend}")
        if launches["H1-fwd"] < 2 * steps or launches["H1-bwd"] < 2 * steps:
            raise RuntimeError(f"19 ({tag}): H1 launches {launches}, "
                               f"expected the render's and the eikonal "
                               f"call's on every step")
        if inst is not None:
            fwd = counts[tag]["H1-fwd"].get(inst, 0)
            if fwd < steps:
                raise RuntimeError(f"19 ({tag}): H1-fwd {inst} launched "
                                   f"{fwd} times in {steps} steps")
            fargs = next(a for a in rec["fused_fwd"]
                         if a is not None and a[4:6] == inst)
            x01, emb_a, emb_b, lt = fargs[:4]
            found[tag] = compare_h1(
                x01, emb_a.detach(),
                None if emb_b is None else emb_b.detach(), lt, 40,
                timed=True,
                modes=("exact",) if inst[0] == "tetrahedral" else (),
                interp=inst[0], fetch=inst[1])
            found[tag]["points"] = (x01.shape[0], lt.n_levels,
                                    1 if emb_b is None else 2)
        if tag == "a":
            bwd = counts[tag]["H1-bwd"].get(("tetrahedral", "exact"), 0)
            if bwd < steps or counts[tag]["H1-fwd"].get(
                    ("trilinear", "packed")):
                raise RuntimeError(f"19 (a): H1 by instantiation "
                                   f"{counts[tag]}: every H1 call tetrahedral"
                                   f", its backward too")
            # (e) the extraction of (a)'s field
            reset_counts()
            t0 = time.perf_counter()
            meshes, rec_e = record_hash(
                lambda: runner.extract_meshes(resolution=S19_EXTRACT_RES),
                ("sampler_fwd",), keep=_first_calls(1))
            counts["e"] = variant_counts()
            wall = time.perf_counter() - t0
            h2 = counts["e"]["H2"].get(("tetrahedral", True), 0)
            faces = [0 if m is None else len(m.faces) for m in meshes]
            chunks = 1 + sum(-(-r ** 3 // EXTRACT_CHUNK)
                             for r in runner.extract_fine_res)
            log(f"== 19 (e) extraction of (a)'s field at {S19_EXTRACT_RES}: "
                f"{wall:.1f} s ({ {k: round(v, 3) for k, v in runner.extract_seconds.items()} }), "
                f"faces by object {faces}, H2 by instantiation "
                f"{counts['e']['H2']} for {chunks} grid chunks; on {card}")
            notes.append(f"(e) {wall:.1f} s")
            if h2 != chunks or len(counts["e"]["H2"]) != 1 \
                    or not any(faces):
                raise RuntimeError(f"19 (e): H2 {counts['e']['H2']} for "
                                   f"{chunks} chunks, faces {faces}")
            x01, emb, lt, packed, interp = rec_e["sampler_fwd"][0]
            found["e"] = {"H2": compare_h2(x01, emb, lt, timed=True,
                                           packed=packed, interp=interp),
                          "points": (x01.shape[0], lt.n_levels, 1)}
            del rec_e, meshes
        del runner, rec
    rows = {}
    for key, (kernel, inst, jax_src) in S19_ROWS.items():
        tag = {"H2": "e"}.get(kernel, "a" if inst[0] == "tetrahedral"
                              else "b")
        r = found[tag][kernel]
        rows[key] = {
            "name": f"{HASH_KERNELS[kernel]['name']} {key.split(' ', 1)[1]}",
            "route": "cuda", "source": HASH_KERNELS[kernel]["source"],
            "replaces": jax_src,
            "launches": counts[tag][kernel].get(inst, 0),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "shape": found[tag]["points"]}
        log(f"   {key}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} "
            f"ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
            f"({100 * r['bound_ms'] / r['ms']:.1f}% of it) at "
            f"{found[tag]['points']} (points, levels, tables) captured from "
            f"({tag}); max abs err {r['max_abs_err']:.3g} (within {H_REL} "
            f"of the largest value); launches in ({tag}) "
            f"{rows[key]['launches']}; on {card}")
    log(f"   phase 19 in {time.perf_counter() - t_phase:.1f} s: "
        + ", ".join(notes))
    return rows


# ---------------------------------------------------------------------------
# phase 20: repeatability
# ---------------------------------------------------------------------------

# phase 20's depths: Stage-1 steps of phase 10b's conf, and finetune
# iterations of object 1 on phase 10b's checkpoint (its extraction at
# S2_MESH_RES); a run of holoscene_tpu_torch/utils/repeat_check.py checks
# phase 10b's 40 steps and phase 14's 60 iterations and whole Stage 2
REPEAT_S1_STEPS = 10
REPEAT_FT_ITERS = 20
REPEAT_OBJ = 1


def float_sum_noise(bargs) -> float:
    """The largest difference between float32 sums of H1-bwd's own
    contributions at this call (the plain twin's per-corner values, as the
    kernel computes them) added by index_add_'s float atomics on the card:
    twice, and once with the contributions in a permuted order. The
    order-dependence that the fixed-point accumulation removed."""
    import torch

    from holoscene_tpu_torch.ops import hashgrid as hg

    recorded = []
    scatter = hg._scatter

    def record(acc, rows, vals, scale):
        recorded.append((acc.numel(), rows.reshape(-1).clone(),
                         [v.expand(rows.shape).reshape(-1).clone()
                          for v in vals]))
        return scatter(acc, rows, vals, scale)

    hg._scatter = record
    try:
        hg.fused_bwd_plain(*bargs[:9], interp=(
            bargs[9] if len(bargs) > 9 else "trilinear"))
    finally:
        hg._scatter = scatter
    worst = 0.0
    for size, rows, vals in recorded:
        perm = torch.randperm(rows.numel(), device=rows.device)
        sums = []
        for order in (None, None, perm):
            g = torch.zeros(size, device=rows.device)
            for c, v in enumerate(vals):
                r, x = (rows, v) if order is None else (rows[order], v[order])
                g.index_add_(0, 2 * r + c, x)
            sums.append(g)
        worst = max(worst, *(float((a - sums[0]).abs().max())
                             for a in sums[1:]))
    return worst


def repeat_phase(work: Path, card: str) -> dict:
    """Phase 20: the same bits twice from one seed. (a) phase 10b's conf for
    REPEAT_S1_STEPS steps twice through exp_runner.main: every parameter
    after every step and both checkpoints; (b) object REPEAT_OBJ's
    finetune for REPEAT_FT_ITERS iterations twice from phase 10b's
    checkpoint, each on a fresh Stage2Runner, then its extraction at
    S2_MESH_RES twice; (c) H1-bwd at phase 11's fine-tier call: two
    launches and one on the points, cotangents and uniforms permuted,
    beside the float-atomic sums' difference on the same contributions.
    Any nonzero difference fails. Returns the largest differences."""
    import argparse

    import torch

    from holoscene_tpu_torch.ops import hashgrid as hg
    from holoscene_tpu_torch.training.exp_runner_post import (
        add_run_args,
        build_stage2_runner,
    )
    from holoscene_tpu_torch.utils import repeat_check as rc

    t0 = time.perf_counter()
    conf = stage1_conf(work, "smoke_s1_vjp", S1_MODEL_DEFAULT)
    a = rc.stage1_twice(conf, work / "exps_repeat", REPEAT_S1_STEPS)
    parser = argparse.ArgumentParser()
    add_run_args(parser, mesh_resolution=S2_MESH_RES)
    args = parser.parse_args(rc.stage2_args(stage2_conf(work),
                                            work / "exps_s1b", S2_MESH_RES))

    def make_runner():
        return build_stage2_runner(args)[0]

    setup = rc.object_setup(make_runner(), REPEAT_OBJ)
    b, runner = rc.finetune_twice(make_runner, setup, REPEAT_OBJ,
                                  REPEAT_FT_ITERS)
    c = rc.extract_twice(runner)
    del runner
    # (c) H1-bwd: twice, then permuted
    x01, n_rows, ct_fa, ct_J, ct_fb, lt, mode, u_b, u_a = FINE_BWD[:9]
    first, second = hg.fused_bwd(*FINE_BWD), hg.fused_bwd(*FINE_BWD)
    perm = torch.randperm(x01.shape[0], device=x01.device)
    third = hg.fused_bwd(x01[perm].contiguous(), n_rows,
                         ct_fa[perm].contiguous(),
                         ct_J[..., perm].contiguous(),
                         ct_fb[perm].contiguous(), lt, mode,
                         None if u_b is None else u_b[..., perm].contiguous(),
                         None if u_a is None else u_a[..., perm].contiguous())
    torch.cuda.synchronize()
    h1 = max(float((x - y).abs().max()) for g in (second, third)
             for x, y in zip(g, first) if x is not None)
    h1_bits = all(same_bits(x, y) for g in (second, third)
                  for x, y in zip(g, first) if x is not None)
    noise = float_sum_noise(FINE_BWD)
    res = {"stage1": a["max_abs_diff"], "finetune": b["max_abs_diff"],
           "extraction": max((o["vertex_max_abs_diff"] or 0.0)
                             for o in c["objects"]),
           "h1_bwd": h1, "float_atomics_noise": noise,
           "seconds": time.perf_counter() - t0}
    log(f"== 20 repeatability in {res['seconds']:.1f} s on {card}: largest "
        f"absolute difference between two runs from one seed: (a) Stage 1, "
        f"{REPEAT_S1_STEPS} steps of phase 10b's conf, every parameter after "
        f"every step {a['max_abs_diff']:.3g} (checkpoints bitwise equal "
        f"{a['checkpoints_bitwise_equal']}); (b) object {REPEAT_OBJ}'s "
        f"finetune, {REPEAT_FT_ITERS} iterations from phase 10b's checkpoint "
        f"({setup['faces']} faces, {len(setup['gen_views'])} packs) "
        f"{b['max_abs_diff']:.3g}, its extraction at {S2_MESH_RES} twice "
        f"{res['extraction']:.3g} (faces "
        + ", ".join(str(o["faces"]) for o in c["objects"])
        + f"); (c) H1-bwd at phase 11's fine tier ({x01.shape[0]} points x "
        f"{lt.n_levels} levels, {mode}), two launches and permuted points "
        f"{h1:.3g}, where float atomics over the same contributions "
        f"differ by {noise:.3g}")
    bad = [k for k, ok in (
        ("(a)", a["bitwise_equal"] and a["checkpoints_bitwise_equal"]),
        ("(b)", b["bitwise_equal"]), ("(b) extraction", c["bitwise_equal"]),
        ("(c)", h1_bits)) if not ok]
    if bad:
        raise RuntimeError(f"phase 20: not bitwise repeatable: {bad}; "
                           f"(a) {a}, (b) {b}, extraction {c}")
    return res


def main() -> int:
    # one process runs every phase: segments that grow in place keep the
    # blocks earlier phases freed from stranding the chain's Stage-4 step
    # (12 GiB gradient arrays at ~5M gaussians)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch

    # 1 environment
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"== 1 environment: torch {torch.__version__} CUDA "
        f"{torch.version.cuda} python {sys.version.split()[0]}")
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2 build (from the sources in this checkout)
    from holoscene_tpu_torch import kernels
    from holoscene_tpu_torch.ops import splat_flat as sf

    info = kernels.build(force=True)
    kernels.library()
    log(f"== 2 build: nvcc {info['seconds']:.1f} s -> {kernels.LIB}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"   ptxas: {line.strip()}")

    # 3 kernels vs plain, small random scene
    xy, depth, conic, radius, valid, opac, rgb = random_scene(dev)
    cand, cs, cc, tiles = flat_inputs(xy, depth, conic, valid, opac, rgb,
                                      SMALL_RES)
    small = compare_flat(cand, cs, cc, tiles, SMALL_RES, SMALL_RES, 1,
                         timed=False)
    lists = topk_lists(xy, depth, conic, radius, valid, opac, rgb, SMALL_RES,
                       SMALL_RES, SMALL_K)
    small.update(compare_topk(*lists, SMALL_RES, SMALL_RES, 3, timed=False))
    log(f"== 3 kernels vs plain, random {SMALL_RES}^2 scene of {SMALL_N} "
        f"gaussians ({cand.shape[0] // sf.CHUNK} flat chunks, top-K lists of "
        f"{lists[0].shape[1]}): max abs err "
        + ", ".join(f"{k} {small[k]['max_abs_err']:.3g}{exact_note(small[k])}"
                    for k in KERNELS)
        + f" (forward atol {FWD_ATOL}, backward atol {BWD_ATOL} rtol "
        f"{BWD_RTOL})")

    from holoscene_tpu_torch.datasets.synthetic import write_vis_info
    from holoscene_tpu_torch.models.gom import GoMConfig
    from holoscene_tpu_torch.training import exp_runner_gaussian, gs_render
    from holoscene_tpu_torch.training.stage4 import Stage4Runner

    paths = {}
    with tempfile.TemporaryDirectory(prefix="holoscene_smoke_") as tmp:
        work = Path(tmp)
        t0 = time.perf_counter()
        conf, plots = write_slice_inputs(work)
        log(f"== 4 flat slice: scene {N_IMAGES} x {RES}^2 + meshes written "
            f"in {time.perf_counter() - t0:.1f} s")

        # 4 the flat slice through its CLI
        reset_counts()
        runner = exp_runner_gaussian.main(
            ["--conf", str(conf), "--exps_folder", str(work / "exps"),
             "--max_niters", str(STEPS), "--area_to_subdivide", str(AREA),
             "--log_every", "1", "--quiet", "--device", "cuda"])
        paths["flat"] = read_counts()
        check_training("flat slice", runner, runner.history, STEPS,
                       paths["flat"], ("K1", "K2"), card)
        if not finite(runner.test_metrics["psnr"]):
            raise RuntimeError(f"eval PSNR not finite: {runner.test_metrics}")
        outs = [plots / "gauss_scene.ply", plots / "gauss_scene.usdz"] + [
            plots / f"gauss_obj_{i}.ply"
            for i in range(len(runner.instance_ranges))]
        missing = [str(p) for p in outs if not p.exists()]
        if missing:
            raise RuntimeError(f"exports missing: {missing}")
        log(f"   test {runner.test_metrics}, rebins {runner.rebin_count}, "
            f"trim {runner._trim_active}, launches {paths['flat']}")

        # 5 the top-K slice: same scene, same meshes, K auto-calibrated
        t0 = time.perf_counter()
        reset_counts()
        topk = Stage4Runner(
            runner.meshes, runner.dataset,
            cfg=GoMConfig(use_flat=False, max_per_tile=0),
            area_to_subdivide=AREA, max_total_iters=TOPK_STEPS,
            out_dir=str(work / "topk_out"), quiet=True, device="cuda")
        probes = read_counts()["K3"]
        log(f"== 5 top-K slice: calibrated max_per_tile "
            f"{topk.cfg.max_per_tile} under the p99 overlap bound "
            f"{topk.k_geom} ({probes} probe renders, runner built in "
            f"{time.perf_counter() - t0:.1f} s)")
        if topk.use_flat or not 64 <= topk.cfg.max_per_tile <= 1024:
            raise RuntimeError(f"top-K runner: use_flat {topk.use_flat}, K "
                               f"{topk.cfg.max_per_tile}")
        reset_counts()
        topk.run(log_every=1)
        paths["topk"] = read_counts()
        check_training("top-K slice", topk, topk.history, TOPK_STEPS,
                       paths["topk"], ("K3", "K4"), card)
        log(f"   launches {paths['topk']}")

        # 6 the invisible-view path on a fresh flat runner
        packs = write_vis_info(str(plots), n_views=PACK_VIEWS, res=PACK_RES)
        invis = Stage4Runner(
            runner.meshes, runner.dataset, cfg=GoMConfig(max_per_tile=0),
            area_to_subdivide=AREA, max_total_iters=2 * INVIS_ITERS,
            out_dir=str(work / "invis_out"), quiet=True, device="cuda")
        invis.load_vis_info(str(plots))
        probe0 = invis_probe_l1(invis)
        reset_counts()
        invis.run(n_iters=INVIS_ITERS, log_every=1)
        paths["invisible"] = read_counts()
        probe1 = invis_probe_l1(invis)
        hist = invis.history
        trend = thirds(hist, ("invis_l1", "l1"))
        log(f"== 6 invisible-view path: {len(packs)} pack files of "
            f"{PACK_VIEWS} orthographic {PACK_RES}^2 views, K "
            f"{invis.cfg.max_per_tile}; {INVIS_ITERS} iterations (flat step "
            f"+ invisible-view step) in {invis.run_seconds:.3f} s, "
            f"{1e3 * invis.run_seconds / INVIS_ITERS:.2f} ms/iteration, "
            f"first iteration included; first/last third means: "
            + ", ".join(f"{k} {a:.4f} -> {b:.4f}"
                        for k, (a, b) in trend.items())
            + f"; invisible-view l1 on fixed probe views {probe0:.4f} -> "
            f"{probe1:.4f}; launches {paths['invisible']}; on {card}")
        if len(hist) != INVIS_ITERS or invis.invis_steps != INVIS_ITERS \
                or not all(finite(h["invis_l1"]) and finite(h["loss"])
                           for h in hist):
            raise RuntimeError("invisible-view run: a step is missing or "
                               f"not finite: {hist}")
        if not (finite(probe1) and probe1 < probe0):
            raise RuntimeError("invisible-view l1 on the fixed probe views "
                               f"did not fall: {probe0} -> {probe1}")
        if min(paths["invisible"].values()) < INVIS_ITERS:
            raise RuntimeError("invisible-view run: not every kernel "
                               f"launched every iteration: "
                               f"{paths['invisible']}")

        # 7 the standalone renderer on the flat run's export
        reset_counts()
        out_dir = work / "renders"
        t0 = time.perf_counter()
        summary = gs_render.main(
            ["--ply", str(plots / "gauss_scene.ply"), "--dataset", "ns",
             "--data_root", str(work / "data" / "scene_0"), "--split",
             "train", "--out", str(out_dir), "--device", "cuda"])
        paths["gs_render"] = read_counts()
        pngs = sorted(out_dir.glob("render_*.png"))
        log(f"== 7 gs_render: {len(pngs)} views in "
            f"{time.perf_counter() - t0:.1f} s, mean {summary}, launches "
            f"{paths['gs_render']}")
        if len(pngs) != N_IMAGES or not (out_dir / "metrics.json").exists() \
                or not finite(summary["psnr"]):
            raise RuntimeError(f"gs_render: {len(pngs)} PNGs, {summary}")
        if paths["gs_render"]["K3"] < N_IMAGES + 1:
            raise RuntimeError("gs_render: K3 not launched once per view "
                               f"plus the probes: {paths['gs_render']}")

        # 8 kernels vs plain at the slices' shapes (training frame 0)
        h, w = runner.dataset.img_res
        pose, intr = runner._pose_intr(0)
        xy, depth, conic, radius, valid, opac, rgb = gom_projection(
            runner, pose, intr, w, h)
        bins = runner._get_bins(0, pose, intr)
        cand = sf.gather_payload(xy, depth, conic, opac, rgb, bins["gidx"])
        big = compare_flat(cand, bins["tile_chunk_start"],
                           bins["tile_chunk_cnt"], -(-w // 16), w, h, 2,
                           timed=True)
        proj = gom_projection(topk, *topk._pose_intr(0), w, h)
        k_top = topk.cfg.max_per_tile
        lists = topk_lists(*proj, w, h, k_top)
        big.update(compare_topk(*lists, w, h, 4, timed=True))
        # what surrounds the walks in a step: binning / selection, gathers
        from holoscene_tpu_torch.ops.splat import select_topk

        top_idx = select_topk(*proj[:2], *proj[3:5], w, h, 16, k_top)[0]
        around = {
            "flat rebin (build_flat_bins, full plan)": cuda_ms(
                lambda: runner._rebin(pose, intr, None), 5),
            "flat payload gather": cuda_ms(lambda: sf.gather_payload(
                xy, depth, conic, opac, rgb, bins["gidx"]), 20),
            f"top-K selection (select_topk, k={k_top})": cuda_ms(
                lambda: select_topk(*proj[:2], *proj[3:5], w, h, 16, k_top),
                5),
            "top-K payload gather": cuda_ms(lambda: sf.gather_payload(
                *proj[:3], *proj[5:7], top_idx.reshape(-1)), 20),
        }
        log(f"== 8 kernels vs plain, training frame 0 "
            f"({cand.shape[0] // sf.CHUNK} flat chunks; top-K lists "
            f"{tuple(lists[0].shape)}) on {card}:")
        for k in KERNELS:
            b = big[k]
            log(f"   {k}: max abs err {b['max_abs_err']:.3g}{exact_note(b)}, "
                f"kernel {b['ms']:.3f} ms, plain {b['plain_ms']:.3f} ms, bound "
                f"{b['bound_ms']:.4f} ms by {b['bound_by']} "
                f"({b['walked_chunks']} chunks walked, "
                f"{b['live_candidate_pixels']} of {b['candidate_pixels']} "
                f"candidate-pixels live)"
                + (f"; the walk it replaced: {EARLIER_MS[k]:.3f} ms, "
                   f"{EARLIER_MS[k] / b['ms']:.2f}x; two launches bitwise "
                   f"equal" if k in EARLIER_MS else ""))
        for name, k in (("flat bins", "K2"), ("top-K lists", "K4")):
            log(f"   tiles by chunks walked, {name}: "
                f"{big[k]['tiles_by_walked_chunks']}")
        log("   around the walks (forward only, CUDA events): " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in around.items()))

        # K3/K4 vs plain on the lists of the other two paths that launch them
        from holoscene_tpu_torch import as_tensor
        from holoscene_tpu_torch.models.gom import read_gaussian_ply
        from holoscene_tpu_torch.ops.gaussians import view_matrix

        obj_i = next(i for i, v in enumerate(invis.vis_info_list) if v)
        pose_o, intr_o, w_o, h_o = pack_camera(invis.vis_info_list[obj_i][0],
                                               dev)
        lists_o = topk_lists(
            *gom_projection(invis, pose_o, intr_o, w_o, h_o,
                            visible_mask=invis._visible_mask(obj_i),
                            ortho=True),
            w_o, h_o, invis.cfg.max_per_tile)
        other = {"invisible": compare_topk(*lists_o, w_o, h_o, 5,
                                           timed=False)}
        g = gs_render.gaussian_tensors(
            read_gaussian_ply(str(plots / "gauss_scene.ply")), dev)
        ds = gs_render.load_dataset("ns", str(work / "data" / "scene_0"), -1)
        vm0 = view_matrix(ds.pose_all[0], dev)
        intr_r = as_tensor(ds.intrinsics[:3, :3], dev)
        k_render = gs_render.pick_max_per_tile(*g, vm0, intr_r, w, h, 3)
        lists_r = topk_lists(
            *projection(*g, vm0, intr_r, w, h, 3), w, h, k_render)
        other["gs_render"] = compare_topk(*lists_r, w, h, 6, timed=False)
        log(f"   K3/K4 vs plain on the other paths' lists: invisible-view "
            f"pack view of object {obj_i}, orthographic "
            f"{tuple(lists_o[0].shape)}; gs_render view 0 at its calibrated "
            f"K {k_render}, {tuple(lists_r[0].shape)}: max abs err "
            + ", ".join(f"{path} K3 {r['K3']['max_abs_err']:.3g} K4 "
                        f"{r['K4']['max_abs_err']:.3g}{exact_note(r['K4'])}"
                        for path, r in other.items()))

        # the chain record of phases 10b, 14a, 14, 15 and 16
        chain = {}
        hash_rows = stage1_phases(work, dev, card, chain)
        gate = gate_phase(work, card)
        mv = mv_predict_phase(work, dev, card, chain)
        stage2 = stage2_phase(work, dev, card, chain)
        stage3 = stage3_phase(work, dev, card, plots / "gauss_scene.ply",
                              chain)
        paths["chain_stage4"], other["chain_stage4"] = chain_phase(
            work, dev, card, chain)
        t1_row = free_gaussian_phase(work, dev, card,
                                     plots / "gauss_scene.ply", paths, other)
        # 18 the last modules: small ones, the occupancy grid, multi-rank
        small_modules_phase(dev, card)
        occ_launches = occupancy_phase(work, card)
        ranks = multirank_phase(work, dev, card, runner)
        torchrun_phase(work, card)
        # 19 the Stage-1 network variants
        variant_rows = variants_phase(work, card)
        # 20 repeatability
        repeat = repeat_phase(work, card)
        hash_rows["H1-bwd"]["repeatability"] = repeat
        paths["stage4_dp"] = ranks["stage4_dp"]
        for k, row in hash_rows.items():
            row["launches_by_path"]["stage1_occupancy"] = occ_launches[k]
            row["launches_by_path"]["stage1_ranks"] = ranks["stage1_ranks"][k]
            row["launches_by_path"]["quality_gate"] = gate[k]
            row["launches_by_path"]["mv_predict"] = mv[k].pop("launches")
            row["launches_by_path"]["stage2"] = stage2[k].pop("launches")
            row["launches_by_path"]["stage3"] = stage3[k].pop("launches")
            for tag, r in [*mv[k].items(), *stage2[k].items(),
                           *stage3[k].items()]:
                row["max_abs_err"] = max(row["max_abs_err"],
                                         r["max_abs_err"])
                row[tag] = {key: r[key] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}

    main_path = {"K1": "flat", "K2": "flat", "K3": "topk", "K4": "topk"}
    table = []
    for k, meta in KERNELS.items():
        b = dict(big[k])
        b["max_abs_err"] = max(
            [b["max_abs_err"], small[k]["max_abs_err"]]
            + [r[k]["max_abs_err"] for r in other.values() if k in r])
        for tag in ("chain_stage4", "gs_train", "ut_raster"):
            if k in other[tag]:
                b[tag] = {key: val for key, val in other[tag][k].items()
                          if key in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "max_abs_err",
                                     "max_abs_err_exact", "tolerance_share",
                                     "plain_max_abs_err_exact")}
        table.append({**meta, "launches": paths[main_path[k]][k], **b,
                      "launches_by_path": {p: c[k] for p, c in paths.items()}})
    table.extend(hash_rows.values())
    table.extend(variant_rows.values())
    table.append(t1_row)
    log(json.dumps({"kernels": table}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
