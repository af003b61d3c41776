#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (holoscene_tpu_torch) runs on an
NVIDIA GPU: builds the hand-written kernels, holds each against its plain
PyTorch version, then drives the Stage-4 Gaussian-on-Mesh paths through their
entry points at full width (512^2 frames, >= 100k gaussians, SH degree 3).

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
Wherever a kernel is held against plain (phases 3 and 8) it is launched
twice on the same inputs and the two results must be the same bits.
The launch counts are set to 0 just before each of the paths 4-7 and read
just after. Then the kernel table as one JSON line and last the device line
{"ok": true, "device": {...}}. Any failure exits non-zero before it.

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
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

FWD_ATOL = 2e-4               # K1/K3 vs plain (all 8 output channels)
BWD_ATOL, BWD_RTOL = 5e-4, 5e-3   # K2/K4 vs plain
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
    from holoscene_tpu_torch.ops import splat_flat as sf
    from holoscene_tpu_torch.ops import splat_topk as st

    sf.flat_fwd.launches = sf.flat_bwd.launches = 0
    st.composite_fwd.launches = st.composite_bwd.launches = 0


def read_counts() -> dict:
    import torch

    from holoscene_tpu_torch.ops import splat_flat as sf
    from holoscene_tpu_torch.ops import splat_topk as st

    torch.cuda.synchronize()
    return {"K1": sf.flat_fwd.launches, "K2": sf.flat_bwd.launches,
            "K3": st.composite_fwd.launches, "K4": st.composite_bwd.launches}


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


def bound_ms(n_bytes: int, n_ops: int):
    by_bytes = n_bytes / MEM_BYTES_S * 1e3
    by_ops = n_ops / FP32_OPS_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def compare_walks(names, chunks, real, cs, pixels, fwd, fwd_plain, bwd,
                  bwd_plain, extra_in_bytes, seed, timed):
    """One forward/backward kernel pair vs plain on the card; raises on
    disagreement. pixels = (px, py, in_img) of the tiles; fwd() -> (out
    [T,P,8], used [T]); bwd(out, used, v) -> d cand. Returns {name: dict(max_abs_err, ms, plain_ms, bound_ms,
    bound_by)} (the times None unless timed)."""
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
    err_b = float((dker - dref).abs().max())
    over = ((dker - dref).abs() > BWD_ATOL + BWD_RTOL * dref.abs()).sum()
    if not torch.isfinite(dker).all() or int(over):
        raise RuntimeError(f"{kb} disagrees with plain: {int(over)} values "
                           f"outside atol {BWD_ATOL} rtol {BWD_RTOL}; max abs "
                           f"err {err_b}")
    res = {kf: dict(max_abs_err=err_f, ms=None, plain_ms=None),
           kb: dict(max_abs_err=err_b, ms=None, plain_ms=None)}
    walked, pairs, live = walk_work(chunks, real, cs, ref_used, *pixels)
    vals, tiles = torch.unique(ref_used.long(), return_counts=True)
    read = walked * chunks[0].numel() * 4 + extra_in_bytes
    block = out.numel() * 4
    res[kf]["bound_ms"], res[kf]["bound_by"] = bound_ms(
        read + block, pairs * OPS_TEST + live * OPS_LIVE_FWD)
    res[kb]["bound_ms"], res[kb]["bound_by"] = bound_ms(
        read + 2 * block + dker.numel() * 4,
        pairs * OPS_TEST + live * OPS_LIVE_BWD)
    for k in names:
        res[k].update(walked_chunks=walked, candidate_pixels=pairs,
                      live_candidate_pixels=live, library_ms=None,
                      tiles_by_walked_chunks=dict(zip(vals.tolist(),
                                                      tiles.tolist())))
    if timed:
        # the candidate rows (tens of MB) are left warm in the 50 MB L2, as
        # the gather that precedes each walk in a training step leaves them
        res[kf]["ms"] = cuda_ms(fwd, 20)
        res[kf]["plain_ms"] = cuda_ms(fwd_plain, 3)
        res[kb]["ms"] = cuda_ms(lambda: bwd(ref, ref_used, v), 20)
        res[kb]["plain_ms"] = cuda_ms(lambda: bwd_plain(ref, ref_used, v), 3)
    return res


def compare_flat(cand, cs, cc, tiles_x, width, height, seed, timed):
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
        2 * cs.numel() * 4, seed, timed)


def compare_topk(cand, origins, counts, width, height, seed, timed):
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
        lambda o, u, v: st.composite_bwd(cand, origins, u, o, v, *geom),
        lambda o, u, v: st.composite_bwd_plain(cand, origins, u, o, v, *geom),
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
               sh_degree, ortho=False):
    """Projected, shaded gaussians as render_gaussians makes them: (xy,
    depth, conic, radius, valid, opac, rgb)."""
    import torch

    from holoscene_tpu_torch.ops.gaussians import project_gaussians_fused
    from holoscene_tpu_torch.ops.splat import shade

    with torch.no_grad():
        xy, depth, conic, radius, valid = project_gaussians_fused(
            means, quats, scales, viewmat, intr, w, h, ortho=ortho)
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


def main() -> int:
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
        + ", ".join(f"{k} {small[k]['max_abs_err']:.3g}" for k in KERNELS)
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
            log(f"   {k}: max abs err {b['max_abs_err']:.3g}, kernel "
                f"{b['ms']:.3f} ms, plain {b['plain_ms']:.3f} ms, bound "
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
        ds = gs_render._load_dataset("ns", str(work / "data" / "scene_0"), -1)
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
                        f"{r['K4']['max_abs_err']:.3g}"
                        for path, r in other.items()))

    main_path = {"K1": "flat", "K2": "flat", "K3": "topk", "K4": "topk"}
    table = []
    for k, meta in KERNELS.items():
        b = dict(big[k])
        b["max_abs_err"] = max(
            [b["max_abs_err"], small[k]["max_abs_err"]]
            + [r[k]["max_abs_err"] for r in other.values() if k in r])
        table.append({**meta, "launches": paths[main_path[k]][k], **b,
                      "launches_by_path": {p: c[k] for p, c in paths.items()}})
    log(json.dumps({"kernels": table}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
