#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (holoscene_tpu_torch) runs on an
NVIDIA GPU: builds the hand-written kernels, holds each against its plain
PyTorch version, then trains the Stage-4 Gaussian-on-Mesh slice through its
CLI at full width (512^2 frames, >= 100k gaussians, SH degree 3).

    python3 chip_smoke.py        # from the repository root, one GPU

Phases, one '== ' line each:
  1 environment  torch / CUDA versions and the card (nvidia-smi name, power
                 limit); refuses to run without CUDA
  2 build        nvcc csrc/*.cu -> holoscene_tpu_torch/build (seconds)
  3 kernels      K1/K2 vs their plain versions on a random 128^2 scene
  4 slice        exp_runner_gaussian.main on a generated 512^2 scene: every
                 loss finite, l1 falls, K1/K2 launched every step, eval PSNR
                 finite, exports written; steps/s and splats/s
  5 kernels      K1/K2 vs plain again, at one training frame's bins (max abs
                 error, kernel ms beside plain ms)
Then the kernel table as one JSON line, and last the device line
{"ok": true, "device": {...}}. Any failure exits non-zero before it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

FWD_ATOL = 2e-4               # K1 vs plain (all 8 output channels)
BWD_ATOL, BWD_RTOL = 5e-4, 5e-3   # K2 vs plain
RES = 512
N_IMAGES = 8
MESH_RES = 32                 # marching-tetrahedra grid of the analytic meshes
AREA = 2e-4                   # face-area cap: ~123k gaussians at MESH_RES 32
# 30 steps move the per-step l1 less than its frame-to-frame noise at 512^2
# (first/last-third means 0.1934 -> 0.1977 over 30 steps, 0.1780 -> 0.1543
# over 150, on an H100 80GB HBM3 at 700 W); 100 steps show the trend
STEPS = 100
SMALL_RES, SMALL_N = 128, 5000

K1 = dict(name="K1 splat_flat_fwd", route="cuda",
          source="holoscene_tpu_torch/csrc/splat_flat_fwd.cu",
          replaces="holoscene_tpu/ops/splat_flat.py:601")
K2 = dict(name="K2 splat_flat_bwd", route="cuda",
          source="holoscene_tpu_torch/csrc/splat_flat_bwd.cu",
          replaces="holoscene_tpu/ops/splat_flat.py:710")


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


def compare_kernels(cand, cs, cc, tiles_x, width, height, seed, timed):
    """K1/K2 vs plain on the card; raises on disagreement. Returns
    {"K1": (max_abs_err, ms, plain_ms), "K2": ...} (ms None if not timed)."""
    import torch

    from holoscene_tpu_torch.ops import splat_flat as sf

    geom = (tiles_x, 16, width, height)
    ref = sf.flat_fwd_plain(cand, cs, cc, *geom)
    out = sf.flat_fwd(cand, cs, cc, *geom)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise RuntimeError("K1 output is not finite")
    err_f = float((out - ref).abs().max())
    if err_f > FWD_ATOL:
        bad = (out - ref).abs().amax(dim=(1,))   # per tile, per channel
        raise RuntimeError(f"K1 disagrees with plain: max abs err {err_f} > "
                           f"{FWD_ATOL}; worst channel errors "
                           f"{bad.amax(0).tolist()}")
    gen = torch.Generator(device=cand.device).manual_seed(seed)
    v = torch.randn(ref.shape, generator=gen, device=cand.device)
    v[..., 5:] = 0.0   # the diagnostics channels carry no cotangent
    dref = sf.flat_bwd_plain(cand, cs, ref, v, *geom)
    dker = sf.flat_bwd(cand, cs, ref, v, *geom)
    torch.cuda.synchronize()
    err_b = float((dker - dref).abs().max())
    over = ((dker - dref).abs() > BWD_ATOL + BWD_RTOL * dref.abs()).sum()
    if not torch.isfinite(dker).all() or int(over):
        raise RuntimeError(f"K2 disagrees with plain: {int(over)} values "
                           f"outside atol {BWD_ATOL} rtol {BWD_RTOL}; max abs "
                           f"err {err_b}")
    res = {"K1": [err_f, None, None], "K2": [err_b, None, None]}
    if timed:
        res["K1"][1] = cuda_ms(lambda: sf.flat_fwd(cand, cs, cc, *geom), 20)
        res["K1"][2] = cuda_ms(lambda: sf.flat_fwd_plain(cand, cs, cc, *geom),
                               3)
        res["K2"][1] = cuda_ms(lambda: sf.flat_bwd(cand, cs, ref, v, *geom),
                               20)
        res["K2"][2] = cuda_ms(
            lambda: sf.flat_bwd_plain(cand, cs, ref, v, *geom), 3)
    return res


def random_scene_inputs(dev):
    """A random 128^2 scene of SMALL_N gaussians -> walk inputs."""
    import numpy as np
    import torch

    from holoscene_tpu_torch.ops import splat_flat as sf
    from holoscene_tpu_torch.ops.gaussians import project_gaussians_fused

    rng = np.random.default_rng(0)
    n, res = SMALL_N, SMALL_RES
    means = np.stack([rng.uniform(-0.7, 0.7, n), rng.uniform(-0.7, 0.7, n),
                      rng.uniform(1.2, 3.0, n)], -1)
    f32 = dict(dtype=torch.float32, device=dev)
    xy, depth, conic, _, valid = project_gaussians_fused(
        torch.as_tensor(means, **f32),
        torch.as_tensor(rng.normal(size=(n, 4)), **f32),
        torch.as_tensor(rng.uniform(0.01, 0.05, (n, 3)), **f32),
        torch.eye(4, device=dev),
        torch.tensor([[res * 0.8, 0, res / 2], [0, res * 0.8, res / 2],
                      [0, 0, 1.0]], device=dev), res, res)
    opac = torch.as_tensor(rng.uniform(0.2, 0.95, n), **f32)
    rgb = torch.as_tensor(rng.uniform(0, 1, (n, 3)), **f32)
    tiles = res // 16
    plan = sf.plan_flat(xy, conic, opac, valid, tiles, tiles, 16)
    bins = sf.build_flat_bins(xy, depth, conic, opac, valid, tiles_x=tiles,
                              tiles_y=tiles, tile_size=16, plan=plan)
    cand = sf.gather_payload(xy, depth, conic, opac, rgb, bins["gidx"])
    return cand, bins["tile_chunk_start"], bins["tile_chunk_cnt"], tiles


def frame_inputs(runner, frame: int):
    """One training frame's walk inputs at the slice's shapes."""
    import torch

    from holoscene_tpu_torch.models import gom
    from holoscene_tpu_torch.ops.gaussians import view_matrix
    from holoscene_tpu_torch.ops.splat import project_and_shade
    from holoscene_tpu_torch.ops.splat_flat import gather_payload

    p, st, cfg = runner.params, runner.static, runner.cfg
    h, w = runner.dataset.img_res
    pose, intr = runner._pose_intr(frame)
    bins = runner._get_bins(frame, pose, intr)
    with torch.no_grad():
        colors = torch.cat([p["features_dc"][:, None], p["features_rest"]], 1)
        xy, depth, conic, _valid, rgb = project_and_shade(
            gom.gom_means(p, st, cfg), gom.gom_quats(p, st, cfg),
            gom.gom_scales(p, st, cfg), colors,
            view_matrix(pose, pose.device), intr, w, h,
            sh_degree=cfg.sh_degree)
        cand = gather_payload(xy, depth, conic, gom.gom_opacities(p), rgb,
                              bins["gidx"])
    return cand, bins["tile_chunk_start"], bins["tile_chunk_cnt"], \
        -(-w // cfg.tile_size), w, h


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
    cand, cs, cc, tiles = random_scene_inputs(dev)
    small = compare_kernels(cand, cs, cc, tiles, SMALL_RES, SMALL_RES, 1,
                            timed=False)
    log(f"== 3 kernels vs plain, random {SMALL_RES}^2 scene of {SMALL_N} "
        f"gaussians ({cand.shape[0] // sf.CHUNK} chunks): K1 max abs err "
        f"{small['K1'][0]:.3g} (atol {FWD_ATOL}), K2 max abs err "
        f"{small['K2'][0]:.3g} (atol {BWD_ATOL} rtol {BWD_RTOL})")

    # 4 the slice through its CLI; counts reset just before, read just after
    from holoscene_tpu_torch.training import exp_runner_gaussian

    with tempfile.TemporaryDirectory(prefix="holoscene_smoke_") as tmp:
        work = Path(tmp)
        t0 = time.perf_counter()
        conf, plots = write_slice_inputs(work)
        log(f"== 4 slice: scene {N_IMAGES} x {RES}^2 + meshes written in "
            f"{time.perf_counter() - t0:.1f} s")
        sf.flat_fwd.launches = 0
        sf.flat_bwd.launches = 0
        runner = exp_runner_gaussian.main(
            ["--conf", str(conf), "--exps_folder", str(work / "exps"),
             "--max_niters", str(STEPS), "--area_to_subdivide", str(AREA),
             "--log_every", "1", "--quiet", "--device", "cuda"])
        torch.cuda.synchronize()
        launches = {"K1": sf.flat_fwd.launches, "K2": sf.flat_bwd.launches}

        n_gauss = runner.static["num_gaussians"]
        hist = runner.history
        losses = [h["loss"] for h in hist]
        if not all(map(lambda x: x == x and abs(x) != float("inf"), losses)):
            raise RuntimeError(f"non-finite loss in {losses}")
        # each step draws a random frame and background, so single steps are
        # noisy: compare the means of the first and the last third
        third = max(len(hist) // 3, 1)
        trend = {k: (sum(h[k] for h in hist[:third]) / third,
                     sum(h[k] for h in hist[-third:]) / third)
                 for k in ("loss", "l1", "acm_loss", "depth_loss", "psnr")}
        log("   first/last third means: " + ", ".join(
            f"{k} {a:.4f} -> {b:.4f}" for k, (a, b) in trend.items()))
        if len(hist) != STEPS or not (trend["l1"][1] < trend["l1"][0]
                                      and trend["loss"][1] < trend["loss"][0]):
            raise RuntimeError(f"l1 or loss did not fall over {len(hist)} "
                               f"logged steps: {trend}")
        if n_gauss < 100_000 or runner.cfg.sh_degree != 3:
            raise RuntimeError(f"not the full-width slice: {n_gauss} "
                               f"gaussians, sh_degree {runner.cfg.sh_degree}")
        if launches["K1"] < STEPS or launches["K2"] < STEPS:
            raise RuntimeError(f"kernels not on the main path: {launches} "
                               f"launches for {STEPS} steps")
        psnr = runner.test_metrics["psnr"]
        if psnr != psnr or abs(psnr) == float("inf"):
            raise RuntimeError(f"eval PSNR not finite: {runner.test_metrics}")
        outs = [plots / "gauss_scene.ply", plots / "gauss_scene.usdz"] + [
            plots / f"gauss_obj_{i}.ply"
            for i in range(len(runner.instance_ranges))]
        missing = [str(p) for p in outs if not p.exists()]
        if missing:
            raise RuntimeError(f"exports missing: {missing}")
        steps_s = STEPS / runner.run_seconds
        steady_s = (STEPS - 1) / (hist[-1]["elapsed_s"] - hist[0]["elapsed_s"])
        log(f"   {n_gauss} gaussians, sh_degree 3, {RES}^2, {STEPS} steps "
            f"in {runner.run_seconds:.3f} s: {steps_s:.3f} steps/s, "
            f"{n_gauss * steps_s:.6g} splats/s (first step included); "
            f"steps 2..{STEPS}: {steady_s:.3f} steps/s, "
            f"{n_gauss * steady_s:.6g} splats/s; on {card}")
        log(f"   test {runner.test_metrics}, rebins {runner.rebin_count}, "
            f"trim {runner._trim_active}, launches {launches}")

        # 5 kernels vs plain at the slice's shapes (one training frame)
        cand, cs, cc, tiles_x, w, h = frame_inputs(runner, 0)
        big = compare_kernels(cand, cs, cc, tiles_x, w, h, 2, timed=True)
        n_chunks = cand.shape[0] // sf.CHUNK
        log(f"== 5 kernels vs plain, training frame 0 ({n_chunks} chunks, "
            f"{cs.shape[0]} tiles) on {card}:")
        for k in ("K1", "K2"):
            err, ms, plain = big[k]
            log(f"   {k}: max abs err {err:.3g}, kernel {ms:.3f} ms, plain "
                f"{plain:.3f} ms")

    table = []
    for k, meta in (("K1", K1), ("K2", K2)):
        err, ms, plain = big[k]
        table.append({**meta, "launches": launches[k],
                      "max_abs_err": max(err, small[k][0]), "ms": ms,
                      "plain_ms": plain})
    log(json.dumps({"kernels": table}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
