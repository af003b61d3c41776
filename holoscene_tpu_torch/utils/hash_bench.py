"""Time the hash-grid kernels on the card: H1-fwd (hash_fused_fwd) and
H1-bwd (hash_fused_bwd) at every H1 call of one background step, and H2
(hash_sampler_fwd) at the shapes it runs at. Needs one NVIDIA GPU with
nvcc; run from the repository root:

    python -m holoscene_tpu_torch.utils.hash_bench
    python -m holoscene_tpu_torch.utils.hash_bench --kernel H2 \
        --variant old=path/to/other/csrc

H1: chip_smoke.py's phase-11 shapes (bench.py's flagship_config, d_out 32,
a random 1024-ray batch, the background patch on; the third step, since at
the first the geometric init gives the SDF grid zero cotangents): the fine
tier (32,768 points x 16 levels, sampled_all), the tail (24,576 x 6,
sampled_all), the eikonal call (4,096 x 16, one table, exact) and the
background patch (100,352 x 16, exact), each with the step's own
cotangents and draws.

H2, at the flagship meta (16 levels 16-2048, 2^19 rows) with phase 9's
random tables (the time depends on the points and the meta, which fix the
rows gathered, not on the table's values): `extract_last` and
`extract_mid`, the chunks of mesh extraction's 512^3 grid (packed,
262,144 points, one x-plane each) at x01 = 1 (the last chunk, which
chip_smoke.py's phase 12 also times: every point in one x cell) and at
plane 256 (x01 = 256/511, as the other 638 chunks of an extraction are);
`bake`, the first 262,144-point chunk of the 129^3 probe bake at its 8
levels; `vjp_sampler`, the first sampler call of the first step of the
vjp conf (chip_smoke.py's phase 10b: confs/replica_room0.conf's model
section, 1024 rays x 129 points at 16 levels, not packed), captured from
that step with its own table.

It prints the card (nvidia-smi name, power limit) and, for the tree's
csrc/ and every --variant NAME=DIR[:DEFINE,...] (another csrc directory,
built with -DDEFINE ...): what ptxas reports for the kernels (registers,
spills) and each kernel's ms at each call (CUDA events, REPS launches back
to back, taken in two rounds over all variants so that the spread between
rounds shows). H1: H1-bwd's time includes the wrapper's
zero-fill (and, since the fixed-point accumulation, the maxima and the
conversion); the largest deviation of each output from the tree's (H1-fwd:
whether it is bitwise the tree's; H1-bwd: relative to the largest
gradient) and whether two launches are bitwise equal (H1-fwd, and H1-bwd
since its fixed-point accumulation; an older csrc/'s float-atomic H1-bwd
is recognised by its C signature and called through float_atomic_bwd,
e.g. `git archive 124e6ee holoscene_tpu_torch/csrc`). H2: also the ms of a
launch that finds the L2
cold (a 128 MB buffer written before each launch, as the trunk's
activations between two chunks of an extraction write it), whether the
output is bitwise the tree's and two launches bitwise equal, and for the
tree the plain version's ms and max abs error. Each call's bound is
chip_smoke.hash_bound's. The earlier kernels are a variant: their sources
out of git, e.g. `git archive 2c8f867 holoscene_tpu_torch/csrc | tar -x
-C .checkout/old` and `--variant old=.checkout/old/holoscene_tpu_torch/csrc`.
The ablation switches of H1-bwd are listed in the header note of
csrc/hash_fused_bwd.cu; any other ablation is an edited copy of csrc/
passed as a variant. The last line is one JSON object with all of it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from holoscene_tpu_torch import kernels
from holoscene_tpu_torch.ops import hashgrid as hg
from holoscene_tpu_torch.utils.walk_bench import load_variant

ROOT = Path(__file__).resolve().parents[2]
REPS = 50
CALLS = ("fine", "tail", "eikonal", "patch")
H2_SHAPES = ("extract_last", "extract_mid", "bake", "vjp_sampler")
FLUSH_BYTES = 128 << 20

def captured_calls(cs_, dev):
    """The H1 calls of the third step at the bench shapes, a background
    step: {call: (fwd args, bwd args)} (chip_smoke.capture_h1)."""
    from holoscene_tpu_torch.losses.holoscene_loss import LossConfig
    from holoscene_tpu_torch.models import holoscene as hs
    from holoscene_tpu_torch.training import stage1 as s1

    cfg = cs_.flagship_cfg(32)
    model = hs.init_holoscene(cfg, 0, dev)
    opt, sched = s1.make_optimizer(model, 5e-4, 20.0, 200000)
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = cs_.bench_batch(gen, dev, cs_.BENCH_RAYS)
    probe = hs.make_probe_bake(cfg)(model)
    lcfg = LossConfig(depth_weight=0.5, semantic_weight=5.0,
                      reg_vio_weight=0.01, bg_reg_weight=0.01)
    for i in range(cs_.BENCH_WARMUP):
        with_bg = i == cs_.BENCH_WARMUP - 1
        draws = s1.StepDraws.make(cfg, cs_.BENCH_RAYS, gen, dev, with_bg)
        calls = cs_.capture_h1(lambda: s1.train_step(
            model, opt, sched, lcfg, batch, draws, i, probe=probe))
    if len(calls) != len(CALLS) or any(b is None for _, b in calls):
        raise RuntimeError(f"{len(calls)} H1 calls captured, expected "
                           f"{len(CALLS)} with their backwards")
    out = {}
    for name, (f, b) in zip(CALLS, calls):
        x01, ea, eb, lt = f[:4]
        out[name] = ((x01, ea.detach(), None if eb is None else eb.detach(),
                      lt), b)
    return out


def h2_calls(cs_, dev) -> dict:
    """{shape: (x01, emb, lt, packed)} of H2_SHAPES."""
    from holoscene_tpu_torch.training import exp_runner

    cfg = cs_.flagship_cfg(32)
    meta = cfg.implicit.grid_meta
    _, emb, _ = cs_.random_hash_inputs(meta, 3, dev, 40)
    res, chunk = cs_.PLOT_RES, cs_.EXTRACT_CHUNK
    axis = torch.as_tensor(np.linspace(-1.0, 1.0, res, dtype=np.float32),
                           device=dev)

    def extract_chunk(start):
        i = torch.arange(start, start + chunk, device=dev)
        x = torch.stack([axis[i // (res * res)], axis[(i // res) % res],
                         axis[i % res]], -1)
        return ((x / cfg.implicit.divide_factor + 1.0) * 0.5).contiguous()

    n = cfg.probe_grid_res + 1
    ax = torch.linspace(-1.0, 1.0, n, device=dev)
    grid = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1)
    bake = ((grid.reshape(-1, 3)[:cs_.BAKE_CHUNK] + 1.0) * 0.5).contiguous()
    full = hg.level_tables(meta)
    with tempfile.TemporaryDirectory(prefix="hash_bench_") as tmp:
        conf = cs_.stage1_conf(Path(tmp), "bench_vjp", cs_.S1_MODEL_DEFAULT)
        _, sampled = cs_.record_hash(lambda: exp_runner.main(
            ["--conf", str(conf), "--exps_folder", str(Path(tmp) / "exps"),
             "--max_niters", "1", "--quiet", "--device", "cuda"]),
            ("sampler_fwd",))
    vjp = sampled["sampler_fwd"][0][:4]
    if vjp[2].n_levels != full.n_levels or vjp[3]:
        raise RuntimeError(f"the vjp step's sampler call: {vjp[2].n_levels} "
                           f"levels, packed {vjp[3]}")
    return {"extract_last": (extract_chunk(res ** 3 - chunk), emb, full,
                             True),
            "extract_mid": (extract_chunk(res // 2 * res * res), emb, full,
                            True),
            "bake": (bake, emb, hg.level_tables(meta, cfg.sampler_grid_levels),
                     False),
            "vjp_sampler": vjp}


def cold_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Mean ms of fn() over reps launches, each after writing `flush`
    (which evicts the L2), each timed alone with CUDA events."""
    fn()
    total = 0.0
    for _ in range(reps):
        flush.add_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def float_atomic_bwd(lib):
    """H1-bwd of a csrc/ from before the fixed-point accumulation (commit
    124e6ee and earlier): float atomics into the wrapper's zero-filled
    float32 gradients, the C signature without the int64 work buffer."""
    fn = lib.hash_fused_bwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]

    def bwd(x01, n_rows, ct_fa, ct_J, ct_fb, lt, mode, u_b=None, u_a=None,
            interp="trilinear"):
        dev = x01.device
        ga = torch.zeros(n_rows, 2, device=dev)
        gb = torch.zeros(n_rows, 2, device=dev) if ct_fb is not None \
            else None
        scales, ints = lt.device_arrays(dev)
        kernels.check(fn(
            x01.data_ptr(), ct_fa.data_ptr(), hg._ptr(ct_J), hg._ptr(ct_fb),
            hg._ptr(u_b) if mode != "exact" else 0,
            hg._ptr(u_a) if mode == "sampled_all" else 0, scales.data_ptr(),
            ints.data_ptr(), ga.data_ptr(), hg._ptr(gb), x01.shape[0],
            lt.n_levels, hg._MODE_ID[mode], hg.INTERPS.index(interp),
            torch.cuda.current_stream(dev).cuda_stream), "hash_fused_bwd")
        return ga, gb

    return bwd


def bench_h1(cs_, libs, reps: int, dev, bwds: dict) -> dict:
    calls = captured_calls(cs_, dev)
    bounds = {}
    for name, ((x01, _, eb, lt), b) in calls.items():
        bounds[name] = {
            "points": x01.shape[0], "levels": lt.n_levels,
            "tables": 1 if eb is None else 2, "mode": b[6],
            "H1-fwd": cs_.hash_bound("H1-fwd", x01, lt, has_b=eb is not None),
            "H1-bwd": cs_.hash_bound("H1-bwd", x01, lt, b[1],
                                     has_b=b[4] is not None, mode=b[6])}
        print(f"call {name}: {bounds[name]}", flush=True)

    results = {name: {} for name in libs}
    base = {}
    for rnd in range(2):
        for name, lib in libs.items():
            kernels.library = lambda lib=lib: lib
            res = results[name]
            for call, (fargs, bargs) in calls.items():
                r = res.setdefault(call, {"H1-fwd_ms": [], "H1-bwd_ms": []})
                r["H1-fwd_ms"].append(cs_.cuda_ms(
                    lambda: hg.fused_fwd(*fargs), reps))
                r["H1-bwd_ms"].append(cs_.cuda_ms(
                    lambda: bwds[name](*bargs), reps))
                if rnd:
                    continue
                first, second = hg.fused_fwd(*fargs), hg.fused_fwd(*fargs)
                g1, g2 = bwds[name](*bargs), bwds[name](*bargs)
                torch.cuda.synchronize()
                ref_f = base.setdefault((call, "fwd"), first)
                ref_b = base.setdefault((call, "bwd"), g1)
                outs = [(a, b, c) for a, b, c in zip(first, second, ref_f)
                        if a is not None]
                r["H1-fwd_two_launches_equal"] = all(
                    torch.equal(a, b) for a, b, _ in outs)
                r["H1-fwd_bitwise_tree"] = all(
                    torch.equal(a, c) for a, _, c in outs)
                r["H1-fwd_max_abs_dev_from_tree"] = max(
                    float((a - c).abs().max()) for a, _, c in outs)
                grads = [(a, b, c) for a, b, c in zip(g1, g2, ref_b)
                         if a is not None]
                r["H1-bwd_rel_dev_two_launches"] = max(
                    float((a - b).abs().max() / c.abs().max().clamp(1e-30))
                    for a, b, c in grads)
                r["H1-bwd_rel_dev_from_tree"] = max(
                    float((a - c).abs().max() / c.abs().max().clamp(1e-30))
                    for a, _, c in grads)
                r["H1-bwd_two_launches_bitwise"] = all(
                    torch.equal(a.view(torch.int32), b.view(torch.int32))
                    for a, b, _ in grads)
    for name, res in results.items():
        for call in calls:
            r = res[call]
            print(f"{name} {call}: H1-fwd {r['H1-fwd_ms']} ms (bound "
                  f"{bounds[call]['H1-fwd'][0]:.4f}), two launches equal "
                  f"{r['H1-fwd_two_launches_equal']}, bitwise tree "
                  f"{r['H1-fwd_bitwise_tree']}; H1-bwd {r['H1-bwd_ms']} ms "
                  f"(bound {bounds[call]['H1-bwd'][0]:.4f}), deviation from "
                  f"tree {r['H1-bwd_rel_dev_from_tree']:.3g}, two launches "
                  f"{r['H1-bwd_rel_dev_two_launches']:.3g}", flush=True)
    return {"calls": bounds, "variants": results}


def bench_h2(cs_, libs, reps: int, dev) -> dict:
    calls = h2_calls(cs_, dev)
    shapes, base = {}, {}
    for name, (x01, emb, lt, packed) in calls.items():
        ref = hg.sampler_fwd_plain(x01, emb, lt, packed)
        out = hg.sampler_fwd(x01, emb, lt, packed)
        torch.cuda.synchronize()
        base[name] = out
        shapes[name] = {
            "points": x01.shape[0], "levels": lt.n_levels, "packed": packed,
            "bound": cs_.hash_bound("H2", x01, lt),
            "plain_ms": cs_.cuda_ms(lambda: hg.sampler_fwd_plain(
                x01, emb, lt, packed), 3),
            "max_abs_err": cs_._check_close(f"H2 {name}", out, ref)}
        print(f"H2 {name}: {shapes[name]}", flush=True)
    flush = torch.zeros(FLUSH_BYTES // 4, device=dev)
    results = {name: {} for name in libs}
    for rnd in range(2):
        for name, lib in libs.items():
            kernels.library = lambda lib=lib: lib
            for shape, args in calls.items():
                r = results[name].setdefault(shape, {"ms": [], "cold_ms": []})
                r["ms"].append(cs_.cuda_ms(lambda: hg.sampler_fwd(*args),
                                           reps))
                r["cold_ms"].append(cold_ms(lambda: hg.sampler_fwd(*args),
                                            reps, flush))
                if rnd:
                    continue
                a, b = hg.sampler_fwd(*args), hg.sampler_fwd(*args)
                torch.cuda.synchronize()
                r["two_launches_equal"] = torch.equal(a, b)
                r["bitwise_tree"] = torch.equal(a, base[shape])
                r["max_abs_dev_from_tree"] = float(
                    (a - base[shape]).abs().max())
    for name, res in results.items():
        for shape in calls:
            r = res[shape]
            bound = shapes[shape]["bound"][0]
            print(f"{name} H2 {shape}: {r['ms']} ms, cold L2 {r['cold_ms']} "
                  f"ms (bound {bound:.4f}, {100 * bound / min(r['ms']):.1f}%"
                  f"), two launches equal {r['two_launches_equal']}, bitwise "
                  f"tree {r['bitwise_tree']}", flush=True)
    return {"shapes": shapes, "variants": results}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("H1", "H2"), action="append",
                    help="the kernels to time (default both)")
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=DIR[:DEFINE,...]")
    ap.add_argument("--reps", type=int, default=REPS)
    args = ap.parse_args(argv)
    which = args.kernel or ["H1", "H2"]
    if not torch.cuda.is_available():
        print("hash_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs_

    card = cs_.card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    specs = [("tree", kernels.CSRC, [])]
    for spec in args.variant:
        name, _, rest = spec.partition("=")
        path, _, defs = rest.partition(":")
        specs.append((name, Path(path).resolve(),
                      [d for d in defs.split(",") if d]))
    libs, ptxas, bwds = {}, {}, {}
    for name, path, defs in specs:
        libs[name], report = load_variant(name, path, defs)
        fixed = "void* acc" in (path / "hash_fused_bwd.cu").read_text()
        bwds[name] = hg.fused_bwd if fixed else float_atomic_bwd(libs[name])
        ptxas[name] = [r for r in report if "hash_" in r]
        print(f"{name}: {path} {defs}: " + " | ".join(ptxas[name]),
              flush=True)
    tree_library = kernels.library
    kernels.library = lambda: libs["tree"]
    out = {"card": card, "reps": args.reps, "ptxas": ptxas,
           "ncu": shutil.which("ncu")}
    try:
        if "H1" in which:
            out["H1"] = bench_h1(cs_, libs, args.reps, dev, bwds)
        if "H2" in which:
            out["H2"] = bench_h2(cs_, libs, args.reps, dev)
    finally:
        kernels.library = tree_library
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
