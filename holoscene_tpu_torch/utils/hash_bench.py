"""Time the hash-grid kernels H1-fwd (hash_fused_fwd) and H1-bwd
(hash_fused_bwd) on the card at every H1 call of one background step at
chip_smoke.py's phase-11 shapes (bench.py's flagship_config, d_out 32, a
random 1024-ray batch, the background patch on; the third step, since at
the first the geometric init gives the SDF grid zero cotangents): the
fine tier (32,768
points x 16 levels, sampled_all), the tail (24,576 x 6, sampled_all), the
eikonal call (4,096 x 16, one table, exact) and the background patch
(100,352 x 16, exact), each with the step's own cotangents and draws.
Needs one NVIDIA GPU with nvcc; run from the repository root:

    python -m holoscene_tpu_torch.utils.hash_bench
    python -m holoscene_tpu_torch.utils.hash_bench \
        --variant old=path/to/other/csrc \
        --variant zero=holoscene_tpu_torch/csrc:HASH_BWD_ZERO_FILL_ONLY

It prints the card (nvidia-smi name, power limit) and, for the tree's
csrc/ and every --variant NAME=DIR[:DEFINE,...] (another csrc directory,
built with -DDEFINE ...): what ptxas reports for the two kernels
(registers, spills), H1-fwd and H1-bwd ms at each call (CUDA events, REPS
launches, taken in two rounds over all variants so that the spread between
rounds shows; H1-bwd's time includes the wrapper's zero-fill of the
gradient tables), each call's bound (chip_smoke.hash_bound), the largest
deviation of each output from the tree's (H1-fwd: whether it is bitwise
the tree's; H1-bwd: relative to the largest gradient) and whether two
launches agree (H1-fwd bitwise, H1-bwd within chip_smoke.H_REL: atomics).
The earlier kernels are a variant: their sources out of git, e.g.
`git archive 43206f0 holoscene_tpu_torch/csrc | tar -x -C .checkout/old`
and `--variant old=.checkout/old/holoscene_tpu_torch/csrc` (one thread per
(point, level)). The
ablation switches of H1-bwd are listed in the header note of
csrc/hash_fused_bwd.cu; any other change is timed from an edited copy of
csrc/ passed as a variant. The last line is one JSON object with all of
it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from holoscene_tpu_torch import kernels
from holoscene_tpu_torch.ops import hashgrid as hg
from holoscene_tpu_torch.utils.walk_bench import load_variant

ROOT = Path(__file__).resolve().parents[2]
REPS = 50
CALLS = ("fine", "tail", "eikonal", "patch")


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
        x01, ea, eb, lt = f
        out[name] = ((x01, ea.detach(), None if eb is None else eb.detach(),
                      lt), b)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=DIR[:DEFINE,...]")
    ap.add_argument("--reps", type=int, default=REPS)
    args = ap.parse_args(argv)
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
    libs, ptxas = {}, {}
    for name, path, defs in specs:
        libs[name], report = load_variant(name, path, defs)
        ptxas[name] = [r for r in report if "hash_fused" in r]
        print(f"{name}: {path} {defs}: " + " | ".join(ptxas[name]),
              flush=True)
    tree_library = kernels.library
    kernels.library = lambda: libs["tree"]
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

    results = {name: {"ptxas": ptxas[name]} for name in libs}
    base = {}
    for rnd in range(2):
        for name, lib in libs.items():
            kernels.library = lambda lib=lib: lib
            res = results[name]
            for call, (fargs, bargs) in calls.items():
                r = res.setdefault(call, {"H1-fwd_ms": [], "H1-bwd_ms": []})
                r["H1-fwd_ms"].append(cs_.cuda_ms(
                    lambda: hg.fused_fwd(*fargs), args.reps))
                r["H1-bwd_ms"].append(cs_.cuda_ms(
                    lambda: hg.fused_bwd(*bargs), args.reps))
                if rnd:
                    continue
                first, second = hg.fused_fwd(*fargs), hg.fused_fwd(*fargs)
                g1, g2 = hg.fused_bwd(*bargs), hg.fused_bwd(*bargs)
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
                r["H1-bwd_two_launches_within_tolerance"] = \
                    r["H1-bwd_rel_dev_two_launches"] <= cs_.H_REL
    kernels.library = tree_library
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
    print(json.dumps({"card": card, "reps": args.reps, "calls": bounds,
                      "variants": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
