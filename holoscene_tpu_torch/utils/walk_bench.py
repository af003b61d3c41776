"""Time the backward tile walks K2 (splat_flat_bwd) and K4 (splat_topk_bwd)
on the card, at the inputs of chip_smoke.py's phase 8: training frame 0 of
the generated 512^2 scene after the flat run (100 steps) and the top-K run
(90 steps). Needs one NVIDIA GPU with nvcc; run from the repository root:

    python -m holoscene_tpu_torch.utils.walk_bench
    python -m holoscene_tpu_torch.utils.walk_bench \
        --variant old=path/to/other/csrc --variant nochain=path/to/csrc:NO_CHAIN

It prints the card (nvidia-smi name, power limit), the histogram of walked
chunks per tile (`used`) of the flat bins and of the top-K lists, and for
the tree's csrc/ and every --variant NAME=DIR[:DEFINE,...] (another csrc
directory, built with -DDEFINE ...): what ptxas reports for the two backward
kernels (registers, spills), K2 and K4 ms (CUDA events, 50 launches, taken
in two rounds over all variants so that the spread between rounds shows),
the largest deviation of each result from the tree's, and whether two
launches on the same inputs are bitwise equal. A variant is how a kernel
is taken apart to see where its time goes: a copy of the sources with one
part compiled out under a define. A variant library may export
`splat_flat_bwd_set_order(order, n)` / `splat_topk_bwd_set_order`; it is
then given the tiles sorted by `used`, longest first. The last line is one
JSON object with all of it.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import torch

from holoscene_tpu_torch import kernels
from holoscene_tpu_torch.ops import splat_flat as sf
from holoscene_tpu_torch.ops import splat_topk as st

ROOT = Path(__file__).resolve().parents[2]
REPS = 50


def load_variant(name: str, csrc: Path, defines: list[str]):
    """Build csrc/*.cu with the defines into its own library; returns (the
    loaded library, ptxas lines of the backward kernels)."""
    tree = (kernels.CSRC, kernels.LIB, kernels.NVCC_FLAGS)
    kernels.CSRC = csrc
    kernels.LIB = kernels.BUILD / f"libholoscene_kernels_{name}.so"
    kernels.NVCC_FLAGS = tree[2] + tuple(f"-D{d}" for d in defines)
    try:
        info = kernels.build(force=True)
        kernels.library.cache_clear()
        lib = kernels.library()
    finally:
        kernels.CSRC, kernels.LIB, kernels.NVCC_FLAGS = tree
        kernels.library.cache_clear()
    report, entry, spills = [], "", ""
    for line in info["log"].splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line and "bwd" in entry:
            used = line.split(":", 1)[1].strip()
            report.append(f"{entry}: {used}; {spills}")
    return lib, report


def used_histogram(used) -> dict:
    vals, counts = torch.unique(used.long().cpu(), return_counts=True)
    return {int(v): int(c) for v, c in zip(vals, counts)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=DIR[:DEFINE,...]")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("walk_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs_

    from holoscene_tpu_torch.models.gom import GoMConfig
    from holoscene_tpu_torch.training import exp_runner_gaussian
    from holoscene_tpu_torch.training.stage4 import Stage4Runner

    card = cs_.card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    specs = [("tree", kernels.CSRC, [])]
    for spec in args.variant:
        name, _, rest = spec.partition("=")
        path, _, defs = rest.partition(":")
        specs.append((name, Path(path).resolve(),
                      [d for d in defs.split(",") if d]))
    libs, ptxas = {}, {}
    for name, path, defs in specs:
        libs[name], ptxas[name] = load_variant(name, path, defs)
        print(f"built {name} ({path}, {defs}): {ptxas[name]}", flush=True)
    tree_library = kernels.library
    kernels.library = lambda: libs["tree"]

    with tempfile.TemporaryDirectory(prefix="holoscene_walk_") as tmp:
        work = Path(tmp)
        conf, _plots = cs_.write_slice_inputs(work)
        runner = exp_runner_gaussian.main(
            ["--conf", str(conf), "--exps_folder", str(work / "exps"),
             "--max_niters", str(cs_.STEPS), "--area_to_subdivide",
             str(cs_.AREA), "--log_every", "1", "--quiet", "--device", "cuda"])
        topk = Stage4Runner(
            runner.meshes, runner.dataset,
            cfg=GoMConfig(use_flat=False, max_per_tile=0),
            area_to_subdivide=cs_.AREA, max_total_iters=cs_.TOPK_STEPS,
            out_dir=str(work / "topk_out"), quiet=True, device="cuda")
        topk.run(log_every=1)
        h, w = runner.dataset.img_res
        pose, intr = runner._pose_intr(0)
        xy, depth, conic, _radius, _valid, opac, rgb = cs_.gom_projection(
            runner, pose, intr, w, h)
        bins = runner._get_bins(0, pose, intr)
        cand = sf.gather_payload(xy, depth, conic, opac, rgb, bins["gidx"])
        lists = cs_.topk_lists(
            *cs_.gom_projection(topk, *topk._pose_intr(0), w, h), w, h,
            topk.cfg.max_per_tile)

    flat_geom = (-(-w // 16), 16, w, h)
    tiles_cs = bins["tile_chunk_start"]
    fwd2 = sf.flat_fwd(cand, tiles_cs, bins["tile_chunk_cnt"], *flat_geom)
    fwd4, used4 = st.composite_fwd(*lists, 16, w, h)
    gen = torch.Generator(device=cand.device).manual_seed(2)
    v2 = torch.randn(fwd2.shape, generator=gen, device=cand.device)
    v4 = torch.randn(fwd4.shape, generator=gen, device=cand.device)
    v2[..., 5:] = 0.0
    v4[..., 5:] = 0.0
    used2 = fwd2[:, 0, 5].int()
    hist = {"flat": used_histogram(used2), "topk": used_histogram(used4)}
    print(f"used per tile (chunks: tiles), flat bins of "
          f"{cand.shape[0] // sf.CHUNK} chunks: {hist['flat']}; top-K lists "
          f"{tuple(lists[0].shape)}: {hist['topk']}", flush=True)
    orders = {"flat": torch.argsort(used2, descending=True, stable=True).int(),
              "topk": torch.argsort(used4, descending=True, stable=True).int()}

    def k2():
        return sf.flat_bwd(cand, tiles_cs, fwd2, v2, *flat_geom)

    def k4():
        return st.composite_bwd(lists[0], lists[1], used4, fwd4, v4, 16, w, h)

    results = {name: {"ptxas": ptxas[name], "K2_ms": [], "K4_ms": []}
               for name in libs}
    base = {}
    for rnd in range(2):
        for name, lib in libs.items():
            kernels.library = lambda lib=lib: lib
            for path, order in orders.items():
                entry = f"splat_{path}_bwd_set_order"
                if hasattr(lib, entry):
                    kernels.check(getattr(lib, entry)(
                        kernels._P(order.data_ptr()), order.numel()), entry)
            res = results[name]
            for key, fn in (("K2", k2), ("K4", k4)):
                res[f"{key}_ms"].append(cs_.cuda_ms(fn, REPS))
                if rnd:
                    continue
                first, second = fn(), fn()
                torch.cuda.synchronize()
                base.setdefault(key, first)
                res[f"{key}_max_abs_dev_from_tree"] = float(
                    (first - base[key]).abs().max())
                res[f"{key}_two_launches_equal"] = bool(
                    torch.equal(first, second))
    kernels.library = tree_library
    for name, res in results.items():
        print(f"{name}: K2 {res['K2_ms']} ms, K4 {res['K4_ms']} ms; "
              f"deviation from tree K2 {res['K2_max_abs_dev_from_tree']:.3g} "
              f"K4 {res['K4_max_abs_dev_from_tree']:.3g}; two launches equal "
              f"K2 {res['K2_two_launches_equal']} K4 "
              f"{res['K4_two_launches_equal']}", flush=True)
    print(json.dumps({"card": card, "reps": REPS, "used_histogram": hist,
                      "variants": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
