"""Time the four tile walks K1 (splat_flat_fwd), K2 (splat_flat_bwd), K3
(splat_topk_fwd) and K4 (splat_topk_bwd) on the card, at the inputs of
chip_smoke.py's phase 8: training frame 0 of the generated 512^2 scene
after the flat run (100 steps) and the top-K run (90 steps). Needs one
NVIDIA GPU with nvcc; run from the repository root:

    python -m holoscene_tpu_torch.utils.walk_bench
    python -m holoscene_tpu_torch.utils.walk_bench \
        --variant old=path/to/other/csrc --variant nochain=path/to/csrc:NO_CHAIN

It prints the card (nvidia-smi name, power limit), the histogram of walked
chunks per tile (`used`) of the flat bins and of the top-K lists, the share
of (warp, candidate) pairs of the walked chunks that the forward walk's
per-warp test passes (from its plain mirror, `warp_may_keep_plain`) beside
the share that have a lane with alpha >= 1/255, for warps of 16 x 2 pixels
(row-major) and of 8 x 4 pixels (the kernels' mapping); and for the tree's
csrc/ and every --variant NAME=DIR[:DEFINE,...] (another csrc directory,
built with -DDEFINE ...): what ptxas reports for every kernel (registers,
spills), K1-K4 ms (CUDA events, 50 launches, taken in two rounds over all
variants so that the spread between rounds shows), the largest deviation of
each result from the tree's in every output channel (K3 also in `used`),
and whether two launches on the same inputs are bitwise equal. The
backward walks of every variant get the tree's forward outputs. A variant is
how a kernel is taken apart to see where its time goes: a copy of the
sources with one part compiled out under a define. A variant library may
export `splat_flat_bwd_set_order(order, n)` / `splat_topk_bwd_set_order`; it
is then given the tiles sorted by `used`, longest first. The last line is
one JSON object with all of it.

With --gs_train STEPS it measures K2 at chip_smoke.py phase 17 (a)'s frame
instead: for each --seed, gs_train (splatfacto, capacity 100,000, SH 3) for
STEPS steps on the generated 512^2 scene, then K1's inputs at training
frame 0 as the trainer's step hands them over (saved with torch.save to
--capture DIR/k2_gs_train_seed{S}.pt when given); for the tree and every
variant, K2's worst deviation from plain's float64 sums as a share of
chip_smoke's tolerance (BWD_ATOL + BWD_RTOL |exact|), its largest absolute
deviation, and K1/K2 ms. --frame FILE reads such a capture instead of
training. The precision variants of the reverse walk are defines of the
tree's own sources:

    python -m holoscene_tpu_torch.utils.walk_bench --gs_train 700 \
        --variant terms=holoscene_tpu_torch/csrc:SPLAT_BWD_FLOAT_TERMS \
        --variant sums=holoscene_tpu_torch/csrc:SPLAT_BWD_FLOAT_SUMS
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
    loaded library, ptxas lines of every kernel)."""
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
        elif "registers" in line and entry:
            used = line.split(":", 1)[1].strip()
            report.append(f"{entry}: {used}; {spills}")
    return lib, report


def used_histogram(used) -> dict:
    vals, counts = torch.unique(used.long().cpu(), return_counts=True)
    return {int(v): int(c) for v, c in zip(vals, counts)}


def warp_test_rates(chunks, cs, used, px, py, tile_size) -> dict:
    """Over the walked chunks, per warp mapping: (warp, candidate) pairs,
    how many the per-warp test passes, how many have a live lane."""
    cs, used = cs.long(), used.long()
    orders = {"16x2": torch.arange(tile_size * tile_size),
              "8x4": sf.fwd_thread_pixels(tile_size)}
    rates = {}
    for name, order in orders.items():
        order = order.to(px.device)
        opx, opy = px[:, order], py[:, order]
        pairs = passed = live = 0
        for j in range(int(used.max()) if used.numel() else 0):
            act = j < used
            c = chunks[(cs + j)[act]]
            rect = sf.warp_rects(opx[act], opy[act])
            keep = sf._chunk_alpha(opx[act], opy[act], c)[6]
            n_t, n_p, n_c = keep.shape
            lane_live = keep.reshape(n_t, n_p // 32, 32, n_c).any(2)
            ok = sf.warp_may_keep_plain(rect, c)
            if bool((lane_live & ~ok).any()):
                raise RuntimeError("the warp test rejects a live candidate")
            pairs += ok.numel()
            passed += int(ok.sum())
            live += int(lane_live.sum())
        rates[name] = {"pairs": pairs, "pass": passed, "live": live,
                       "pass_share": passed / max(pairs, 1),
                       "live_share": live / max(pairs, 1)}
    return rates


def channel_dev(a, b) -> list:
    """Largest |a - b| in each channel (last dimension)."""
    d = (a.float() - b.float()).abs().reshape(-1, a.shape[-1])
    return d.amax(0).tolist()


def compact_frame(cand, cs, cc, tiles_x, w, h) -> tuple:
    """The same frame with only each tile's own chunks [cs, cs + cc) kept,
    in tile order (the flat plan's buffer holds spare chunks beyond them):
    K1 and K2 give the same results on it, and it is the size a capture
    has to be."""
    chunks = cand.reshape(-1, sf.CHUNK, sf.CAND_ROWS)
    cs64, cc64 = cs.long(), cc.long()
    idx = torch.repeat_interleave(cs64, cc64) + (
        torch.arange(int(cc64.sum()), device=cand.device)
        - torch.repeat_interleave(torch.cumsum(cc64, 0) - cc64, cc64))
    new_cs = (torch.cumsum(cc64, 0) - cc64).int()
    return (chunks[idx].reshape(-1, sf.CAND_ROWS).contiguous(), new_cs,
            cc.clone(), tiles_x, w, h)


def gs_train_frames(cs_, steps: int, seeds, capture) -> list:
    """[(name, (cand, cs, cc, tiles_x, w, h))]: training frame 0 of a
    gs_train run of `steps` steps for each seed (chip_smoke phase 17 (a)'s
    settings)."""
    from holoscene_tpu_torch.datasets.synthetic import generate_scene
    from holoscene_tpu_torch.training import gs_train

    frames = []
    with tempfile.TemporaryDirectory(prefix="holoscene_walk_") as tmp:
        scene = Path(tmp) / "scene_0"
        generate_scene(str(scene), n_images=cs_.S1_IMAGES,
                       img_res=(cs_.S1_RES, cs_.S1_RES))
        for seed in seeds:
            tr = gs_train.main([
                "--dataset", "ns", "--data_root", str(scene), "--out",
                str(Path(tmp) / f"gs_{seed}"), "--capacity",
                str(cs_.FREE_CAPACITY), "--sh_degree", "3", "--warmup",
                str(cs_.FREE_WARMUP), "--refine_every", str(cs_.FREE_REFINE),
                "--iters", str(steps), "--export", "scene.ply", "--seed",
                str(seed), "--quiet", "--device", "cuda"])
            inputs = compact_frame(*cs_.free_frame_inputs(tr, 0))
            name = f"gs_train_seed{seed}"
            if capture:
                Path(capture).mkdir(parents=True, exist_ok=True)
                torch.save(inputs, Path(capture) / f"k2_{name}.pt")
            frames.append((name, inputs))
            del tr
    return frames


def k2_precision(cs_, frames, libs, ptxas, card) -> dict:
    """For each frame and each variant library: K2's worst deviation from
    plain's float64 sums as a share of chip_smoke's tolerance, its largest
    absolute deviation, and K1 / K2 ms (CUDA events)."""
    out = {}
    for fname, (cand, cs, cc, tiles_x, w, h) in frames:
        geom = (tiles_x, 16, w, h)
        kernels.library = lambda: libs["tree"]
        fwd = sf.flat_fwd(cand, cs, cc, *geom)
        gen = torch.Generator(device=cand.device).manual_seed(8)
        v = torch.randn(fwd.shape, generator=gen, device=cand.device)
        v[..., 5:] = 0.0
        exact = sf.flat_bwd_plain(cand, cs, fwd, v, *geom,
                                  acc=torch.float64)
        plain = sf.flat_bwd_plain(cand, cs, fwd, v, *geom)
        tol = cs_.BWD_ATOL + cs_.BWD_RTOL * exact.abs()
        res = {"chunks": cand.shape[0] // sf.CHUNK,
               "walked_chunks": int(fwd[:, 0, 5].sum()),
               "float32_plain": {
                   "tolerance_share": float(((plain.double() - exact).abs()
                                             / tol).max()),
                   "max_abs_err_exact": float((plain.double() - exact)
                                              .abs().max())}}
        for name, lib in libs.items():
            kernels.library = lambda lib=lib: lib
            got = sf.flat_bwd(cand, cs, fwd, v, *geom)
            x = (got.double() - exact).abs()
            res[name] = {
                "tolerance_share": float((x / tol).max()),
                "max_abs_err_exact": float(x.max()),
                "values_over": int((x > tol).sum()),
                "K1_ms": cs_.cuda_ms(lambda: sf.flat_fwd(cand, cs, cc, *geom),
                                     REPS),
                "K2_ms": cs_.cuda_ms(lambda: sf.flat_bwd(cand, cs, fwd, v,
                                                         *geom), REPS)}
            print(f"{fname} {name}: K2 worst {res[name]['tolerance_share']:.4f}"
                  f" of its tolerance, max abs err "
                  f"{res[name]['max_abs_err_exact']:.4g} vs exact sums, "
                  f"{res[name]['values_over']} values over; K1 "
                  f"{res[name]['K1_ms']:.4f} ms, K2 {res[name]['K2_ms']:.4f} "
                  f"ms", flush=True)
        print(f"{fname}: float32 plain worst "
              f"{res['float32_plain']['tolerance_share']:.4f} of the "
              f"tolerance; {res['walked_chunks']} chunks walked; on {card}",
              flush=True)
        out[fname] = res
    return {"card": card, "reps": REPS, "ptxas": ptxas, "frames": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=DIR[:DEFINE,...]")
    ap.add_argument("--gs_train", type=int, default=0, metavar="STEPS",
                    help="K2's precision at gs_train's frame after STEPS")
    ap.add_argument("--seed", type=int, action="append", default=[],
                    help="gs_train seeds (default 0)")
    ap.add_argument("--frame", action="append", default=[],
                    help="a frame saved by --capture, instead of training")
    ap.add_argument("--capture", default="",
                    help="directory to save the gs_train frames in")
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
    if args.gs_train or args.frame:
        frames = [(Path(f).stem, torch.load(f, map_location="cuda"))
                  for f in args.frame]
        if args.gs_train:
            frames += gs_train_frames(cs_, args.gs_train, args.seed or [0],
                                      args.capture)
        result = k2_precision(cs_, frames, libs, ptxas, card)
        kernels.library = tree_library
        print(json.dumps(result), flush=True)
        return 0

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
    tiles_cc = bins["tile_chunk_cnt"]
    fwd2 = sf.flat_fwd(cand, tiles_cs, tiles_cc, *flat_geom)
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
    n_tiles, k_top = lists[0].shape[0], lists[0].shape[1]
    warp_test = {
        "flat": warp_test_rates(
            cand.reshape(-1, sf.CHUNK, sf.CAND_ROWS), tiles_cs, used2,
            *sf._tile_pixels(tiles_cs.shape[0], *flat_geom,
                             cand.device)[:2], 16),
        "topk": warp_test_rates(
            lists[0].reshape(-1, sf.CHUNK, sf.CAND_ROWS),
            torch.arange(n_tiles, device=cand.device) * (k_top // sf.CHUNK),
            used4, *sf.tile_pixels_at(lists[1], 16, w, h)[:2], 16)}
    for path, rates in warp_test.items():
        print(f"warp test, {path}: " + "; ".join(
            f"{m} warps pass {r['pass_share']:.4f}, live lane "
            f"{r['live_share']:.4f} of {r['pairs']} (warp, candidate) pairs"
            for m, r in rates.items()), flush=True)
    orders = {"flat": torch.argsort(used2, descending=True, stable=True).int(),
              "topk": torch.argsort(used4, descending=True, stable=True).int()}

    walks = {
        "K1": lambda: sf.flat_fwd(cand, tiles_cs, tiles_cc, *flat_geom),
        "K2": lambda: sf.flat_bwd(cand, tiles_cs, fwd2, v2, *flat_geom),
        "K3": lambda: st.composite_fwd(*lists, 16, w, h),
        "K4": lambda: st.composite_bwd(lists[0], lists[1], used4, fwd4, v4,
                                       16, w, h),
    }
    results = {name: {"ptxas": ptxas[name],
                      **{f"{k}_ms": [] for k in walks}} for name in libs}
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
            for key, fn in walks.items():
                res[f"{key}_ms"].append(cs_.cuda_ms(fn, REPS))
                if rnd:
                    continue
                first, second = fn(), fn()
                torch.cuda.synchronize()
                if key == "K3":
                    first, used = first
                    second, used_again = second
                    base.setdefault("K3_used", used)
                    res["K3_used_max_abs_dev_from_tree"] = int(
                        (used - base["K3_used"]).abs().max())
                    same = torch.equal(used, used_again)
                else:
                    same = True
                base.setdefault(key, first)
                res[f"{key}_channel_dev_from_tree"] = channel_dev(
                    first, base[key])
                res[f"{key}_two_launches_equal"] = bool(
                    same and torch.equal(first, second))
    kernels.library = tree_library
    for name, res in results.items():
        dev = {k: [float(f"{d:.3g}") for d in res[f"{k}_channel_dev_from_tree"]]
               for k in walks}
        print(f"{name}: " + "; ".join(
            f"{k} {res[f'{k}_ms']} ms, two launches equal "
            f"{res[f'{k}_two_launches_equal']}, deviation from tree by "
            f"channel {dev[k]}" for k in walks)
            + f"; K3 used deviation {res['K3_used_max_abs_dev_from_tree']}",
            flush=True)
    print(json.dumps({"card": card, "reps": REPS, "used_histogram": hist,
                      "warp_test": warp_test, "variants": results}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
