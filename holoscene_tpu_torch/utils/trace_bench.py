"""Time kernel T1 (gs_trace_select, the ray tracer's hit selection) on the
card at the inputs of chip_smoke.py's phase 17 (f): view 0 of the generated
512^2 scene against the gaussians that the flat Stage-4 run of its phase 4
(100 steps) exports. Needs one NVIDIA GPU with nvcc; run from the
repository root:

    python -m holoscene_tpu_torch.utils.trace_bench
    python -m holoscene_tpu_torch.utils.trace_bench \\
        --variant old=.checkout/old/holoscene_tpu_torch/csrc \\
        --variant noinsert=holoscene_tpu_torch/csrc:T1_NO_INSERT

The selections: `tile` and `row`, the middle 65,536 rays of the view in
trace_image's tile order and row-major (one T1 launch of trace_image);
`tile4096` and `row4096`, the middle 4096 of each (a 4096-ray chunk);
`fisheye`, the view's fisheye rays (as gs_render --camera fisheye traces
them) at `tile`'s indices. For each, from the cull's plain mirror: the
survivors a block (mean, max), the exact pairs tested, the pairs whose ray
meets the exact sphere, and the bound as chip_smoke.py computes it. For the tree's
csrc/ and every --variant NAME=DIR[:DEFINE,...] (another csrc directory,
built with -DDEFINE ...): what ptxas reports (registers, spills), the
kernel's ms at each selection (CUDA events, REPS launches back to back on
spheres made once before; two rounds over all variants, so that the spread
between rounds shows), whether its indices and counts are bitwise the
tree's, whether two launches agree, and the wall seconds of a whole
traced view 0 (trace_image with the variant's kernel behind its selection,
VIEW_ROUNDS rounds over all variants) with whether its image is bitwise the
tree's. For the tree also the wrapper's ms (select_hits: the spheres, then
the launch), the spheres' ms alone, whether plain's indices and counts
equal its own at every selection, and the plain version's ms at the
4096-ray selections. A variant whose
gs_trace_select.cu takes no sphere argument has the interface of the
kernel before the cull, e.g.
`git archive 748fe3e holoscene_tpu_torch/csrc | tar -x -C .checkout/old`.
The kernel's one ablation switch, T1_NO_INSERT, is described in the header
note of csrc/gs_trace_select.cu; any other ablation is an edited copy of
csrc/ in a gitignored directory.
The last line is one JSON object with all of it.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from holoscene_tpu_torch import kernels
from holoscene_tpu_torch.ops import gs_trace
from holoscene_tpu_torch.utils.walk_bench import load_variant

ROOT = Path(__file__).resolve().parents[2]
REPS = 20
VIEW_ROUNDS = 3


def selections(w: int, h: int, dev) -> dict:
    """{name: ray indices of the view} (the middle rays of each order;
    `fisheye` takes `tile`'s indices of the fisheye rays)."""
    out = {}
    orders = {"tile": gs_trace.tile_order(w, h, dev),
              "row": torch.arange(w * h, device=dev)}
    for n in (gs_trace.SELECT_RAYS, 4096):
        n = min(n, w * h)
        mid = (w * h // n // 2) * n
        for name, order in orders.items():
            out[name if n > 4096 else f"{name}4096"] = order[mid:mid + n]
    out["fisheye"] = out["tile"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=DIR[:DEFINE,...]")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs_

    from holoscene_tpu_torch.models.gom import read_gaussian_ply
    from holoscene_tpu_torch.training import exp_runner_gaussian, gs_render

    card = cs_.card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    specs = [("tree", kernels.CSRC, [])]
    for spec in opts.variant:
        name, _, rest = spec.partition("=")
        path, _, defs = rest.partition(":")
        specs.append((name, Path(path).resolve(),
                      [d for d in defs.split(",") if d]))
    libs, ptxas, with_spheres = {}, {}, {}
    for name, path, defs in specs:
        libs[name], ptxas[name] = load_variant(name, path, defs)
        src = (path / "gs_trace_select.cu").read_text()
        with_spheres[name] = "const void* spheres" in src
        sig = list(kernels._SIGNATURES["gs_trace_select"])
        if not with_spheres[name]:
            del sig[3]
        libs[name].gs_trace_select.argtypes = sig
        print(f"built {name} ({path}, {defs}): "
              f"{[p for p in ptxas[name] if 'gs_trace' in p]}", flush=True)

    with tempfile.TemporaryDirectory(prefix="holoscene_trace_") as tmp:
        work = Path(tmp)
        conf, plots = cs_.write_slice_inputs(work)
        exp_runner_gaussian.main(
            ["--conf", str(conf), "--exps_folder", str(work / "exps"),
             "--max_niters", str(cs_.STEPS), "--area_to_subdivide",
             str(cs_.AREA), "--log_every", "1", "--quiet", "--device", "cuda"])
        g = read_gaussian_ply(str(plots / "gauss_scene.ply"))
        ds = gs_render.load_dataset("ns", str(work / "data" / "scene_0"))
    dev = torch.device("cuda")
    h, w = ds.img_res
    gt, g13, ro_all, rd_all = cs_.t1_inputs(g, ds, dev)
    args = cs_.T1_ARGS
    k, min_kernel, min_alpha, near, degree = args
    fish = gs_trace.fisheye_rays(ds.pose_all[0], ds.intrinsics[:3, :3], w,
                                 h, dev)
    sel = {}
    for name, ids in selections(w, h, dev).items():
        o_all, d_all = fish if name == "fisheye" else (ro_all, rd_all)
        ro, rd = o_all[ids].contiguous(), d_all[ids].contiguous()
        spheres = gs_trace.cull_spheres(g13, ro, min_kernel, min_alpha,
                                        degree)
        sel[name] = {"ro": ro, "rd": rd, "spheres": spheres,
                     "work": {"rays": ro.shape[0],
                              "all_pairs": ro.shape[0] * g13.shape[0],
                              **cs_.t1_work(g13, ro, rd)}}
        print(f"{name}: {sel[name]['work']}", flush=True)

    def t1_call(name, packed, ro, rd, spheres, idx, cnt, *cut):
        ptrs = [ro.data_ptr(), rd.data_ptr(), packed.data_ptr()]
        if with_spheres[name]:
            ptrs.append(spheres.data_ptr())
        st = libs[name].gs_trace_select(
            *ptrs, ro.shape[0], packed.shape[0], idx.shape[1], *cut,
            idx.data_ptr(), cnt.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        kernels.check(st, f"gs_trace_select ({name})")

    def launcher(name, s):
        n = s["ro"].shape[0]
        out = (torch.empty((n, k), dtype=torch.int32, device=dev),
               torch.empty((n,), dtype=torch.int32, device=dev))
        return (lambda: t1_call(name, g13, s["ro"], s["rd"], s["spheres"],
                                *out, min_kernel, min_alpha, near, degree),
                out)

    tree_select, images = gs_trace._select_hits, {}

    def selector(name):
        """The selection trace_image calls, with the variant's kernel."""
        def select(packed, ro, rd, k_, mk, ma, nr, deg, block, spheres):
            out = (torch.empty((ro.shape[0], k_), dtype=torch.int32,
                               device=dev),
                   torch.empty((ro.shape[0],), dtype=torch.int32,
                               device=dev))
            t1_call(name, packed, ro, rd, spheres, *out, mk, ma, nr, deg)
            return out
        return tree_select if name == "tree" else select

    results = {name: {"ptxas": ptxas[name], "ms": {s: [] for s in sel}}
               for name in libs}
    base = {}
    for rnd in range(2):
        for name in libs:
            res = results[name]
            for sname, s in sel.items():
                run, out = launcher(name, s)
                res["ms"][sname].append(cs_.cuda_ms(run, REPS))
                if rnd:
                    continue
                run()
                first = [x.clone() for x in out]
                run()
                second = [x.clone() for x in out]
                torch.cuda.synchronize()
                base.setdefault(sname, first)
                res.setdefault("idx_equal_tree", {})[sname] = torch.equal(
                    first[0], base[sname][0])
                res.setdefault("count_equal_tree", {})[sname] = torch.equal(
                    first[1], base[sname][1])
                res.setdefault("two_launches_equal", {})[sname] = bool(
                    torch.equal(first[0], second[0])
                    and torch.equal(first[1], second[1]))
    tree = results["tree"]
    tree["wrapper_ms"], tree["spheres_ms"], tree["plain_ms"] = {}, {}, {}
    tree["plain_equal"] = {}
    for sname, s in sel.items():
        ro, rd = s["ro"], s["rd"]
        tree["wrapper_ms"][sname] = cs_.cuda_ms(
            lambda: gs_trace.select_hits(g13, ro, rd, *args), REPS)
        tree["spheres_ms"][sname] = cs_.cuda_ms(
            lambda: gs_trace.cull_spheres(g13, ro, min_kernel, min_alpha,
                                          degree), REPS)
        if sname.endswith("4096"):
            tree["plain_ms"][sname] = cs_.cuda_ms(
                lambda: gs_trace.select_hits_plain(g13, ro, rd, *args), 2)
        ref = gs_trace.select_hits_plain(g13, ro, rd, *args)
        tree["plain_equal"][sname] = bool(
            torch.equal(ref[0], base[sname][0])
            and torch.equal(ref[1], base[sname][1]))
    # a whole traced view 0 (trace_image: the tile order, four T1
    # launches, the composite), each variant's kernel behind its selection
    try:
        for rnd in range(VIEW_ROUNDS):
            for name in libs:
                gs_trace._select_hits = selector(name)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                img = gs_trace.trace_image(g, ds.pose_all[0],
                                           ds.intrinsics[:3, :3], w, h,
                                           sh_degree=3, device="cuda")
                results[name].setdefault("view_s", []).append(
                    time.perf_counter() - t0)
                images.setdefault(name, img)
    finally:
        gs_trace._select_hits = tree_select
    for name, img in images.items():
        results[name]["view_equal_tree"] = all(
            np.array_equal(img[key], images["tree"][key]) for key in img)
    for name, res in results.items():
        print(f"{name}: view 0 traced in {res['view_s']} s (image equal "
              f"tree {res['view_equal_tree']}); " + "; ".join(
            f"{s} {res['ms'][s]} ms, idx / count equal tree "
            f"{res['idx_equal_tree'][s]} / {res['count_equal_tree'][s]}, "
            f"two launches equal {res['two_launches_equal'][s]}"
            for s in sel), flush=True)
    print(f"tree wrapper ms {tree['wrapper_ms']}, spheres ms "
          f"{tree['spheres_ms']}, plain ms {tree['plain_ms']} (equal "
          f"{tree['plain_equal']})", flush=True)
    print(json.dumps({
        "card": card, "reps": REPS, "gaussians": g13.shape[0],
        "live": int((gt[3] > min_alpha).sum()), "k": k,
        "work": {s: v["work"] for s, v in sel.items()},
        "variants": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
