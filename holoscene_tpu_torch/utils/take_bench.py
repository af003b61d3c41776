r"""Time kernel H4 (planned_take_bwd, the payload gather's transpose) on the
card, the tree's build beside other builds of csrc/. Needs one NVIDIA GPU
with nvcc; run from the repository root:

    python -m holoscene_tpu_torch.utils.take_bench \
        [--variant NAME=DIR[:DEFINE,...]] [--full] [--out FILE]

for example beside the kernel before the redesign (the half-warp a row):

    git archive 520bff9 holoscene_tpu_torch/csrc | tar -x -C .checkout/old
    python -m holoscene_tpu_torch.utils.take_bench \
        --variant old=.checkout/old/holoscene_tpu_torch/csrc

Each --variant is another csrc directory (an ablation: an edited copy of
csrc/ in a gitignored directory), built with -DDEFINE ... into its own
library; its `planned_take_bwd` must have the tree's C signature. The
inputs, each timed by chip_smoke.py's compare_h4 with every variant in
chip_smoke.H4_VARIANTS (each variant's result bitwise the tree's or the
run fails; warm windows and cold launches, two rounds, the tree first and
then last; index_add_ of the live slots and an empty kernel beside):
  phase8    chip_smoke's phase 8: the flat bins of training frame 0 after
            phase 4's 100-step flat Stage-4 run, K2's d cand;
  gs_train  phase 17 (a): gs_train's training frame 0 after its 700 steps
            at the CLI's defaults (capacity 100,000) on the 512^2 scene;
  random    a plan of the chain frame's size (chip_smoke phase 16, an
            H100 run: 4,321,077 rows, ~0.82 live slots a row, Poisson, and
            32,174,935 dead slots), in random slot order, a random
            cotangent.
--full instead runs chip_smoke.main() whole with the variants in
H4_VARIANTS, so that its phases 8, 16 (the chain's training frame) and 17
time them beside the tree (~13 min on an H100). The last line of the
output is one JSON object with all of it (also written to --out).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import torch

from holoscene_tpu_torch import kernels
from holoscene_tpu_torch.utils.walk_bench import load_variant

ROOT = Path(__file__).resolve().parents[2]
# chip_smoke phase 16's chain frame on an H100 (rows, live, dead slots)
CHAIN_ROWS, CHAIN_LIVE_A_ROW, CHAIN_DEAD = 4_321_077, 0.82, 32_174_935


def variant_fn(lib, name: str):
    """fn(ct, perm, bounds) -> [n + 1, 16]: H4 of the library `lib`."""
    def fn(ct, perm, bounds):
        n = bounds.shape[0] - 2
        out = torch.empty(n + 1, 16, dtype=torch.float32, device=ct.device)
        stream = torch.cuda.current_stream(ct.device).cuda_stream
        st = lib.planned_take_bwd(ct.data_ptr(), perm.data_ptr(),
                                  bounds.data_ptr(), out.data_ptr(), n,
                                  stream)
        kernels.check(st, f"planned_take_bwd ({name})")
        return out
    return fn


def random_plan(dev, seed: int = 0):
    """(ct, perm, bounds, gidx) of a plan at the chain frame's size:
    Poisson run lengths, the slots in random order."""
    from holoscene_tpu_torch.ops import splat_flat as sf

    gen = torch.Generator(dev).manual_seed(seed)
    lens = torch.poisson(torch.full((CHAIN_ROWS,), CHAIN_LIVE_A_ROW,
                                    device=dev), generator=gen).long()
    rows = torch.repeat_interleave(torch.arange(CHAIN_ROWS, device=dev),
                                   lens)
    gidx = torch.cat([rows, torch.full((CHAIN_DEAD,), CHAIN_ROWS,
                                       device=dev)])
    gidx = gidx[torch.randperm(gidx.shape[0], generator=gen, device=dev)]
    perm, bounds = sf.take_plan(gidx, CHAIN_ROWS)
    ct = torch.randn(gidx.shape[0], sf.CAND_ROWS, generator=gen, device=dev)
    return ct, perm, bounds, gidx


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=DIR[:DEFINE,...]")
    ap.add_argument("--full", action="store_true",
                    help="run chip_smoke.main() with the variants")
    ap.add_argument("--out", type=str, default=None)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("take_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs_

    card = cs_.card_line()
    print(card, flush=True)
    ptxas = {}
    for spec in opts.variant:
        name, _, rest = spec.partition("=")
        path, _, defs = rest.partition(":")
        lib, ptxas[name] = load_variant(name, Path(path).resolve(),
                                        [d for d in defs.split(",") if d])
        cs_.H4_VARIANTS[name] = variant_fn(lib, name)
        print(f"built {name} ({path}, {defs}): "
              f"{[p for p in ptxas[name] if 'planned_take' in p]}",
              flush=True)
    if opts.full:
        rc = cs_.main()
        print(json.dumps({"card": card, "variants": list(cs_.H4_VARIANTS),
                          "ptxas": ptxas, "chip_smoke_exit": rc}),
              flush=True)
        return rc

    from holoscene_tpu_torch.datasets.synthetic import generate_scene
    from holoscene_tpu_torch.ops import splat_flat as sf
    from holoscene_tpu_torch.training import exp_runner_gaussian, gs_train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ptxas["tree"] = [p for p in load_variant("tree", kernels.CSRC, [])[1]
                     if "planned_take" in p]
    print(f"tree: {ptxas['tree']}", flush=True)
    dev = torch.device("cuda")
    results = {}
    with tempfile.TemporaryDirectory(prefix="holoscene_take_") as tmp:
        work = Path(tmp)
        conf, _ = cs_.write_slice_inputs(work)
        runner = exp_runner_gaussian.main(
            ["--conf", str(conf), "--exps_folder", str(work / "exps"),
             "--max_niters", str(cs_.STEPS), "--area_to_subdivide",
             str(cs_.AREA), "--log_every", "1", "--quiet", "--device",
             "cuda"])
        h, w = runner.dataset.img_res
        pose, intr = runner._pose_intr(0)
        xy, depth, conic, _, _, opac, rgb = cs_.gom_projection(
            runner, pose, intr, w, h)
        bins = runner._get_bins(0, pose, intr)
        cand = sf.gather_payload(xy, depth, conic, opac, rgb, bins["gidx"])
        results["phase8"] = cs_.compare_h4(
            cs_.h4_cotangent(cand, bins["tile_chunk_start"],
                             bins["tile_chunk_cnt"], -(-w // 16), w, h, 12),
            bins["perm"], bins["bounds"], bins["gidx"], timed=True)
        print(f"phase8: {cs_.h4_note(results['phase8'])}", flush=True)
        del runner, bins, cand

        scene = work / "data_s1" / "scene_0"
        generate_scene(str(scene), n_images=cs_.S1_IMAGES,
                       img_res=(cs_.S1_RES, cs_.S1_RES))
        tr = gs_train.main(
            ["--dataset", "ns", "--data_root", str(scene), "--out",
             str(work / "gs"), "--capacity", str(cs_.FREE_CAPACITY),
             "--sh_degree", "3", "--warmup", str(cs_.FREE_WARMUP),
             "--refine_every", str(cs_.FREE_REFINE), "--iters",
             str(cs_.FREE_ITERS), "--quiet", "--device", "cuda"])
        results["gs_train"] = cs_.free_frame_h4(tr, 0, timed=True)
        print(f"gs_train: {cs_.h4_note(results['gs_train'])}", flush=True)
        del tr
    torch.cuda.empty_cache()
    results["random"] = cs_.compare_h4(*random_plan(dev), timed=True)
    print(f"random: {cs_.h4_note(results['random'])}", flush=True)
    line = json.dumps({"card": card, "ptxas": ptxas, "inputs": results})
    if opts.out:
        Path(opts.out).parent.mkdir(parents=True, exist_ok=True)
        Path(opts.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
