r"""Run the port's training paths twice from one seed and report where the
two runs part: Stage 1 and Stage 2, Stage 4 and the free-Gaussian trainer
(gs_train), Stage 3. Needs one NVIDIA GPU with nvcc; run from the
repository root:

    python -m holoscene_tpu_torch.utils.repeat_check \
        [--parts a b c d e f] [--modes default det det_plain multinomial] \
        [--s1_steps 40] [--ft_iters 60] [--stage2_runs 2] [--out FILE]

(for example `--parts d e --modes default det` for Stage 4 and gs_train
alone, ~1.5 min on an H100). The runs are chip_smoke.py's: phase 10b's
conf (confs/replica_room0.conf's model at the flagship widths on the
generated 512^2 scene), phase 14's Stage 2 on its checkpoint
(confs/replica_room0_post.conf, mesh resolution chip_smoke.S2_MESH_RES,
quasi-static physics), and phase 4's scene (8 generated 512^2 views, the
analytic meshes, the spheres' orthographic packs). For each mode:

  (a) Stage 1 through training/exp_runner.main, s1_steps steps, twice from
      seed 0: the first step after which a parameter differs (the tensor,
      its largest difference and the count of differing elements), and
      whether the two checkpoints (model, Adam state, scheduler) are the
      same bits;
  (b) Stage2Runner.finetune_object of object 1, ft_iters iterations, twice
      from default mode's first checkpoint file, each on a fresh runner
      (the same numpy rng and torch.Generator seeds), with the packs of
      the object's best views made once beforehand: the first step and
      tensor where they part;
  (c) Stage2Runner.extract_meshes twice on the parameters after (b):
      vertices and faces identical or not, per object;
  (d) a flat Stage4Runner (seed 0) on phase 4's scene, twice:
      S4_FLAT_STEPS flat steps (K1/K2; bins refreshed every
      S4_REBIN_EVERY visits of a frame, the saturation trim on once every
      frame has been walked), then S4_INVIS_STEPS iterations that each add
      an invisible-view step (top-K, K3/K4) on the packs: every parameter
      after every step;
  (e) a GSTrainer (gs_train's command line, MCMC, seed 0) on phase 4's
      scene, GS_STEPS steps twice, a relocation every GS_REFINE_EVERY
      steps after GS_WARMUP: every parameter after every step;
  (f) a Stage3Runner (seed 0) on phase 4's scene and its analytic meshes,
      object S3_OBJ's colour field trained for S3_STEPS image steps and
      its chart atlas baked at S3_TEX_RES, twice: every parameter after
      every step, then the baked OBJ, MTL and PNG bytes.
(a)-(c) run together when any of them is named; (d), (e) and (f) run at
the same depths as in chip_smoke.py's phase 20 ((f) there on phase 15's
meshes and scene).

Modes: `default` as the port runs; `det` under
torch.use_deterministic_algorithms(True, warn_only=True) (the script sets
CUBLAS_WORKSPACE_CONFIG=:4096:8 before CUDA starts, in every mode), whose
warnings name the torch ops on the path without a deterministic
implementation; `det_plain` the same with H1-bwd and H4 replaced by their
plain twins on the card (a diagnosis: what is left when no hand-written
accumulation runs); `multinomial` as `default` with ops/draws.py::
draw_by_weight replaced by torch.multinomial (with replacement, the same
generator), the draw Stage 3 and MCMC made before their exact integer
CDF (a diagnosis: does the float draw part two runs). --modes defaults to
the first three.

Then, with (a)-(c), Stage 2 whole (training/exp_runner_post.main at phase
14's settings) stage2_runs times from the same checkpoint, in default
mode: each object's accepted face count, the failed objects, the
translations, and whether the accepted meshes and translations are the
same bits as the first run's. The last line of the output is one JSON
object with all of it (also written to --out).

chip_smoke.py's phase 20 calls stage1_twice, finetune_twice and
extract_twice at smaller depths, stage4_twice and gs_train_twice as they
are.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
MODES = ("default", "det", "det_plain", "multinomial")
PARTS = ("a", "b", "c", "d", "e", "f")
# (d): bins refreshed every second visit of a frame, so that ten flat steps
# over phase 4's seven training frames rebuild some, then five iterations
# with an invisible-view step; (e): one MCMC relocation, after step 39,
# with 20 steps after it in a 60-step run
S4_FLAT_STEPS, S4_INVIS_STEPS, S4_REBIN_EVERY = 10, 5, 2
GS_STEPS, GS_WARMUP, GS_REFINE_EVERY, GS_CAPACITY = 60, 20, 40, 100_000
# (f): object 1 (a sphere of the generated scene: 0/1 pixel weights over
# its instance mask), 200 image steps and a bake at 512^2
S3_OBJ, S3_STEPS, S3_TEX_RES = 1, 200, 512


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """a and b hold the same bits (NaN payloads included)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point() and a.element_size() == 4:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


class StepTrace:
    """The named parameters after every step of a run (ref None), or the
    first step at which they part from `ref`, an earlier run's StepTrace
    (then nothing is kept)."""

    def __init__(self, ref: StepTrace | None = None):
        self.ref = ref
        self.snaps: list[dict] = []
        self.steps = 0
        self.first: dict | None = None
        self.max_diff = 0.0

    def after_step(self, model) -> None:
        """Record (or compare) the parameters after a step: a module's
        named parameters, or a trainer's dict of parameter tensors."""
        named = model.items() if isinstance(model, dict) \
            else model.named_parameters()
        params = {k: p.detach() for k, p in named}
        if self.ref is None:
            self.snaps.append({k: p.clone() for k, p in params.items()})
        elif self.steps < len(self.ref.snaps):
            ref = self.ref.snaps[self.steps]
            for k, p in params.items():
                if same_bits(p, ref[k]):
                    continue
                d = float((p - ref[k]).abs().max())
                self.max_diff = max(self.max_diff, d)
                if self.first is None:
                    self.first = {"step": self.steps, "tensor": k,
                                  "max_abs_diff": d,
                                  "differing": int((p != ref[k]).sum()),
                                  "of": p.numel()}
        self.steps += 1

    def report(self) -> dict:
        return {"steps": self.steps, "first_difference": self.first,
                "max_abs_diff": self.max_diff,
                "bitwise_equal": self.first is None
                and self.steps == len(self.ref.snaps)}


@contextlib.contextmanager
def patched(module, name: str, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


@contextlib.contextmanager
def traced(module, name: str, trace: StepTrace):
    """module.name (a step function whose first argument is the model)
    wrapped to call trace.after_step(model) after each call."""
    fn = getattr(module, name)

    def wrapped(model, *args, **kwargs):
        out = fn(model, *args, **kwargs)
        trace.after_step(model)
        return out

    with patched(module, name, wrapped):
        yield


def trace_methods(obj, names, trace: StepTrace, params) -> None:
    """Wrap the bound methods `names` of obj (a trainer's step functions)
    so that trace.after_step(params()) follows each call."""
    for name in names:
        fn = getattr(obj, name)

        def wrapped(*args, _fn=fn, **kwargs):
            out = _fn(*args, **kwargs)
            trace.after_step(params())
            return out

        setattr(obj, name, wrapped)


@contextlib.contextmanager
def run_mode(mode: str):
    """The mode's switches for the block; yields the list of warnings
    recorded in it."""
    from holoscene_tpu_torch.ops import draws
    from holoscene_tpu_torch.ops import hashgrid as hg
    from holoscene_tpu_torch.ops import splat_flat as sf

    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    det = mode in ("det", "det_plain")
    before = torch.are_deterministic_algorithms_enabled()
    with warnings.catch_warnings(record=True) as caught, \
            contextlib.ExitStack() as stack:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(det, warn_only=True)
        if mode == "det_plain":
            def plain_bwd(x01, n_rows, ct_fa, ct_J, ct_fb, lt, mode,
                          u_b=None, u_a=None, interp="trilinear"):
                return hg.fused_bwd_plain(x01, n_rows, ct_fa, ct_J, ct_fb,
                                          lt, mode, u_b, u_a,
                                          interp=interp)[:2]

            stack.enter_context(patched(hg, "fused_bwd", plain_bwd))
            stack.enter_context(patched(sf, "planned_take_bwd",
                                        sf.planned_take_bwd_plain))
        if mode == "multinomial":
            def multinomial(weights, n, generator=None):
                return torch.multinomial(weights, n, replacement=True,
                                         generator=generator)

            stack.enter_context(patched(draws, "draw_by_weight",
                                        multinomial))
        try:
            yield caught
        finally:
            torch.use_deterministic_algorithms(before)


def warning_lines(caught) -> list[str]:
    """The distinct messages of recorded UserWarnings (torch's notes on
    ops without a deterministic implementation among them), first line
    each."""
    seen = []
    for w in caught:
        if not issubclass(w.category, UserWarning):
            continue
        line = str(w.message).splitlines()[0][:200]
        if line not in seen:
            seen.append(line)
    return seen


def checkpoint_files(rundir: str) -> dict:
    """{relative path: loaded object} of every .pth under a run's
    checkpoints directory."""
    base = Path(rundir) / "checkpoints"
    return {str(p.relative_to(base)): torch.load(p, map_location="cpu",
                                                 weights_only=False)
            for p in sorted(base.rglob("*.pth"))}


def compare_objects(a, b, path: str = "") -> list[str]:
    """The paths at which two nested state objects differ in their bits."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        ok = (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
              and same_bits(a, b))
        return [] if ok else [path]
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return [path + " (keys)"]
        out = []
        for k in a:
            out += compare_objects(a[k], b[k], f"{path}/{k}")
        return out
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return [path + " (length)"]
        out = []
        for i, (x, y) in enumerate(zip(a, b)):
            out += compare_objects(x, y, f"{path}[{i}]")
        return out
    return [] if a == b else [path]


def stage1_twice(conf: Path, exps: Path, steps: int) -> dict:
    """(a): exp_runner.main on `conf` for `steps` steps twice, into
    exps/run0 and exps/run1. Returns the report and the first run's
    directory under "rundir"."""
    from holoscene_tpu_torch.training import exp_runner
    from holoscene_tpu_torch.training import stage1 as s1

    first = StepTrace()
    second = StepTrace(first)
    rundirs, losses = [], []
    t0 = time.perf_counter()
    for i, trace in enumerate((first, second)):
        with traced(s1, "train_step", trace):
            runner = exp_runner.main(
                ["--conf", str(conf), "--exps_folder", str(exps / f"run{i}"),
                 "--max_niters", str(steps), "--log_every", "1", "--quiet",
                 "--device", "cuda"])
        rundirs.append(runner.rundir)
        losses.append([h["loss"] for h in runner.history])
        del runner
    files = [checkpoint_files(d) for d in rundirs]
    differ = compare_objects(files[0], files[1])
    rep = second.report()
    first.snaps.clear()
    rep.update(checkpoints_bitwise_equal=not differ,
               checkpoint_differences=differ[:12],
               losses_equal=losses[0] == losses[1],
               seconds=time.perf_counter() - t0, rundir=rundirs[0])
    return rep


def stage2_args(post_conf: Path, exps: Path, mesh_res: int,
                extra: tuple = ()) -> list[str]:
    return ["--conf", str(post_conf), "--exps_folder", str(exps),
            "--mesh_resolution", str(mesh_res), "--quiet", "--device",
            "cuda", *extra]


def object_setup(runner, obj_i: int) -> dict:
    """What Stage2Runner._refine_object hands finetune_object for object
    obj_i, made once on `runner`: the packs of its best views (no novel
    views), its bbox centre and scale, parent ids (0,)."""
    from holoscene_tpu_torch.stage2.views import select_best_views

    meshes = runner.extract_meshes()
    mesh = meshes[obj_i]
    if mesh is None:
        raise RuntimeError(f"object {obj_i} has no mesh to finetune")
    b = mesh.bounds
    half_extent = float(np.linalg.norm(b[1] - b[0]) / 2 * 1.3)
    runner._current_obj, runner._current_half_extent = obj_i, half_extent
    others = [runner._view_mesh(m) for j, m in enumerate(meshes)
              if j != obj_i and m is not None]
    best = select_best_views(runner._view_mesh(mesh), others, n_views=4,
                             img_res=runner.view_render_res,
                             device=runner.device)
    packs = runner.object_view_packs(obj_i, meshes, best, half_extent)
    return {"gen_views": packs, "center": (b[0] + b[1]) / 2,
            "scale": (b[1] - b[0]) / 2 + 0.05, "parent_ids": (0,),
            "faces": len(mesh.faces)}


def finetune_twice(make_runner, setup: dict, obj_i: int, iters: int):
    """(b): finetune_object(obj_i) for `iters` iterations on two fresh
    runners from make_runner(). Returns (report, the second runner)."""
    from holoscene_tpu_torch.stage2 import runner as s2runner

    first = StepTrace()
    second = StepTrace(first)
    t0 = time.perf_counter()
    runner = None
    for trace in (first, second):
        del runner
        runner = make_runner()
        with traced(s2runner, "finetune_step", trace):
            runner.finetune_object(obj_i, setup["gen_views"],
                                   setup["center"], setup["scale"],
                                   setup["parent_ids"], n_iters=iters)
    rep = second.report()
    first.snaps.clear()
    rep["seconds"] = time.perf_counter() - t0
    return rep, runner


def extract_twice(runner) -> dict:
    """(c): extract_meshes twice on the runner's parameters: per object,
    whether vertices and faces are identical, and the face counts."""
    t0 = time.perf_counter()
    a, b = runner.extract_meshes(), runner.extract_meshes()
    per = []
    for ma, mb in zip(a, b):
        if ma is None or mb is None:
            per.append({"faces": None, "equal": ma is None and mb is None})
            continue
        eq = (np.array_equal(ma.vertices, mb.vertices)
              and np.array_equal(ma.faces, mb.faces))
        d = (float(np.abs(ma.vertices - mb.vertices).max())
             if ma.vertices.shape == mb.vertices.shape else None)
        per.append({"faces": [len(ma.faces), len(mb.faces)], "equal": eq,
                    "vertex_max_abs_diff": d})
    return {"objects": per, "bitwise_equal": all(p["equal"] for p in per),
            "seconds": time.perf_counter() - t0}


def stage4_twice(make_runner, plots_dir) -> dict:
    """(d): a Stage4Runner from make_runner() (flat training renders) runs
    S4_FLAT_STEPS flat steps, then loads the invisible-view packs of
    plots_dir and runs S4_INVIS_STEPS iterations, each a flat step and an
    invisible-view step (top-K); twice. Every parameter after every step
    (flat and invisible-view alike) is compared; the report adds the
    second run's bin builds (first visits, refreshes and the trim's
    rebuilds: more than its distinct frames once a frame's bins were
    rebuilt), those frames, and whether the trim switched on."""
    first = StepTrace()
    second = StepTrace(first)
    t0 = time.perf_counter()
    runs = []
    for trace in (first, second):
        runner = make_runner()
        trace_methods(runner, ("_step", "_invis_step"), trace,
                      lambda r=runner: r.params)
        runner.run(n_iters=S4_FLAT_STEPS, log_every=1)
        runner.load_vis_info(str(plots_dir))
        runner.run(n_iters=S4_INVIS_STEPS, log_every=1)
        runs.append({"bin_builds": runner.rebin_count,
                     "frames": len(runner._used_cache),
                     "trim_active": runner._trim_active,
                     "invis_steps": runner.invis_steps,
                     "losses": [h["loss"] for h in runner.history]})
        del runner
    rep = second.report()
    first.snaps.clear()
    rep.update(runs[1], losses_equal=runs[0]["losses"] == runs[1]["losses"],
               seconds=time.perf_counter() - t0)
    return rep


def gs_train_twice(gs_args: list[str]) -> dict:
    """(e): a fresh GSTrainer from gs_train's command line `gs_args` runs
    GS_STEPS steps, twice; every parameter after every step is compared
    (a refine event between two steps shows in the next step's). The
    report adds the refine events of the second run."""
    from holoscene_tpu_torch.training import gs_train

    first = StepTrace()
    second = StepTrace(first)
    t0 = time.perf_counter()
    refines, losses = [], []
    for trace in (first, second):
        trainer, _ = gs_train.build_trainer(gs_train.parse_args(gs_args))
        trace_methods(trainer, ("step",), trace, lambda t=trainer: t.params)
        trainer.run(GS_STEPS, log_every=1)
        refines.append(trainer.refines)
        losses.append([h["loss"] for h in trainer.history])
        del trainer
    rep = second.report()
    first.snaps.clear()
    rep.update(refines=refines[1], refines_equal=refines[0] == refines[1],
               losses_equal=losses[0] == losses[1],
               seconds=time.perf_counter() - t0)
    return rep


def stage4_factory(meshes, dataset, out_dir, area: float):
    """make_runner for (d): a fresh flat Stage4Runner (seed 0) on these
    meshes and dataset on the card, the invisible-view renders at K 256,
    bins refreshed every S4_REBIN_EVERY visits of a frame, the run's
    S4_FLAT_STEPS + S4_INVIS_STEPS iterations in its schedule."""
    from holoscene_tpu_torch.models.gom import GoMConfig
    from holoscene_tpu_torch.training.stage4 import Stage4Runner

    def make_runner():
        return Stage4Runner(
            meshes, dataset,
            cfg=GoMConfig(max_per_tile=0, rebin_every=S4_REBIN_EVERY),
            area_to_subdivide=area,
            max_total_iters=S4_FLAT_STEPS + S4_INVIS_STEPS,
            out_dir=str(out_dir), quiet=True, device="cuda")

    return make_runner


def gs_args(data_root, out) -> list[str]:
    """gs_train's command line for (e) on an NS-format scene, on the card:
    MCMC relocation every GS_REFINE_EVERY steps after GS_WARMUP,
    GS_CAPACITY slots, SH 3."""
    return ["--dataset", "ns", "--data_root", str(data_root), "--out",
            str(out), "--capacity", str(GS_CAPACITY), "--sh_degree", "3",
            "--strategy", "mcmc", "--warmup", str(GS_WARMUP),
            "--refine_every", str(GS_REFINE_EVERY), "--quiet", "--device",
            "cuda"]


def stage3_twice(make_runner, obj_i: int) -> dict:
    """(f): a fresh Stage3Runner from make_runner(run) trains object
    obj_i's colour field for S3_STEPS image steps, then bakes its chart
    atlas at S3_TEX_RES; twice. Every parameter after every step is
    compared, then the baked files' bytes (surface_{obj_i}.obj / .mtl /
    .png); the report adds the texture's size and the losses."""
    from holoscene_tpu_torch.training import stage3 as s3

    first = StepTrace()
    second = StepTrace(first)
    t0 = time.perf_counter()
    files, losses = [], []
    for i, trace in enumerate((first, second)):
        runner = make_runner(i)
        with traced(s3, "color_step", trace):
            losses.append(runner.train_object(obj_i, n_iters=S3_STEPS))
        obj = Path(runner.export_mesh_texture(obj_i, texture_res=S3_TEX_RES))
        files.append({p.name: p.read_bytes() for p in (
            obj, obj.with_suffix(".mtl"), obj.with_suffix(".png"))})
        del runner
    rep = second.report()
    first.snaps.clear()
    rep.update(files_differing=sorted(k for k in files[0]
                                      if files[0][k] != files[1].get(k)),
               png_bytes=len(files[0][f"surface_{obj_i}.png"]),
               losses=losses[1], losses_equal=losses[0] == losses[1],
               seconds=time.perf_counter() - t0)
    rep["atlas_bitwise_equal"] = not rep["files_differing"]
    return rep


def stage3_factory(meshes, dataset, out_dir, lr: float = 5e-4,
                   lr_factor_for_grid: float = 20.0):
    """make_runner for (f): a fresh Stage3Runner (seed 0) on these meshes
    and dataset on the card, writing into out_dir/run{i}."""
    from holoscene_tpu_torch.training.stage3 import Stage3Runner

    def make_runner(i: int):
        return Stage3Runner(meshes, dataset, lr=lr,
                            lr_factor_for_grid=lr_factor_for_grid,
                            max_total_iters=S3_STEPS,
                            out_dir=str(Path(out_dir) / f"run{i}"),
                            texture_res=S3_TEX_RES, quiet=True,
                            device="cuda")

    return make_runner


def stage2_whole(args: list[str], runs: int) -> dict:
    """exp_runner_post.main(args) `runs` times: accepted face counts,
    failed objects, translations, and whether each run's accepted meshes
    and translations are the first run's bits."""
    from holoscene_tpu_torch.training import exp_runner_post

    out, first = [], None
    for _ in range(runs):
        t0 = time.perf_counter()
        res = exp_runner_post.main(args).result
        meshes = res["meshes"]
        tr = {int(k): np.asarray(v, np.float64).tolist()
              for k, v in res["translations"].items()}
        run = {"faces": [None if m is None else len(m.faces)
                         for m in meshes],
               "failed": [int(i) for i in res["failed_objects"]],
               "translations": tr, "seconds": time.perf_counter() - t0}
        if first is None:
            first = (meshes, tr)
        else:
            run["meshes_equal_first"] = all(
                (m is None and f is None) or (
                    m is not None and f is not None
                    and np.array_equal(m.vertices, f.vertices)
                    and np.array_equal(m.faces, f.faces))
                for m, f in zip(meshes, first[0]))
            run["translations_equal_first"] = tr == first[1]
        out.append(run)
    return {"runs": out}


def scene_parts(rep: dict, mode: str, parts: set, make_s4, meshes, plots,
                work: Path) -> None:
    """Parts (d), (e) and (f) of one mode on phase 4's scene (its
    analytic `meshes`) into rep, each logged."""
    import chip_smoke as cs_

    if "d" in parts:
        rep["d"] = stage4_twice(make_s4, plots)
        cs_.log(f"== ({mode}) d: {json.dumps(rep['d'])}")
    if "e" in parts:
        rep["e"] = gs_train_twice(gs_args(work / "data" / "scene_0",
                                          work / f"gs_{mode}"))
        cs_.log(f"== ({mode}) e: {json.dumps(rep['e'])}")
    if "f" in parts:
        from holoscene_tpu_torch.datasets.ns_dataset import NSDataset

        dataset = NSDataset(data_root_dir=str(work / "data"),
                            data_dir="scene_0", img_res=[cs_.RES, cs_.RES])
        rep["f"] = stage3_twice(stage3_factory(
            meshes, dataset, work / f"s3_{mode}"), S3_OBJ)
        cs_.log(f"== ({mode}) f: {json.dumps(rep['f'])}")


def stage12_parts(rep: dict, mode: str, conf: Path, post_conf: Path,
                  ckpt_exps, work: Path, args):
    """Parts (a)-(c) of one mode into rep, each logged. (b) and (c) start
    from ckpt_exps, default mode's first Stage-1 run (this mode's when it
    is None). Returns the checkpoint's exps folder."""
    import chip_smoke as cs_

    from holoscene_tpu_torch.training.exp_runner_post import (
        add_run_args,
        build_stage2_runner,
    )

    a = stage1_twice(conf, work / f"exps_{mode}", args.s1_steps)
    rep["a"] = a
    cs_.log(f"== ({mode}) a: {json.dumps(a)}")
    if ckpt_exps is None:
        # default mode's first run: the one checkpoint file that (b) and
        # Stage 2 start from in every mode
        ckpt_exps = Path(a["rundir"]).parents[1]
    parser2 = argparse.ArgumentParser()
    add_run_args(parser2, mesh_resolution=cs_.S2_MESH_RES)
    s2_args = parser2.parse_args(stage2_args(post_conf, ckpt_exps,
                                             cs_.S2_MESH_RES))

    def make_runner():
        return build_stage2_runner(s2_args)[0]

    setup = object_setup(make_runner(), args.obj)
    b, runner = finetune_twice(make_runner, setup, args.obj, args.ft_iters)
    rep["b"] = b
    cs_.log(f"== ({mode}) b (object {args.obj}, {setup['faces']} faces, "
            f"{len(setup['gen_views'])} packs): {json.dumps(b)}")
    rep["c"] = extract_twice(runner)
    del runner
    cs_.log(f"== ({mode}) c: {json.dumps(rep['c'])}")
    return ckpt_exps


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--s1_steps", type=int, default=40)
    parser.add_argument("--ft_iters", type=int, default=60)
    parser.add_argument("--obj", type=int, default=1)
    parser.add_argument("--modes", nargs="+", default=list(MODES[:3]),
                        choices=MODES)
    parser.add_argument("--stage2_runs", type=int, default=2)
    parser.add_argument("--parts", nargs="+", default=list(PARTS),
                        choices=PARTS, help="runs to make in each mode")
    parser.add_argument("--work", type=str, default=None,
                        help="work directory (default: a temporary one)")
    parser.add_argument("--out", type=str, default=None)
    args = parser.parse_args(argv)

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        print("repeat_check: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import tempfile

    import chip_smoke as cs_

    from holoscene_tpu_torch import kernels
    from holoscene_tpu_torch.physics import sim

    card = cs_.card_line()
    cs_.log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build(force=True)
    kernels.library()
    os.environ["HOLOSCENE_PHYSICS"] = "quasistatic"
    sim._PROVIDER = None
    report = {"card": card, "torch": torch.__version__,
              "args": vars(args), "modes": {}}
    with contextlib.ExitStack() as stack:
        work = Path(args.work) if args.work else Path(
            stack.enter_context(tempfile.TemporaryDirectory(
                prefix="repeat_check_")))
        work.mkdir(parents=True, exist_ok=True)
        parts = set(args.parts)
        stage12 = bool(parts & {"a", "b", "c"})
        if stage12:
            conf = cs_.stage1_conf(work, "smoke_s1_vjp",
                                   cs_.S1_MODEL_DEFAULT)
            post_conf = cs_.stage2_conf(work)
        if parts & {"d", "e", "f"}:
            # phase 4's scene: 8 generated 512^2 views and the analytic
            # meshes, read back as exp_runner_gaussian reads them
            from holoscene_tpu_torch.datasets.synthetic import write_vis_info
            from holoscene_tpu_torch.training import exp_runner_gaussian as eg

            _, plots = cs_.write_slice_inputs(work)
            write_vis_info(str(plots), n_views=cs_.PACK_VIEWS,
                           res=cs_.PACK_RES)
            meshes = [eg.read_obj(str(p)) for p in sorted(
                plots.glob("surface_*.obj"),
                key=lambda p: int(p.stem.split("_")[-1]))]
            dataset = eg.NSDataset(
                data_root_dir=str(work / "data"), data_dir="scene_0",
                img_res=[cs_.RES, cs_.RES], test_split=True)
            make_s4 = stage4_factory(meshes, dataset, work / "s4_out",
                                     cs_.AREA)
        ckpt_exps = None
        for mode in args.modes:
            rep = report["modes"][mode] = {}
            with run_mode(mode) as caught:
                if parts & {"d", "e", "f"}:
                    scene_parts(rep, mode, parts, make_s4, meshes, plots,
                                work)
                if stage12:
                    ckpt_exps = stage12_parts(rep, mode, conf, post_conf,
                                              ckpt_exps, work, args)
            rep["warnings"] = warning_lines(caught)
            cs_.log(f"== ({mode}) warnings: {json.dumps(rep['warnings'])}")
            torch.cuda.empty_cache()
        if args.stage2_runs and stage12:
            s2 = stage2_whole(stage2_args(
                post_conf, ckpt_exps, cs_.S2_MESH_RES,
                ("--finetune_iters", str(cs_.S2_ITERS))), args.stage2_runs)
            report["stage2"] = s2
            for i, r in enumerate(s2["runs"]):
                cs_.log(f"== stage 2 run {i}: {json.dumps(r)}")
    line = json.dumps(report)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
