"""Driver of a Stage-4 configuration: Gaussian-on-mesh training through
the port's `Stage4Runner.run`, as the Stage-4 CLI builds the runner
(`GoMConfig` with the CLI's defaults, the flat path), on the analytic
meshes of the benchmark's room.

Set-up: build the kernels, trace the room and write it (and, where the
traffic has generated views, each object's view packs), build the runner
(seeding the gaussians from the meshes, one mesh raster a frame), run the
checked iterations through `run` in chunks, as the window calls it, while
recording each iteration's frame, backgrounds, object and view: from the
first until the flat plan has been trimmed and `check_trimmed` iterations
have run on it, one of them at least on cached bins, so that the check
covers the path the window times. Then warm up until every training frame
has been visited, the flat plan has been trimmed, and `warmup_min`
iterations have run. The window calls `run` in chunks until --seconds have
passed.

The check rebuilds the gaussians from the same meshes in the plain
reference (port_bench/ref_s4/), which trims its own plan and caches and
drops its bins by the program's rules, and follows the recorded
iterations, comparing the first `check_steps` iterations' losses, the
first Adam step's gradient norm by leaf, the change by leaf after every
checked iteration, and on which iterations the bins came from the trimmed
plan.
"""

from __future__ import annotations

import math
import sys
from pathlib import Path

import numpy as np
import torch

from port_bench import arith, harness, scene
from port_bench.drivers import common

_WALKS = {"flat_fwd": "K1", "flat_bwd": "K2", "composite_fwd": "K3",
          "composite_bwd": "K4"}
# operations counted per element beside the walks and the matmuls /
# convolutions: the projection and colour of a gaussian (EWA projection,
# degree-3 SH), forward and backward; an Adam update of a parameter
# element; the elementwise loss terms of a pixel channel
OPS_PROJECT = 3 * (120 + 16 * 3 * 2)
OPS_ADAM = 12
OPS_LOSS_PIXEL = 3 * 12


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, root: Path,
                 work: Path, device):
        self.config, self.traffic = config, traffic
        self.seed, self.root, self.work = int(seed), root, work
        self.device = torch.device(device)
        self.check_steps = int(traffic["check_steps"])
        self.views = bool(traffic.get("generated_views", False))
        self._ref_seeded = None     # the reference's meshes, static, init

    def _gom_cfg(self, module):
        c = self.config["gom"]
        return module.GoMConfig(
            sh_degree=c["sh_degree"], tile_size=c["tile_size"],
            max_per_tile=c["max_per_tile"], rebin_every=c["rebin_every"],
            rebin_drift_px=c["rebin_drift_px"], trim_flat=c["trim_flat"],
            trim_slack=c["trim_slack"], use_flat=c["use_flat"])

    # -- set-up --------------------------------------------------------------

    def setup(self, warm: bool = True) -> None:
        from holoscene_tpu_torch.datasets.ns_dataset import NSDataset
        from holoscene_tpu_torch.models import gom
        from holoscene_tpu_torch.training.stage4 import Stage4Runner
        from holoscene_tpu_torch.utils.mesh import Mesh

        if self.device.type == "cuda":
            from holoscene_tpu_torch import kernels
            kernels.build()
        sc = self.config["scene"]
        self.room = scene.make_room(self.seed, sc["frames"], sc["res"],
                                    device=self.device)
        data_root = self.work / "data"
        scene.write_room(self.room, str(data_root / "room"))
        plots = self.work / "plots"
        plots.mkdir(parents=True, exist_ok=True)
        if self.views:
            scene.write_view_packs(self.room, str(plots),
                                   int(self.traffic["view_res"]))
        self.test_split = bool(sc["test_split"])
        dataset = NSDataset(str(data_root), "room", (sc["res"], sc["res"]),
                            test_split=self.test_split, seed=self.seed)
        self.meshes = scene.room_meshes(self.room)
        c = self.config["gom"]
        runner = Stage4Runner(
            [Mesh(v, f, vertex_colors=col) for v, f, col in self.meshes],
            dataset, cfg=self._gom_cfg(gom),
            area_to_subdivide=c["area_to_subdivide"],
            max_total_iters=c.get("max_total_iters"),
            out_dir=str(plots), loss_scale=c["loss_scale"], seed=self.seed,
            quiet=True, device=str(self.device))
        if self.views:
            runner.load_vis_info(str(plots))
        self.runner = runner
        self.total_iters = runner.max_total_iters
        self.n_gauss = int(runner.static["num_gaussians"])
        print(f"port_bench: {self.n_gauss} gaussians", file=sys.stderr)
        self._check_steps()
        if warm:
            self._warm_up()
        common.sync(self.device)

    def _check_steps(self) -> None:
        """The checked iterations, run in set-up through `run` in chunks of
        `chunk_steps`, as the window calls it: from the first iteration
        until the flat plan has been trimmed and `check_trimmed`
        iterations have run on the trimmed plan, one of them at least on
        cached bins (`check_steps` at the least, `check_max` at the most).
        Records each iteration's frame, backgrounds, object and view, and
        whether its bins came from the trimmed plan."""
        runner = self.runner
        frames, bgs, objs, poses, trimmed = [], [], [], [], []
        grads: dict = {}
        p0 = {k: p.detach().clone() for k, p in runner.params.items()}
        calls = [0]
        rebins = [0]

        def stepped(opt, args, kwargs):
            calls[0] += 1
            if calls[0] == 1:
                grads.update(common.first_grad_norms(runner.params, opt))

        def bins_before(args, kwargs):
            rebins[0] = runner.rebin_count
            trimmed.append(bool(runner._trim_active))

        def bins_after(args, kwargs, out):
            reused.append(runner.rebin_count == rebins[0])

        reused: list = []
        chunk = int(self.traffic["chunk_steps"])
        need = int(self.traffic["check_trimmed"])
        trims = runner.use_flat and runner.cfg.trim_flat
        ends: list = []
        spans = harness.Spans()
        hook = runner.optimizer.register_step_post_hook(stepped)
        try:
            with harness.patched(runner, "_frame_mesh_raster", "raster",
                                 spans,
                                 lambda a, k: frames.append(int(a[0]))), \
                    harness.patched(runner, "_get_bins", "bins", spans,
                                    bins_before, bins_after), \
                    harness.patched(runner, "_step", "step", spans,
                                    lambda a, k: bgs.append(a[6].clone())), \
                    harness.patched(runner, "_visible_mask", "mask", spans,
                                    lambda a, k: objs.append(int(a[0]))), \
                    harness.patched(runner, "_invis_step", "invis", spans,
                                    lambda a, k: poses.append(
                                        (a[0].cpu().numpy(),
                                         a[5].clone()))):
                while True:
                    runner.run(chunk, log_every=1)
                    done = (ends[-1] + 1 if ends else 0) + chunk
                    ends.append(done - 1)
                    n_trim = sum(trimmed)
                    covered = not trims or (n_trim >= need and any(
                        t and r for t, r in zip(trimmed, reused)))
                    if (done >= self.check_steps and covered) \
                            or done >= int(self.traffic["check_max"]):
                        break
        finally:
            hook.remove()
        hist = runner.history[-done:]
        losses = []
        for h in hist:
            losses.append(h["loss"])
            if self.views:
                losses.append(h["invis_l1"])
        with torch.no_grad():
            change = {k: float((p - p0[k]).norm())
                      for k, p in runner.params.items()}
        del p0
        n_reused = sum(t and r for t, r in zip(trimmed, reused))
        print(f"port_bench: {done} checked iterations, {sum(trimmed)} on "
              f"the trimmed plan, {n_reused} of them on cached bins",
              file=sys.stderr)
        self.program = {"loss": losses, "grad": grads, "change": change,
                        "trimmed": trimmed}
        self.record = {"frames": frames, "bgs": bgs, "objs": objs,
                       "views": poses, "ends": set(ends)}

    def _warm_up(self) -> None:
        runner = self.runner
        n = int(self.traffic["warmup_min"])
        done = 0
        chunk = int(self.traffic["chunk_steps"])
        while done < int(self.traffic["warmup_max"]):
            runner.run(chunk, log_every=int(self.traffic["log_every"]))
            done += chunk
            trimmed = runner._trim_active or not runner.cfg.trim_flat
            if done >= n and trimmed \
                    and len(runner._used_cache) >= runner.dataset.n_images:
                break
        self.step_s = common.timed_steps(
            lambda k: runner.run(k, log_every=int(self.traffic["log_every"])),
            chunk, self.device)

    # -- the window ----------------------------------------------------------

    def window(self, seconds: float, spans: harness.Spans | None) -> dict:
        """The timed window. With spans (a --trace 1 run) each iteration's
        parts are spanned on the host, and each rebin is bracketed by CUDA
        events, read once the window has closed."""
        runner = self.runner
        chunk = int(self.traffic["chunk_steps"])
        log_every = int(self.traffic["log_every"])
        n_hist = len(runner.history)
        rebins = runner.rebin_count
        events: list = []
        with self._spans(spans or harness.Spans(),
                         events if spans is not None else None):
            iters, elapsed, t0 = common.run_window(
                lambda k: runner.run(k, log_every=log_every), seconds,
                self.step_s, chunk, self.device)
        common.sync(self.device)
        logged = runner.history[n_hist:]
        failed = sum(1 for h in logged if not math.isfinite(h["loss"]))
        out = {"steps": iters, "elapsed_s": elapsed, "t0": t0,
               "end": t0 + elapsed, "rebins": runner.rebin_count - rebins,
               "work": {"splats": iters * self.n_gauss}, "failed": failed}
        if events:
            out["rebin_device_s"] = sum(
                a.elapsed_time(b) for a, b in events) / 1e3
        return out

    def _spans(self, spans, events):
        """Spans around an iteration's parts: each iteration starts with
        _frame_mesh_raster (span "iteration" marks the start), _rebin,
        _step and _invis_step. Where `events` is a list, each _rebin call
        appends its (start, end) CUDA events to it."""
        import contextlib

        stack = contextlib.ExitStack()
        r = self.runner
        for attr, name in (("_frame_mesh_raster", "iteration"),
                           ("_step", "step"), ("_invis_step", "invis")):
            stack.enter_context(harness.patched(r, attr, name, spans))
        before = after = None
        if events is not None and self.device.type == "cuda":
            def before(args, kwargs):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append((ev, torch.cuda.Event(enable_timing=True)))

            def after(args, kwargs, out):
                events[-1][1].record()
        stack.enter_context(harness.patched(r, "_rebin", "rebin", spans,
                                            before, after))
        return stack

    def traced(self, spans: harness.Spans) -> dict:
        """A profiled window of `trace_steps` iterations with the
        invisible-view steps marked in the trace, then `count_steps`
        iterations whose walk launches' operations are counted from their
        inputs, and one iteration under a FLOP counter."""
        from torch.profiler import ProfilerActivity, profile, record_function

        runner = self.runner
        n = int(self.traffic["trace_steps"])
        log_every = int(self.traffic["log_every"])
        orig = runner._invis_step

        def marked(*a, **k):
            with record_function("bench.invis"):
                return orig(*a, **k)

        runner._invis_step = marked
        try:
            common.sync(self.device)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = common.now()
                runner.run(n, log_every=log_every)
                window_s = common.now() - t0
        finally:
            runner._invis_step = orig
        trace = harness.reduce_trace(prof, window_s)
        trace["under"] = _device_under(prof, ("bench.invis",))
        del prof
        trace["steps"] = n
        trace["walk_ops_per_step"] = self._walk_ops_per_step(
            int(self.traffic["count_steps"]))
        trace["mm_flops_per_step"] = common.matmul_flops(
            lambda: runner.run(1, log_every=1 << 30))
        trace["elem_ops_per_step"] = self._element_ops()
        return trace

    def _element_ops(self) -> int:
        n = self.n_gauss
        elems = sum(p.numel() for p in self.runner.params.values())
        h, w = self.runner.dataset.img_res
        ops = n * OPS_PROJECT + elems * OPS_ADAM + h * w * OPS_LOSS_PIXEL
        if self.views:
            r = int(self.traffic["view_res"])
            ops += n * OPS_PROJECT + elems * OPS_ADAM + r * r * OPS_LOSS_PIXEL
        return ops

    def _walk_ops_per_step(self, n: int) -> float:
        """The walk launches' operations an iteration, over n iterations."""
        from holoscene_tpu_torch.ops import splat_flat as sf
        from holoscene_tpu_torch.ops import splat_topk as st

        ops = [0]

        def after_of(kind):
            def after(args, kwargs, out):
                ops[0] += _walk_ops(kind, args, out)
            return after

        spans = harness.Spans()
        table_f = {k: (k, None, after_of(_WALKS[k]))
                   for k in ("flat_fwd", "flat_bwd")}
        table_t = {k: (k, None, after_of(_WALKS[k]))
                   for k in ("composite_fwd", "composite_bwd")}
        with common.patches(sf, table_f, spans), \
                common.patches(st, table_t, spans):
            self.runner.run(n, log_every=1 << 30)
        return ops[0] / n

    # -- the check -----------------------------------------------------------

    def release(self) -> None:
        if hasattr(self, "runner"):
            del self.runner
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _frames(self) -> dict:
        train = scene.train_frames(len(self.room.poses), self.test_split)
        centre, scale = scene.normalization(self.room.poses)
        poses = self.room.poses.copy()
        poses[:, :3, 3] = (poses[:, :3, 3] - centre) / scale
        intr = np.eye(3, dtype=np.float32)
        intr[0, 0] = intr[1, 1] = self.room.focal
        intr[0, 2] = intr[1, 2] = self.room.res / 2.0
        return {"rgb": self.room.rgb[train].astype(np.float32) / 255.0,
                "poses": poses[train].astype(np.float32),
                "intrinsics": intr}

    def reference(self, tf32: bool = False, drop_half: bool = False,
                  steps: int | None = None) -> dict:
        """The plain reference over the recorded iterations (the first
        `steps` of them where given): losses, first gradient norms and
        change norms by leaf, and whether each iteration's bins came from
        the trimmed plan. The gaussians are seeded from the meshes once a
        driver and kept for its controls."""
        from port_bench.ref_s4 import gom as ref_gom
        from port_bench.ref_s4.mesh import Mesh
        from port_bench.ref_s4.trainer import RefStage4

        c = self.config["gom"]
        cfg = self._gom_cfg(ref_gom)
        if self._ref_seeded is None:
            meshes = [Mesh(v, f, vertex_colors=col)
                      for v, f, col in self.meshes]
            static = ref_gom.seed_gaussians_from_meshes(
                meshes, c["area_to_subdivide"], cfg, device=self.device)
            init = {k: v.detach()
                    for k, v in ref_gom.init_gom_params(static, cfg).items()}
            self._ref_seeded = (meshes, static, init)
        meshes, static, init = self._ref_seeded
        with common.tf32(tf32):
            ref = RefStage4(static, init, meshes, self._frames(), cfg,
                            c["loss_scale"], self.total_iters, self.device)
            p0 = {k: p.detach().clone() for k, p in ref.params.items()}
            packs = {}
            losses, grads, trimmed = [], None, []
            rec = self.record
            n = len(rec["frames"]) if steps is None else steps
            for k in range(n):
                trimmed.append(ref.trim_active)
                losses.append(ref.step(rec["frames"][k], rec["bgs"][k],
                                       drop_half=drop_half,
                                       last_in_call=k in rec["ends"]))
                if k == 0:
                    grads = common.first_grad_norms(ref.params, ref.optimizer)
                if self.views:
                    obj = rec["objs"][k]
                    if obj not in packs:
                        packs[obj] = scene.object_view_packs(
                            self.room, obj - 1, int(self.traffic["view_res"]))
                    pose, bg = rec["views"][k]
                    pack = next(p for p in packs[obj]
                                if np.array_equal(p["pose"], pose))
                    losses.append(ref.invis_step(obj, pack, bg))
            with torch.no_grad():
                change = {k: float((p - p0[k]).norm())
                          for k, p in ref.params.items()}
        return {"loss": losses, "grad": grads, "change": change,
                "trimmed": trimmed}

    def numbers(self, side: dict, ref: dict) -> dict:
        """The numbers compared: the worst loss gap of the first
        `check_steps` iterations (later losses drift apart by round-off
        that flips a near-tie in a generated view's top-K selection), the
        first step's gradient gap, the change gap after every checked
        iteration, and the count of iterations whose bins came from the
        trimmed plan on one side and not on the other."""
        k = self.check_steps * (2 if self.views else 1)
        out = common.training_numbers(dict(side, loss=side["loss"][:k]),
                                      dict(ref, loss=ref["loss"][:k]))
        a, b = side["trimmed"], ref["trimmed"]
        out["trim_gap"] = float(sum(x != y for x, y in zip(a, b))
                                + abs(len(a) - len(b)))
        return out

    def check(self) -> list:
        return common.checks(self.numbers(self.program, self.reference()),
                             self.traffic["limits"])


def _device_under(prof, names) -> dict:
    """Device seconds of the kernels launched under each named host range
    (record_function) of the trace, by name."""
    from torch.autograd import DeviceType

    out = {n: 0.0 for n in names}
    for ev in prof.events():
        if ev.device_type == DeviceType.CPU and ev.name in out:
            out[ev.name] += ev.device_time_total / 1e6
    return out


def _walk_ops(kind: str, args, out) -> int:
    """The operations of one walk launch, counted from its inputs as
    port_bench/arith.py counts them (frozen from chip_smoke.py)."""
    from port_bench.ref_s4 import splat_flat as rsf

    if kind in ("K1", "K2"):
        cand, cs = args[0], args[1]
        tiles_x, ts, w, h = args[-4:]
        fwd_out = out if kind == "K1" else args[2]
        used = fwd_out[:, 0, 5].int()
        px, py, in_img = rsf._tile_pixels(cs.shape[0], tiles_x, ts, w, h,
                                          cand.device)
        chunks = cand.reshape(-1, arith.CHUNK, arith.CAND_ROWS)
        real = chunks[..., 10] > 0
    else:
        cand, origins = args[0], args[1]
        ts, w, h = args[-3:]
        if kind == "K3":
            counts, (fwd_out, used) = args[2], out
        else:
            used, fwd_out = args[2], args[3]
            counts = None
        px, py, in_img = rsf.tile_pixels_at(origins, ts, w, h)
        n_tiles, k = cand.shape[0], cand.shape[1]
        cs = torch.arange(n_tiles, device=cand.device) * (k // arith.CHUNK)
        chunks = cand.reshape(-1, arith.CHUNK, arith.CAND_ROWS)
        if counts is None:
            real = chunks[..., 10] > 0
        else:
            real = (torch.arange(k, device=cand.device)[None, :]
                    < counts[:, None]).reshape(-1, arith.CHUNK)
    _walked, pairs, live = arith.walk_work(chunks, real, cs, used, px, py,
                                           in_img)
    return pairs * arith.OPS_TEST + live * (
        arith.OPS_LIVE_FWD if kind in ("K1", "K3") else arith.OPS_LIVE_BWD)
