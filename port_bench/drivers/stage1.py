"""Driver of a Stage-1 configuration: object-compositional SDF training
through the port's `Stage1Runner.run`, as the CLI drives it.

Set-up: build the kernels, trace the room into the work directory, build
the runner on the frozen conf, load the harness's weights, put the
iteration counter at the traffic's start (the learning rate decayed as a
resumed run has it), run the traffic's first `check_steps` steps through
`run` while recording their pixels and draws, then warm up. The window
calls `run` in chunks until --seconds have passed. Checkpoint saves are
not part of a step: the runner's `save_checkpoint` is replaced by a no-op
for the whole process, so no save falls inside the window.

The check runs the plain reference (port_bench/ref_s1/) over the same
first steps from the same weights, pixels and draws, and compares each
step's loss, the first gradient's norm by leaf (from Adam's first moment
after one step) and the parameters' change by leaf after the steps.
"""

from __future__ import annotations

import math
from pathlib import Path

import torch

from port_bench import arith, harness, inputs, scene
from port_bench.drivers import common

# the hash-grid kernel wrappers of ops/hashgrid.py whose launches the
# traced window records
_HASH = ("fused_fwd", "fused_bwd", "sampler_fwd")


def _read_conf_text(root: Path, config: dict, data_root: str,
                    data_dir: str) -> str:
    text = (root / config["conf"]).read_text()
    return text.replace("data_root_dir = ./data_dir/replica/",
                        f"data_root_dir = {data_root}") \
        .replace("data_dir = room_0", f"data_dir = {data_dir}")


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, root: Path,
                 work: Path, device):
        self.config, self.traffic = config, traffic
        self.seed, self.root, self.work = int(seed), root, work
        self.device = torch.device(device)
        self.rays = int(traffic["rays_per_step"])
        self.start_iter = int(traffic["start_iter"])
        self.check_steps = int(traffic["check_steps"])

    # -- set-up --------------------------------------------------------------

    def setup(self, warm: bool = True) -> None:
        from holoscene_tpu_torch.config import ConfigFactory
        from holoscene_tpu_torch.training import stage1

        if self.device.type == "cuda":
            from holoscene_tpu_torch import kernels
            kernels.build()
        sc = self.config["scene"]
        self.room = scene.make_room(self.seed, sc["frames"], sc["res"],
                                    device=self.device)
        data_root = self.work / "data"
        scene.write_room(self.room, str(data_root / "room"))
        self.conf_text = _read_conf_text(self.root, self.config,
                                         str(data_root), "room")
        conf = ConfigFactory.parse_string(self.conf_text)
        runner = stage1.Stage1Runner(
            conf, exps_folder=str(self.work / "exps"), seed=self.seed,
            quiet=True, device=str(self.device))
        runner.save_checkpoint = lambda it: None
        runner.checkpoint_freq = 1 << 62
        runner.num_pixels = self.rays
        self.runner = runner
        self.test_split = conf.get_bool("dataset.test_split", False)
        self.lr = (conf.get_float("train.learning_rate", 5e-4),
                   conf.get_float("train.lr_factor_for_grid", 1.0))
        self.total_iters = runner.max_total_iters
        ref_model = self._ref_model()
        weights = inputs.stage1_weights(ref_model, self.seed, self.device)
        del ref_model
        missing = runner.model.load_state_dict(weights, strict=True)
        del weights, missing
        runner.start_iter = self.start_iter
        decay = 0.1 ** (self.start_iter / max(self.total_iters, 1))
        lr, grid = self.lr
        runner.optimizer.param_groups[0]["lr"] = lr * grid * decay
        runner.optimizer.param_groups[1]["lr"] = lr * decay
        self._check_steps()
        if warm:
            log_every = int(self.traffic["log_every"])
            n = int(self.traffic["warmup_steps"])
            runner.run(n, log_every=log_every)
            self.step_s = common.timed_steps(
                lambda k: runner.run(k, log_every=log_every), n, self.device)
        common.sync(self.device)

    def _ref_model(self):
        from port_bench.ref_s1.config import ConfigFactory as RefFactory
        from port_bench.ref_s1.holoscene import HoloSceneConfig, HoloSceneModel

        conf = RefFactory.parse_string(self.conf_text)
        conf.put("model.implicit_network.d_out", self.room.n_objects + 1)
        self.ref_conf = conf
        cfg = HoloSceneConfig.from_conf(conf.get_config("model"))
        return HoloSceneModel(cfg).to(self.device)

    def _check_steps(self) -> None:
        """The traffic's first steps through run(), with their pixels and
        draws recorded, the program's losses, first-gradient norms and
        change norms kept by leaf."""
        from holoscene_tpu_torch.training import stage1

        runner = self.runner
        picks, draws = [], []
        sample = runner.dataset.sample_rays

        def sample_rays(n, *a, **k):
            out = sample(n, *a, **k)
            picks.append((out[0], out[1]["sampling_idx"].copy()))
            return out

        def record(args, kwargs):
            from port_bench.ref_s1.step import Draws
            draws.append(Draws.copy_of(args[5]))

        runner.dataset.sample_rays = sample_rays
        p0 = {n: p.detach().clone() for n, p in runner.model.named_parameters()}
        spans = harness.Spans()
        with harness.patched(stage1, "train_step", "train_step", spans,
                             record):
            runner.run(1, log_every=1)
            grads = common.first_grad_norms(runner.model, runner.optimizer)
            runner.run(self.check_steps - 1, log_every=1)
        runner.dataset.sample_rays = sample
        losses = [h["loss"] for h in runner.history[-self.check_steps:]]
        with torch.no_grad():
            change = {n: float((p - p0[n]).norm())
                      for n, p in runner.model.named_parameters()}
        del p0
        self.program = {"loss": losses, "grad": grads, "change": change}
        self.picks = picks[:self.check_steps]
        self.draws = draws[:self.check_steps]

    # -- the window ----------------------------------------------------------

    def window(self, seconds: float, spans: harness.Spans | None) -> dict:
        """run() in chunks until `seconds` have passed; with spans, every
        train_step is spanned (host time a step) and each step's start is
        kept."""
        from holoscene_tpu_torch.training import stage1

        runner = self.runner
        chunk = int(self.traffic["chunk_steps"])
        log_every = int(self.traffic["log_every"])
        n_hist = len(runner.history)
        spans = spans or harness.Spans()
        with harness.patched(stage1, "train_step", "train_step", spans):
            steps, elapsed, t0 = common.run_window(
                lambda k: runner.run(k, log_every=log_every), seconds,
                self.step_s, chunk, self.device)
        logged = runner.history[n_hist:]
        failed = sum(1 for h in logged if not math.isfinite(h["loss"]))
        return {"steps": steps, "elapsed_s": elapsed, "t0": t0,
                "end": t0 + elapsed,
                "work": {"rays": steps * self.rays}, "failed": failed}

    def traced(self, spans: harness.Spans) -> dict:
        """A profiled window of `trace_steps` steps, the hash launches'
        inputs recorded (references only: nothing is copied on the
        device); then one step under a FLOP counter."""
        from torch.profiler import ProfilerActivity, profile

        from holoscene_tpu_torch.ops import hashgrid as hg

        runner = self.runner
        n = int(self.traffic["trace_steps"])
        launches: list = []

        def rec(kind):
            def f(args, kwargs):
                launches.append((kind, args, kwargs))
            return f

        with common.patches(hg, {k: (k, rec(k)) for k in _HASH}, spans):
            common.sync(self.device)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = common.now()
                runner.run(n, log_every=int(self.traffic["log_every"]))
                window_s = common.now() - t0
        trace = harness.reduce_trace(prof, window_s)
        del prof
        bounds, ops = 0.0, 0
        for kind, args, kwargs in launches:
            b, o = _hash_launch(kind, args, kwargs)
            bounds += b
            ops += o
        del launches
        trace.update(steps=n, hash_bound_s=bounds / 1e3,
                     hash_ops_per_step=ops / n,
                     mm_flops_per_step=common.matmul_flops(
                         lambda: runner.run(1, log_every=1 << 30)))
        return trace

    # -- the check -----------------------------------------------------------

    def release(self) -> None:
        if hasattr(self, "runner"):
            del self.runner
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, tf32: bool = False, drop_half: bool = False,
                  steps: int | None = None) -> dict:
        """The plain reference over the recorded first steps (the first
        `steps` of them where given): losses, first gradient norms and
        change norms by leaf."""
        from port_bench.ref_s1.holoscene_loss import LossConfig
        from port_bench.ref_s1.step import make_optimizer, train_step

        with common.tf32(tf32):
            model = self._ref_model()
            model.load_state_dict(inputs.stage1_weights(
                model, self.seed, self.device))
            lr, grid = self.lr
            opt, sched = make_optimizer(model, lr, grid, self.total_iters)
            decay = 0.1 ** (self.start_iter / max(self.total_iters, 1))
            opt.param_groups[0]["lr"] = lr * grid * decay
            opt.param_groups[1]["lr"] = lr * decay
            lcfg = LossConfig.from_conf(self.ref_conf.get_config("loss"))
            p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
            batches = inputs.RoomBatches(self.room, self.test_split,
                                         self.device)
            add_vio = self.ref_conf.get_int("train.add_objectvio_iter", 100000)
            losses, grads = [], None
            picks = list(zip(self.picks, self.draws))[:steps]
            for k, ((frame, idx), draws) in enumerate(picks):
                it = self.start_iter + k
                loss = train_step(model, opt, sched, lcfg,
                                  batches.batch(frame, idx), draws, it,
                                  call_reg=it >= add_vio, drop_half=drop_half)
                losses.append(float(loss))
                if k == 0:
                    grads = common.first_grad_norms(model, opt)
            with torch.no_grad():
                change = {n: float((p - p0[n]).norm())
                          for n, p in model.named_parameters()}
        return {"loss": losses, "grad": grads, "change": change}

    def numbers(self, side: dict, ref: dict) -> dict:
        """The numbers compared: the training gaps of `side` to `ref`."""
        return common.training_numbers(side, ref)

    def check(self) -> list:
        return common.checks(self.numbers(self.program, self.reference()),
                             self.traffic["limits"])


def _hash_launch(kind: str, args, kwargs) -> tuple[float, int]:
    """(bound ms, operations) of one recorded hash-kernel launch."""
    if kind == "fused_fwd":
        x01, emb_a, emb_b, lt = args[:4]
        interp = kwargs.get("interp", args[4] if len(args) > 4 else
                            "trilinear")
        b = arith.hash_bound("H1-fwd", x01, lt, has_b=emb_b is not None,
                             interp=interp)
        return b, arith.hash_ops("H1-fwd", x01, lt, interp=interp)
    if kind == "fused_bwd":
        x01, n_rows, ct_fa, ct_J, ct_fb, lt, mode = args[:7]
        interp = kwargs.get("interp", args[9] if len(args) > 9 else
                            "trilinear")
        b = arith.hash_bound("H1-bwd", x01, lt, n_rows=n_rows,
                             has_b=ct_fb is not None, mode=mode,
                             has_j=ct_J is not None, interp=interp)
        return b, arith.hash_ops("H1-bwd", x01, lt, has_j=ct_J is not None,
                                 interp=interp)
    x01, emb, lt = args[:3]
    interp = kwargs.get("interp", args[4] if len(args) > 4 else "trilinear")
    return (arith.hash_bound("H2", x01, lt, interp=interp),
            arith.hash_ops("H2", x01, lt, interp=interp))

