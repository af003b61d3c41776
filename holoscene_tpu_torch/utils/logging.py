"""Experiment logging and profiling of the port (counterpart of
holoscene_tpu/utils/logging.py): one JSON object a line in
<run dir>/metrics.jsonl, with wandb / tensorboard attached when asked for
and importable; `profile_trace`, a torch.profiler capture around a block
(the counterpart's is jax.profiler); StepTimer's wall table by part and its
rolling throughput counter (units a second, e.g. rays/s or splats/s)."""

from __future__ import annotations

import contextlib
import json
import os
import time


class MetricsLogger:
    def __init__(self, log_dir: str, project: str = "holoscene_tpu_torch",
                 run_name: str | None = None, use_wandb: bool = False,
                 use_tensorboard: bool = False, config: dict | None = None):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl_path = os.path.join(log_dir, "metrics.jsonl")
        self._jsonl = open(self.jsonl_path, "a")
        self._t0 = time.time()
        # optional sinks: attached only when asked for and importable
        self.wandb = None
        if use_wandb:
            try:
                import wandb

                wandb.init(project=project, name=run_name,
                           config=config or {})
                self.wandb = wandb
            except Exception:
                self.wandb = None
        self.tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(log_dir=os.path.join(log_dir, "tb"))
            except Exception:
                self.tb = None

    def log(self, metrics: dict, step: int) -> None:
        rec = {"step": int(step), "wall": round(time.time() - self._t0, 3)}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self.wandb is not None:
            self.wandb.log(metrics, step=step)
        if self.tb is not None:
            for k, v in metrics.items():
                self.tb.add_scalar(k, float(v), step)

    def close(self) -> None:
        self._jsonl.close()
        if self.wandb is not None:
            self.wandb.finish()
        if self.tb is not None:
            self.tb.close()


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """torch.profiler capture (CPU and, where CUDA is available, the
    device's kernels) around a block, written as a Chrome trace
    <log_dir>/trace.json (chrome://tracing, Perfetto). Yields the profiler
    (None when disabled), whose key_averages() tables the block."""
    if not enabled:
        yield None
        return
    import torch

    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Wall table by part: `with timer.part(name):` adds the block's wall
    seconds to seconds[name] (parts keep their first-seen order). sync,
    when given, runs before each reading of the clock (a device
    synchronize, so a part's time includes its queued device work).
    Throughput: `tick(units)` after each step, `per_sec` the units a second
    over the last `window` ticks."""

    def __init__(self, sync=None, window: int = 100):
        self.sync = sync
        self.seconds: dict[str, float] = {}
        self.window = window
        self._events: list[tuple[float, float]] = []

    def _now(self) -> float:
        if self.sync is not None:
            self.sync()
        return time.perf_counter()

    @contextlib.contextmanager
    def part(self, name: str):
        t0 = self._now()
        try:
            yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) \
                + self._now() - t0

    def table(self) -> str:
        """One line a part, in seconds, then their sum."""
        width = max([len(k) for k in self.seconds] + [5])
        lines = [f"{k:<{width}} {v:10.3f}" for k, v in self.seconds.items()]
        lines.append(f"{'total':<{width}} {sum(self.seconds.values()):10.3f}")
        return "\n".join(lines)

    def tick(self, units: float) -> None:
        self._events.append((self._now(), units))
        if len(self._events) > self.window:
            self._events.pop(0)

    @property
    def per_sec(self) -> float:
        if len(self._events) < 2:
            return 0.0
        dt = self._events[-1][0] - self._events[0][0]
        units = sum(u for _, u in self._events[1:])
        return units / max(dt, 1e-9)
