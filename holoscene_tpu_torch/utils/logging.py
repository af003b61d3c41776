"""Experiment metrics log of the port: one JSON object a line in
<run dir>/metrics.jsonl, and StepTimer's wall table by part (the parts of
holoscene_tpu/utils/logging.py that Stages 1 and 2 use; its throughput
counter and wandb / tensorboard are not ported)."""

from __future__ import annotations

import contextlib
import json
import os
import time


class MetricsLogger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl_path = os.path.join(log_dir, "metrics.jsonl")
        self._jsonl = open(self.jsonl_path, "a")
        self._t0 = time.time()

    def log(self, metrics: dict, step: int) -> None:
        rec = {"step": int(step), "wall": round(time.time() - self._t0, 3)}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()


class StepTimer:
    """Wall table by part: `with timer.part(name):` adds the block's wall
    seconds to seconds[name] (parts keep their first-seen order). sync,
    when given, runs before each reading of the clock (a device
    synchronize, so a part's time includes its queued device work)."""

    def __init__(self, sync=None):
        self.sync = sync
        self.seconds: dict[str, float] = {}

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
