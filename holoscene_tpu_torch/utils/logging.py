"""Experiment metrics log of the port: one JSON object a line in
<run dir>/metrics.jsonl (the part of holoscene_tpu/utils/logging.py that
Stage 1 uses; wandb / tensorboard are not attached)."""

from __future__ import annotations

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
