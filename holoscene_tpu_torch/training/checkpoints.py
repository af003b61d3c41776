"""Checkpoint helpers of the port (holoscene_tpu/training/checkpoints.py
imports flax and jax at module level, so the one helper Stage 4 needs is
carried here)."""

from __future__ import annotations

import os


def latest_timestamp(expdir: str) -> str | None:
    """Resolve `--timestamp latest`: the newest run directory under expdir."""
    if not os.path.isdir(expdir):
        return None
    stamps = sorted(
        d for d in os.listdir(expdir) if os.path.isdir(os.path.join(expdir, d))
    )
    return stamps[-1] if stamps else None
