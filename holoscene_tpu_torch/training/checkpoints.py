"""Checkpoints of the port, in the reference's layout
checkpoints/{Model,Optimizer,Scheduler}Parameters/{epoch,latest}.* (the
JAX package's holoscene_tpu/training/checkpoints.py writes flax msgpack and
imports jax, so the port carries its own). Stage-1 state is the model's
state_dict, the Adam state and the scheduler's, saved with torch.save; the
step, the epoch and the draw generator's state ride in a JSON / .pth
sidecar. Loading the JAX msgpack files is ROADMAP.md queue A item 1."""

from __future__ import annotations

import json
import os

import torch

MODEL_DIR = "ModelParameters"
OPT_DIR = "OptimizerParameters"
SCHED_DIR = "SchedulerParameters"


def latest_timestamp(expdir: str) -> str | None:
    """Resolve `--timestamp latest`: the newest run directory under expdir."""
    if not os.path.isdir(expdir):
        return None
    stamps = sorted(
        d for d in os.listdir(expdir) if os.path.isdir(os.path.join(expdir, d))
    )
    return stamps[-1] if stamps else None


def save_checkpoint(checkpoints_path: str, epoch: int, model, optimizer=None,
                    scheduler=None, extra: dict | None = None,
                    generator_state: torch.Tensor | None = None) -> None:
    for sub in (MODEL_DIR, OPT_DIR, SCHED_DIR):
        os.makedirs(os.path.join(checkpoints_path, sub), exist_ok=True)
    blobs = {MODEL_DIR: model.state_dict()}
    if optimizer is not None:
        blobs[OPT_DIR] = optimizer.state_dict()
    sched = {"scheduler": scheduler.state_dict() if scheduler else None,
             "generator": generator_state}
    meta = {"epoch": int(epoch), **(extra or {})}
    for name in (str(epoch), "latest"):
        for sub, blob in blobs.items():
            torch.save(blob, os.path.join(checkpoints_path, sub, name + ".pth"))
        torch.save(sched, os.path.join(checkpoints_path, SCHED_DIR,
                                       name + ".pth"))
        with open(os.path.join(checkpoints_path, SCHED_DIR, name + ".json"),
                  "w") as f:
            json.dump(meta, f)


def load_checkpoint(checkpoints_path: str, model, optimizer=None,
                    scheduler=None, checkpoint: str = "latest"):
    """Loads into model / optimizer / scheduler in place. Returns (meta,
    generator state or None). Raises FileNotFoundError without a model
    checkpoint."""
    path = os.path.join(checkpoints_path, MODEL_DIR, checkpoint + ".pth")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    dev = next(model.parameters()).device
    model.load_state_dict(torch.load(path, map_location=dev))
    opt_path = os.path.join(checkpoints_path, OPT_DIR, checkpoint + ".pth")
    if optimizer is not None and os.path.exists(opt_path):
        optimizer.load_state_dict(torch.load(opt_path, map_location=dev))
    gen_state = None
    sched_path = os.path.join(checkpoints_path, SCHED_DIR, checkpoint + ".pth")
    if os.path.exists(sched_path):
        sched = torch.load(sched_path, map_location="cpu")
        if scheduler is not None and sched["scheduler"] is not None:
            scheduler.load_state_dict(sched["scheduler"])
        gen_state = sched["generator"]
    meta = {}
    meta_path = os.path.join(checkpoints_path, SCHED_DIR, checkpoint + ".json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return meta, gen_state
