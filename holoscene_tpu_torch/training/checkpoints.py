"""Checkpoints of the port, in the reference's layout
checkpoints/{Model,Optimizer,Scheduler}Parameters/{epoch,latest}.*. The
port writes .pth: the model's state_dict, the Adam state and the
scheduler's, saved with torch.save; the step, the epoch and the draw
generator's state ride in a JSON / .pth sidecar.

`load_checkpoint` reads a run whichever package wrote it: the port's .pth
or the JAX package's .msgpack (flax.serialization.to_bytes of the Stage-1
params and of the optax state, decoded here with msgpack and numpy alone,
convert.py::read_flax_msgpack). A run that holds both for one checkpoint
name is refused, naming both files."""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from holoscene_tpu_torch.convert import (
    read_flax_msgpack,
    stage1_params_from_jax,
)

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
                    generator_state: torch.Tensor | None = None,
                    optimizer_state: dict | None = None) -> None:
    """optimizer_state, when given, is written in place of
    optimizer.state_dict() (a sharded run's reassembled state)."""
    for sub in (MODEL_DIR, OPT_DIR, SCHED_DIR):
        os.makedirs(os.path.join(checkpoints_path, sub), exist_ok=True)
    blobs = {MODEL_DIR: model.state_dict()}
    if optimizer_state is not None:
        blobs[OPT_DIR] = optimizer_state
    elif optimizer is not None:
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


def checkpoint_format(checkpoints_path: str,
                      checkpoint: str = "latest") -> str:
    """"pth" (the port's) or "msgpack" (the JAX package's) for one
    checkpoint name; FileNotFoundError without either, ValueError naming
    both files when both exist."""
    base = os.path.join(checkpoints_path, MODEL_DIR, checkpoint)
    have = [ext for ext in ("pth", "msgpack")
            if os.path.exists(f"{base}.{ext}")]
    if len(have) == 2:
        raise ValueError(
            f"{base}.pth (the port's) and {base}.msgpack (the JAX "
            "package's) both exist: keep one of the two")
    if not have:
        raise FileNotFoundError(f"{base}.pth")
    return have[0]


def load_checkpoint(checkpoints_path: str, model, optimizer=None,
                    scheduler=None, checkpoint: str = "latest"):
    """Loads into model / optimizer / scheduler in place, from the port's
    .pth files or the JAX package's .msgpack ones. Returns (meta,
    generator state or None; None for a JAX run, whose jax key has no
    torch counterpart). Raises FileNotFoundError without a model
    checkpoint."""
    if checkpoint_format(checkpoints_path, checkpoint) == "msgpack":
        return _load_jax_checkpoint(checkpoints_path, model, optimizer,
                                    scheduler, checkpoint)
    path = os.path.join(checkpoints_path, MODEL_DIR, checkpoint + ".pth")
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
    return _read_meta(checkpoints_path, checkpoint), gen_state


def _read_meta(checkpoints_path: str, checkpoint: str) -> dict:
    meta_path = os.path.join(checkpoints_path, SCHED_DIR, checkpoint + ".json")
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def _read_msgpack(path: str):
    with open(path, "rb") as f:
        return read_flax_msgpack(f.read())


def _load_jax_checkpoint(checkpoints_path, model, optimizer, scheduler,
                         checkpoint):
    """The JAX package's Stage-1 checkpoint: the params tree mapped through
    stage1_params_from_jax, and (with an optimizer) the optax state of
    stage1.py::make_optimizer (multi_transform over the labels grid / net,
    each scale_by_adam + the exponential-decay schedule) as the port's
    Adam moments and step and the scheduler's epoch."""
    dev = next(model.parameters()).device
    tree = _read_msgpack(os.path.join(checkpoints_path, MODEL_DIR,
                                      checkpoint + ".msgpack"))
    model.load_state_dict(stage1_params_from_jax(tree, dev))
    opt_path = os.path.join(checkpoints_path, OPT_DIR, checkpoint + ".msgpack")
    if optimizer is not None and os.path.exists(opt_path):
        count = adam_state_from_optax(_read_msgpack(opt_path), model,
                                      optimizer)
        if scheduler is not None:
            scheduler.last_epoch = count
            for group in optimizer.param_groups:
                group["lr"] = group["initial_lr"] * scheduler.gamma ** count
            scheduler._last_lr = [g["lr"] for g in optimizer.param_groups]
    return _read_meta(checkpoints_path, checkpoint), None


def _leaf(tree, name: str):
    node = tree
    for part in name.split("."):
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    return node if isinstance(node, np.ndarray) else None


def adam_state_from_optax(opt_tree: dict, model, optimizer) -> int:
    """Carry an optax multi_transform(scale_by_adam, ...) state into the
    port's torch.optim.Adam, whose parameter groups must hold the same
    parameters as the JAX labels (a label's masked-out leaves are empty
    dicts in the file). Raises ValueError naming the group that differs.
    Returns the update count."""
    names = {id(p): n for n, p in model.named_parameters()}
    inner = opt_tree.get("inner_states")
    if not isinstance(inner, dict) or len(inner) != len(
            optimizer.param_groups):
        raise ValueError(
            f"optimizer state has groups {sorted(inner or {})}; the port's "
            f"optimizer has {len(optimizer.param_groups)}")
    count = None
    labels = sorted(inner)      # "grid", "net": the port's group order
    for label, group in zip(labels, optimizer.param_groups):
        adam = inner[label]["inner_state"]["0"]
        mine = [names[id(p)] for p in group["params"]]
        theirs = {n for n in names.values()
                  if _leaf(adam["mu"], n) is not None}
        if set(mine) != theirs:
            raise ValueError(
                f"optimizer group {label!r}: the JAX state holds "
                f"{sorted(theirs)}, the port's group {sorted(mine)}")
        count = int(adam["count"])
        for p in group["params"]:
            n = names[id(p)]
            optimizer.state[p] = {
                "step": torch.tensor(float(count)),
                "exp_avg": torch.as_tensor(_leaf(adam["mu"], n),
                                           device=p.device).reshape(p.shape),
                "exp_avg_sq": torch.as_tensor(
                    _leaf(adam["nu"], n), device=p.device).reshape(p.shape),
            }
    return count
