"""Pieces the drivers share: the clock, patching a module's callables in
spans, a step's matmul operations, the TF32 switch of the control, and the
comparison of a training run's first steps with the plain reference."""

from __future__ import annotations

import contextlib
import math
import statistics
import time

import torch

from port_bench import harness


def now() -> float:
    return time.perf_counter()


def sync(device) -> None:
    """Wait for the card (a no-op on the CPU, where tests drive the
    drivers at tiny sizes through the plain kernels)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def patches(module, table: dict, spans: harness.Spans):
    """module's callables {attr: (span name, record or None[, after])}
    wrapped in spans while the context lasts."""
    with contextlib.ExitStack() as stack:
        for attr, (name, record, *after) in table.items():
            stack.enter_context(harness.patched(module, attr, name, spans,
                                                record, *after))
        yield


def timed_steps(run, n: int, device) -> float:
    """Seconds a step of run(n), device synced before and after."""
    sync(device)
    t0 = now()
    run(n)
    sync(device)
    return (now() - t0) / n


def run_window(run, seconds: float, step_s: float, chunk: int,
               device) -> tuple[int, float, float]:
    """The measured window: one run() call sized to ~0.9 of the window at
    the warm-up's step time (as the CLI makes one long call), then chunks
    until `seconds` have passed. Returns (steps, elapsed, t0)."""
    sync(device)
    t0 = now()
    steps = max(1, int(0.9 * seconds / max(step_s, 1e-6)))
    run(steps)
    elapsed = now() - t0
    while elapsed < seconds:
        run(chunk)
        steps += chunk
        elapsed = now() - t0
    return steps, elapsed, t0


def matmul_flops(fn) -> int:
    """The matrix products' and convolutions' floating-point operations of
    fn(), counted from their shapes by torch's FlopCounterMode (forward and
    backward as they run; autograd recomputes nothing)."""
    from torch.utils.flop_counter import FlopCounterMode

    mode = FlopCounterMode(display=False)
    with mode:
        fn()
    return int(mode.get_total_flops())


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 matmuls and convolutions on or off while the context lasts."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def first_grad_norms(model_or_params, optimizer) -> dict:
    """{leaf name: norm of the gradient Adam got at its first step}, from
    its first moment after that step (exp_avg = (1 - beta1) g)."""
    named = (model_or_params.named_parameters()
             if hasattr(model_or_params, "named_parameters")
             else model_or_params.items())
    out = {}
    for name, p in named:
        group = next(g for g in optimizer.param_groups
                     if any(q is p for q in g["params"]))
        m = optimizer.state[p]["exp_avg"]
        out[name] = float(m.norm()) / (1.0 - group["betas"][0])
    return out


def leaf_gaps(prog: dict, ref: dict, keep=lambda k: True) -> dict:
    """{kept leaf: |prog - ref| / max(ref, median ref)}."""
    med = statistics.median(ref.values())
    out = {}
    for k, r in ref.items():
        if keep(k):
            gap = abs(prog.get(k, float("nan")) - r) / max(r, med, 1e-30)
            out[k] = gap if math.isfinite(gap) else math.inf
    return out


def _worst_leaf(prog: dict, ref: dict, keep) -> float:
    return max(leaf_gaps(prog, ref, keep).values(), default=0.0)


def training_numbers(program: dict, ref: dict,
                     quiet_share: float = 1e-3) -> dict:
    """The three numbers a training cell compares: the worst step's loss
    gap relative to the reference's loss, the worst leaf's first-gradient
    norm gap, and the worst leaf's change-norm gap after the steps, over
    the leaves whose reference gradient is at least quiet_share of the
    median leaf's (the others move under Adam by round-off alone)."""
    losses = [abs(p - r) / max(abs(r), 1e-30)
              for p, r in zip(program["loss"], ref["loss"])]
    loss_gap = max((x if math.isfinite(x) else math.inf) for x in losses)
    if len(program["loss"]) != len(ref["loss"]):
        loss_gap = math.inf
    med_g = statistics.median(ref["grad"].values())
    moving = {k for k, g in ref["grad"].items() if g >= quiet_share * med_g}
    return {"loss_gap": loss_gap,
            "grad_gap": _worst_leaf(program["grad"], ref["grad"],
                                    lambda k: True),
            "change_gap": _worst_leaf(program["change"], ref["change"],
                                      lambda k: k in moving)}


def checks(numbers: dict, limits: dict) -> list:
    """(name, value, limit) of each number the cell's limits name."""
    return [(k, float(numbers[k]), float(v)) for k, v in limits.items()]
