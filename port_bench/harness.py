"""The benchmark's shared pieces: the cell's files found by name, the guard
against the JAX package, the harness's spans, the reduction of a
torch.profiler trace, and the result line.

Nothing here imports the port: the drivers under port_bench/drivers/ do,
and only the PyTorch package `holoscene_tpu_torch`.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import json
import statistics
import sys
import time
from pathlib import Path

# top-level module names no run may load, compared whole (the port's
# name, holoscene_tpu_torch, begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "holoscene_tpu")


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among the loaded modules."""
    names = {m.split(".", 1)[0] for m in (modules or list(sys.modules))}
    return sorted(names & set(FORBIDDEN))


class CellError(RuntimeError):
    """The cell's files are missing or do not agree."""


def load_cell(root: Path, workload: str) -> dict:
    """BENCHMARK.json's cell `workload` with its configuration, its traffic
    file, and its end-to-end and per-layer metric entries."""
    bench_path = root / "BENCHMARK.json"
    if not bench_path.is_file():
        raise CellError(f"no BENCHMARK.json under {root}")
    bench = json.loads(bench_path.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise CellError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[cell["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic_path = root / "port_bench" / "workloads" / f"{cell['traffic']}.json"
    if not traffic_path.is_file():
        raise CellError(f"no traffic file {traffic_path}")
    traffic = json.loads(traffic_path.read_text())

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    return {"cell": cell, "config": config, "traffic": traffic,
            "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
            "per_layer": [m for m in bench["per_layer"] if applies(m)]}


def load_limits(root: Path, workload: str) -> dict:
    """The cell's limits on the numbers its check compares,
    port_bench/limits/<workload>.json."""
    path = root / "port_bench" / "limits" / f"{workload}.json"
    if not path.is_file():
        raise CellError(f"no limits file {path}")
    return json.loads(path.read_text())["limits"]


class Spans:
    """Host-clock spans by name, kept in memory: (start, end) pairs of
    perf_counter seconds."""

    def __init__(self):
        self.by_name: dict[str, list[tuple[float, float]]] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.by_name.setdefault(name, []).append(
                (t0, time.perf_counter()))

    def total_s(self, name: str, since: float = float("-inf")) -> float:
        return sum(b - a for a, b in self.by_name.get(name, ()) if a >= since)

    def count(self, name: str, since: float = float("-inf")) -> int:
        return sum(1 for a, _ in self.by_name.get(name, ()) if a >= since)


def wrap_callable(fn, name: str, spans: Spans, record=None, after=None):
    """fn inside a span `name`; record(args, kwargs), when given, sees each
    call's arguments first, and after(args, kwargs, result) its result. A
    `launches` counter on fn (the port's kernel wrappers count themselves
    under the name they are bound to) moves to the wrapper."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if record is not None:
            record(args, kwargs)
        with spans.span(name):
            out = fn(*args, **kwargs)
        if after is not None:
            after(args, kwargs, out)
        return out

    if hasattr(fn, "launches"):
        wrapped.launches = fn.launches
    return wrapped


@contextlib.contextmanager
def patched(obj, attr: str, name: str, spans: Spans, record=None,
            after=None):
    """obj.attr wrapped by wrap_callable while the context lasts; a
    launches counter is carried back to the original."""
    orig = getattr(obj, attr)
    w = wrap_callable(orig, name, spans, record, after)
    setattr(obj, attr, w)
    try:
        yield w
    finally:
        setattr(obj, attr, orig)
        if hasattr(orig, "launches"):
            orig.launches = w.launches


def quantile(values, q: float) -> float:
    """The q-quantile (0 < q < 1) by statistics.quantiles' default
    method, with 100 cut points."""
    vals = sorted(values)
    if len(vals) == 1:
        return float(vals[0])
    cuts = statistics.quantiles(vals, n=100)
    return float(cuts[min(max(int(round(q * 100)) - 1, 0), 98)])


# --- the profiler trace -----------------------------------------------------

def reduce_trace(prof, window_s: float) -> dict:
    """The device side of a torch.profiler run: every kernel (name, start
    us, end us), busy seconds (the union of the kernels' intervals), the
    kernel seconds by name, the ten costliest kernel names, and the ten
    longest idle gaps' totals by what the host was doing at each gap's
    start (the innermost host operation then running). The union follows
    chip_smoke.py::device_kernels at commit badb067, except that user
    annotations (record_function ranges the profiler mirrors on the device
    timeline) are not kernels and are left out here."""
    from torch.autograd import DeviceType

    kernels, host = [], []
    for ev in prof.events():
        a, b = ev.time_range.start, ev.time_range.end
        if getattr(ev, "is_user_annotation", False):
            continue    # a host range mirrored on the device timeline
        if ev.device_type == DeviceType.CUDA:
            kernels.append((ev.name, a, b))
        elif b > a:
            host.append((a, b, ev.name))
    kernels.sort(key=lambda k: k[1])
    busy_us, end = 0.0, float("-inf")
    gaps = []
    for _, a, b in kernels:
        if a > end and end != float("-inf"):
            gaps.append((end, a))
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name: dict[str, float] = {}
    for name, a, b in kernels:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    host.sort()
    gap_by: dict[str, float] = {}
    starts = [h[0] for h in host]
    for g0, g1 in gaps:
        i = bisect.bisect_right(starts, g0) - 1
        label = "idle"
        best = None
        # the innermost (latest-starting) host op that covers the gap start
        j = i
        while j >= 0 and j > i - 400:
            a, b, name = host[j]
            if b >= g0:
                best = name
                break
            j -= 1
        if best is not None:
            label = best
        gap_by[label] = gap_by.get(label, 0.0) + (g1 - g0) / 1e6
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(gap_by.items(), key=lambda kv: -kv[1])[:10]
    return {"kernels": kernels, "busy_s": busy_us / 1e6,
            "window_s": window_s, "by_name": by_name,
            "breakdown": {"device_ops": [[n, s] for n, s in top_ops],
                          "idle_gaps": [[n, s] for n, s in top_gaps]}}


def kernel_seconds(trace: dict, match) -> float:
    """Device seconds of the trace's kernels whose name match(name) takes."""
    return sum(s for n, s in trace["by_name"].items() if match(n))


def emit(result: dict, checks: list) -> None:
    """The checks as the last lines on standard error, then the result as
    the last line on standard output, its `checks` key last."""
    for name, value, limit in checks:
        print(f"check {name} = {value!r} limit {limit!r}", file=sys.stderr,
              flush=True)
    result = dict(result)
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in checks}
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
