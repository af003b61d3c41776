"""Helpers of the metric readers: each reader, port_bench/metrics/<metric
name>.py, defines read(rec) -> float or None over the run's record (see
port_bench/run.py): rec["window"] (steps, elapsed_s, t0, end,
work, failed), rec["spans"] (harness.Spans), rec["trace"] (the
profiled window's reduction and the driver's counts), rec["setup_s"],
rec["peak_bytes"]."""

from __future__ import annotations

import re

from port_bench import arith, harness

GEMM = re.compile(r"gemm|cutlass|xmma|cublas|sm90_|ampere_|sm80_", re.I)


def window_rate(rec, key: str):
    w = rec.get("window")
    if not w or key not in w["work"] or w["elapsed_s"] <= 0:
        return None
    return w["work"][key] / w["elapsed_s"]


def host_ms(rec, span: str):
    """Mean host milliseconds inside the span over the window."""
    w, spans = rec.get("window"), rec.get("spans")
    if not w or spans is None:
        return None
    n = spans.count(span, since=w["t0"])
    if not n:
        return None
    return spans.total_s(span, since=w["t0"]) / n * 1e3


def step_p95_ms(rec, span: str):
    """95th percentile of the window's step times: the gaps between
    consecutive starts of the span, the last closed by the window's end."""
    w, spans = rec.get("window"), rec.get("spans")
    if not w or spans is None:
        return None
    starts = [a for a, _ in spans.by_name.get(span, ()) if a >= w["t0"]]
    if len(starts) < 2:
        return None
    gaps = [b - a for a, b in zip(starts, starts[1:] + [w["end"]])]
    return harness.quantile(gaps, 0.95) * 1e3


def per_step_ms(rec, match):
    t = rec.get("trace")
    if not t or not t.get("steps"):
        return None
    s = harness.kernel_seconds(t, match)
    return s / t["steps"] * 1e3 if s > 0 else None


def idle_pct(rec):
    t = rec.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return (1.0 - t["busy_s"] / t["window_s"]) * 100.0


def roofline_pct(rec, bound_key: str, kernels):
    """Summed bound seconds over summed device seconds of the kernels."""
    t = rec.get("trace")
    if not t or not t.get(bound_key):
        return None
    dev = harness.kernel_seconds(t, lambda n: any(k in n for k in kernels))
    if dev <= 0:
        return None
    return t[bound_key] / dev * 100.0


def mfu_pct(rec, ops_keys):
    """The operations a step needs over the window's mean step time at the
    float32 peak."""
    t, w = rec.get("trace"), rec.get("window")
    if not t or not w or not w["steps"]:
        return None
    ops = sum(t.get(k, 0) for k in ops_keys)
    if ops <= 0:
        return None
    step_s = w["elapsed_s"] / w["steps"]
    return ops / step_s / arith.FP32_OPS_S * 100.0
