"""step_ms_p95.stage4: 95th percentile of the window's iteration times
(gaps between consecutive iteration starts, marked by the span around
Stage4Runner._pose_intr, which each iteration calls once first)."""

from port_bench.metrics._lib import step_p95_ms


def read(rec):
    return step_p95_ms(rec, "iteration")
