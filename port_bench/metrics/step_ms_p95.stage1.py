"""step_ms_p95.stage1: 95th percentile of the window's step times (gaps
between consecutive train_step starts)."""

from port_bench.metrics._lib import step_p95_ms


def read(rec):
    return step_p95_ms(rec, "train_step")
