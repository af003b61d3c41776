"""idle_pct.stage1: share of the profiled Stage-1 window with no kernel
running."""

from port_bench.metrics._lib import idle_pct


def read(rec):
    t = rec.get("trace")
    if not t or "hash_bound_s" not in t:
        return None
    return idle_pct(rec)
