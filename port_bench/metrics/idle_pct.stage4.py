"""idle_pct.stage4: share of the profiled Stage-4 window with no kernel
running."""

from port_bench.metrics._lib import idle_pct


def read(rec):
    t = rec.get("trace")
    if not t or "under" not in t:
        return None
    return idle_pct(rec)
