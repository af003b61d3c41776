"""mfu_pct.stage1: the matrix-product operations of one step (counted
from shapes by FlopCounterMode) plus the hash encodes' operations a step
(port_bench/arith.py::hash_ops on each launch), over the window's mean
step time at 67 TFLOP/s."""

from port_bench.metrics._lib import mfu_pct


def read(rec):
    t = rec.get("trace")
    if not t or "hash_bound_s" not in t:
        return None
    return mfu_pct(rec, ("mm_flops_per_step", "hash_ops_per_step"))
