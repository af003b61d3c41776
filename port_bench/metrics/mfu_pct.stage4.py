"""mfu_pct.stage4: the operations an iteration needs (the walks' pairs
counted from each launch's inputs, the matrix products and convolutions
counted from shapes by FlopCounterMode, projection, loss and Adam per
element by the constants of port_bench/drivers/stage4.py) over the
window's mean iteration time at 67 TFLOP/s."""

from port_bench.metrics._lib import mfu_pct


def read(rec):
    t = rec.get("trace")
    if not t or "under" not in t:
        return None
    return mfu_pct(rec, ("walk_ops_per_step", "mm_flops_per_step",
                         "elem_ops_per_step"))
