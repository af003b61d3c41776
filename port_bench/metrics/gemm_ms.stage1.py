"""gemm_ms.stage1: device ms a step of the matrix-product kernels (by
kernel name) in the profiled window."""

from port_bench.metrics._lib import GEMM, per_step_ms


def read(rec):
    t = rec.get("trace")
    if not t or "hash_bound_s" not in t:
        return None
    return per_step_ms(rec, lambda n: bool(GEMM.search(n)))
