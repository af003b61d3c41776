"""hash_roofline.stage1: the summed bound of every H1-fwd, H1-bwd and
H2 launch of the profiled window (port_bench/arith.py::hash_bound on each
launch's inputs) over the summed device time of their kernels."""

from port_bench.metrics._lib import roofline_pct

KERNELS = ("hash_fused_fwd_kernel", "hash_fused_bwd_kernel",
           "hash_bwd_bounds_kernel", "hash_bwd_convert_kernel",
           "hash_sampler_fwd_kernel")


def read(rec):
    return roofline_pct(rec, "hash_bound_s", KERNELS)
