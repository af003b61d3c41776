"""stage4_splats_per_s: gaussians x iterations completed in the window over
the window's seconds (an iteration with its invisible-view step, where the
traffic has one)."""

from port_bench.metrics._lib import window_rate


def read(rec):
    return window_rate(rec, "splats")
