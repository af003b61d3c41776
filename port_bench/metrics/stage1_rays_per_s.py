"""stage1_rays_per_s: rays trained in all steps completed in the window
over the window's seconds."""

from port_bench.metrics._lib import window_rate


def read(rec):
    return window_rate(rec, "rays")
