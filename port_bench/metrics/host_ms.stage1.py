"""host_ms.stage1: mean host ms inside the harness's span around
training/stage1.py::train_step over the window."""

from port_bench.metrics._lib import host_ms


def read(rec):
    return host_ms(rec, "train_step")
