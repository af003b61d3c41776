"""On the card: each cell's control, at a size a test run can hold, fails
the cell's limits where the program passes them. Stage 1 at the
configuration's widths with 512 rays on a 128^2 room; Stage 4 at an area
cap of 1e-4 on a 128^2 room. The control is the plain reference with TF32
matmuls and convolutions (the nearest precision below the configuration's
float32 with TF32 off) put in the program's place, and the planted fault
of half of each batch left out."""

from __future__ import annotations

import pytest
import torch

from port_bench import calibrate
from port_bench.tests import cases

SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells' kernels have no CPU mode")


def _fails(numbers: dict, limits: dict) -> bool:
    return any(numbers[k] > v for k, v in limits.items())


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["s1_room0_4k", "gom_room_views"])
def test_controls_fail_where_the_program_passes(card, workload, tmp_path):
    _, _, limits = cases.cell(workload)
    if workload.startswith("s1"):
        config, traffic = cases.tiny_s1(tmp_path, res=128, subs={})
        traffic = dict(traffic, rays_per_step=512)
    else:
        config, traffic = cases.tiny_s4(workload, res=128, area=1e-4)
    rows = calibrate.readings(workload, SEEDS, ["tf32", "drop_half"],
                              config_patch=config, traffic_patch=traffic)
    for row in rows:
        assert not _fails(row["program"], limits), row
        assert _fails(row["tf32"], limits), row
        assert _fails(row["drop_half"], limits), row
