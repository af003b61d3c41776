"""The yardstick's arithmetic against hand counts at tiny shapes."""

from __future__ import annotations

import math

import torch

from port_bench import arith
from port_bench.ref_s1 import hashgrid as hg


def test_bound_takes_the_larger_of_bytes_and_operations():
    assert math.isclose(arith.bound_ms(3.35e9, 0), 1.0)
    assert math.isclose(arith.bound_ms(0, 67e9), 1.0)
    assert math.isclose(arith.bound_ms(3.35e9, 134e9), 2.0)


def _tables(levels=2, log2=8):
    meta = hg.HashGridMeta(input_dim=3, num_levels=levels, level_dim=2,
                           base_resolution=4, log2_hashmap_size=log2,
                           desired_resolution=8)
    return hg.level_tables(meta)


def test_hash_ops_count_in_range_points_only():
    lt = _tables()
    x = torch.tensor([[0.5, 0.5, 0.5], [0.1, 0.2, 0.3], [1.5, 0.5, 0.5]])
    per = arith.OPS_POINT_LEVEL + 8 * arith.OPS_CORNER["H2"]
    assert arith.hash_ops("H2", x, lt) == 2 * lt.n_levels * per
    per_j = arith.OPS_POINT_LEVEL + 8 * arith.OPS_CORNER_NO_J
    assert arith.hash_ops("H1-bwd", x, lt, has_j=False) \
        == 2 * lt.n_levels * per_j


def test_gather_bytes_one_point_touches_its_sectors():
    lt = _tables()
    x = torch.tensor([[0.5, 0.5, 0.5]])
    rows = hg._fused_rows_frac(x, lt)[0]
    want = sum(min(torch.unique(rows[lvl] // 4).numel() * 32,
                   int(lt.sizes[lvl]) * 8) for lvl in range(lt.n_levels))
    assert arith.gather_bytes(x, lt, 1) == want
    assert arith.gather_bytes(x, lt, 2) == 2 * want
    assert arith.gather_bytes(torch.tensor([[2.0, 0.5, 0.5]]), lt, 1) == 0


def test_h2_bound_by_hand():
    lt = _tables()
    x = torch.tensor([[0.5, 0.5, 0.5], [0.25, 0.75, 0.5]])
    n, L = 2, lt.n_levels
    nbytes = n * 12 + n * L * 2 * 4 + arith.gather_bytes(x, lt, 1)
    ops = arith.hash_ops("H2", x, lt)
    assert math.isclose(arith.hash_bound("H2", x, lt),
                        arith.bound_ms(nbytes, ops))


def test_walk_work_by_hand():
    # one tile of 4 pixels, one chunk of 128 candidates: two real ones, one
    # centred on pixel (0.5, 0.5) with opacity 0.9, one far away
    c = torch.zeros(1, arith.CHUNK, arith.CAND_ROWS)
    c[0, 0, :6] = torch.tensor([0.5, 0.5, 1.0, 0.0, 1.0, 0.9])
    c[0, 1, :6] = torch.tensor([500.0, 500.0, 1.0, 0.0, 1.0, 0.9])
    c[0, :2, 10] = 1.0
    real = c[..., 10] > 0
    px = torch.tensor([[0.5, 1.5, 0.5, 1.5]])
    py = torch.tensor([[0.5, 0.5, 1.5, 1.5]])
    in_img = torch.ones(1, 4, dtype=torch.bool)
    walked, pairs, live = arith.walk_work(
        c, real, torch.zeros(1, dtype=torch.long),
        torch.ones(1, dtype=torch.long), px, py, in_img)
    assert walked == 1
    assert pairs == 2 * 4
    # the near candidate's alpha at distance d: 0.9 exp(-d^2 / 2) >= 1/255
    assert live == 4
