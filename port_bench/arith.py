"""The benchmark's yardstick arithmetic: the H100's peaks, a launch's bound
from the bytes and operations its inputs need, and the walk's work.

Frozen copies of chip_smoke.py at commit badb067 (`bound_ms`,
`_gather_bytes`, `hash_bound`, `walk_work` and their constants) and of
holoscene_tpu_torch/ops/splat_flat.py::_chunk_alpha, with the port's
hash-grid row arithmetic taken from the reference's frozen copy
(port_bench/ref_s1/hashgrid.py). Later changes to the program do not move
these counts.
"""

from __future__ import annotations

import torch

from port_bench.ref_s1 import hashgrid as ref_hg

# NVIDIA's H100 SXM data sheet: HBM3 bytes a second, float32 operations a
# second outside the tensor cores (the port runs float32 with TF32 off)
MEM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12

# operations of the hash encodes: per (point, level) and per corner
OPS_POINT_LEVEL = 18
OPS_CORNER = {"H1-fwd": 2 + 9 + 20, "H1-bwd": 2 + 9 + 16, "H2": 2 + 4}
OPS_CORNER_NO_J = 2 + 2

# operations of the walks: each (candidate, pixel) pair's test, and each
# live pair's compositing forward / backward
OPS_TEST, OPS_LIVE_FWD, OPS_LIVE_BWD = 17, 13, 51
ALPHA_EPS = 1.0 / 255.0
CHUNK, CAND_ROWS = 128, 16


def bound_ms(n_bytes: int, n_ops: int) -> float:
    """The least milliseconds the card could take: the larger of the bytes
    at the HBM rate and the operations at the float32 rate."""
    return max(n_bytes / MEM_BYTES_S * 1e3, n_ops / FP32_OPS_S * 1e3)


def _trilinear(interp: str) -> None:
    if interp != "trilinear":
        raise NotImplementedError(f"the {interp} stencil's work is not "
                                  "counted")


def gather_bytes(x01, lt, n_tables: int, interp: str = "trilinear") -> int:
    """Per level, the lesser of its table's bytes and the 32-byte sectors
    its corner gathers touch (8-byte rows of each table), in-range points
    only."""
    _trilinear(interp)
    x = x01[~((x01 < 0) | (x01 > 1)).any(-1)]
    if not x.shape[0]:
        return 0
    rows = ref_hg._fused_rows_frac(x, lt)[0]
    total = 0
    for lvl in range(lt.n_levels):
        sectors = torch.unique(rows[lvl] // 4).numel() * 32
        total += min(sectors, int(lt.sizes[lvl]) * 8)
    return total * n_tables


def hash_ops(kernel: str, x01, lt, has_j: bool = True,
             interp: str = "trilinear") -> int:
    """The operations a launch's in-range points need."""
    valid = int((~((x01 < 0) | (x01 > 1)).any(-1)).sum())
    L = lt.n_levels
    _trilinear(interp)
    corner = OPS_CORNER[kernel] if has_j else OPS_CORNER_NO_J
    return valid * L * (OPS_POINT_LEVEL + 8 * corner)


def hash_bound(kernel: str, x01, lt, n_rows: int = 0, has_b: bool = True,
               mode: str = "exact", has_j: bool = True,
               interp: str = "trilinear") -> float:
    """Bound ms of one H1-fwd / H1-bwd / H2 launch on these inputs: the
    inputs read once, the outputs written once and the table sectors
    gathered (H1-bwd: its draws read once and each gradient table written
    once instead of the gathers)."""
    n, L = x01.shape[0], lt.n_levels
    tables = 2 if has_b else 1
    ops = hash_ops(kernel, x01, lt, has_j, interp)
    feats = n * L * 2 * 4
    if kernel == "H1-fwd":
        nbytes = n * 12 + feats * tables + n * L * 6 * 4 \
            + gather_bytes(x01, lt, tables, interp)
    elif kernel == "H2":
        nbytes = n * 12 + feats + gather_bytes(x01, lt, 1, interp)
    else:
        cts = feats * tables + (n * L * 6 * 4 if has_j else 0)
        draws = {"exact": 0, "sampled": 3, "sampled_all": 4}[mode] \
            * n * lt.n_hashed * 4
        nbytes = n * 12 + cts + draws + n_rows * 8 * tables
    return bound_ms(nbytes, ops)


def chunk_alpha(px, py, c):
    """Gaussian falloff of chunk candidates c [T, C, 16] at pixels [T, P]:
    (a [T, P, C], keep [T, P, C])."""
    gx, gy = c[:, None, :, 0], c[:, None, :, 1]
    ca, cb, cc = c[:, None, :, 2], c[:, None, :, 3], c[:, None, :, 4]
    dx = px[..., None] - gx
    dy = py[..., None] - gy
    power = -0.5 * (ca * dx * dx + 2.0 * cb * dx * dy + cc * dy * dy)
    e = torch.exp(torch.clamp(power, max=0.0))
    a_cap = torch.clamp(c[:, None, :, 5] * e, max=0.999)
    keep = a_cap >= ALPHA_EPS
    return torch.where(keep, a_cap, torch.zeros_like(a_cap)), keep


def walk_work(chunks, real, cs, used, px, py, in_img, tile_block: int = 256):
    """What a walk over these inputs needs: (chunks walked, (candidate,
    pixel) pairs, live pairs with alpha >= 1/255). A pair is a real
    candidate (`real` [n_chunks, 128] bool) of a walked chunk at an
    in-image pixel of its tile. Tiles are taken tile_block at a time so
    the falloff fits in memory."""
    cs, used = cs.long(), used.long()
    n_pix = in_img.sum(1)
    pairs = live = 0
    for t0 in range(0, cs.shape[0], tile_block):
        sl = slice(t0, t0 + tile_block)
        u = used[sl]
        for j in range(int(u.max()) if u.numel() else 0):
            act = j < u
            idx = (cs[sl] + j)[act]
            pairs += int((real[idx].sum(1) * n_pix[sl][act]).sum())
            keep = chunk_alpha(px[sl][act], py[sl][act], chunks[idx])[1]
            live += int((keep & real[idx][:, None, :]
                         & in_img[sl][act][:, :, None]).sum())
    return int(used.sum()), pairs, live
