# Frozen copy of holoscene_tpu_torch/ops/hashgrid.py at commit badb067, for the
# benchmark's plain reference: imports rewired to port_bench.ref_s1, cut to
# the paths the benchmark's Stage-1 configuration runs, in plain PyTorch.
# Do not edit to follow the port.
"""Multi-resolution hash-grid encoding (port of holoscene_tpu/ops/hashgrid.py),
cut to what the benchmark's Stage-1 configuration runs: the trilinear
fused dual encode with its exact backward, and the sampler's encode.

Per level l: scale = 2^(l log2 s) H - 1 (float32, computed on the host as
numpy computes it), resolution = ceil(H s^l); rows = min(2^logmap, r^3)
unless r <= dense_max_res. Levels whose r^3 fits their rows are dense
(row-major, stride r) and form a prefix; the others hash (pg + corner) with
the xor-primes (1, 2654435761, 805459861) in uint32 wraparound, then % size.
Trilinear interpolation with smoothstep-warped weights; any coordinate
outside [0, 1] gives zero features.

  * `hash_encode_fused_dual` (fused): both tables' values rounded to bf16
    at every level, the dense cell clamped to [0, r-2]; features of tables
    a and b and J_a = d feats_a / d x01 (H1-fwd), and the tables'
    gradients summed in fixed point, so that any order of the points gives
    the same bits (H1-bwd, exact mode). With emb_b=None it is the
    single-table mode (features + J of table a).
  * `hash_encode_sampler`: the first `grid_levels` levels, dense levels
    from exact float32 rows with clamped cells, hashed levels bf16 with the
    wrapped hash; no gradient (H2).

Layouts are the JAX ones: feats [N, L*2] (level-major: l0c0 l0c1 l1c0 ...),
J [L*2, 3, N] (point-minor), tables and their gradients [rows, 2].
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
from torch.autograd.function import once_differentiable

_PRIMES = (1, 2654435761, 805459861)
_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class HashGridMeta:
    """Static per-level metadata (hashable)."""

    input_dim: int = 3
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    per_level_scale: float = 2.0
    desired_resolution: int | None = None
    dense_max_res: int = 0

    def __post_init__(self):
        if self.desired_resolution is not None:
            s = math.exp2(
                math.log2(self.desired_resolution / self.base_resolution)
                / (self.num_levels - 1))
            object.__setattr__(self, "per_level_scale", s)

    def level_tables(self):
        """(resolutions [L], sizes [L], offsets [L]) as numpy uint32."""
        max_params = 2 ** self.log2_hashmap_size
        res, sizes, offsets = [], [], []
        offset = 0
        for lvl in range(self.num_levels):
            r = int(np.ceil(self.base_resolution * self.per_level_scale ** lvl))
            if r <= self.dense_max_res:
                n = r ** self.input_dim
            else:
                n = min(max_params, r ** self.input_dim)
            res.append(r)
            sizes.append(n)
            offsets.append(offset)
            offset += n
        return (np.array(res, dtype=np.uint32), np.array(sizes, dtype=np.uint32),
                np.array(offsets, dtype=np.uint32))

    @property
    def table_rows(self) -> int:
        return int(self.level_tables()[1].sum())


def init_hash_embeddings(meta: HashGridMeta, generator=None,
                         std: float = 1e-4, device="cpu") -> torch.Tensor:
    """Uniform(-std, std) [table_rows, level_dim] float32."""
    u = torch.rand(meta.table_rows, meta.level_dim, generator=generator,
                   device=device)
    return (u * 2.0 - 1.0) * std


def level_scales(meta: HashGridMeta) -> np.ndarray:
    """float32 [L]: 2^(l log2 s) H - 1, exactly as the JAX package's numpy
    computes it."""
    return (np.exp2(np.arange(meta.num_levels) * np.log2(meta.per_level_scale))
            * meta.base_resolution - 1.0).astype(np.float32)


def dense_level_count(meta: HashGridMeta) -> int:
    """Number of leading levels whose dense grid fits the level's rows."""
    res, sizes, _ = meta.level_tables()
    dense = res.astype(np.int64) ** meta.input_dim <= sizes.astype(np.int64)
    n = 0
    while n < len(dense) and dense[n]:
        n += 1
    return n


@dataclasses.dataclass(frozen=True, eq=False)
class LevelTables:
    """The first `n_levels` levels of a meta, as the kernels read them:
    numpy on the host, and on a device one float32 array of scales and one
    int32 array [n_dense, res[L], sizes[L], offsets[L]]. One object per
    (meta, levels) (level_tables caches it), hashed by identity."""

    n_levels: int
    n_dense: int
    res: np.ndarray       # int64 [L]
    sizes: np.ndarray
    offsets: np.ndarray
    scales: np.ndarray    # float32 [L]

    @property
    def n_hashed(self) -> int:
        return self.n_levels - self.n_dense


@functools.lru_cache(maxsize=None)
def level_tables(meta: HashGridMeta, levels: int | None = None) -> LevelTables:
    n = meta.num_levels if levels is None else int(levels)
    if not 1 <= n <= meta.num_levels:
        raise ValueError(f"levels must be in [1, {meta.num_levels}], got {n}")
    if meta.input_dim != 3 or meta.level_dim != 2:
        raise ValueError("the hash-grid kernels take input_dim 3, level_dim 2")
    res, sizes, offsets = (a.astype(np.int64)[:n] for a in meta.level_tables())
    if int(sizes.sum() + offsets[0]) >= 2 ** 31:
        raise ValueError("table rows exceed int32 indexing")
    n_dense = min(dense_level_count(meta), n)
    hashed = sizes[n_dense:]
    if np.any(hashed & (hashed - 1)):
        # the kernels wrap a hashed level's hash by a mask (hash_grid.cuh)
        raise ValueError(f"hashed level sizes must be powers of two, got "
                         f"{hashed.tolist()}")
    return LevelTables(n, n_dense, res, sizes, offsets,
                       level_scales(meta)[:n])


def _smoothstep(t):
    return t * t * (3.0 - 2.0 * t)


def _corner_bits(device) -> torch.Tensor:
    """[8, 3] int64 corner offset bits: corner k = (k & 1, k >> 1 & 1,
    k >> 2 & 1)."""
    k = torch.arange(8, device=device)
    return torch.stack([(k >> d) & 1 for d in range(3)], -1)


def _hash_rows(pg: torch.Tensor, sizes, offsets) -> torch.Tensor:
    """pg [L, 3, N] int64 grid coords -> rows [L, 8, N] int64: xor-prime
    hash of (pg + corner) in uint32 wraparound (int64 products masked to 32
    bits), % size, + offset. sizes / offsets: int64 [L]."""
    bits = _corner_bits(pg.device)
    cg = pg[:, None] + bits[None, :, :, None]            # [L, 8, 3, N]
    h = (cg[:, :, 0] * _PRIMES[0]) & _MASK32
    for d in (1, 2):
        h = h ^ ((cg[:, :, d] * _PRIMES[d]) & _MASK32)
    return h % sizes[:, None, None] + offsets[:, None, None]


def _dense_rows(cell: torch.Tensor, res, offsets) -> torch.Tensor:
    """cell [L, 3, N] int64 (lower corner) -> rows [L, 8, N] row-major with
    stride res."""
    bits = _corner_bits(cell.device)
    cg = cell[:, None] + bits[None, :, :, None]
    r = res[:, None, None]
    return cg[:, :, 0] + r * (cg[:, :, 1] + r * cg[:, :, 2]) \
        + offsets[:, None, None]


def _oob(x01: torch.Tensor) -> torch.Tensor:
    return ((x01 < 0.0) | (x01 > 1.0)).any(-1)


# ---------------------------------------------------------------------------
# fused dual encode-with-jacobian: plain versions
# ---------------------------------------------------------------------------


def _fused_cells(x01: torch.Tensor, lt: LevelTables):
    """(cell [L, 3, N] int64 lower corners, frac [L, 3, N] f32) of the
    fused semantics: dense cells clamped to [0, r-2], hashed levels
    unclamped."""
    dev = x01.device
    res = torch.as_tensor(lt.res, device=dev)
    pos = torch.as_tensor(lt.scales, device=dev)[:, None, None] * x01.T[None]
    ld = lt.n_dense
    cells, fracs = [], []
    if ld:
        top = (res[:ld] - 2).to(torch.float32)[:, None, None]
        cf = torch.minimum(torch.clamp(torch.floor(pos[:ld]), min=0.0), top)
        fracs.append(pos[:ld] - cf)
        cells.append(cf)
    if lt.n_hashed:
        pf = torch.floor(pos[ld:])
        fracs.append(pos[ld:] - pf)
        cells.append(pf)
    return torch.cat(cells).long(), torch.cat(fracs)


def _grid_rows(cg: torch.Tensor, lt: LevelTables) -> torch.Tensor:
    """Grid points cg [L, K, 3, N] int64 -> rows [L, K, N]: row-major with
    stride res on the dense levels, the xor-prime hash % size on the
    others, plus the level's offset."""
    dev = cg.device
    res, sizes, offsets = (torch.as_tensor(a, device=dev)[:, None, None]
                           for a in (lt.res, lt.sizes, lt.offsets))
    ld = lt.n_dense
    rows = []
    if ld:
        c, r = cg[:ld], res[:ld]
        idx = c[:, :, 0] + r * (c[:, :, 1] + r * c[:, :, 2])
        rows.append(idx)
    if lt.n_hashed:
        c = cg[ld:]
        h = (c[:, :, 0] * _PRIMES[0]) & _MASK32
        for d in (1, 2):
            h = h ^ ((c[:, :, d] * _PRIMES[d]) & _MASK32)
        rows.append(h % sizes[ld:])
    return torch.cat(rows) + offsets


def _fused_rows_frac(x01: torch.Tensor, lt: LevelTables):
    """(rows [L, 8, N] int64, frac [L, 3, N] f32) of the fused semantics
    (trilinear corners of _fused_cells)."""
    cell, frac = _fused_cells(x01, lt)
    cg = cell[:, None] + _corner_bits(x01.device)[None, :, :, None]
    return _grid_rows(cg, lt), frac


def _fused_weights(frac, scales):
    """frac [L, 3, N], scales [L] -> (ws, cw, dcw, dws, dds): per-dim corner
    weights (3 x [L, 8, N]), trilinear weights, d cw / d x01 (3 x, with the
    scale chain factor), and the first / second derivative helpers."""
    bits = _corner_bits(frac.device).bool()
    w = _smoothstep(frac)
    dwdf = 6.0 * frac * (1.0 - frac)
    ddwdf = 6.0 - 12.0 * frac
    sgn = torch.where(bits, 1.0, -1.0)
    ws, dws, dds = [], [], []
    for d in range(3):
        bit = bits[None, :, d, None]
        ws.append(torch.where(bit, w[:, None, d], 1.0 - w[:, None, d]))
        s = sgn[None, :, d, None]
        dws.append(s * dwdf[:, None, d])
        dds.append(s * ddwdf[:, None, d])
    sc = scales[:, None, None]
    cw = ws[0] * ws[1] * ws[2]
    dcw = [sc * dws[0] * ws[1] * ws[2], sc * ws[0] * dws[1] * ws[2],
           sc * ws[0] * ws[1] * dws[2]]
    return ws, cw, dcw, dws, dds


def _values(emb: torch.Tensor) -> torch.Tensor:
    return emb.to(torch.bfloat16).float()


def fused_fwd_plain(x01, emb_a, emb_b, lt: LevelTables):
    """H1-fwd: (feats_a [N, L*2], J_a [L*2, 3, N], feats_b [N, L*2] or
    None)."""
    n, L = x01.shape[0], lt.n_levels
    rows, frac = _fused_rows_frac(x01, lt)
    _, cw, dcw, _, _ = _fused_weights(
        frac, torch.as_tensor(lt.scales, device=x01.device))
    valid = (~_oob(x01)).float()
    va = _values(emb_a)[rows]                             # [L, K, N, 2]
    fa = torch.stack([(cw * va[..., c]).sum(1) * valid for c in (0, 1)], 1)
    J = torch.stack([torch.stack([(dcw[d] * va[..., c]).sum(1) * valid
                                  for d in range(3)], 1) for c in (0, 1)], 1)
    fb = None
    if emb_b is not None:
        vb = _values(emb_b)[rows]
        fb = torch.stack([(cw * vb[..., c]).sum(1) * valid for c in (0, 1)], 1)
        fb = fb.reshape(L * 2, n).T.contiguous()
    return fa.reshape(L * 2, n).T.contiguous(), J.reshape(L * 2, 3, n), fb


def fixed_point(ct_fa, ct_J, ct_fb, lt: LevelTables):
    """H1-bwd's fixed point (csrc/hash_fused_bwd.cu's header note):
    (scale [T, L], inv [T, L]) float32 for tables a and b (T = 2), level by
    level. A contribution v of table t at level l is added as the int64
    round(v * scale[t, l]) and a row's sum s read back as float32(s) *
    inv[t, l]; the exponent keeps any row of 8 N contributions below 2^63.
    inv is NaN where a cotangent's maximum is not finite."""
    n, L = ct_fa.shape[0], lt.n_levels
    dev = ct_fa.device

    def amax(t, shape):
        if t is None or not n:
            return torch.zeros(L, device=dev)
        return t.detach().abs().reshape(shape).amax(1)

    a = amax(ct_fa.reshape(n, L, 2).transpose(0, 1), (L, -1))
    bound_a = a
    if ct_J is not None:
        j = amax(ct_J, (L, -1))
        s45 = torch.as_tensor(lt.scales, device=dev) * 4.5
        bound_a = a + s45 * j
    bound_b = amax(None if ct_fb is None
                   else ct_fb.reshape(n, L, 2).transpose(0, 1), (L, -1))
    clog2 = (8 * n - 1).bit_length() if n else 0
    bounds = torch.stack([bound_a, bound_b])
    x = torch.frexp(bounds)[1].to(torch.int64)
    e = torch.clamp(62 - clog2 - x, -126, 126).to(torch.float64)
    scale = torch.pow(2.0, e).to(torch.float32)
    inv = torch.pow(2.0, -e).to(torch.float32)
    inv = torch.where(torch.isfinite(bounds), inv, float("nan"))
    return scale, inv


def _scatter(acc, rows, vals, scale):
    """acc [rows*2] int64 += round(vals * scale) (2 x [...]) at rows [...]
    (channels 0, 1); scale broadcasts against vals (a level's own)."""
    r = rows.reshape(-1) * 2
    for c in (0, 1):
        q = torch.round(vals[c] * scale).to(torch.int64)
        acc.index_add_(0, r + c, q.reshape(-1))


def _from_fixed(acc, inv, lt: LevelTables, n_rows: int) -> torch.Tensor:
    """float32 [n_rows, 2] of the int64 sums acc [n_rows*2]: each level's
    rows times its inv; rows past the last level are zeros."""
    out = torch.zeros(n_rows * 2, device=acc.device)
    for lvl in range(lt.n_levels):
        a = 2 * int(lt.offsets[lvl])
        b = a + 2 * int(lt.sizes[lvl])
        out[a:b] = acc[a:b].to(torch.float32) * inv[lvl]
    return out.reshape(n_rows, 2)


def fused_bwd_plain(x01, n_rows, ct_fa, ct_J, ct_fb, lt: LevelTables):
    """H1-bwd, exact mode: (grad_a [n_rows, 2], grad_b [n_rows, 2] or
    None). The per-corner cotangent of table a is cw ct_f + sum_d dcw_d
    ct_J[d] (cw ct_f with ct_J None: no jacobian term); table b's is cw
    ct_f. They are summed as the kernel sums them: in fixed point
    (fixed_point), int64 index_add_, the same conversion, so any order of
    the points gives the same bits."""
    n, L = x01.shape[0], lt.n_levels
    scales = torch.as_tensor(lt.scales, device=x01.device)
    rows, frac = _fused_rows_frac(x01, lt)
    _, cw, dcw, _, _ = _fused_weights(frac, scales)
    valid = (~_oob(x01)).float()
    cfa = ct_fa.T.reshape(L, 2, n) * valid
    if ct_J is None:
        ca = [cw * cfa[:, c, None] for c in (0, 1)]
    else:
        cJa = ct_J.reshape(L, 2, 3, n) * valid
        ca = [cw * cfa[:, c, None] + sum(dcw[d] * cJa[:, c, d, None]
                                         for d in range(3)) for c in (0, 1)]
    scale, inv = fixed_point(ct_fa, ct_J, ct_fb, lt)
    ga = torch.zeros(n_rows * 2, dtype=torch.int64, device=x01.device)
    _scatter(ga, rows, ca, scale[0][:, None, None])
    gb = None
    if ct_fb is not None:
        cfb = ct_fb.T.reshape(L, 2, n) * valid
        gb = torch.zeros_like(ga)
        _scatter(gb, rows, [cw * cfb[:, c, None] for c in (0, 1)],
                 scale[1][:, None, None])
    return (_from_fixed(ga, inv[0], lt, n_rows),
            _from_fixed(gb, inv[1], lt, n_rows) if gb is not None else None)


class _FusedEncode(torch.autograd.Function):
    """hash_encode_fused_dual as an autograd Function: forward H1-fwd,
    backward H1-bwd. The points carry no gradient (training points are
    leaves)."""

    @staticmethod
    def forward(ctx, x01, emb_a, emb_b, lt):
        fa, J, fb = fused_fwd_plain(x01, emb_a, emb_b, lt)
        ctx.lt, ctx.has_b = lt, emb_b is not None
        ctx.save_for_backward(x01, emb_a)
        return (fa, J, fb) if emb_b is not None else (fa, J)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct_fa, ct_J, ct_fb=None):
        x01, emb_a = ctx.saved_tensors
        if ctx.needs_input_grad[0]:
            raise NotImplementedError(
                "hash_encode_fused_dual: the points carry no gradient")
        ga, gb = fused_bwd_plain(
            x01, emb_a.shape[0], ct_fa.contiguous(), ct_J.contiguous(),
            ct_fb.contiguous() if ctx.has_b else None, ctx.lt)
        return None, ga, gb, None


def hash_encode_fused_dual(x01, emb_a, emb_b, meta: HashGridMeta,
                           levels: int | None = None):
    """Dual-table encode + analytic jacobian of table a (fused semantics,
    the values rounded to bf16). x01 [N, 3]; emb_a / emb_b [rows, 2] (the
    full tables: `levels` < L encodes the coarse prefix, and the gradients
    land in the same rows).

    Returns (feats_a [N, levels*2], J_a [levels*2, 3, N], feats_b
    [N, levels*2]); with emb_b=None the single-table mode returns
    (feats_a, J_a)."""
    return _FusedEncode.apply(x01.contiguous(), emb_a, emb_b,
                              level_tables(meta, levels))


# ---------------------------------------------------------------------------
# sampler encode (H2)
# ---------------------------------------------------------------------------


def sampler_fwd_plain(x01, emb, lt: LevelTables) -> torch.Tensor:
    """H2: [N, L*2] for the first L = lt.n_levels levels; dense levels
    exact float32 with clamped cells, hashed levels bf16 with the wrapped
    hash; out-of-range points zero."""
    n, L, ld = x01.shape[0], lt.n_levels, lt.n_dense
    dev = x01.device
    res, sizes, offsets = (torch.as_tensor(a, device=dev)
                           for a in (lt.res, lt.sizes, lt.offsets))
    pos = torch.as_tensor(lt.scales, device=dev)[:, None, None] * x01.T[None]
    bits = _corner_bits(dev).bool()
    parts = []
    for lo, hi, dense in ((0, ld, True), (ld, L, False)):
        if hi <= lo:
            continue
        p = pos[lo:hi]
        if dense:
            top = (res[lo:hi] - 2).to(torch.float32)[:, None, None]
            pg = torch.minimum(torch.clamp(torch.floor(p), min=0.0), top)
            rows = _dense_rows(pg.long(), res[lo:hi], offsets[lo:hi])
            vals = emb[rows]
        else:
            pg = torch.floor(p)
            rows = _hash_rows(pg.long(), sizes[lo:hi], offsets[lo:hi])
            vals = emb.to(torch.bfloat16).float()[rows]
        w = _smoothstep(p - pg)
        ws = [torch.where(bits[None, :, d, None], w[:, None, d],
                          1.0 - w[:, None, d]) for d in range(3)]
        cw = ws[0] * ws[1] * ws[2]
        parts.append((cw[..., None] * vals).sum(1))       # [l, N, 2]
    out = torch.cat(parts)
    out = torch.where(_oob(x01)[None, :, None], 0.0, out)
    return out.permute(1, 0, 2).reshape(n, L * 2)


def hash_encode_sampler(inputs, embeddings, meta: HashGridMeta,
                        grid_levels: int | None = None) -> torch.Tensor:
    """SDF-probe encode of the error-bound sampler, no gradient: [N,
    grid_levels*2] (the caller zero-pads the fine levels)."""
    lt = level_tables(meta, grid_levels)
    with torch.no_grad():
        return sampler_fwd_plain(inputs.contiguous(), embeddings.detach(), lt)
