"""Multi-resolution hash-grid encoding (port of holoscene_tpu/ops/hashgrid.py)
with the hand-written kernels of the Stage-1 hot path.

Per level l: scale = 2^(l log2 s) H - 1 (float32, computed on the host as
numpy computes it), resolution = ceil(H s^l); rows = min(2^logmap, r^3)
unless r <= dense_max_res. Levels whose r^3 fits their rows are dense
(row-major, stride r) and form a prefix; the others hash (pg + corner) with
the xor-primes (1, 2654435761, 805459861) in uint32 wraparound, then % size.
Trilinear interpolation with smoothstep-warped weights; any coordinate
outside [0, 1] gives zero features.

Three semantics live side by side, as in the JAX package (they differ only
at x01 == 1 and in rounding):
  * `hash_encode` (packed): every level's values rounded to bf16, the dense
    index mod-wrapped, no clamp. Plain PyTorch only (tests, H2's hashed
    levels). `hash_encode_packed` is the same encode with its table
    gradient (Stage 3's colour field): H2 packed forward, H1-bwd without
    the jacobian term backward, the dense cell clamped (a zero-weight
    corner apart at x01 == 1).
  * `hash_encode_fused_dual` (fused): both tables' values rounded to bf16
    at every level (fetch "packed") or read as they are (fetch "raw", JAX's
    _fused_core with fetch="raw"), the dense cell clamped to [0, r-2];
    features of tables a and b and J_a = d feats_a / d x01. Forward H1-fwd
    (csrc/hash_fused_fwd.cu), backward H1-bwd (csrc/hash_fused_bwd.cu) in
    the modes exact / sampled / sampled_all. With emb_b=None it is the
    single-table mode (features + J of table a) the eikonal jacobians use.
    interp="tetrahedral" takes JAX's _encode_core_tet stencil (4 corners,
    barycentric weights; packed fetch, exact backward): the packed
    hash_encode(interp="tetrahedral") of the vjp and jvp gradient modes.
  * `hash_encode_sampler`: the first `grid_levels` levels, dense levels
    from exact float32 rows with clamped cells, hashed levels as the packed
    encode; no gradient. H2 (csrc/hash_sampler_fwd.cu). With packed=True
    the dense levels' values are rounded to bf16 too: the packed encode
    with clamped cells, which mesh extraction evaluates its grids with
    (trilinear or, for a tetrahedral field, tetrahedral).

Each kernel wrapper launches its CUDA kernel for a CUDA tensor (and counts
the launch on itself, `fused_fwd.launches` ...) and runs its plain PyTorch
version, in this module, for a CPU tensor. There is no fallback from one to
the other.

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
MODES = ("exact", "sampled", "sampled_all")
_MODE_ID = {m: i for i, m in enumerate(MODES)}
INTERPS = ("trilinear", "tetrahedral")
FETCHES = ("packed", "raw")


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


def prefix_meta(meta: HashGridMeta, levels: int) -> HashGridMeta:
    """Meta of the first `levels` levels of `meta`, with the same scales,
    offsets and sizes (a table_rows prefix of the table serves it)."""
    return dataclasses.replace(meta, num_levels=levels,
                               desired_resolution=None)


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

    def device_arrays(self, device: torch.device):
        return _device_arrays(self, str(device))


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


@functools.lru_cache(maxsize=None)
def _device_arrays(lt: LevelTables, device: str):
    ints = np.concatenate([[lt.n_dense], lt.res, lt.sizes, lt.offsets])
    return (torch.tensor(lt.scales, dtype=torch.float32, device=device),
            torch.tensor(ints.astype(np.int32), device=device))


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


def _bf16(emb: torch.Tensor) -> torch.Tensor:
    """Values rounded to bf16 (round to nearest even), gradient straight
    through."""
    return emb + (emb.to(torch.bfloat16).float() - emb).detach()


def _oob(x01: torch.Tensor) -> torch.Tensor:
    return ((x01 < 0.0) | (x01 > 1.0)).any(-1)


# ---------------------------------------------------------------------------
# packed hash_encode (plain PyTorch only)
# ---------------------------------------------------------------------------


def hash_encode(inputs: torch.Tensor, embeddings: torch.Tensor,
                meta: HashGridMeta) -> torch.Tensor:
    """JAX hash_encode(packed=True): inputs [N, 3], embeddings [rows, 2]
    -> [N, L*2]; bf16 values at every level, dense index mod-wrapped."""
    n = inputs.shape[0]
    res, sizes, offsets = (torch.as_tensor(a.astype(np.int64),
                                           device=inputs.device)
                           for a in meta.level_tables())
    dense = res ** 3 <= sizes
    scales = torch.as_tensor(level_scales(meta), device=inputs.device)
    x_t = inputs.T
    pos = scales[:, None, None] * x_t[None]               # [L, 3, N]
    pf = torch.floor(pos)
    w = _smoothstep(pos - pf)
    pg = pf.long()
    row = torch.where(dense[:, None, None],
                      _dense_rows(pg, res, torch.zeros_like(offsets)) % sizes[:, None, None]
                      + offsets[:, None, None],
                      _hash_rows(pg, sizes, offsets))
    bits = _corner_bits(inputs.device).bool()
    ws = [torch.where(bits[None, :, d, None], w[:, None, d], 1.0 - w[:, None, d])
          for d in range(3)]
    cw = ws[0] * ws[1] * ws[2]                            # [L, 8, N]
    vals = _bf16(embeddings)[row]                         # [L, 8, N, 2]
    feats = (cw[..., None] * vals).sum(1)                 # [L, N, 2]
    feats = torch.where(_oob(inputs)[None, :, None], 0.0, feats)
    return feats.permute(1, 0, 2).reshape(n, -1)


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


def _grid_rows(cg: torch.Tensor, lt: LevelTables,
               wrap: bool = False) -> torch.Tensor:
    """Grid points cg [L, K, 3, N] int64 -> rows [L, K, N]: row-major with
    stride res on the dense levels (modulo the level's size with wrap, as
    JAX's packed encode takes it), the xor-prime hash % size on the
    others, plus the level's offset."""
    dev = cg.device
    res, sizes, offsets = (torch.as_tensor(a, device=dev)[:, None, None]
                           for a in (lt.res, lt.sizes, lt.offsets))
    ld = lt.n_dense
    rows = []
    if ld:
        c, r = cg[:ld], res[:ld]
        idx = c[:, :, 0] + r * (c[:, :, 1] + r * c[:, :, 2])
        rows.append(idx % sizes[:ld] if wrap else idx)
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


def _tet_stencil(x01: torch.Tensor, lt: LevelTables):
    """JAX's _encode_core_tet: (rows [L, 4, N], cw [L, 4, N], dcw 3 x
    [L, 4, N]). The cell is floor(pos) on every level and a dense level's
    row index wraps modulo its size, as JAX's does (the clamped cell of the
    trilinear stencil gives the same features at x01 = 1 but another,
    one-sided J: csrc/hash_grid.cuh::tet_rows). rank_d (descending order of
    the fractions; a tie puts the higher dimension first) from JAX's strict
    comparisons; vertex k adds e_d where rank_d < k; weights [1 - g0,
    g0 - g1, g1 - g2, g2] of the sorted fractions; d cw_k / d x01_d =
    scale ([rank_d == k - 1] - [rank_d == k]), piecewise constant."""
    pos = torch.as_tensor(lt.scales, device=x01.device)[:, None, None] \
        * x01.T[None]
    pf = torch.floor(pos)
    cell, f = pf.long(), pos - pf
    gt01, gt02, gt12 = f[:, 0] > f[:, 1], f[:, 0] > f[:, 2], f[:, 1] > f[:, 2]
    rank = torch.stack([(~gt01).long() + (~gt02).long(),
                        gt01.long() + (~gt12).long(),
                        gt02.long() + gt12.long()], 1)       # [L, 3, N]
    ks = torch.arange(4, device=x01.device)[None, :, None, None]
    cg = cell[:, None] + (rank[:, None] < ks).long()         # [L, 4, 3, N]
    g = torch.gather(f, 1, torch.argsort(rank, 1))            # descending
    cw = torch.stack([1.0 - g[:, 0], g[:, 0] - g[:, 1], g[:, 1] - g[:, 2],
                      g[:, 2]], 1)
    sc = torch.as_tensor(lt.scales, device=x01.device)[:, None, None]
    k4 = torch.arange(4, device=x01.device)[None, :, None]
    dcw = [torch.where(rank[:, None, d] == k4 - 1, sc, 0.0)
           - torch.where(rank[:, None, d] == k4, sc, 0.0) for d in range(3)]
    return _grid_rows(cg, lt, wrap=True), cw, dcw


def _check_interp(interp: str, fetch: str = "packed") -> None:
    if interp not in INTERPS:
        raise ValueError(f"interp must be one of {INTERPS}, got {interp!r}")
    if fetch not in FETCHES:
        raise ValueError(f"fetch must be one of {FETCHES}, got {fetch!r}")
    if interp == "tetrahedral" and fetch == "raw":
        raise ValueError("the raw fetch is the fused encode's, which is "
                         "trilinear only (JAX fields.py:527)")


def _values(emb: torch.Tensor, fetch: str) -> torch.Tensor:
    return emb.to(torch.bfloat16).float() if fetch == "packed" else emb


def fused_fwd_plain(x01, emb_a, emb_b, lt: LevelTables,
                    interp: str = "trilinear", fetch: str = "packed"):
    """H1-fwd's plain version: (feats_a [N, L*2], J_a [L*2, 3, N],
    feats_b [N, L*2] or None)."""
    _check_interp(interp, fetch)
    n, L = x01.shape[0], lt.n_levels
    if interp == "tetrahedral":
        rows, cw, dcw = _tet_stencil(x01, lt)
    else:
        rows, frac = _fused_rows_frac(x01, lt)
        _, cw, dcw, _, _ = _fused_weights(
            frac, torch.as_tensor(lt.scales, device=x01.device))
    valid = (~_oob(x01)).float()
    va = _values(emb_a, fetch)[rows]                      # [L, K, N, 2]
    fa = torch.stack([(cw * va[..., c]).sum(1) * valid for c in (0, 1)], 1)
    J = torch.stack([torch.stack([(dcw[d] * va[..., c]).sum(1) * valid
                                  for d in range(3)], 1) for c in (0, 1)], 1)
    fb = None
    if emb_b is not None:
        vb = _values(emb_b, fetch)[rows]
        fb = torch.stack([(cw * vb[..., c]).sum(1) * valid for c in (0, 1)], 1)
        fb = fb.reshape(L * 2, n).T.contiguous()
    return fa.reshape(L * 2, n).T.contiguous(), J.reshape(L * 2, 3, n), fb


def fixed_point(ct_fa, ct_J, ct_fb, lt: LevelTables, mode: str):
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
    extra = torch.tensor([[4 if mode == "sampled_all" else 0], [0]],
                         device=dev)
    e = torch.clamp(62 - clog2 - x - extra, -126, 126).to(torch.float64)
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


def fused_bwd_plain(x01, n_rows, ct_fa, ct_J, ct_fb, lt: LevelTables,
                    mode: str, u_b=None, u_a=None, emb_a=None, emb_b=None,
                    need_x=False, interp: str = "trilinear",
                    fetch: str = "packed"):
    """H1-bwd's plain version: (grad_a [n_rows, 2], grad_b [n_rows, 2] or
    None, ct_x01 [N, 3] or None). The fused per-corner cotangent of table a
    is cw ct_f + sum_d dcw_d ct_J[d] (cw ct_f with ct_J None: no jacobian
    term); table b's is cw ct_f. They are summed as the kernel sums them:
    in fixed point (fixed_point), int64 index_add_, the same conversion, so
    any order of the points gives the same bits. Dense levels
    scatter every corner in every mode; hashed levels follow `mode`
    (JAX hashgrid.py _hash_fused_bwd; the tetrahedral stencil in exact mode
    only). need_x also returns the cotangent of x01 from the gathered
    values (emb_a / emb_b needed, fetched as `fetch` fetches them)."""
    _check_interp(interp, fetch)
    if interp == "tetrahedral":
        if mode != "exact":
            raise ValueError("the tetrahedral stencil's backward is exact "
                             "only (JAX samples the fused trilinear one)")
        return _tet_bwd_plain(x01, n_rows, ct_fa, ct_J, ct_fb, lt, emb_a,
                              emb_b, need_x)
    n, L, ld = x01.shape[0], lt.n_levels, lt.n_dense
    scales = torch.as_tensor(lt.scales, device=x01.device)
    rows, frac = _fused_rows_frac(x01, lt)
    ws, cw, dcw, dws, dds = _fused_weights(frac, scales)
    valid = (~_oob(x01)).float()
    has_b = ct_fb is not None
    cfa = ct_fa.T.reshape(L, 2, n) * valid
    if ct_J is None:
        ca = [cw * cfa[:, c, None] for c in (0, 1)]
    else:
        cJa = ct_J.reshape(L, 2, 3, n) * valid
        ca = [cw * cfa[:, c, None] + sum(dcw[d] * cJa[:, c, d, None]
                                         for d in range(3)) for c in (0, 1)]
    scale, inv = fixed_point(ct_fa, ct_J, ct_fb, lt, mode)
    pa, pb = scale[0][:, None, None], scale[1][:, None, None]
    ga = torch.zeros(n_rows * 2, dtype=torch.int64, device=x01.device)
    gb = torch.zeros_like(ga) if has_b else None
    if has_b:
        cfb = ct_fb.T.reshape(L, 2, n) * valid
        cb = [cw * cfb[:, c, None] for c in (0, 1)]
    # every corner: dense levels always, hashed levels of table a unless
    # sampled_all and of table b only in exact mode
    a_to = ld if mode == "sampled_all" else L
    _scatter(ga, rows[:a_to], [c[:a_to] for c in ca], pa[:a_to])
    if has_b:
        b_to = L if mode == "exact" else ld
        _scatter(gb, rows[:b_to], [c[:b_to] for c in cb], pb[:b_to])
    if mode != "exact" and lt.n_hashed:
        rh = rows[ld:]
        if has_b:
            # one corner a (hashed level, point), drawn with probability
            # its trilinear weight: the scattered value is the bare
            # feature cotangent
            wh = _smoothstep(frac[ld:])
            ksel = sum((u_b[d] < wh[:, d]).long() << d for d in range(3))
            rs = torch.gather(rh, 1, ksel[:, None])[:, 0]
            _scatter(gb, rs, [cfb[ld:, 0], cfb[ld:, 1]], pb[ld:, 0])
        if mode == "sampled_all":
            # one corner drawn ~ |ca0| + |ca1|, scaled by S / s_k
            ch = [c[ld:] for c in ca]
            s = ch[0].abs() + ch[1].abs()
            cum = torch.cumsum(s, 1)
            S = cum[:, -1]
            u2 = u_a * S
            ksel = torch.clamp((u2[:, None] >= cum).sum(1), max=7)
            s_k = torch.gather(s, 1, ksel[:, None])[:, 0]
            ratio = torch.where(s_k > 0.0, S / torch.clamp(s_k, min=1e-30),
                                0.0)
            rs = torch.gather(rh, 1, ksel[:, None])[:, 0]
            _scatter(ga, rs, [torch.gather(c, 1, ksel[:, None])[:, 0] * ratio
                              for c in ch], pa[ld:, 0])
    ct_x = None
    if need_x:
        va = _values(emb_a, fetch)[rows]
        v_dot_f = va[..., 0] * cfa[:, 0, None] + va[..., 1] * cfa[:, 1, None]
        if has_b:
            vb = _values(emb_b, fetch)[rows]
            v_dot_f = v_dot_f + vb[..., 0] * cfb[:, 0, None] \
                + vb[..., 1] * cfb[:, 1, None]
        v_dot_J = [va[..., 0] * cJa[:, 0, e, None] + va[..., 1] * cJa[:, 1, e, None]
                   for e in range(3)]
        sc2 = (scales * scales)[:, None, None]
        cols = []
        for d in range(3):
            o = [e for e in range(3) if e != d]
            acc = v_dot_f * dcw[d] + v_dot_J[d] * (sc2 * dds[d] * ws[o[0]]
                                                   * ws[o[1]])
            for e in o:
                third = 3 - d - e
                acc = acc + v_dot_J[e] * (sc2 * dws[d] * dws[e] * ws[third])
            cols.append(acc.sum((0, 1)))
        ct_x = torch.stack(cols, -1)
    return (_from_fixed(ga, inv[0], lt, n_rows),
            _from_fixed(gb, inv[1], lt, n_rows) if has_b else None, ct_x)


def _tet_bwd_plain(x01, n_rows, ct_fa, ct_J, ct_fb, lt: LevelTables,
                   emb_a=None, emb_b=None, need_x=False):
    """fused_bwd_plain of the tetrahedral stencil, exact mode: every corner
    of both tables. Its weights are linear in x01 and J piecewise constant,
    so the points' cotangent has no term through J."""
    n, L = x01.shape[0], lt.n_levels
    rows, cw, dcw = _tet_stencil(x01, lt)
    valid = (~_oob(x01)).float()
    cfa = ct_fa.T.reshape(L, 2, n) * valid
    if ct_J is None:
        ca = [cw * cfa[:, c, None] for c in (0, 1)]
    else:
        cJa = ct_J.reshape(L, 2, 3, n) * valid
        ca = [cw * cfa[:, c, None] + sum(dcw[d] * cJa[:, c, d, None]
                                         for d in range(3)) for c in (0, 1)]
    scale, inv = fixed_point(ct_fa, ct_J, ct_fb, lt, "exact")
    ga = torch.zeros(n_rows * 2, dtype=torch.int64, device=x01.device)
    _scatter(ga, rows, ca, scale[0][:, None, None])
    gb = None
    if ct_fb is not None:
        cfb = ct_fb.T.reshape(L, 2, n) * valid
        gb = torch.zeros_like(ga)
        _scatter(gb, rows, [cw * cfb[:, c, None] for c in (0, 1)],
                 scale[1][:, None, None])
    ct_x = None
    if need_x:
        va = _values(emb_a, "packed")[rows]
        v_dot_f = va[..., 0] * cfa[:, 0, None] + va[..., 1] * cfa[:, 1, None]
        if ct_fb is not None:
            vb = _values(emb_b, "packed")[rows]
            v_dot_f = v_dot_f + vb[..., 0] * cfb[:, 0, None] \
                + vb[..., 1] * cfb[:, 1, None]
        ct_x = torch.stack([(v_dot_f * dcw[d]).sum((0, 1)) for d in range(3)],
                           -1)
    return (_from_fixed(ga, inv[0], lt, n_rows),
            _from_fixed(gb, inv[1], lt, n_rows) if gb is not None else None,
            ct_x)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def near_flip_pairs(x01, lt: LevelTables, ct_fa, ct_J, u_b, u_a,
                    mode: str) -> torch.Tensor:
    """[Lh, N] bool: the (hashed level, point) pairs whose sampled corner
    can differ between two correct implementations in the last bit (a
    uniform within 1e-6 of a weight, or for sampled_all of a running sum,
    relative to the total). Comparisons of sampled backwards zero these
    pairs' cotangents on both sides."""
    n, L, ld = x01.shape[0], lt.n_levels, lt.n_dense
    _, frac = _fused_rows_frac(x01, lt)
    w = _smoothstep(frac[ld:]).permute(1, 0, 2)
    near = ((u_b - w).abs() < 1e-6).any(0)
    if mode == "sampled_all":
        _, cw, dcw, _, _ = _fused_weights(
            frac, torch.as_tensor(lt.scales, device=x01.device))
        cfa = ct_fa.T.reshape(L, 2, n)
        cJa = ct_J.reshape(L, 2, 3, n)
        s = sum((cw * cfa[:, c, None] + sum(dcw[d] * cJa[:, c, d, None]
                                            for d in range(3))).abs()
                for c in (0, 1))[ld:]
        cum = torch.cumsum(s, 1)
        near |= ((u_a * cum[:, -1])[:, None] - cum).abs().lt(
            1e-6 * cum[:, -1:]).any(1)
    return near


def _check(name, t, shape=None, dtype=torch.float32, device=None):
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous {dtype} tensor, got "
                         f"{t.dtype} contiguous={t.is_contiguous()}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def fused_fwd(x01, emb_a, emb_b, lt: LevelTables,
              interp: str = "trilinear", fetch: str = "packed"):
    """H1-fwd. CUDA tensors: launches `hash_fused_fwd` of
    csrc/hash_fused_fwd.cu (a block a tile of 32 points x all levels; the
    instantiation of `interp` and `fetch`) and counts it in
    `fused_fwd.launches` and in `variant_launches`; CPU tensors:
    fused_fwd_plain."""
    _check_interp(interp, fetch)
    if not x01.is_cuda:
        return fused_fwd_plain(x01, emb_a, emb_b, lt, interp, fetch)
    from holoscene_tpu_torch import kernels

    n, L, dev = x01.shape[0], lt.n_levels, x01.device
    _check("x01", x01, (n, 3))
    rows = emb_a.shape[0]
    _check("emb_a", emb_a, (rows, 2), device=dev)
    if emb_b is not None:
        _check("emb_b", emb_b, (rows, 2), device=dev)
    if int(lt.offsets[-1] + lt.sizes[-1]) > rows:
        raise ValueError(f"tables of {rows} rows, levels need "
                         f"{int(lt.offsets[-1] + lt.sizes[-1])}")
    fa = torch.empty(n, L * 2, device=dev)
    J = torch.empty(L * 2, 3, n, device=dev)
    fb = torch.empty(n, L * 2, device=dev) if emb_b is not None else None
    if n:
        scales, ints = lt.device_arrays(dev)
        st = kernels.library().hash_fused_fwd(
            x01.data_ptr(), emb_a.data_ptr(), _ptr(emb_b), scales.data_ptr(),
            ints.data_ptr(), fa.data_ptr(), J.data_ptr(), _ptr(fb), n, L,
            INTERPS.index(interp), FETCHES.index(fetch),
            torch.cuda.current_stream(dev).cuda_stream)
        kernels.check(st, "hash_fused_fwd")
        fused_fwd.launches += 1
        _count("fused_fwd", (interp, fetch))
    return fa, J, fb


# Launches by kernel instantiation: {(wrapper name, instantiation key):
# count}, the keys (interp, fetch) of fused_fwd, (interp, mode) of
# fused_bwd and (interp, packed) of sampler_fwd. A module dict rather than
# an attribute of the wrapper, so that it survives a caller's wrapping of
# the wrapper; the totals stay on the wrappers (`.launches`).
variant_launches: dict = {}


def _count(name: str, key) -> None:
    variant_launches[name, key] = variant_launches.get((name, key), 0) + 1


def reset_variant_counts() -> None:
    variant_launches.clear()


fused_fwd.launches = 0


def fused_bwd(x01, n_rows, ct_fa, ct_J, ct_fb, lt: LevelTables, mode: str,
              u_b=None, u_a=None, interp: str = "trilinear"):
    """H1-bwd. CUDA tensors: launches `hash_fused_bwd` of
    csrc/hash_fused_bwd.cu (the cotangents' maxima, then point tiles with
    warp-aggregated int64 atomics into a zero-filled fixed-point buffer,
    then its conversion to the float32 [n_rows, 2] grads; the
    instantiation of `interp`) and counts it in `fused_bwd.launches` and
    in `variant_launches`; CPU tensors: fused_bwd_plain. Either gives the
    same bits for any order of the points. ct_J None: no jacobian term
    (the packed encode's transpose). Returns (grad_a, grad_b or None)."""
    _check_interp(interp)
    if interp == "tetrahedral" and mode != "exact":
        raise ValueError("the tetrahedral stencil's backward is exact only")
    if not x01.is_cuda:
        return fused_bwd_plain(x01, n_rows, ct_fa, ct_J, ct_fb, lt, mode,
                               u_b, u_a, interp=interp)[:2]
    from holoscene_tpu_torch import kernels

    n, L, dev = x01.shape[0], lt.n_levels, x01.device
    lh = lt.n_hashed
    _check("x01", x01, (n, 3))
    _check("ct_fa", ct_fa, (n, L * 2), device=dev)
    if ct_J is not None:
        _check("ct_J", ct_J, (L * 2, 3, n), device=dev)
    if ct_fb is not None:
        _check("ct_fb", ct_fb, (n, L * 2), device=dev)
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    if mode != "exact":
        if ct_fb is None:
            raise ValueError("sampled modes need table b")
        _check("u_b", u_b, (3, lh, n), device=dev)
    if mode == "sampled_all":
        _check("u_a", u_a, (lh, n), device=dev)
    tables = 2 if ct_fb is not None else 1
    if not n:
        return (torch.zeros(n_rows, 2, device=dev),
                torch.zeros(n_rows, 2, device=dev) if tables == 2 else None)
    # the fixed-point sums of each table, then the cotangents' maxima (3 L
    # uint32), zero-filled in one allocation
    acc = torch.zeros(tables * n_rows * 2 + (3 * L + 1) // 2,
                      dtype=torch.int64, device=dev)
    ga = torch.empty(n_rows, 2, device=dev)
    gb = torch.empty(n_rows, 2, device=dev) if tables == 2 else None
    scales, ints = lt.device_arrays(dev)
    st = kernels.library().hash_fused_bwd(
        x01.data_ptr(), ct_fa.data_ptr(), _ptr(ct_J), _ptr(ct_fb),
        _ptr(u_b) if mode != "exact" else 0,
        _ptr(u_a) if mode == "sampled_all" else 0,
        scales.data_ptr(), ints.data_ptr(), acc.data_ptr(), ga.data_ptr(),
        _ptr(gb), n, n_rows, L, _MODE_ID[mode], INTERPS.index(interp),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(st, "hash_fused_bwd")
    fused_bwd.launches += 1
    _count("fused_bwd", (interp, mode))
    return ga, gb


fused_bwd.launches = 0


class _FusedEncode(torch.autograd.Function):
    """hash_encode_fused_dual as an autograd Function: forward H1-fwd,
    backward H1-bwd. The points' cotangent is only computed on the CPU
    (training points are leaves); on the card asking for it raises."""

    @staticmethod
    def forward(ctx, x01, emb_a, emb_b, lt, mode, u_b, u_a, interp, fetch):
        fa, J, fb = fused_fwd(x01, emb_a, emb_b, lt, interp, fetch)
        ctx.lt, ctx.mode, ctx.has_b = lt, mode, emb_b is not None
        ctx.interp, ctx.fetch = interp, fetch
        ctx.save_for_backward(x01, emb_a, emb_b, u_b, u_a)
        return (fa, J, fb) if emb_b is not None else (fa, J)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct_fa, ct_J, ct_fb=None):
        x01, emb_a, emb_b, u_b, u_a = ctx.saved_tensors
        cts = (ct_fa.contiguous(), ct_J.contiguous(),
               ct_fb.contiguous() if ctx.has_b else None)
        ct_x = None
        if ctx.needs_input_grad[0]:
            if x01.is_cuda:
                raise NotImplementedError(
                    "hash_encode_fused_dual: the cotangent of the points is "
                    "not computed on the card (training points are leaves)")
            ct_x = fused_bwd_plain(x01, emb_a.shape[0], *cts, ctx.lt,
                                   ctx.mode, u_b, u_a, emb_a, emb_b, True,
                                   ctx.interp, ctx.fetch)[2]
        ga, gb = fused_bwd(x01, emb_a.shape[0], *cts, ctx.lt, ctx.mode, u_b,
                           u_a, ctx.interp)
        return ct_x, ga, gb, None, None, None, None, None, None


def hash_encode_fused_dual(x01, emb_a, emb_b, meta: HashGridMeta,
                           levels: int | None = None, mode: str = "exact",
                           u_b=None, u_a=None, interp: str = "trilinear",
                           fetch: str = "packed"):
    """Dual-table encode + analytic jacobian of table a (fused semantics;
    fetch "packed" rounds the values to bf16, "raw" reads them as they are;
    interp "tetrahedral" takes the 4-corner stencil, exact mode only).
    x01 [N, 3]; emb_a / emb_b [rows, 2] (the full tables:
    `levels` < L encodes the coarse prefix, as JAX's prefix_meta with a
    table_rows slice does, and the gradients land in the same rows).

    Returns (feats_a [N, levels*2], J_a [levels*2, 3, N], feats_b
    [N, levels*2]); with emb_b=None the single-table mode returns
    (feats_a, J_a). mode picks H1-bwd's hashed-level scatter: "exact",
    "sampled" (table b: one corner per (level, point) chosen by the
    per-dimension Bernoulli u_b[d] < w_d) or "sampled_all" (also table a:
    one corner drawn ~ |ca0| + |ca1| against u_a * S, weighted S / s_k).
    The draws are arguments: u_b [3, Lh, N], u_a [Lh, N] uniforms, Lh the
    hashed levels among `levels`."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    _check_interp(interp, fetch)
    if mode != "exact" and (interp != "trilinear" or fetch != "packed"):
        raise ValueError("the sampled backward needs the trilinear, packed "
                         "encode (JAX fields.py:532)")
    lt = level_tables(meta, levels)
    n = x01.shape[0]
    if mode != "exact":
        if emb_b is None:
            raise ValueError("the sampled modes need table b")
        if u_b is None or tuple(u_b.shape) != (3, lt.n_hashed, n):
            raise ValueError(f"mode {mode!r} needs u_b [3, {lt.n_hashed}, "
                             f"{n}]")
    if mode == "sampled_all" and (u_a is None or tuple(u_a.shape)
                                  != (lt.n_hashed, n)):
        raise ValueError(f"sampled_all needs u_a [{lt.n_hashed}, {n}]")
    if mode != "sampled_all":
        u_a = None
    if mode == "exact":
        u_b = None
    return _FusedEncode.apply(x01.contiguous(), emb_a, emb_b, lt, mode, u_b,
                              u_a, interp, fetch)


# ---------------------------------------------------------------------------
# sampler encode (H2)
# ---------------------------------------------------------------------------


def sampler_fwd_plain(x01, emb, lt: LevelTables, packed: bool = False,
                      interp: str = "trilinear") -> torch.Tensor:
    """H2's plain version: [N, L*2] for the first L = lt.n_levels levels;
    dense levels exact float32 (bf16 when packed) with clamped cells,
    hashed levels bf16 with the wrapped hash; out-of-range points zero.
    interp "tetrahedral" (packed only): fused_fwd_plain's features of the
    tetrahedral stencil, table a alone."""
    _check_sampler_interp(interp, packed)
    if interp == "tetrahedral":
        return fused_fwd_plain(x01, emb, None, lt, interp)[0]
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
            vals = (emb.to(torch.bfloat16).float() if packed else emb)[rows]
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


def _check_sampler_interp(interp: str, packed: bool) -> None:
    _check_interp(interp)
    if interp == "tetrahedral" and not packed:
        raise ValueError("H2 takes the tetrahedral stencil in its packed "
                         "mode only (the sampler's probes stay trilinear, "
                         "as JAX's do)")


def sampler_fwd(x01, emb, lt: LevelTables, packed: bool = False,
                interp: str = "trilinear") -> torch.Tensor:
    """H2. CUDA tensors: launches `hash_sampler_fwd` of
    csrc/hash_sampler_fwd.cu (a thread a point, the levels in groups of 4
    staged in shared memory; the instantiation of `interp`) and counts it
    in `sampler_fwd.launches` and in `variant_launches`; CPU tensors:
    sampler_fwd_plain."""
    _check_sampler_interp(interp, packed)
    if not x01.is_cuda:
        return sampler_fwd_plain(x01, emb, lt, packed, interp)
    from holoscene_tpu_torch import kernels

    n, L, dev = x01.shape[0], lt.n_levels, x01.device
    _check("x01", x01, (n, 3))
    _check("emb", emb, (emb.shape[0], 2), device=dev)
    out = torch.empty(n, L * 2, device=dev)
    if n:
        scales, ints = lt.device_arrays(dev)
        st = kernels.library().hash_sampler_fwd(
            x01.data_ptr(), emb.data_ptr(), scales.data_ptr(), ints.data_ptr(),
            out.data_ptr(), n, L, int(packed), INTERPS.index(interp),
            torch.cuda.current_stream(dev).cuda_stream)
        kernels.check(st, "hash_sampler_fwd")
        sampler_fwd.launches += 1
        _count("sampler_fwd", (interp, bool(packed)))
    return out


sampler_fwd.launches = 0


class _PackedEncode(torch.autograd.Function):
    """The packed encode with its table gradient: forward H2 in its packed
    mode over every level, backward H1-bwd exact with one table and no
    jacobian cotangent. The points carry no gradient."""

    @staticmethod
    def forward(ctx, x01, emb, lt):
        ctx.lt = lt
        ctx.save_for_backward(x01)
        ctx.n_rows = emb.shape[0]
        return sampler_fwd(x01, emb.detach(), lt, True)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        (x01,) = ctx.saved_tensors
        if ctx.needs_input_grad[0]:
            raise NotImplementedError(
                "hash_encode_packed: the points carry no gradient")
        ga, _ = fused_bwd(x01, ctx.n_rows, ct.contiguous(), None, None,
                          ctx.lt, "exact")
        return None, ga, None


def hash_encode_packed(x01, emb, meta: HashGridMeta) -> torch.Tensor:
    """JAX hash_encode(packed=True) (holoscene_tpu/ops/hashgrid.py:407)
    with the table gradient of its packed-pair gather (`gather_pairs`'
    transpose: straight through the bf16 rounding): x01 [N, 3], emb
    [rows, 2] -> [N, L*2]. The packed encode wraps a dense level's row
    where H2 and H1-bwd clamp the cell; they name different rows only at
    x01 = 1 on a level of integer scale, where that corner's weight is 0,
    so the features are equal and the gradient adds 0 to another row."""
    return _PackedEncode.apply(x01.contiguous(), emb,
                               level_tables(meta))


def hash_encode_world(x, embeddings, meta: HashGridMeta,
                      size: float = 1.0) -> torch.Tensor:
    """JAX hash_encode_world (reference HashEncoder.forward,
    hashgrid.py:154-158): world points x [N, 3] in [-size, size] mapped to
    [0, 1], then the packed encode with its table gradient
    (hash_encode_packed: H2 forward, H1-bwd backward)."""
    return hash_encode_packed((x + size) / (2.0 * size), embeddings, meta)


def hash_encode_sampler(inputs, embeddings, meta: HashGridMeta,
                        grid_levels: int | None = None,
                        packed: bool = False,
                        interp: str = "trilinear") -> torch.Tensor:
    """SDF-probe encode of the error-bound sampler, no gradient: [N,
    grid_levels*2] (the caller zero-pads the fine levels); packed rounds
    the dense levels' values to bf16 as well (and may take the tetrahedral
    stencil: a tetrahedral field's grid evaluation)."""
    lt = level_tables(meta, grid_levels)
    with torch.no_grad():
        return sampler_fwd(inputs.contiguous(), embeddings.detach(), lt,
                           packed, interp)
