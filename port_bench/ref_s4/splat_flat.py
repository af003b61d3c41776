# Frozen copy of holoscene_tpu_torch/ops/splat_flat.py at commit badb067, for the
# benchmark's plain reference: imports rewired to port_bench.ref_s4, cut to
# the paths the benchmark's Stage-4 configuration runs, in plain PyTorch.
# Do not edit to follow the port.
"""Flat sorted-candidate gaussian splat pipeline: binning + the K1/K2
tile-walk kernels (port of holoscene_tpu/ops/splat_flat.py).

Binning (plain PyTorch): every gaussian expands over the tiles its
{alpha >= 1/255} footprint can reach, an exact anisotropic bound culls the
tiles it cannot, ONE sort by a fused (tile, quantized depth) key orders the
survivors, and each tile's run is padded to whole 128-candidate chunks in a
flat slot array. The per-tile chunk ranges (`tile_chunk_start`,
`tile_chunk_cnt`) are all the walk kernels need.

Compositing: the candidate payload is gathered ONCE as row-major
[c_max, 16] rows (x y conic_a conic_b conic_c opacity r g b depth 1 pad*5)
through `_PlannedTake`, whose backward is

  H4 `planned_take_bwd` — the gather's transpose, each payload row's
      cotangent summed over its slots in a fixed order through the plan
      (`perm`, `bounds`) that build_flat_bins keeps beside the bins
      (csrc/planned_take_bwd.cu),

and handed to

  K1 `flat_fwd` — per tile, a front-to-back walk over its chunks with
      per-tile chunk-granular early termination (csrc/splat_flat_fwd.cu),
  K2 `flat_bwd` — the reverse walk over exactly the chunks K1 used, in
      closed form (csrc/splat_flat_bwd.cu),

joined by the autograd Function `_FlatWalk`. Each wrapper launches its CUDA
kernel for a CUDA tensor and runs its plain PyTorch version (`*_plain`, same
semantics, vectorised over tiles; H4's adds in the kernel's order) for a CPU
tensor. There is no fallback from one to the other.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

CHUNK = 128          # candidates per walk step
CAND_ROWS = 16       # payload row width (11 live columns + pad)
GRAD_ROWS = 10       # payload columns K2 writes (x..depth); rest stay zero
BWD_COLS = 11        # payload columns H4 sums (JAX's bwd_cols); rest zero
TERM_EPS = 1e-4      # tile saturation threshold
ALPHA_EPS = 1.0 / 255.0
# slack of the forward walk's per-warp test (warp_may_keep_plain), in units
# of d^T conic d: absolute, and relative to the size of its terms
CUT_MARGIN, CUT_MARGIN_REL = 1e-3, 1e-5
DRIFT_STRIDE = 16    # xy_snap sub-sampling (build_flat_bins)


@dataclass(frozen=True)
class FlatPlan:
    """Capacity plan: tile span per gaussian + flat candidate capacity."""

    span_x: int      # max tiles a gaussian may cover along x
    span_y: int
    c_max: int       # flat candidate capacity (multiple of CHUNK)

    def __post_init__(self):
        if self.c_max % CHUNK or self.span_x < 1 or self.span_y < 1:
            raise ValueError(f"bad FlatPlan {self}")


# ---------------------------------------------------------------------------
# candidate expansion + binning
# ---------------------------------------------------------------------------


def _alpha_extents(conic, opac):
    """Per-axis half-extents of the {alpha >= 1/255} ellipse q(d) <= thr,
    thr = 2 ln(255 op), from cov = conic^{-1}."""
    a, b, c = conic[:, 0], conic[:, 1], conic[:, 2]
    det = torch.clamp(a * c - b * b, min=1e-12)
    thr = 2.0 * torch.log(torch.clamp(opac, min=1e-6) * 255.0)
    thr = torch.clamp(thr, min=0.0)
    wx = torch.sqrt(thr * c / det)
    wy = torch.sqrt(thr * a / det)
    return wx, wy, thr


def _schur_qmin(conic, dxm, dym):
    """Lower bound on min over a tile rect of d^T conic d (Schur
    complements per axis); culling on it never drops a contributor."""
    a, b, c = conic[:, 0], conic[:, 1], conic[:, 2]
    sx = torch.clamp(a - b * b / torch.clamp(c, min=1e-12), min=0.0)
    sy = torch.clamp(c - b * b / torch.clamp(a, min=1e-12), min=0.0)
    return torch.maximum(sx[:, None] * dxm * dxm, sy[:, None] * dym * dym)


def _propagate(values, positions, c_max, fill=0):
    """out[p] = values[t] for the largest t with positions[t] <= p (values
    non-decreasing in t). Out-of-range positions are dropped."""
    base = torch.full((c_max,), fill, dtype=values.dtype,
                      device=values.device)
    ok = (positions >= 0) & (positions < c_max)
    base = base.scatter_reduce(0, positions[ok], values[ok], reduce="amax")
    return torch.cummax(base, 0).values


def _tile_spans(xy, conic, opac, tiles_x, tiles_y, ts):
    wx, wy, thr = _alpha_extents(conic, opac)
    tx_lo = torch.clamp(torch.floor((xy[:, 0] - wx) / ts), 0, tiles_x - 1)
    tx_hi = torch.clamp(torch.floor((xy[:, 0] + wx) / ts), 0, tiles_x - 1)
    ty_lo = torch.clamp(torch.floor((xy[:, 1] - wy) / ts), 0, tiles_y - 1)
    ty_hi = torch.clamp(torch.floor((xy[:, 1] + wy) / ts), 0, tiles_y - 1)
    return tx_lo, tx_hi, ty_lo, ty_hi, thr


def _expand_keep(xy, conic, opac, valid, tiles_x, tiles_y, tile_size,
                 span_x, span_y):
    """Per (gaussian, span offset) candidate: (tile id [N,S] int64,
    keep [N,S] bool) after the span clamp and the Schur-bound cull."""
    ts = float(tile_size)
    tx_lo, tx_hi, ty_lo, ty_hi, thr = _tile_spans(
        xy, conic, opac, tiles_x, tiles_y, ts)
    tx_lo, tx_hi = tx_lo.long(), tx_hi.long()
    ty_lo, ty_hi = ty_lo.long(), ty_hi.long()
    # spans wider than the plan are clamped (footprint corners dropped)
    tx_hi = torch.minimum(tx_hi, tx_lo + span_x - 1)
    ty_hi = torch.minimum(ty_hi, ty_lo + span_y - 1)
    off = torch.arange(span_x * span_y, device=xy.device)
    tx = tx_lo[:, None] + (off % span_x)[None, :]          # [N, S]
    ty = ty_lo[:, None] + (off // span_x)[None, :]
    in_span = (tx <= tx_hi[:, None]) & (ty <= ty_hi[:, None])
    rx0 = tx.float() * ts
    ry0 = ty.float() * ts
    dxm = torch.clamp(torch.maximum(rx0 - xy[:, 0:1], xy[:, 0:1] - (rx0 + ts)),
                      min=0.0)
    dym = torch.clamp(torch.maximum(ry0 - xy[:, 1:2], xy[:, 1:2] - (ry0 + ts)),
                      min=0.0)
    q_lb = _schur_qmin(conic, dxm, dym)
    v = valid & (opac >= ALPHA_EPS)
    keep = in_span & v[:, None] & (q_lb <= thr[:, None])
    return ty * tiles_x + tx, keep


@torch.no_grad()
def build_flat_candidates(
    xy, depth, conic, opac, valid,
    tiles_x: int, tiles_y: int, tile_size: int, plan: FlatPlan,
    used_chunks=None, trim_slack: int = 2,
):
    """Expansion -> cull -> fused-key sort -> chunk-aligned compaction.

    Returns dict with
      gidx [c_max] int64 — gaussian index per flat slot (N = trash row)
      tile_chunk_start / tile_chunk_cnt [T] int32 — each tile's chunk range
      trimmed [T] int32 — tiles whose tail was saturation-trimmed
      overflow [] int32 — 1 if the scene needed more than c_max slots
    used_chunks [T] (optional): a prior walk's per-tile chunk counts; each
    tile then keeps only its front-most (used + trim_slack) chunks."""
    n = xy.shape[0]
    dev = xy.device
    n_tiles = tiles_x * tiles_y
    c_max = plan.c_max

    # depth-quantization bits for the fused sort key (i32 range, as JAX)
    bits = 0
    while ((n_tiles + 1) << (bits + 1)) <= 2**31 - 1 and bits < 20:
        bits += 1
    if bits < 10:
        raise ValueError(f"too many tiles for fused i32 keys: {n_tiles}")
    dq_max = (1 << bits) - 2  # top code reserved for per-tile dummies

    xy, depth, conic, opac = (x.detach() for x in (xy, depth, conic, opac))
    tile_id, keep = _expand_keep(xy, conic, opac, valid, tiles_x, tiles_y,
                                 tile_size, plan.span_x, plan.span_y)
    v = valid & (opac >= ALPHA_EPS)
    inf = torch.tensor(float("inf"), device=dev)
    dmin = torch.min(torch.where(v, depth, inf))
    dmax = torch.max(torch.where(v, depth, -inf))
    dq = torch.clamp((depth - dmin) / torch.clamp(dmax - dmin, min=1e-9)
                     * dq_max, 0, dq_max).to(torch.int64)

    key = torch.where(keep, (tile_id << bits) | dq[:, None],
                      torch.full_like(tile_id, n_tiles << bits)).reshape(-1)
    s_tot = tile_id.shape[1]
    gidx = torch.arange(n, device=dev).repeat_interleave(s_tot)
    # one dummy per tile keeps every tile's range non-empty (empty tiles
    # still write alpha=0); it sorts to the back of its tile
    t_ids = torch.arange(n_tiles, device=dev)
    key = torch.cat([key, (t_ids << bits) | (dq_max + 1)])
    gidx = torch.cat([gidx, torch.full((n_tiles,), n, device=dev)])
    skey, order = torch.sort(key, stable=True)
    sgidx = gidx[order]

    starts = torch.searchsorted(
        skey, torch.arange(n_tiles + 1, device=dev) << bits)
    counts = starts[1:] - starts[:-1]                      # [T] >= 1
    if used_chunks is not None:
        cap = (torch.as_tensor(used_chunks, device=dev).long()
               + trim_slack) * CHUNK
        trimmed = (counts > cap).int()
        counts = torch.minimum(counts, torch.clamp(cap, min=1))
    else:
        trimmed = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    aligned = -(-counts // CHUNK) * CHUNK
    aoff = F.pad(torch.cumsum(aligned, 0), (1, 0))
    overflow = (aoff[n_tiles] > c_max).int()

    pos_t = torch.clamp(aoff[:n_tiles], 0, c_max - 1)
    aoff_p = _propagate(aoff[:n_tiles], pos_t, c_max)
    roff_p = _propagate(starts[:n_tiles], pos_t, c_max)
    rend_p = _propagate(starts[:n_tiles] + counts, pos_t, c_max)
    src = roff_p + (torch.arange(c_max, device=dev) - aoff_p)
    live = src < rend_p
    gidx_flat = torch.where(
        live, sgidx[torch.clamp(src, max=skey.shape[0] - 1)],
        torch.full_like(src, n))

    # per-tile chunk ranges; tiles spilling past c_max are clamped to empty
    start_c = torch.clamp(aoff[:n_tiles] // CHUNK, max=c_max // CHUNK)
    end_c = torch.clamp(aoff[1:] // CHUNK, max=c_max // CHUNK)
    return dict(
        gidx=gidx_flat, overflow=overflow, trimmed=trimmed,
        tile_chunk_start=start_c.int(),
        tile_chunk_cnt=torch.clamp(end_c - start_c, min=0).int(),
    )


def _plan_counts(xy, conic, opac, valid, tiles_x, tiles_y, tile_size,
                 span_x, span_y):
    """Per-tile candidate counts mirroring build_flat_candidates' keep."""
    tile_id, keep = _expand_keep(xy, conic, opac, valid, tiles_x, tiles_y,
                                 tile_size, span_x, span_y)
    n_tiles = tiles_x * tiles_y
    tile_id = torch.where(keep, tile_id, torch.full_like(tile_id, n_tiles))
    return torch.bincount(tile_id.reshape(-1), minlength=n_tiles + 1)[:-1]


@torch.no_grad()
def plan_flat(xy, conic, opac, valid, tiles_x, tiles_y, tile_size,
              margin: float = 1.3, span_cap: int = 8) -> FlatPlan:
    """Probe a projected scene and derive the FlatPlan: the span covers
    every gaussian up to span_cap tiles per axis; c_max = margin x the
    chunk-aligned candidate total (+1 per tile for its dummy)."""
    tx_lo, tx_hi, ty_lo, ty_hi, _ = _tile_spans(
        xy, conic, opac, tiles_x, tiles_y, float(tile_size))
    one = torch.ones_like(tx_lo)
    span_x = int(min(span_cap, max(1, int(torch.max(torch.where(
        valid, tx_hi - tx_lo + 1, one))))))
    span_y = int(min(span_cap, max(1, int(torch.max(torch.where(
        valid, ty_hi - ty_lo + 1, one))))))
    counts = _plan_counts(xy, conic, opac, valid, tiles_x, tiles_y,
                          tile_size, span_x, span_y).cpu().numpy()
    aligned = (-(-(counts + 1) // CHUNK) * CHUNK).sum()
    c_max = int(-(-int(aligned * margin) // CHUNK) * CHUNK)
    return FlatPlan(span_x=span_x, span_y=span_y, c_max=max(c_max, CHUNK))


def plan_trimmed(plan: FlatPlan, tile_chunk_cnt, used_chunks,
                 trim_slack: int = 2, round_chunks: int = 64,
                 margin: float = 1.0) -> FlatPlan:
    """Capacity of a saturation-trimmed plan: each tile keeps
    min(cnt, used + slack) chunks, total rounded UP to round_chunks."""
    cnt = np.asarray(torch.as_tensor(tile_chunk_cnt).cpu())
    used = np.asarray(torch.as_tensor(used_chunks).cpu())
    total = int(np.minimum(cnt, used + trim_slack).sum())
    total = int(-(-int(total * margin) // round_chunks) * round_chunks)
    total = max(min(total, plan.c_max // CHUNK), 1)
    return FlatPlan(span_x=plan.span_x, span_y=plan.span_y,
                    c_max=total * CHUNK)


@torch.no_grad()
def take_plan(gidx, n: int):
    """The transpose plan of a gather of the [n + 1]-row payload by gidx
    (row n the trash row): perm [c] int32, the positions of gidx sorted by
    row, stably (so ascending within each row's run), and bounds [n + 2]
    int32, row s's run being perm[bounds[s]:bounds[s + 1]] (bincount +
    cumsum, as JAX's build_flat_bins)."""
    perm = torch.sort(gidx, stable=True).indices.to(torch.int32)
    counts = torch.bincount(gidx, minlength=n + 1)
    bounds = F.pad(torch.cumsum(counts, 0), (1, 0)).to(torch.int32)
    return perm, bounds


@torch.no_grad()
def build_flat_bins(xy, depth, conic, opac, valid,
                    tiles_x: int, tiles_y: int, tile_size: int,
                    plan: FlatPlan, used_chunks=None, trim_slack: int = 2):
    """Index-only binning plan, cacheable across train steps: payload
    VALUES are re-gathered every step, so gradients always use the current
    parameters. Besides build_flat_candidates' dict it holds the gather's
    transpose plan `perm` / `bounds` (take_plan) and `xy_snap` (every
    DRIFT_STRIDE-th projected centre), with which a render reports its
    screen drift since binning."""
    meta = build_flat_candidates(
        xy, depth, conic, opac, valid, tiles_x=tiles_x, tiles_y=tiles_y,
        tile_size=tile_size, plan=plan, used_chunks=used_chunks,
        trim_slack=trim_slack)
    meta["perm"], meta["bounds"] = take_plan(meta["gidx"], xy.shape[0])
    meta["xy_snap"] = xy[::DRIFT_STRIDE].detach().clone()
    return meta


# ---------------------------------------------------------------------------
# K1 / K2: the tile walks
# ---------------------------------------------------------------------------


def tile_pixels_at(origins, tile_size, img_w, img_h):
    """Pixel centres [T, P] of tiles at pixel `origins` [T, 2] (float) and
    their mask of pixels inside the img_w x img_h image."""
    pid = torch.arange(tile_size * tile_size, device=origins.device)[None, :]
    px = origins[:, 0:1] + (pid % tile_size).float() + 0.5
    py = origins[:, 1:2] + (pid // tile_size).float() + 0.5
    return px, py, (px < float(img_w)) & (py < float(img_h))


def _tile_pixels(n_tiles, tiles_x, tile_size, img_w, img_h, device):
    """tile_pixels_at for the row-major tile grid."""
    t = torch.arange(n_tiles, device=device)
    origins = torch.stack([t % tiles_x, t // tiles_x], dim=-1) * tile_size
    return tile_pixels_at(origins.float(), tile_size, img_w, img_h)


def _chunk_alpha(px, py, c):
    """Gaussian falloff of chunk candidates c [T, C, 16] at pixels [T, P]:
    (dx, dy, power, e, a_pre, a, keep), each [T, P, C]."""
    gx, gy = c[:, None, :, 0], c[:, None, :, 1]
    ca, cb, cc = c[:, None, :, 2], c[:, None, :, 3], c[:, None, :, 4]
    dx = px[..., None] - gx
    dy = py[..., None] - gy
    power = -0.5 * (ca * dx * dx + 2.0 * cb * dx * dy + cc * dy * dy)
    e = torch.exp(torch.clamp(power, max=0.0))
    a_pre = c[:, None, :, 5] * e
    a_cap = torch.clamp(a_pre, max=0.999)
    keep = a_cap >= ALPHA_EPS
    a = torch.where(keep, a_cap, torch.zeros_like(a_cap))
    return dx, dy, power, e, a_pre, a, keep


def walk_fwd_plain(chunks, cs, cc, px, py, in_img) -> torch.Tensor:
    """The forward tile walk in plain PyTorch, shared by K1's and K3's plain
    versions (as csrc/splat_walk.cuh is by the kernels): tile t walks chunks
    [cs[t], cs[t] + cc[t]) of `chunks` [n_chunks, 128, 16] front to back at
    its pixel centres px/py [T, P] while its max transmittance exceeds
    TERM_EPS, all live tiles one chunk at a time; pixels outside `in_img`
    start at transmittance 0. Differentiable (autograd), which the tests use
    to check the closed-form backward.

    Returns [T, P, 8]: rgb(3), depth_acc, 1 - T, used_chunks, total
    log(1 - alpha), ended-live."""
    n_tiles = cs.shape[0]
    cs, cc = cs.long(), cc.long()
    trans = in_img.to(chunks.dtype)
    acc = chunks.new_zeros(n_tiles, px.shape[1], 4)
    tot = chunks.new_zeros(n_tiles, px.shape[1])
    kc = torch.zeros_like(cc)
    max_m = int(cc.max()) if n_tiles else 0
    for j in range(max_m):
        active = (j < cc) & (trans.amax(1) > TERM_EPS)       # [T]
        if not bool(active.any()):
            break
        c = chunks[torch.clamp(cs + j, max=chunks.shape[0] - 1)]
        _, _, _, _, _, a, _ = _chunk_alpha(px, py, c)
        log1m = torch.log1p(-a)                              # [T, P, C]
        cums = F.pad(torch.cumsum(log1m, -1)[..., :-1], (1, 0))
        w = a * torch.exp(cums) * trans[..., None]
        step = torch.einsum("tpc,tcr->tpr", w, c[:, :, 6:10])
        csum = log1m.sum(-1)
        act = active[:, None]
        acc = torch.where(act[..., None], acc + step, acc)
        trans = torch.where(act, trans * torch.exp(csum), trans)
        tot = torch.where(act, tot + csum, tot)
        kc = kc + active.long()
    live = trans.amax(1) > TERM_EPS
    ended = ((kc >= cc) & live).to(chunks.dtype)
    bcast = torch.ones_like(tot)
    return torch.cat([
        acc, (1.0 - trans)[..., None], (kc.to(chunks.dtype)[:, None] * bcast)
        [..., None], tot[..., None], (ended[:, None] * bcast)[..., None],
    ], dim=-1)


def walk_bwd_plain(chunks, cs, used, total, v, px, py, in_img, acc=None):
    """The reverse tile walk in closed form (not autograd), shared by K2's
    and K4's plain versions: tile t walks its `used[t]` chunks from the last
    back to cs[t] with
      log T_k = total - sum_{r >= k} log(1 - a_r)   (no division),
      dL/da_k = T_k s_k - (sum_{r > k} w_r s_r) / (1 - a_k),
    s_k = v . payload_k; total [T, P] is the forward's log-transmittance
    over the walked chunks, v [T, P, 8] the cotangent. Returns d chunks
    [n_chunks, 128, 16] in dtype `acc` (default the chunks'); chunks never
    walked and columns 10-15 are zero.

    The alphas and their masks are always taken in the chunks' own dtype;
    `acc` is the dtype of everything after them, so acc=torch.float64 walks
    the very candidates and pixels a float32 walk keeps, with exact sums."""
    n_tiles = cs.shape[0]
    acc = acc or chunks.dtype
    dchunks = torch.zeros(chunks.shape, dtype=acc, device=chunks.device)
    cs, used = cs.long(), used.long()
    total, v = total.to(acc), v.to(acc)
    suffix = torch.zeros_like(total)      # sum log(1-a) of later chunks
    s_after = torch.zeros_like(total)     # sum w s of later chunks
    max_used = int(used.max()) if n_tiles else 0
    for j in range(max_used):
        active = j < used
        idx = torch.clamp(cs + used - 1 - j, 0, chunks.shape[0] - 1)
        c = chunks[idx]
        dx, dy, power, e, a_pre, a, keep = _chunk_alpha(px, py, c)
        dx, dy, power, e, a_pre, a, c = (
            x.to(acc) for x in (dx, dy, power, e, a_pre, a, c))
        log1m = torch.log1p(-a)
        rev_incl = torch.flip(torch.cumsum(torch.flip(log1m, [-1]), -1), [-1])
        log_t = (total - suffix)[..., None] - rev_incl
        tr = torch.exp(log_t) * in_img[..., None]
        w = a * tr
        s = torch.einsum("tpr,tcr->tpc", v, c[:, :, 6:14])
        ws = w * s
        rev_ws = torch.flip(torch.cumsum(torch.flip(ws, [-1]), -1), [-1])
        s_k = F.pad(rev_ws[..., 1:], (0, 1)) + s_after[..., None]
        da = tr * s - s_k / (1.0 - a)
        da = torch.where(keep & (a_pre < 0.999), da, torch.zeros_like(da))
        dpow = torch.where(power < 0.0, da * a, torch.zeros_like(da))
        ca, cb, cc_ = c[:, None, :, 2], c[:, None, :, 3], c[:, None, :, 4]
        rows = torch.stack([
            (dpow * (ca * dx + cb * dy)).sum(1),
            (dpow * (cb * dx + cc_ * dy)).sum(1),
            (dpow * (-0.5 * dx * dx)).sum(1),
            (dpow * (-dx * dy)).sum(1),
            (dpow * (-0.5 * dy * dy)).sum(1),
            (da * e).sum(1),
        ], dim=-1)                                            # [T, C, 6]
        du = torch.einsum("tpr,tpc->tcr", v[..., 0:4], w)     # [T, C, 4]
        dchunks[idx[active], :, :GRAD_ROWS] = torch.cat(
            [rows, du], dim=-1)[active]
        act = active[:, None]
        suffix = torch.where(act, suffix + log1m.sum(-1), suffix)
        s_after = torch.where(act, s_after + ws.sum(-1), s_after)
    return dchunks


def flat_fwd_plain(cand, cs, cc, tiles_x: int, tile_size: int,
                   img_w: int, img_h: int) -> torch.Tensor:
    """Plain PyTorch K1 (the CPU path and the card's reference):
    walk_fwd_plain over the flat chunk ranges at the tiles' own pixels.

    cand [c_max, 16] f32 rows; cs/cc [T] int32. Returns [T, P, 8]: rgb(3),
    depth_acc, 1 - T, used_chunks, total log(1 - alpha), ended-live."""
    px, py, in_img = _tile_pixels(cs.shape[0], tiles_x, tile_size, img_w,
                                  img_h, cand.device)
    return walk_fwd_plain(cand.reshape(-1, CHUNK, CAND_ROWS), cs, cc, px, py,
                          in_img)


def flat_bwd_plain(cand, cs, fwd_out, v, tiles_x: int, tile_size: int,
                   img_w: int, img_h: int, acc=None) -> torch.Tensor:
    """Plain PyTorch K2: walk_bwd_plain over the `used` chunks of each tile
    (fwd_out[:, 0, 5]) from K1's stored total (fwd_out[..., 6]), its sums
    in dtype `acc` (default cand's). Returns dcand [c_max, 16]; rows never
    walked and columns 10-15 are zero."""
    px, py, in_img = _tile_pixels(cs.shape[0], tiles_x, tile_size, img_w,
                                  img_h, cand.device)
    dchunks = walk_bwd_plain(
        cand.reshape(-1, CHUNK, CAND_ROWS), cs, fwd_out[:, 0, 5],
        fwd_out[..., 6], v, px, py, in_img, acc)
    return dchunks.reshape(cand.shape)


def _check_walk_args(cand, tile_size, ranges, blocks):
    """Validate what the kernels read through raw pointers: cand f32
    [c_max, 16]; ranges (chunk start/count) int32 [T]; blocks (forward
    output, cotangent) f32 [T, tile_size^2, 8]; one device, contiguous."""
    if cand.dtype != torch.float32 or cand.dim() != 2 \
            or cand.shape[1] != CAND_ROWS or cand.shape[0] % CHUNK:
        raise ValueError(f"cand must be f32 [c_max, {CAND_ROWS}] with c_max "
                         f"% {CHUNK} == 0, got {cand.dtype} "
                         f"{tuple(cand.shape)}")
    if (tile_size * tile_size) % 32 or tile_size * tile_size > 1024:
        raise ValueError(f"tile_size {tile_size}: tile_size^2 must be a "
                         "multiple of 32 and <= 1024 (one thread per pixel)")
    n_tiles = ranges[0].shape[0]
    for x in ranges:
        if x.dtype != torch.int32 or x.shape != (n_tiles,):
            raise ValueError(f"chunk ranges must be int32 [{n_tiles}], got "
                             f"{x.dtype} {tuple(x.shape)}")
    for x in blocks:
        if x.dtype != torch.float32 or x.shape != (
                n_tiles, tile_size * tile_size, 8):
            raise ValueError(f"tile blocks must be f32 [{n_tiles}, "
                             f"{tile_size * tile_size}, 8], got {x.dtype} "
                             f"{tuple(x.shape)}")
    for x in (cand, *ranges, *blocks):
        if x.device != cand.device or not x.is_contiguous():
            raise ValueError("walk tensors must share one device and be "
                             "contiguous")


def flat_fwd(cand, cs, cc, tiles_x: int, tile_size: int, img_w: int,
             img_h: int) -> torch.Tensor:
    """K1 wrapper. CUDA tensor: launches `splat_flat_fwd` of
    csrc/splat_flat_fwd.cu (one block per tile, one thread per pixel, the
    forward walk of csrc/splat_walk.cuh) and counts the launch in
    `flat_fwd.launches`; CPU tensor: flat_fwd_plain."""
    _check_walk_args(cand, tile_size, (cs, cc), ())
    return flat_fwd_plain(cand, cs, cc, tiles_x, tile_size, img_w, img_h)


flat_fwd.launches = 0


def flat_bwd(cand, cs, fwd_out, v, tiles_x: int, tile_size: int, img_w: int,
             img_h: int) -> torch.Tensor:
    """K2 wrapper. CUDA tensor: launches `splat_flat_bwd` of
    csrc/splat_flat_bwd.cu into a zeroed dcand (the zeros stand for every
    chunk the walk skipped) and counts it in `flat_bwd.launches`; CPU
    tensor: flat_bwd_plain."""
    _check_walk_args(cand, tile_size, (cs,), (fwd_out, v))
    return flat_bwd_plain(cand, cs, fwd_out, v, tiles_x, tile_size,
                          img_w, img_h)


flat_bwd.launches = 0


class _FlatWalk(torch.autograd.Function):
    """out [T, P, 8] = K1(cand); d cand = K2(cand, out, d out). Channels
    5-7 of out are diagnostics: callers detach them, and K2 pairs their
    cotangents with zero payload columns."""

    @staticmethod
    def forward(ctx, cand, cs, cc, tiles_x, tile_size, img_w, img_h):
        out = flat_fwd(cand, cs, cc, tiles_x, tile_size, img_w, img_h)
        ctx.save_for_backward(cand, cs, out)
        ctx.geom = (tiles_x, tile_size, img_w, img_h)
        return out

    @staticmethod
    def backward(ctx, d_out):
        cand, cs, out = ctx.saved_tensors
        dcand = flat_bwd(cand, cs, out, d_out.contiguous(), *ctx.geom)
        return dcand, None, None, None, None, None, None


# ---------------------------------------------------------------------------
# H4: the payload gather's transpose
# ---------------------------------------------------------------------------


def planned_take_bwd_plain(ct, perm, bounds) -> torch.Tensor:
    """Plain PyTorch H4 (the CPU path and the card's reference), the
    kernel's additions in the kernel's order: row s < n of the result is
    0 + ct[perm[bounds[s]]] + ct[perm[bounds[s] + 1]] + ... in float32
    over its run, in columns < BWD_COLS; the other columns and row n are
    zero. The rows are walked longest run first, so that the rows still
    adding at step j are a prefix. ct [c, 16]; returns [n + 1, 16]."""
    n = bounds.shape[0] - 2
    out = ct.new_zeros(n + 1, CAND_ROWS)
    starts = bounds[:n].long()
    lens = bounds[1:n + 1].long() - starts
    order = torch.argsort(lens, descending=True, stable=True)
    starts = starts[order]
    rows = ct[perm.long(), :BWD_COLS]
    acc = ct.new_zeros(n, BWD_COLS)
    # active[j] = rows whose run is longer than j
    len_hist = torch.bincount(lens.cpu(), minlength=1)
    active = n - torch.cumsum(len_hist, 0)
    for j in range(len_hist.shape[0] - 1):
        m = int(active[j])
        acc[:m] += rows[starts[:m] + j]
    out[order, :BWD_COLS] = acc
    return out


def _check_take_args(ct, perm, bounds):
    """Validate what H4 reads through raw pointers: ct f32 [c, 16], perm
    int32 [c], bounds int32 [n + 2]; one device, contiguous; on the card
    ct at a 16-byte boundary."""
    if ct.dtype != torch.float32 or ct.dim() != 2 \
            or ct.shape[1] != CAND_ROWS:
        raise ValueError(f"ct must be f32 [c, {CAND_ROWS}], got {ct.dtype} "
                         f"{tuple(ct.shape)}")
    if perm.dtype != torch.int32 or perm.shape != (ct.shape[0],):
        raise ValueError(f"perm must be int32 [{ct.shape[0]}], got "
                         f"{perm.dtype} {tuple(perm.shape)}")
    if bounds.dtype != torch.int32 or bounds.dim() != 1 \
            or bounds.shape[0] < 2:
        raise ValueError(f"bounds must be int32 [n + 2], got {bounds.dtype} "
                         f"{tuple(bounds.shape)}")
    for x in (ct, perm, bounds):
        if x.device != ct.device or not x.is_contiguous():
            raise ValueError("H4 tensors must share one device and be "
                             "contiguous")
    if ct.is_cuda and ct.data_ptr() % 16:
        raise ValueError("ct must start at a 16-byte boundary (the kernel "
                         "copies its rows 16 bytes at a time)")


def planned_take_bwd(ct, perm, bounds) -> torch.Tensor:
    """H4 wrapper: the transpose of a gather of the [n + 1, 16] payload,
    through its plan (take_plan). CUDA tensor: launches `planned_take_bwd`
    of csrc/planned_take_bwd.cu (a block a span of rows, their slots
    staged in shared memory by async copies, each run summed in order by
    its row's thread) and counts it in `planned_take_bwd.launches`; CPU
    tensor: planned_take_bwd_plain. Returns [n + 1, 16], the same bits
    either way."""
    _check_take_args(ct, perm, bounds)
    return planned_take_bwd_plain(ct, perm, bounds)


planned_take_bwd.launches = 0


class _PlannedTake(torch.autograd.Function):
    """payload.index_select(0, gidx) whose backward is H4 through the
    gather's plan (perm, bounds): the one given (the flat path's, built
    with its bins), or else take_plan of gidx, built in the backward, so a
    render that takes no gradient builds none. The counterpart of JAX's
    _planned_take_sliced with bwd_cols = BWD_COLS."""

    @staticmethod
    def forward(ctx, payload, gidx, perm, bounds):
        if bounds is not None and payload.shape[0] != bounds.shape[0] - 1:
            raise ValueError(f"a plan of {bounds.shape[0] - 1} rows for a "
                             f"payload of {payload.shape[0]}")
        ctx.n = payload.shape[0] - 1
        ctx.save_for_backward(gidx, perm, bounds)
        return payload.index_select(0, gidx)

    @staticmethod
    def backward(ctx, ct):
        gidx, perm, bounds = ctx.saved_tensors
        if perm is None:
            perm, bounds = take_plan(gidx, ctx.n)
        return planned_take_bwd(ct.contiguous(), perm, bounds), None, None, \
            None


def gather_payload(xy, depth, conic, opac, rgb, gidx, perm=None,
                   bounds=None) -> torch.Tensor:
    """The walks' candidate rows [c_max, 16]: ONE row gather of the
    [N+1, 16] payload (x y conic opacity rgb depth 1 pad*5; row N is the
    trash row). Its transpose is H4 through the gather's plan (perm,
    bounds: take_plan of gidx, given or built when the backward runs)."""
    n = xy.shape[0]
    payload = torch.cat(
        [xy, conic, opac[:, None], rgb, depth[:, None],
         torch.ones_like(depth)[:, None],
         xy.new_zeros(n, CAND_ROWS - 11)], dim=-1)
    payload = torch.cat([payload, payload.new_zeros(1, CAND_ROWS)], dim=0)
    return _PlannedTake.apply(payload, gidx, perm, bounds)


def composite_tiles_flat(
    xy, depth, conic, opac, rgb, valid,
    width: int, height: int, tile_size: int, plan: FlatPlan,
    bins: dict | None = None,
):
    """Bins (unless a cached `bins` plan is given) and composites projected
    gaussians exactly. Returns (rgb [T,P,3], depth_norm [T,P], alpha [T,P],
    flags) with flags: overflow [] int32, stale [] int32 (a saturation-
    trimmed tile walked its whole shortened range while live), used_chunks
    [T] int32, and xy_drift [] (max px drift since binning) with cached
    bins."""
    tiles_x = -(-width // tile_size)
    tiles_y = -(-height // tile_size)
    if bins is None:
        bins = build_flat_bins(
            xy, depth, conic, opac, valid, tiles_x=tiles_x, tiles_y=tiles_y,
            tile_size=tile_size, plan=plan)

    cand = gather_payload(xy, depth, conic, opac, rgb, bins["gidx"],
                          bins["perm"], bins["bounds"])
    out = _FlatWalk.apply(cand, bins["tile_chunk_start"],
                          bins["tile_chunk_cnt"], tiles_x, tile_size,
                          width, height)
    rgb_t = out[:, :, :3]
    depth_acc = out[:, :, 3]
    alpha = out[:, :, 4]
    depth_norm = depth_acc / torch.clamp(alpha, min=1e-10)
    diag = out[:, 0, 5:8].detach()
    used = diag[:, 0].int()
    ended_live = diag[:, 2] > 0.5
    trimmed = bins.get("trimmed")
    if trimmed is None:
        stale = torch.zeros((), dtype=torch.int32, device=xy.device)
    else:
        stale = torch.any(ended_live & (trimmed > 0)).int()
    flags = {"overflow": bins["overflow"], "stale": stale,
             "used_chunks": used}
    if "xy_snap" in bins:
        cur = xy[::DRIFT_STRIDE].detach()
        flags["xy_drift"] = torch.max(torch.abs(cur - bins["xy_snap"]))
    return rgb_t, depth_norm, alpha, flags
