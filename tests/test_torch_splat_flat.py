"""Flat splat pipeline of the port (holoscene_tpu_torch/ops/splat_flat.py)
against the JAX reference: binning, the plain versions of the K1/K2 tile
walks, and the compositing entry point. The JAX walks run in Pallas
interpret mode on the CPU, as tests/test_splat_flat.py runs them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holoscene_tpu.ops import splat_flat as jflat
from holoscene_tpu.ops.gaussians import project_gaussians_fused as jproject
from holoscene_tpu_torch.ops import splat_flat as tflat
from test_torch_threads import few_torch_threads  # noqa: F401
from test_torch_walk_cases import (
    FWD_USED,
    cotangent,
    flat_layout,
    hard_fwd_tiles,
    hard_tiles,
)

CHUNK = tflat.CHUNK
# K1: JAX's default bf16x2 triangular prefix matmul is ~f32-accurate
FWD_ATOL = 2e-4
# jitted JAX entry points: eager dispatch compiles op by op (seconds each)
_jproject = jax.jit(jproject, static_argnames=("width", "height"))
_jbins = jax.jit(jflat.build_flat_bins, static_argnames=(
    "tiles_x", "tiles_y", "tile_size", "plan", "trim_slack"))
# K2: as tests/test_splat_flat.py holds the JAX backward to brute force
BWD_ATOL, BWD_RTOL = 5e-4, 5e-3


def _random_scene(n, res, seed):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.6, 0.6, n),
                      rng.uniform(1.2, 3.0, n)], -1)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return dict(means=means, quats=q, scales=rng.uniform(0.02, 0.08, (n, 3)),
                opac=rng.uniform(0.2, 0.95, n), colors=rng.uniform(0, 1, (n, 3)),
                res=res)


def _wall_scene(seed=7):
    """An opaque near wall in front of more content: tiles saturate."""
    rng = np.random.default_rng(seed)
    nf, nb = 220, 400
    front = np.stack([rng.uniform(-0.7, 0.7, nf), rng.uniform(-0.7, 0.7, nf),
                      rng.uniform(1.0, 1.1, nf)], -1)
    back = np.stack([rng.uniform(-0.7, 0.7, nb), rng.uniform(-0.7, 0.7, nb),
                     rng.uniform(1.5, 3.0, nb)], -1)
    n = nf + nb
    return dict(means=np.concatenate([front, back]),
                quats=np.tile([1.0, 0, 0, 0], (n, 1)),
                scales=np.full((n, 3), 0.12),
                opac=np.concatenate([np.full(nf, 0.97),
                                     rng.uniform(0.3, 0.9, nb)]),
                colors=rng.uniform(0, 1, (n, 3)), res=48)


def _corner_scene(seed=5):
    """All gaussians in the top-left corner: the far tiles stay empty."""
    rng = np.random.default_rng(seed)
    n = 64
    means = np.stack([rng.uniform(-0.55, -0.35, n),
                      rng.uniform(-0.55, -0.35, n),
                      rng.uniform(1.0, 1.4, n)], -1)
    return dict(means=means, quats=np.tile([1.0, 0, 0, 0], (n, 1)),
                scales=np.full((n, 3), 0.01), opac=np.full(n, 0.9),
                colors=rng.uniform(0, 1, (n, 3)), res=48)


SCENES = {
    "random32": lambda: _random_scene(200, 32, 0),
    "random40": lambda: _random_scene(250, 40, 3),   # 40 % 16 != 0
    "saturated": _wall_scene,
    "empty_tiles": _corner_scene,
}


def _project(sc):
    """JAX projection -> numpy (xy, depth, conic, opac, valid, rgb)."""
    res = sc["res"]
    f = res * 0.8
    intr = jnp.array([[f, 0, res / 2], [0, f, res / 2], [0, 0, 1.0]])
    xy, depth, conic, _r, valid = _jproject(
        jnp.asarray(sc["means"], jnp.float32),
        jnp.asarray(sc["quats"], jnp.float32),
        jnp.asarray(sc["scales"], jnp.float32), jnp.eye(4), intr,
        width=res, height=res)
    return tuple(np.asarray(x) for x in (xy, depth, conic)) + (
        np.asarray(sc["opac"], np.float32), np.asarray(valid),
        np.asarray(sc["colors"], np.float32))


def _t(x):
    return torch.as_tensor(np.array(x))


def _bins_both(xy, depth, conic, opac, valid, res, used=None, plan=None):
    tiles = -(-res // 16)
    if plan is None:
        plan = jflat.plan_flat(xy, conic, opac, valid, tiles, tiles, 16)
    jb = _jbins(
        jnp.asarray(xy), jnp.asarray(depth), jnp.asarray(conic),
        jnp.asarray(opac), jnp.asarray(valid), tiles_x=tiles, tiles_y=tiles,
        tile_size=16, plan=plan,
        used_chunks=None if used is None else jnp.asarray(used), trim_slack=1)
    tb = tflat.build_flat_bins(
        _t(xy), _t(depth), _t(conic), _t(opac), _t(valid), tiles_x=tiles,
        tiles_y=tiles, tile_size=16,
        plan=tflat.FlatPlan(plan.span_x, plan.span_y, plan.c_max),
        used_chunks=None if used is None else _t(used), trim_slack=1)
    return plan, {k: np.asarray(v) for k, v in jb.items()}, tb


def _jax_walk(cand_rows, cs, cc, res, height=None):
    """JAX _flat_core forward (interpret) + VJP closure, row-major I/O, for
    a res x res image (res x height if given)."""
    tiles = -(-res // 16)
    tiles_y = tiles if height is None else -(-height // 16)
    n_chunks = cand_rows.shape[0] // CHUNK
    cand = jnp.swapaxes(jnp.asarray(cand_rows).reshape(n_chunks, CHUNK, 16),
                        1, 2)

    def core(c):
        return jflat._flat_core(c, jnp.asarray(cs), jnp.asarray(cc),
                                tiles * tiles_y, 16, tiles, res,
                                res if height is None else height, True,
                                "bf16x2", "vpu")

    out, vjp = jax.vjp(core, cand)

    def bwd(v):
        (d,) = vjp(jnp.asarray(v))
        return np.asarray(jnp.swapaxes(d, 1, 2).reshape(-1, 16))

    return np.asarray(out), bwd


def _cand_rows(xy, depth, conic, opac, rgb, gidx):
    n = xy.shape[0]
    pay = np.concatenate([xy, conic, opac[:, None], rgb, depth[:, None],
                          np.ones((n, 1)), np.zeros((n, 5))], 1)
    pay = np.concatenate([pay, np.zeros((1, 16))], 0).astype(np.float32)
    return pay[gidx]


@pytest.mark.parametrize("name", sorted(SCENES))
def test_binning_matches_jax(name):
    sc = SCENES[name]()
    xy, depth, conic, opac, valid, _rgb = _project(sc)
    res = sc["res"]
    tiles = -(-res // 16)
    plan, jb, tb = _bins_both(xy, depth, conic, opac, valid, res)
    tplan = tflat.plan_flat(_t(xy), _t(conic), _t(opac), _t(valid), tiles,
                            tiles, 16)
    assert (tplan.span_x, tplan.span_y, tplan.c_max) == (
        plan.span_x, plan.span_y, plan.c_max)
    for k in ("tile_chunk_start", "tile_chunk_cnt", "overflow", "trimmed"):
        np.testing.assert_array_equal(tb[k].numpy(), jb[k], err_msg=k)
    np.testing.assert_array_equal(tb["xy_snap"].numpy(), jb["xy_snap"])
    # sort ties order arbitrarily in JAX: compare each tile as a multiset
    tg = tb["gidx"].numpy()
    for s, c in zip(jb["tile_chunk_start"], jb["tile_chunk_cnt"]):
        sl = slice(s * CHUNK, (s + c) * CHUNK)
        np.testing.assert_array_equal(np.sort(tg[sl]), np.sort(jb["gidx"][sl]))


def test_trimmed_plan_and_bins_match_jax():
    sc = _wall_scene()
    xy, depth, conic, opac, valid, rgb = _project(sc)
    res = sc["res"]
    plan, jb, _ = _bins_both(xy, depth, conic, opac, valid, res)
    out, _ = _jax_walk(_cand_rows(xy, depth, conic, opac, rgb, jb["gidx"]),
                       jb["tile_chunk_start"], jb["tile_chunk_cnt"], res)
    used = out[:, 0, 5].astype(np.int32)
    assert used.sum() < jb["tile_chunk_cnt"].sum()  # saturation bites
    jplan = jflat.plan_trimmed(plan, jb["tile_chunk_cnt"], used,
                               trim_slack=1, round_chunks=4)
    tplan = tflat.plan_trimmed(
        tflat.FlatPlan(plan.span_x, plan.span_y, plan.c_max),
        _t(jb["tile_chunk_cnt"]), _t(used), trim_slack=1, round_chunks=4)
    assert (tplan.span_x, tplan.span_y, tplan.c_max) == (
        jplan.span_x, jplan.span_y, jplan.c_max)
    _, jt, tt = _bins_both(xy, depth, conic, opac, valid, res, used=used,
                           plan=jplan)
    assert jt["trimmed"].sum() > 0
    for k in ("tile_chunk_start", "tile_chunk_cnt", "overflow", "trimmed"):
        np.testing.assert_array_equal(tt[k].numpy(), jt[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_walk_plain_matches_jax(name):
    """K1 plain vs JAX _flat_core forward (all 8 channels); K2 plain
    (closed form) vs JAX's VJP and vs torch autograd through K1 plain."""
    sc = SCENES[name]()
    xy, depth, conic, opac, valid, rgb = _project(sc)
    res = sc["res"]
    tiles = -(-res // 16)
    _, jb, _ = _bins_both(xy, depth, conic, opac, valid, res)
    rows = _cand_rows(xy, depth, conic, opac, rgb, jb["gidx"])
    cs, cc = jb["tile_chunk_start"], jb["tile_chunk_cnt"]
    j_out, j_bwd = _jax_walk(rows, cs, cc, res)

    cand = _t(rows).requires_grad_(True)
    t_out = tflat.flat_fwd(cand, _t(cs), _t(cc), tiles, 16, res, res)
    np.testing.assert_allclose(t_out.detach().numpy(), j_out, atol=FWD_ATOL)
    if name == "saturated":
        assert (j_out[:, 0, 5] < cc).any()      # used < cnt somewhere
    if name == "empty_tiles":
        assert (j_out[:, :, 4].max(1) == 0).any()

    v = np.random.default_rng(1).normal(size=j_out.shape).astype(np.float32)
    v[..., 5:] = 0.0   # diagnostics channels carry no cotangent
    d_plain = tflat.flat_bwd(cand.detach(), _t(cs), t_out.detach(), _t(v),
                             tiles, 16, res, res)
    np.testing.assert_allclose(d_plain.numpy(), j_bwd(v), atol=BWD_ATOL,
                               rtol=BWD_RTOL)
    (d_auto,) = torch.autograd.grad(t_out, cand, _t(v))
    np.testing.assert_allclose(d_plain.numpy(), d_auto.numpy(),
                               atol=BWD_ATOL, rtol=BWD_RTOL)


def test_walk_plain_matches_jax_on_hard_tiles():
    """K1/K2 plain vs the JAX kernels on the hand-built tiles of
    test_torch_walk_cases.py: used = 0 beside a full walk, candidates live
    in one warp's rows only or nowhere, the 0.999 clamp, edge tiles (their
    out-of-image cotangents zero), an early stop."""
    lists, origins, (w, h) = hard_tiles()
    rows, cs, cc = flat_layout(lists)
    j_out, j_bwd = _jax_walk(rows, cs, cc, w, h)
    geom = (-(-w // 16), 16, w, h)
    t_out = tflat.flat_fwd(_t(rows), _t(cs), _t(cc), *geom)
    np.testing.assert_allclose(t_out.numpy(), j_out, atol=FWD_ATOL)
    assert j_out[:, 0, 5].tolist() == [0, 3, 2, 2, 2, 1]
    v = cotangent(len(lists), origins, (w, h))
    d_plain = tflat.flat_bwd(_t(rows), _t(cs), t_out, _t(v), *geom)
    np.testing.assert_allclose(d_plain.numpy(), j_bwd(v), atol=BWD_ATOL,
                               rtol=BWD_RTOL)


def test_walk_plain_matches_jax_on_hard_fwd_tiles():
    """K1 plain vs the JAX kernel on the forward walk's hand-built tiles of
    test_torch_walk_cases.py (without the candidates at the 1/255 cut, which
    can flip between the two on their own): thin ellipses crossing a tile
    from outside, single-pixel candidates, conics that are not positive
    definite, stops on a chunk boundary and mid-chunk, a tile that never
    saturates, an edge column."""
    lists, _origins, (w, h) = hard_fwd_tiles(near_cut=False)
    rows, cs, cc = flat_layout(lists)
    j_out, _ = _jax_walk(rows, cs, cc, w, h)
    t_out = tflat.flat_fwd(_t(rows), _t(cs), _t(cc), -(-w // 16), 16, w, h)
    assert j_out[:, 0, 5].tolist() == FWD_USED
    np.testing.assert_array_equal(t_out[:, :, 5].numpy(), j_out[:, :, 5])
    np.testing.assert_allclose(t_out.numpy(), j_out, atol=FWD_ATOL)


def test_composite_tiles_flat_matches_jax():
    """The compositing entry point end to end: images, flags and gradients
    w.r.t. every projected input, through the payload gather."""
    sc = _random_scene(180, 40, 11)
    xy, depth, conic, opac, valid, rgb = _project(sc)
    res, ts = sc["res"], 16
    tiles = -(-res // ts)
    plan, jb, _ = _bins_both(xy, depth, conic, opac, valid, res)
    tgt = np.random.default_rng(2).uniform(0, 1, (tiles * tiles, 256, 3))
    jbins = {k: jnp.asarray(v) for k, v in jb.items()}

    def jloss(xy, depth, conic, opac, rgb):
        r, d, a, fl = jflat.composite_tiles_flat(
            xy, depth, conic, opac, rgb, jnp.asarray(valid), res, res, ts,
            plan, bins=jbins, interpret=True)
        loss = jnp.mean((r - tgt) ** 2) + 0.1 * jnp.mean(a) \
            + 0.01 * jnp.mean(d)
        return loss, fl

    args = [jnp.asarray(x) for x in (xy, depth, conic, opac, rgb)]
    (jl, jfl), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4),
                                       has_aux=True)(*args)

    targs = [_t(x).requires_grad_(True) for x in (xy, depth, conic, opac,
                                                    rgb)]
    tbins = tflat.build_flat_bins(
        *[a.detach() for a in targs[:4]], _t(valid), tiles_x=tiles,
        tiles_y=tiles, tile_size=ts,
        plan=tflat.FlatPlan(plan.span_x, plan.span_y, plan.c_max))
    r, d, a, tfl = tflat.composite_tiles_flat(
        targs[0], targs[1], targs[2], targs[3], targs[4], _t(valid), res,
        res, ts, tflat.FlatPlan(plan.span_x, plan.span_y, plan.c_max),
        bins=tbins)
    tl = torch.mean((r - _t(tgt).float()) ** 2) + 0.1 * torch.mean(a) \
        + 0.01 * torch.mean(d)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-4)
    for k in ("overflow", "stale", "used_chunks", "xy_drift"):
        np.testing.assert_allclose(tfl[k].numpy(), np.asarray(jfl[k]),
                                   err_msg=k)
    for tg, g, nm in zip(targs, jg, ("xy", "depth", "conic", "opac", "rgb")):
        np.testing.assert_allclose(tg.grad.numpy(), np.asarray(g),
                                   atol=BWD_ATOL, rtol=BWD_RTOL, err_msg=nm)


def test_walk_wrappers_refuse_bad_input():
    cand = torch.zeros(CHUNK, 16)
    cs = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        tflat.flat_fwd(cand[:, :8], cs, cs, 1, 16, 16, 16)
    with pytest.raises(ValueError):
        tflat.flat_fwd(cand, cs.long(), cs.long(), 1, 16, 16, 16)
    with pytest.raises(ValueError):
        tflat.flat_fwd(cand, cs, cs, 1, 5, 5, 5)   # 25 threads, not 32k
    with pytest.raises(ValueError):
        tflat.flat_fwd(cand, cs, torch.zeros(2, dtype=torch.int32), 1, 16,
                       16, 16)
    blocks = torch.zeros(1, 256, 8)
    with pytest.raises(ValueError):
        tflat.flat_bwd(cand, cs, blocks[:, :128], blocks, 1, 16, 16, 16)
    with pytest.raises(ValueError):
        tflat.flat_bwd(cand, cs, blocks, blocks.double(), 1, 16, 16, 16)
