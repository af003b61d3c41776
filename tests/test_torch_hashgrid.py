"""The port's hash grid (holoscene_tpu_torch/ops/hashgrid.py) against the
JAX package's on the CPU: the plain versions of H1-fwd / H1-bwd (the fused
dual encode with jacobian, its three backward modes with JAX's own
uniforms) and of H2 (the sampler encode), the single-table mode against
jacfwd of the packed encode, and the packed encode itself. Tiny metas as
in tests/test_hashgrid_fused.py; points in [0.01, 0.99] (the three index
semantics differ only at x01 == 1) plus three outside [0, 1].

Tolerances: features and J atol 1e-5 (float32 sums of 8 corners in another
order: measured ~1e-7 and ~1e-5 of J's scale 60); table gradients atol
1e-5 max|JAX| (the same sums, scattered in another order); the points'
cotangent 1e-4 of its scale. In the sampled modes a (level, point) pair
whose uniform lies within 1e-6 of the weight (or of a running sum, for
table a) can pick another corner in the last bit: those pairs' cotangents
are set to 0 on both sides, all others are compared."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401
from torch_stage1_cases import fused_uniforms

from holoscene_tpu.ops import hashgrid as jh
from holoscene_tpu_torch.ops import hashgrid as th

FEAT_ATOL = 1e-5
GRAD_REL = 1e-5


def _metas(dmr: int, levels: int = 6, end: int = 48, logmap: int = 8):
    kw = dict(num_levels=levels, level_dim=2, base_resolution=4,
              log2_hashmap_size=logmap, desired_resolution=end,
              dense_max_res=dmr)
    return jh.HashGridMeta(**kw), th.HashGridMeta(**kw)


def _inputs(meta, n: int = 157, seed: int = 0):
    rng = np.random.default_rng(seed)
    ea = rng.uniform(-0.5, 0.5, (meta.table_rows, 2)).astype(np.float32)
    eb = rng.uniform(-0.5, 0.5, (meta.table_rows, 2)).astype(np.float32)
    x = rng.uniform(0.01, 0.99, (n, 3)).astype(np.float32)
    x[:3] = [[1.2, 0.5, 0.5], [-0.1, 0.3, 0.3], [0.5, 0.5, 1.01]]
    return ea, eb, x


def _np(a):
    return np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)


@pytest.mark.parametrize("dmr", [0, 64])
def test_packed_encode_matches_jax(dmr):
    jm, tm = _metas(dmr)
    ea, _, x = _inputs(jm)
    ref = jh.hash_encode(jnp.asarray(x), jnp.asarray(ea), jm)
    got = th.hash_encode(torch.tensor(x), torch.tensor(ea), tm)
    np.testing.assert_allclose(_np(got), _np(ref), atol=FEAT_ATOL)


@pytest.mark.parametrize("levels", [None, 3])
@pytest.mark.parametrize("dmr", [0, 64])
def test_fused_forward_matches_jax(dmr, levels):
    """feats_a, J_a, feats_b of the plain H1-fwd; levels=3 against JAX's
    prefix_meta with table_rows-sliced tables (coarse_levels)."""
    jm, tm = _metas(dmr)
    ea, eb, x = _inputs(jm)
    jmeta = jm if levels is None else jh.prefix_meta(jm, levels)
    rows = jmeta.table_rows
    ref = jh.hash_encode_fused_dual(jnp.asarray(x), jnp.asarray(ea[:rows]),
                                    jnp.asarray(eb[:rows]), jmeta,
                                    fetch="packed")
    got = th.hash_encode_fused_dual(torch.tensor(x), torch.tensor(ea),
                                    torch.tensor(eb), tm, levels)
    for r, g in zip(ref, got):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(_np(g), _np(r), atol=FEAT_ATOL)
    assert not _np(got[0])[:3].any() and not _np(got[1])[..., :3].any()


@pytest.mark.parametrize("dmr,mode", [(0, "exact"), (0, "sampled"),
                                      (0, "sampled_all"), (64, "exact")])
def test_fused_backward_matches_jax(dmr, mode):
    """Both tables' gradients of the plain H1-bwd against JAX's custom VJP,
    the sampled modes with the uniforms JAX draws from the same seed (at
    dense_max_res 64 every level is dense, where the modes coincide)."""
    jm, tm = _metas(dmr)
    ea, eb, x = _inputs(jm)
    n = x.shape[0]
    lt = th.level_tables(tm)
    rng = np.random.default_rng(1)
    cts = [torch.tensor(rng.normal(size=s).astype(np.float32))
           for s in ((n, 12), (12, 3, n), (n, 12))]
    key = jax.random.PRNGKey(7)
    gs = jax.lax.bitcast_convert_type(jax.random.bits(key, dtype=jnp.uint32),
                                      jnp.float32)
    u_b, u_a = fused_uniforms(key, tm, n)
    if mode != "exact" and lt.n_hashed:
        bad = th.near_flip_pairs(torch.tensor(x), lt, cts[0], cts[1], u_b,
                                 u_a, mode)
        keep = torch.ones(lt.n_levels, n, dtype=torch.bool)
        keep[lt.n_dense:] = ~bad
        cts[0] = cts[0] * keep.T.repeat_interleave(2, 1)
        cts[1] = cts[1] * keep.repeat_interleave(2, 0)[:, None, :]
        cts[2] = cts[2] * keep.T.repeat_interleave(2, 1)
        assert int(bad.sum()) < bad.numel() // 100

    def f(a, b):
        o = jh.hash_encode_fused_dual(jnp.asarray(x), a, b, jm, "packed",
                                      seed=gs, color_bwd=mode)
        return sum(jnp.sum(oo * jnp.asarray(c.numpy())) for oo, c in zip(o, cts))

    ga, gb = jax.grad(f, argnums=(0, 1))(jnp.asarray(ea), jnp.asarray(eb))
    ta = torch.tensor(ea, requires_grad=True)
    tb = torch.tensor(eb, requires_grad=True)
    out = th.hash_encode_fused_dual(torch.tensor(x), ta, tb, tm, mode=mode,
                                    u_b=u_b if mode != "exact" else None,
                                    u_a=u_a if mode == "sampled_all" else None)
    sum((o * c).sum() for o, c in zip(out, cts)).backward()
    for ref, got in ((ga, ta.grad), (gb, tb.grad)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=GRAD_REL * np.abs(ref).max())


def test_fused_backward_points_cotangent_matches_jax():
    """The plain backward's cotangent of the points (first- and second-order
    weight derivatives), which training never asks for."""
    jm, tm = _metas(0)
    ea, eb, x = _inputs(jm)
    n = x.shape[0]
    rng = np.random.default_rng(2)
    cts = [rng.normal(size=s).astype(np.float32)
           for s in ((n, 12), (12, 3, n), (n, 12))]

    def f(xx):
        o = jh.hash_encode_fused_dual(xx, jnp.asarray(ea), jnp.asarray(eb),
                                      jm, "packed")
        return sum(jnp.sum(oo * c) for oo, c in zip(o, cts))

    ref = np.asarray(jax.grad(f)(jnp.asarray(x)))
    tx = torch.tensor(x, requires_grad=True)
    out = th.hash_encode_fused_dual(tx, torch.tensor(ea), torch.tensor(eb), tm)
    sum((o * torch.tensor(c)).sum() for o, c in zip(out, cts)).backward()
    np.testing.assert_allclose(tx.grad.numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("dmr", [0, 64])
def test_single_table_mode_matches_jacfwd_of_packed_encode(dmr):
    """Features and J of table a alone (the eikonal call) against the packed
    hash_encode and its jacfwd, and the exact backward of both against
    JAX's second-order AD through them."""
    jm, tm = _metas(dmr)
    ea, _, x = _inputs(jm)
    n = x.shape[0]

    def enc_and_jac(emb):
        fe = jh.hash_encode(jnp.asarray(x), emb, jm)
        per_pt = jax.vmap(jax.jacfwd(
            lambda p: jh.hash_encode(p[None], emb, jm)[0]))(jnp.asarray(x))
        return fe, jnp.transpose(per_pt, (1, 2, 0))      # [F, 3, N]

    fe, jac = enc_and_jac(jnp.asarray(ea))
    te = torch.tensor(ea, requires_grad=True)
    tf_, tJ = th.hash_encode_fused_dual(torch.tensor(x), te, None, tm)
    np.testing.assert_allclose(_np(tf_), np.asarray(fe), atol=FEAT_ATOL)
    np.testing.assert_allclose(_np(tJ), np.asarray(jac), atol=FEAT_ATOL)
    rng = np.random.default_rng(3)
    c1 = rng.normal(size=(n, 12)).astype(np.float32)
    c2 = rng.normal(size=(12, 3, n)).astype(np.float32)
    ref = np.asarray(jax.grad(lambda e: jnp.sum(enc_and_jac(e)[0] * c1)
                              + jnp.sum(enc_and_jac(e)[1] * c2))(
        jnp.asarray(ea)))
    ((tf_ * torch.tensor(c1)).sum() + (tJ * torch.tensor(c2)).sum()).backward()
    np.testing.assert_allclose(te.grad.numpy(), ref, rtol=0,
                               atol=GRAD_REL * np.abs(ref).max())


@pytest.mark.parametrize("dmr", [0, 16])
def test_sampler_encode_matches_jax_at_8_of_16_levels(dmr):
    """H2's plain version: dense levels exact f32 with clamped cells, hashed
    levels bf16 with the wrapped hash."""
    jm, tm = _metas(dmr, levels=16, end=128, logmap=10)
    ea, _, x = _inputs(jm, n=301)
    blocks = jh.build_dense_block_tables(jnp.asarray(ea), jm, max_levels=8)
    ref = jh.hash_encode_sampler(jnp.asarray(x), jnp.asarray(ea), blocks, jm,
                                 grid_levels=8)
    got = th.hash_encode_sampler(torch.tensor(x), torch.tensor(ea), tm, 8)
    lt = th.level_tables(tm, 8)
    assert 0 < lt.n_dense < 8 and got.shape == (301, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=FEAT_ATOL)


def test_modes_and_draws_are_checked_and_cpu_counts_no_launch():
    _, tm = _metas(0)
    ea, eb, x = (torch.tensor(a) for a in _inputs(_metas(0)[0]))
    lh = th.level_tables(tm).n_hashed
    n = x.shape[0]
    with pytest.raises(ValueError, match="mode"):
        th.hash_encode_fused_dual(x, ea, eb, tm, mode="raw")
    with pytest.raises(ValueError, match="u_b"):
        th.hash_encode_fused_dual(x, ea, eb, tm, mode="sampled")
    with pytest.raises(ValueError, match="u_a"):
        th.hash_encode_fused_dual(x, ea, eb, tm, mode="sampled_all",
                                  u_b=torch.rand(3, lh, n))
    with pytest.raises(ValueError, match="table b"):
        th.hash_encode_fused_dual(x, ea, None, tm, mode="sampled",
                                  u_b=torch.rand(3, lh, n))
    lt = th.level_tables(tm)
    assert th.level_tables(tm) is lt
    coarse = th.level_tables(th.prefix_meta(tm, 3))
    for a, b in ((coarse.res, lt.res), (coarse.sizes, lt.sizes),
                 (coarse.offsets, lt.offsets), (coarse.scales, lt.scales)):
        assert np.array_equal(a, b[:3])
    assert th.prefix_meta(tm, 3).table_rows == int(lt.offsets[3])
    scales, ints = lt.device_arrays(torch.device("cpu"))
    assert ints.dtype == torch.int32 and ints.tolist() == [
        lt.n_dense, *lt.res, *lt.sizes, *lt.offsets]
    assert scales.dtype == torch.float32 and scales.numpy().tobytes() \
        == th.level_scales(tm).tobytes()
    counts = (th.fused_fwd.launches, th.fused_bwd.launches,
              th.sampler_fwd.launches)
    e = ea.clone().requires_grad_(True)
    th.hash_encode_fused_dual(x, e, eb, tm)[0].sum().backward()
    th.hash_encode_sampler(x, ea, tm, 4)
    assert (th.fused_fwd.launches, th.fused_bwd.launches,
            th.sampler_fwd.launches) == counts


def test_level_tables_refuses_a_hashed_size_not_a_power_of_two():
    """The kernels wrap a hashed level's hash by a mask. A meta whose
    resolutions fall (desired below base) hashes level 0 into 2^19 rows
    and its level 1 into r^3 < 2^19 rows: refused."""
    meta = th.HashGridMeta(num_levels=2, level_dim=2, base_resolution=128,
                           log2_hashmap_size=19, desired_resolution=50)
    assert th.dense_level_count(meta) == 0
    assert meta.level_tables()[1][1] & (meta.level_tables()[1][1] - 1)
    with pytest.raises(ValueError, match="powers of two"):
        th.level_tables(meta)
    for dmr in (0, 16, 64):
        lt = th.level_tables(_metas(dmr)[1])
        hashed = lt.sizes[lt.n_dense:]
        assert not np.any(hashed & (hashed - 1))
