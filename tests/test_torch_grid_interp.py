"""The port's tetrahedral stencil and raw fetch (holoscene_tpu_torch/ops/
hashgrid.py: the plain versions of H1-fwd, H1-bwd and H2 that the CPU runs)
against the JAX package's hash_encode(interp="tetrahedral"),
hash_encode_dual(interp="tetrahedral") and hash_encode_fused_dual(
fetch="raw") on the CPU, on the tiny metas of tests/test_torch_hashgrid.py
(one dense level, or all dense) and on the flagship meta's boundary planes.

JAX's jacobian of the tetrahedral encode is its autodiff through the sort of
the fractions (jvp with the three basis tangents); the port's is H1's
analytic J. Tolerances are tests/test_torch_hashgrid.py's: features and J
atol 1e-5, table gradients 1e-5 of the largest JAX value, the points'
cotangent 1e-4 of its scale, and on the boundary planes 1e-6 of the largest
feature (tests/test_torch_extract.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401

from holoscene_tpu.ops import hashgrid as jh
from holoscene_tpu_torch.ops import hashgrid as th

FEAT_ATOL = 1e-5
GRAD_REL = 1e-5
X_REL = 1e-4
PLANE_REL = 1e-6
TET = "tetrahedral"


def _metas(dmr: int):
    kw = dict(num_levels=6, level_dim=2, base_resolution=4,
              log2_hashmap_size=8, desired_resolution=48, dense_max_res=dmr)
    return jh.HashGridMeta(**kw), th.HashGridMeta(**kw)


def _inputs(meta, n: int = 157, seed: int = 0):
    """Tables of uniform(-0.5, 0.5), points in [0.01, 0.99] and three
    outside [0, 1] (numpy)."""
    rng = np.random.default_rng(seed)
    ea = rng.uniform(-0.5, 0.5, (meta.table_rows, 2)).astype(np.float32)
    eb = rng.uniform(-0.5, 0.5, (meta.table_rows, 2)).astype(np.float32)
    x = rng.uniform(0.01, 0.99, (n, 3)).astype(np.float32)
    x[:3] = [[1.2, 0.5, 0.5], [-0.1, 0.3, 0.3], [0.5, 0.5, 1.01]]
    return ea, eb, x


def _np(a):
    return np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)


def _jax_tet_with_j(x, ea, jm):
    """JAX's tetrahedral packed encode of table a and its jacobian in the
    points ([L*2, 3, N], point-minor as H1's J) by three jvps."""
    f = lambda p: jh.hash_encode(p, jnp.asarray(ea), jm, interp=TET)  # noqa
    cols = []
    for d in range(3):
        t = jnp.zeros_like(jnp.asarray(x)).at[:, d].set(1.0)
        feats, jv = jax.jvp(f, (jnp.asarray(x),), (t,))
        cols.append(jv)
    return np.asarray(feats), np.transpose(np.stack(cols, 0), (2, 0, 1))


@pytest.mark.parametrize("dmr", [0, 64])
def test_tetrahedral_forward_matches_jax(dmr):
    """feats_a, J_a (against JAX's autodiff) and feats_b of the plain
    H1-fwd's tetrahedral instantiation; H2's packed tetrahedral mode gives
    feats_a too. Dense and hashed levels; the points outside [0, 1] zero."""
    jm, tm = _metas(dmr)
    ea, eb, x = _inputs(jm)
    ref_a, ref_j = _jax_tet_with_j(x, ea, jm)
    ref_a2, ref_b = jh.hash_encode_dual(jnp.asarray(x), jnp.asarray(ea),
                                        jnp.asarray(eb), jm, interp=TET)
    np.testing.assert_allclose(np.asarray(ref_a2), ref_a, atol=FEAT_ATOL)
    fa, J, fb = th.hash_encode_fused_dual(torch.tensor(x), torch.tensor(ea),
                                          torch.tensor(eb), tm, interp=TET)
    np.testing.assert_allclose(_np(fa), ref_a, atol=FEAT_ATOL)
    np.testing.assert_allclose(_np(J), ref_j, atol=FEAT_ATOL)
    np.testing.assert_allclose(_np(fb), np.asarray(ref_b), atol=FEAT_ATOL)
    assert float(np.abs(ref_j).max()) > 1.0     # J is ±scale x values
    assert not _np(fa)[:3].any() and not _np(J)[..., :3].any()
    h2 = th.hash_encode_sampler(torch.tensor(x), torch.tensor(ea), tm,
                                packed=True, interp=TET)
    np.testing.assert_allclose(_np(h2), ref_a, atol=FEAT_ATOL)
    # four corners, not eight: the trilinear encode is another function
    tri = jh.hash_encode(jnp.asarray(x), jnp.asarray(ea), jm)
    assert float(np.abs(np.asarray(tri) - ref_a).max()) > 1e-3


@pytest.mark.parametrize("dmr", [0, 64])
def test_tetrahedral_backward_matches_jax(dmr):
    """Both tables' gradients of the plain H1-bwd (exact) against JAX's
    gradient of sum(feats_a ct_a) + sum(J ct_J) + sum(feats_b ct_b), where
    J is the jvp of the packed tetrahedral encode: the second-order path
    through J included. Also the points' cotangent (the port computes it on
    the CPU), which has no term through J (piecewise constant)."""
    jm, tm = _metas(dmr)
    ea, eb, x = _inputs(jm)
    n, F = x.shape[0], 2 * jm.num_levels
    rng = np.random.default_rng(1)
    cts = [rng.normal(size=s).astype(np.float32)
           for s in ((n, F), (F, 3, n), (n, F))]

    def loss(a, b, p):
        def fa_(q):
            return jh.hash_encode(q, a, jm, interp=TET)

        feats = fa_(p)
        js = [jax.jvp(fa_, (p,), (jnp.zeros_like(p).at[:, d].set(1.0),))[1]
              for d in range(3)]
        J = jnp.transpose(jnp.stack(js, 0), (2, 0, 1))
        fb = jh.hash_encode(p, b, jm, interp=TET)
        return (jnp.sum(feats * cts[0]) + jnp.sum(J * cts[1])
                + jnp.sum(fb * cts[2]))

    ga, gb, gx = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(ea), jnp.asarray(eb), jnp.asarray(x))
    ta = torch.tensor(ea, requires_grad=True)
    tb = torch.tensor(eb, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    out = th.hash_encode_fused_dual(tx, ta, tb, tm, interp=TET)
    sum((o * torch.tensor(c)).sum() for o, c in zip(out, cts)).backward()
    for ref, got in ((ga, ta.grad), (gb, tb.grad)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(_np(got), ref,
                                   atol=GRAD_REL * np.abs(ref).max())
    gx = np.asarray(gx)
    np.testing.assert_allclose(_np(tx.grad), gx, atol=X_REL * np.abs(gx).max())
    with pytest.raises(ValueError, match="sampled backward"):
        th.hash_encode_fused_dual(tx, ta, tb, tm, mode="sampled",
                                  u_b=torch.zeros(3, 0, n), interp=TET)


@pytest.mark.parametrize("dmr", [0, 64])
def test_raw_fetch_matches_jax(dmr):
    """The raw fetch (JAX hash_encode_fused_dual(fetch="raw"): float32
    values, no bf16 rounding) forward, and both tables' gradients and the
    points' cotangent of its exact backward, against JAX's custom VJP."""
    jm, tm = _metas(dmr)
    ea, eb, x = _inputs(jm)
    n, F = x.shape[0], 2 * jm.num_levels
    ref = jh.hash_encode_fused_dual(jnp.asarray(x), jnp.asarray(ea),
                                    jnp.asarray(eb), jm, fetch="raw")
    got = th.hash_encode_fused_dual(torch.tensor(x), torch.tensor(ea),
                                    torch.tensor(eb), tm, fetch="raw")
    for r, g in zip(ref, got):
        np.testing.assert_allclose(_np(g), np.asarray(r), atol=FEAT_ATOL)
    packed = th.hash_encode_fused_dual(torch.tensor(x), torch.tensor(ea),
                                       torch.tensor(eb), tm)
    assert float((packed[0] - got[0]).abs().max()) > 1e-4   # bf16 rounding
    rng = np.random.default_rng(2)
    cts = [rng.normal(size=s).astype(np.float32)
           for s in ((n, F), (F, 3, n), (n, F))]

    def loss(a, b, p):
        o = jh.hash_encode_fused_dual(p, a, b, jm, fetch="raw")
        return sum(jnp.sum(oo * c) for oo, c in zip(o, cts))

    ga, gb, gx = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(ea), jnp.asarray(eb), jnp.asarray(x))
    ta = torch.tensor(ea, requires_grad=True)
    tb = torch.tensor(eb, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    out = th.hash_encode_fused_dual(tx, ta, tb, tm, fetch="raw")
    sum((o * torch.tensor(c)).sum() for o, c in zip(out, cts)).backward()
    for r, g in ((ga, ta.grad), (gb, tb.grad)):
        r = np.asarray(r)
        np.testing.assert_allclose(_np(g), r, atol=GRAD_REL * np.abs(r).max())
    gx = np.asarray(gx)
    np.testing.assert_allclose(_np(tx.grad), gx, atol=X_REL * np.abs(gx).max())
    with pytest.raises(ValueError, match="trilinear"):
        th.hash_encode_fused_dual(tx, ta, tb, tm, interp=TET, fetch="raw")


def test_tetrahedral_prefix_levels_and_single_table():
    """The coarse prefix (`levels`) and the single-table mode of the
    tetrahedral instantiation: the full encode's first columns and its J."""
    jm, tm = _metas(0)
    ea, eb, x = _inputs(jm)
    fa, J, _ = th.hash_encode_fused_dual(torch.tensor(x), torch.tensor(ea),
                                         torch.tensor(eb), tm, interp=TET)
    pa, pJ = th.hash_encode_fused_dual(torch.tensor(x), torch.tensor(ea),
                                       None, tm, levels=3, interp=TET)
    np.testing.assert_array_equal(_np(pa), _np(fa)[:, :6])
    np.testing.assert_array_equal(_np(pJ), _np(J)[:6])


def test_tetrahedral_on_flagship_boundary_planes():
    """At the flagship meta (levels 0-4 dense, level 0 at the integer scale
    15) on the six boundary planes of a 64^3 extraction grid. At x01 = 1 a
    corner of level 0 lies past the last grid point: JAX's packed encode
    wraps its dense row, the trilinear stencil of H1 / H2 clamps the cell
    instead (the same features, and a J that vanishes there). The
    tetrahedral stencil takes JAX's wrap: clamped, its walk reaches the
    same grid point with weight 1 and the same features, but its J, which
    does not vanish at a face, is the other one-sided derivative (and JAX's
    training step puts eikonal points on the cube's faces). H2's packed
    tetrahedral mode and H1-fwd's features agree with JAX's within 1e-6 of
    the largest on every level, and H1's J JAX's jvp within 1e-6 of its
    largest (~1e3: the scale of the finest level)."""
    meta_kw = dict(num_levels=16, level_dim=2, base_resolution=16,
                   log2_hashmap_size=19, desired_resolution=2048)
    jm, tm = jh.HashGridMeta(**meta_kw), th.HashGridMeta(**meta_kw)
    rng = np.random.default_rng(0)
    emb = rng.uniform(-0.5, 0.5, (tm.table_rows, 2)).astype(np.float32)
    axis = np.linspace(0.0, 1.0, 24, dtype=np.float32)
    u, v = (a.reshape(-1) for a in np.meshgrid(axis, axis, indexing="ij"))
    planes = []
    for d in range(3):
        for side in (0.0, 1.0):
            p = np.empty((u.size, 3), np.float32)
            p[:, d] = side
            p[:, (d + 1) % 3], p[:, (d + 2) % 3] = u, v
            planes.append(p)
    x01 = np.concatenate(planes)
    lt = th.level_tables(tm)
    assert lt.scales[0] == 15.0 and lt.res[0] == 16 and lt.n_dense == 5
    ref, ref_j = _jax_tet_with_j(x01, emb, jm)
    scale = float(np.abs(ref).max())
    h2 = th.hash_encode_sampler(torch.tensor(x01), torch.tensor(emb), tm,
                                packed=True, interp=TET).numpy()
    h1, J = th.hash_encode_fused_dual(torch.tensor(x01), torch.tensor(emb),
                                      None, tm, interp=TET)
    at_one = (x01 == 1.0).any(-1)
    for got, what in ((h2, "H2"), (h1.detach().numpy(), "H1-fwd")):
        assert float(np.abs(got - ref).max()) <= PLANE_REL * scale, what
        assert float(np.abs(got[at_one, :2] - ref[at_one, :2]).max()) \
            <= PLANE_REL * scale, what
    err_j = float(np.abs(_np(J) - ref_j).max())
    assert err_j <= PLANE_REL * float(np.abs(ref_j).max()), err_j
    with pytest.raises(ValueError, match="packed"):
        th.hash_encode_sampler(torch.tensor(x01), torch.tensor(emb), tm,
                               interp=TET)
