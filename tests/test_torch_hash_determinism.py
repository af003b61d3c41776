"""H1-bwd's fixed-point accumulation (csrc/hash_fused_bwd.cu's header note;
holoscene_tpu_torch/ops/hashgrid.py::fixed_point): the same bits for any
order of the points, and still JAX's gradient.

On the CPU, the plain twin fused_bwd_plain, which sums as the kernel does
(the same exponent, int64 index_add_, the same conversion): against JAX's
_hash_fused_bwd (trilinear: exact, sampled, sampled_all with JAX's own
uniforms), the transpose of JAX's tetrahedral encode and its jacobian, and
_gather_pairs_transpose (no jacobian term: the packed encode's transpose),
at tests/test_torch_hashgrid.py's tolerance (1e-5 of the largest JAX
value; in the sampled modes the pairs whose corner can flip in the last
bit carry zero cotangents on both sides); bitwise equal under a
permutation of the points with their cotangents and uniforms; the
exponent at cotangents of 1e6 and 1e-6 (no row overflows, nothing
underflows to zero). On the card (marker `cuda`, skipped without one):
the kernel launched twice and on the permuted inputs gives the same bits,
and matches plain within 1e-5 of the largest value. Run the card tests
with

    python -m pytest --noconftest tests/test_torch_hash_determinism.py -m cuda

(the JAX package is imported inside the CPU tests only)."""

import numpy as np
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401

from holoscene_tpu_torch.ops import hashgrid as th

GRAD_REL = 1e-5
# (stencil, mode): the trilinear fused backward in each mode, the
# tetrahedral one (exact only), and the single-table transpose without the
# jacobian term ("packed")
CASES = [("trilinear", "exact"), ("trilinear", "sampled"),
         ("trilinear", "sampled_all"), ("tetrahedral", "exact"),
         ("packed", "exact")]
META = dict(num_levels=6, level_dim=2, base_resolution=4,
            log2_hashmap_size=8, desired_resolution=48, dense_max_res=0)


def _inputs(case, n: int = 157, seed: int = 0, device="cpu"):
    """(x01, n_rows, [ct_fa, ct_J, ct_fb], u_b, u_a, lt, numpy x01) of a
    case: points in [0.01, 0.99] and three outside [0, 1], normal
    cotangents, uniform draws (the JAX test draws its own)."""
    interp, mode = case
    meta = th.HashGridMeta(**META)
    lt = th.level_tables(meta)
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.01, 0.99, (n, 3)).astype(np.float32)
    x[:3] = [[1.2, 0.5, 0.5], [-0.1, 0.3, 0.3], [0.5, 0.5, 1.01]]
    F = 2 * lt.n_levels
    cts = [rng.normal(size=s).astype(np.float32)
           for s in ((n, F), (F, 3, n), (n, F))]
    if interp == "packed":
        cts[1] = cts[2] = None
    u_b = rng.uniform(size=(3, lt.n_hashed, n)).astype(np.float32)
    u_a = rng.uniform(size=(lt.n_hashed, n)).astype(np.float32)

    def t(a):
        return None if a is None else torch.tensor(a, device=device)

    return (t(x), meta.table_rows, [t(c) for c in cts],
            t(u_b) if mode != "exact" else None,
            t(u_a) if mode == "sampled_all" else None, lt, x)


def _plain(x, rows, cts, u_b, u_a, lt, case):
    interp, mode = case
    return th.fused_bwd_plain(
        x, rows, *cts, lt, mode, u_b, u_a,
        interp="trilinear" if interp == "packed" else interp)[:2]


def _permuted(x, cts, u_b, u_a, perm):
    """The inputs with the points in the order perm."""
    cts = [None if c is None else (c[..., perm] if c.dim() == 3 else c[perm])
           for c in cts]
    return (x[perm], cts, None if u_b is None else u_b[..., perm],
            None if u_a is None else u_a[..., perm])


def _bits(t):
    return t.contiguous().view(torch.int32)


KEY = 7


def _jax_uniforms(case, n: int):
    """The case's uniforms (u_b, u_a or None) as JAX's _hash_fused_bwd
    draws them from the fused call's seed."""
    import jax
    from torch_stage1_cases import fused_uniforms

    u_b, u_a = fused_uniforms(jax.random.PRNGKey(KEY), th.HashGridMeta(**META),
                              n)
    return (u_b if case[1] != "exact" else None,
            u_a if case[1] == "sampled_all" else None)


def _jax_grads(case, x, cts, rows):
    """JAX's gradients of the tables (a, b or None) for these cotangents."""
    import jax
    import jax.numpy as jnp

    from holoscene_tpu.ops import hashgrid as jh

    interp, mode = case
    jm = jh.HashGridMeta(**META)
    rng = np.random.default_rng(2)
    ea, eb = (jnp.asarray(rng.uniform(-0.5, 0.5, (rows, 2)).astype(
        np.float32)) for _ in range(2))
    xj = jnp.asarray(x)
    c = [None if a is None else jnp.asarray(a.numpy()) for a in cts]
    if interp == "packed":
        ga = jax.grad(lambda a: jnp.sum(jh.hash_encode(xj, a, jm) * c[0]))(ea)
        return np.asarray(ga), None
    if interp == "tetrahedral":
        def loss(a, b):
            def fa_(q):
                return jh.hash_encode(q, a, jm, interp="tetrahedral")

            js = [jax.jvp(fa_, (xj,), (jnp.zeros_like(xj).at[:, d].set(1.0),))
                  [1] for d in range(3)]
            J = jnp.transpose(jnp.stack(js, 0), (2, 0, 1))
            fb = jh.hash_encode(xj, b, jm, interp="tetrahedral")
            return (jnp.sum(fa_(xj) * c[0]) + jnp.sum(J * c[1])
                    + jnp.sum(fb * c[2]))

        g = jax.grad(loss, argnums=(0, 1))(ea, eb)
        return tuple(np.asarray(a) for a in g)
    key = jax.random.PRNGKey(KEY)
    gs = jax.lax.bitcast_convert_type(jax.random.bits(key, dtype=jnp.uint32),
                                      jnp.float32)

    def f(a, b):
        o = jh.hash_encode_fused_dual(xj, a, b, jm, "packed", seed=gs,
                                      color_bwd=mode)
        return sum(jnp.sum(oo * cc) for oo, cc in zip(o, c))

    return tuple(np.asarray(a) for a in jax.grad(f, argnums=(0, 1))(ea, eb))


def _zero_near_flips(x, cts, u_b, u_a, lt, mode):
    """The sampled modes' pairs whose corner can flip in the last bit get
    zero cotangents (tests/test_torch_hashgrid.py)."""
    if mode == "exact":
        return cts
    n = x.shape[0]
    keep = torch.ones(lt.n_levels, n, dtype=torch.bool)
    keep[lt.n_dense:] = ~th.near_flip_pairs(x, lt, cts[0], cts[1], u_b, u_a,
                                            mode)
    return [cts[0] * keep.T.repeat_interleave(2, 1),
            cts[1] * keep.repeat_interleave(2, 0)[:, None, :],
            cts[2] * keep.T.repeat_interleave(2, 1)]


@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_plain_twin_matches_jax(case):
    x, rows, cts, _, _, lt, xn = _inputs(case)
    u_b, u_a = _jax_uniforms(case, x.shape[0])
    cts = _zero_near_flips(x, cts, u_b, u_a, lt, case[1])
    refs = _jax_grads(case, xn, cts, rows)
    got = _plain(x, rows, cts, u_b, u_a, lt, case)
    for ref, g in zip(refs, got):
        assert (ref is None) == (g is None)
        if ref is not None:
            np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                       atol=GRAD_REL * np.abs(ref).max())


@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_plain_twin_is_bitwise_equal_under_a_permutation(case):
    x, rows, cts, u_b, u_a, lt, _ = _inputs(case, n=600, seed=3)
    ref = _plain(x, rows, cts, u_b, u_a, lt, case)
    perm = torch.randperm(x.shape[0],
                          generator=torch.Generator().manual_seed(5))
    xp, cp, ubp, uap = _permuted(x, cts, u_b, u_a, perm)
    got = _plain(xp, rows, cp, ubp, uap, lt, case)
    for r, g in zip(ref, got):
        if r is not None:
            assert torch.equal(_bits(r), _bits(g))
            assert r.abs().max() > 0


@pytest.mark.parametrize("scale", [1e6, 1e-6])
def test_exponent_at_large_and_small_cotangents(scale):
    """Cotangents scaled by 1e6 and 1e-6: the gradient scales with them
    (no row wraps past 2^63, no contribution rounds away), and each level's
    bound times its scale lies in [2^(57-c), 2^(62-c)) with 8 N <= 2^c
    (sampled_all's table a 4 bits lower). The worst row: every point at
    one place, so each level's 8 rows take all 8 N contributions of one
    sign."""
    case = ("trilinear", "sampled_all")
    x, rows, cts, u_b, u_a, lt, _ = _inputs(case)
    n = x.shape[0]
    base = _plain(x, rows, cts, u_b, u_a, lt, case)
    big = [c * scale for c in cts]
    got = _plain(x, rows, big, u_b, u_a, lt, case)
    for b, g in zip(base, got):
        assert torch.isfinite(g).all()
        assert torch.equal(g != 0, b != 0)
        np.testing.assert_allclose((g / scale).numpy(), b.numpy(), rtol=0,
                                   atol=1e-6 * float(b.abs().max()))
    sc, inv = th.fixed_point(*big, lt, case[1])
    c = (8 * n - 1).bit_length()
    bound_a = (big[0].abs().reshape(n, -1, 2).amax((0, 2))
               + torch.as_tensor(lt.scales) * 4.5
               * big[1].abs().reshape(lt.n_levels, -1).amax(1))
    prod = torch.stack([bound_a * sc[0] * 16, big[2].abs().reshape(
        n, -1, 2).amax((0, 2)) * sc[1]]).double()
    assert (prod >= 2.0 ** (61 - c)).all() and (prod < 2.0 ** (62 - c)).all()
    assert torch.equal(inv, 1 / sc)
    # one place for every point, the same cotangents: sums of 8 N terms
    one = x[3:4].expand(n, 3).contiguous()
    same = [torch.full_like(cts[0], scale), torch.full_like(cts[1], scale),
            torch.full_like(cts[2], scale)]
    ga, gb = _plain(one, rows, same, None, None, lt, ("trilinear", "exact"))
    ga1, gb1 = _plain(one[:1], rows, [same[0][:1], same[1][..., :1],
                                      same[2][:1]], None, None, lt,
                      ("trilinear", "exact"))
    for g, g1 in ((ga, ga1), (gb, gb1)):
        np.testing.assert_allclose(g.double().numpy(),
                                   n * g1.double().numpy(), rtol=1e-6,
                                   atol=1e-6 * n * float(g1.abs().max()))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_kernel_is_bitwise_repeatable_and_matches_plain(case, cuda):
    """Two launches and one on the permuted points give the same bits; plain
    within 1e-5 of the largest value (the sampled modes' near-flip pairs
    zeroed), at 20,000 points so that warps aggregate and rows collide."""
    interp, mode = case
    x, rows, cts, u_b, u_a, lt, _ = _inputs(case, n=20000, seed=9,
                                            device=cuda)
    if mode != "exact":
        cts = _zero_near_flips(x.cpu(), [c.cpu() for c in cts],
                               u_b.cpu(), None if u_a is None else u_a.cpu(),
                               lt, mode)
        cts = [c.to(cuda) for c in cts]
    kw = dict(interp="trilinear" if interp == "packed" else interp)
    n0 = th.fused_bwd.launches
    first, second = (th.fused_bwd(x, rows, *cts, lt, mode, u_b, u_a, **kw)
                     for _ in range(2))
    perm = torch.randperm(x.shape[0], device=cuda)
    xp, cp, ubp, uap = _permuted(x, cts, u_b, u_a, perm)
    third = th.fused_bwd(xp, rows, *cp, lt, mode, ubp, uap, **kw)
    assert th.fused_bwd.launches == n0 + 3
    ref = _plain(x, rows, cts, u_b, u_a, lt, case)
    for a, b, c, r in zip(first, second, third, ref):
        if a is None:
            continue
        assert torch.equal(_bits(a), _bits(b))
        assert torch.equal(_bits(a), _bits(c))
        err = float((a - r).abs().max())
        assert err <= GRAD_REL * float(r.abs().max()), (case, err)
