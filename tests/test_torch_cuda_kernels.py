"""The hand-written CUDA kernels K1-K4, H1/H2 and T1 (holoscene_tpu_torch/csrc)
against their plain PyTorch versions, on the card. CUDA kernels have no
CPU mode, so every test here needs an NVIDIA GPU with nvcc and skips
without one; run them on the card with

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q
"""

import numpy as np
import pytest
import torch

from holoscene_tpu_torch.ops import gaussians as tg
from holoscene_tpu_torch.ops import gs_trace as ttrace
from holoscene_tpu_torch.ops import hashgrid as thash
from holoscene_tpu_torch.ops import splat as tsplat
from holoscene_tpu_torch.ops import splat_flat as tflat
from holoscene_tpu_torch.ops import splat_topk as ttopk
from test_torch_walk_cases import (
    FWD_USED,
    cotangent,
    flat_layout,
    hard_fwd_tiles,
    hard_tiles,
    topk_layout,
)

pytestmark = pytest.mark.cuda

FWD_ATOL = 2e-4
BWD_ATOL, BWD_RTOL = 5e-4, 5e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _projected(n, res, seed, wall=False):
    """Projected gaussians (CPU tensors) of a random scene; wall=True puts
    an opaque layer in front so tiles saturate."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(1.0, 1.1, n) if wall else rng.uniform(1.2, 3.0, n)
    means = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.6, 0.6, n),
                      z], -1)
    q = rng.normal(size=(n, 4))
    scales = rng.uniform(0.02, 0.12 if wall else 0.08, (n, 3))
    f = res * 0.8
    intr = torch.tensor([[f, 0, res / 2], [0, f, res / 2], [0, 0, 1.0]])
    xy, depth, conic, _, valid = tg.project_gaussians_fused(
        *(torch.as_tensor(x, dtype=torch.float32) for x in (means, q, scales)),
        torch.eye(4), intr, res, res)
    opac = torch.as_tensor(rng.uniform(0.9 if wall else 0.2, 0.97, n),
                           dtype=torch.float32)
    rgb = torch.as_tensor(rng.uniform(0, 1, (n, 3)), dtype=torch.float32)
    return xy, depth, conic, opac, valid, rgb


def _walk_inputs(xy, depth, conic, opac, valid, rgb, res):
    tiles = -(-res // 16)
    plan = tflat.plan_flat(xy, conic, opac, valid, tiles, tiles, 16)
    bins = tflat.build_flat_bins(xy, depth, conic, opac, valid, tiles_x=tiles,
                                 tiles_y=tiles, tile_size=16, plan=plan)
    n = xy.shape[0]
    pay = torch.cat([xy, conic, opac[:, None], rgb, depth[:, None],
                     torch.ones(n, 1), torch.zeros(n, 5)], -1)
    pay = torch.cat([pay, torch.zeros(1, 16)], 0)
    return (pay[bins["gidx"]].contiguous(), bins["tile_chunk_start"],
            bins["tile_chunk_cnt"], tiles)


@pytest.mark.parametrize("case", ["random64", "random40", "saturated"])
def test_kernels_match_plain(cuda, case):
    res, n, seed, wall = {"random64": (64, 800, 0, False),
                          "random40": (40, 400, 1, False),
                          "saturated": (48, 900, 2, True)}[case]
    cand, cs, cc, tiles = _walk_inputs(*_projected(n, res, seed, wall), res)
    ref = tflat.flat_fwd(cand, cs, cc, tiles, 16, res, res)
    n_fwd = tflat.flat_fwd.launches
    out = tflat.flat_fwd(cand.to(cuda), cs.to(cuda), cc.to(cuda), tiles, 16,
                         res, res)
    torch.cuda.synchronize()
    assert tflat.flat_fwd.launches == n_fwd + 1
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), atol=FWD_ATOL)
    if wall:
        assert (ref[:, 0, 5] < cc).any()

    v = torch.as_tensor(np.random.default_rng(seed).normal(size=ref.shape),
                        dtype=torch.float32)
    v[..., 5:] = 0.0
    dref = tflat.flat_bwd(cand, cs, ref, v, tiles, 16, res, res)
    n_bwd = tflat.flat_bwd.launches
    dker, again = (tflat.flat_bwd(cand.to(cuda), cs.to(cuda), ref.to(cuda),
                                  v.to(cuda), tiles, 16, res, res)
                   for _ in range(2))
    torch.cuda.synchronize()
    assert tflat.flat_bwd.launches == n_bwd + 2
    np.testing.assert_allclose(dker.cpu().numpy(), dref.numpy(),
                               atol=BWD_ATOL, rtol=BWD_RTOL)
    assert torch.equal(dker, again)   # sums in a fixed order: the same bits


def test_composite_autograd_on_card_matches_cpu(cuda):
    res = 48
    args = _projected(500, res, 5)
    tiles = -(-res // 16)
    plan = tflat.plan_flat(args[0], args[2], args[3], args[4], tiles, tiles,
                           16)
    grads = []
    for dev in ("cpu", cuda):
        xs = [a.detach().to(dev, copy=True).requires_grad_(
            a.is_floating_point()) for a in args]
        r, d, a, _ = tflat.composite_tiles_flat(
            xs[0], xs[1], xs[2], xs[3], xs[5], xs[4], res, res, 16, plan)
        (r.square().mean() + a.mean() + 0.01 * d.mean()).backward()
        grads.append([x.grad.cpu().numpy() for x in xs if x.requires_grad])
    for gc, gk in zip(*grads):
        np.testing.assert_allclose(gk, gc, atol=BWD_ATOL, rtol=BWD_RTOL)


def _topk_lists(n, res, k, seed, wall=False):
    """Per-tile top-k lists (CPU tensors): gated cand [T,K,16] with K padded
    to 128, origins [T,2], counts [T] int32."""
    xy, depth, conic, opac, valid, rgb = _projected(n, res, seed, wall)
    # 3-sigma radius from the conic (the inverse 2D covariance)
    det = conic[:, 0] * conic[:, 2] - conic[:, 1] ** 2
    mid = 0.5 * (conic[:, 0] + conic[:, 2]) / det
    radius = torch.ceil(3.0 * torch.sqrt(
        mid + torch.sqrt(torch.clamp(mid * mid - 1.0 / det, min=0.0))))
    top_idx, live, origins = tsplat.select_topk(xy, depth, radius, valid, res,
                                                res, 16, k)
    cand = tflat.gather_payload(xy, depth, conic, opac, rgb,
                                top_idx.reshape(-1)).reshape(-1, k, 16)
    return (ttopk.gate_and_pad(cand, live.float()), origins,
            live.sum(1).to(torch.int32))


@pytest.mark.parametrize("case", ["random64", "random40", "saturated",
                                  "count0"])
def test_topk_kernels_match_plain(cuda, case):
    res, n, k, seed, wall = {"random64": (64, 800, 256, 0, False),
                             "random40": (40, 400, 200, 1, False),
                             "saturated": (48, 1400, 512, 2, True),
                             "count0": (48, 300, 128, 3, False)}[case]
    cand, origins, counts = _topk_lists(n, res, k, seed, wall)
    if case == "count0":
        counts[0] = 0
    ref, ref_used = ttopk.composite_fwd(cand, origins, counts, 16, res, res)
    n_fwd = ttopk.composite_fwd.launches
    out, used = ttopk.composite_fwd(cand.to(cuda), origins.to(cuda),
                                    counts.to(cuda), 16, res, res)
    torch.cuda.synchronize()
    assert ttopk.composite_fwd.launches == n_fwd + 1
    np.testing.assert_array_equal(used.cpu().numpy(), ref_used.numpy())
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), atol=FWD_ATOL)
    if wall:
        assert (ref_used < -(-counts // 128)).any()
    if case == "count0":
        assert int(used[0]) == 0 and not out[0, :, :5].any()

    v = torch.as_tensor(np.random.default_rng(seed).normal(size=ref.shape),
                        dtype=torch.float32)
    v[..., 5:] = 0.0
    dref = ttopk.composite_bwd(cand, origins, ref_used, ref, v, 16, res, res)
    n_bwd = ttopk.composite_bwd.launches
    dker, again = (ttopk.composite_bwd(
        cand.to(cuda), origins.to(cuda), ref_used.to(cuda), ref.to(cuda),
        v.to(cuda), 16, res, res) for _ in range(2))
    torch.cuda.synchronize()
    assert ttopk.composite_bwd.launches == n_bwd + 2
    np.testing.assert_allclose(dker.cpu().numpy(), dref.numpy(),
                               atol=BWD_ATOL, rtol=BWD_RTOL)
    assert torch.equal(dker, again)   # sums in a fixed order: the same bits
    assert not dker.cpu()[cand[..., 5] == 0].any()   # dead slots: exact 0


@pytest.mark.parametrize("ortho", [False, True])
def test_topk_render_autograd_on_card_matches_cpu(cuda, ortho):
    """render_gaussians without a flat plan, values and gradients, card
    against CPU. The gather's transpose is an index_add: atomics on the
    card, so its sums come in no fixed order (covered by the tolerance)."""
    rng = np.random.default_rng(11)
    n, res = 500, 48
    host = [np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.6, 0.6, n),
                      rng.uniform(1.2, 3.0, n)], -1),
            rng.normal(size=(n, 4)), rng.uniform(0.02, 0.08, (n, 3)),
            rng.uniform(0.2, 0.95, n), rng.uniform(0, 1, (n, 3))]
    f = res * (0.4 if ortho else 0.8)
    results = []
    for dev in ("cpu", cuda):
        xs = [torch.tensor(a, dtype=torch.float32, device=dev,
                           requires_grad=True) for a in host]
        intr = torch.tensor([[f, 0, res / 2], [0, f, res / 2], [0, 0, 1.0]],
                            device=dev)
        out = tsplat.render_gaussians(
            *xs, torch.eye(4, device=dev), intr, res, res, max_per_tile=200,
            ortho=ortho)
        (out["rgb"].square().mean() + out["alpha"].mean()
         + 0.01 * out["depth"].mean()).backward()
        results.append((out["rgb"].detach().cpu().numpy(),
                        [x.grad.cpu().numpy() for x in xs]))
    np.testing.assert_allclose(results[1][0], results[0][0], atol=FWD_ATOL)
    for gc, gk in zip(results[0][1], results[1][1]):
        np.testing.assert_allclose(gk, gc, atol=BWD_ATOL, rtol=BWD_RTOL)


def _hard_walk(layout, ts, dev, tiles=hard_tiles):
    """The hand-built tiles of test_torch_walk_cases.py (`tiles` builds
    them) in one layout on `dev`: (fwd(), bwd(out, used, v), v)."""
    lists, origins, (w, h) = tiles(ts=ts)
    v = torch.as_tensor(cotangent(len(lists), origins, (w, h), ts)).to(dev)
    if layout == "flat":
        cand, cs, cc = (torch.as_tensor(x).to(dev) for x in flat_layout(lists))
        geom = (-(-w // ts), ts, w, h)

        def fwd():
            out = tflat.flat_fwd(cand, cs, cc, *geom)
            return out, out[:, 0, 5].int()

        return fwd, lambda o, _u, v: tflat.flat_bwd(cand, cs, o, v, *geom), v
    cand, counts = (torch.as_tensor(x).to(dev) for x in topk_layout(lists))
    org = torch.as_tensor(origins).to(dev)
    return (lambda: ttopk.composite_fwd(cand, org, counts, ts, w, h),
            lambda o, u, v: ttopk.composite_bwd(cand, org, u, o, v, ts, w, h),
            v)


@pytest.mark.parametrize("ts", [16, 32])
@pytest.mark.parametrize("layout", ["flat", "topk"])
def test_backward_walks_on_hard_tiles(cuda, layout, ts):
    """K2 / K4 against plain where the walk is most likely wrong: used = 0
    beside a full walk, candidates live in one warp only or nowhere, the
    0.999 clamp, edge tiles, an early stop; two launches give the same bits.
    ts = 32 runs the 1024-thread blocks."""
    fwd_p, bwd_p, v_p = _hard_walk(layout, ts, "cpu")
    ref, ref_used = fwd_p()
    dref = bwd_p(ref, ref_used, v_p)
    fwd, bwd, v = _hard_walk(layout, ts, cuda)
    out, used = fwd()
    assert used.tolist() == ref_used.tolist()
    assert used.tolist()[0] == 0 and used.tolist()[1] == 3
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), atol=FWD_ATOL)
    n_bwd = tflat.flat_bwd.launches + ttopk.composite_bwd.launches
    first = bwd(ref.to(cuda), ref_used.to(cuda), v)
    second = bwd(ref.to(cuda), ref_used.to(cuda), v)
    torch.cuda.synchronize()
    assert tflat.flat_bwd.launches + ttopk.composite_bwd.launches == n_bwd + 2
    assert torch.equal(first, second)
    np.testing.assert_allclose(first.cpu().numpy(), dref.numpy(),
                               atol=BWD_ATOL, rtol=BWD_RTOL)
    assert not first.cpu()[dref == 0].any()   # plain's exact zeros stay zeros


@pytest.mark.parametrize("ts", [16, 32])
@pytest.mark.parametrize("layout", ["flat", "topk"])
def test_forward_walks_on_hard_fwd_tiles(cuda, layout, ts):
    """K1 / K3 against plain where the per-warp test and the look-ahead are
    most likely wrong: thin ellipses crossing a tile from outside,
    single-pixel candidates at warp corners, candidates within 1e-6 of the
    1/255 cut, conics that are not positive definite, stops on a chunk
    boundary and mid-chunk, a tile that never saturates, an edge column.
    The same chunks walked as plain, and two launches give the same bits.
    ts = 32 runs the 1024-thread blocks."""
    ref, ref_used = _hard_walk(layout, ts, "cpu", hard_fwd_tiles)[0]()
    fwd = _hard_walk(layout, ts, cuda, hard_fwd_tiles)[0]
    n_fwd = tflat.flat_fwd.launches + ttopk.composite_fwd.launches
    (out, used), (again, used_again) = fwd(), fwd()
    torch.cuda.synchronize()
    assert tflat.flat_fwd.launches + ttopk.composite_fwd.launches == n_fwd + 2
    assert used.tolist() == ref_used.tolist() == FWD_USED
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), atol=FWD_ATOL)
    assert torch.equal(out, again) and torch.equal(used, used_again)


# ---------------------------------------------------------------------------
# the hash-grid kernels H1-fwd, H1-bwd and H2 (csrc/hash_*.cu) against their
# plain versions (run on the CPU). Forward kernels: two launches give the
# same bits, and agree with plain to 1e-5 of the output's largest value
# (the 8-corner sums in another order). H1-bwd: atomicAdd makes the sums
# order-dependent, so two launches and plain agree to 1e-5 of the largest
# gradient, not bitwise; in the sampled modes the pairs whose corner can
# flip in the last bit (thash.near_flip_pairs) carry zero cotangents.
# ---------------------------------------------------------------------------

H_REL = 1e-5


def _hash_case(dmr, n=3001, levels=6, end=48, logmap=8, seed=0):
    meta = thash.HashGridMeta(num_levels=levels, level_dim=2,
                              base_resolution=4, log2_hashmap_size=logmap,
                              desired_resolution=end, dense_max_res=dmr)
    rng = np.random.default_rng(seed)
    ea, eb = (torch.as_tensor(rng.uniform(-0.5, 0.5, (meta.table_rows, 2)),
                              dtype=torch.float32) for _ in range(2))
    x = rng.uniform(0.01, 0.99, (n, 3))
    x[:3] = [[1.2, 0.5, 0.5], [-0.1, 0.3, 0.3], [0.5, 0.5, 1.01]]
    return meta, ea, eb, torch.as_tensor(x, dtype=torch.float32)


def _close(got, ref, rel=H_REL):
    got = got.cpu()
    assert torch.isfinite(got).all()
    err = float((got - ref).abs().max())
    assert err <= rel * float(ref.abs().max()) + 1e-7, err


@pytest.mark.parametrize("levels", [None, 3])
@pytest.mark.parametrize("dmr", [0, 64])
def test_hash_fused_fwd_matches_plain(cuda, dmr, levels):
    meta, ea, eb, x = _hash_case(dmr)
    lt = thash.level_tables(meta, levels)
    n0 = thash.fused_fwd.launches
    for b in (eb, None):
        ref = thash.fused_fwd_plain(x, ea, b, lt)
        args = (x.to(cuda), ea.to(cuda), None if b is None else b.to(cuda), lt)
        first, second = thash.fused_fwd(*args), thash.fused_fwd(*args)
        torch.cuda.synchronize()
        for r, g, g2 in zip(ref, first, second):
            if r is None:
                assert g is None
                continue
            assert torch.equal(g, g2)
            _close(g, r)
    assert thash.fused_fwd.launches == n0 + 4


@pytest.mark.parametrize("mode", ["exact", "sampled", "sampled_all"])
@pytest.mark.parametrize("dmr", [0, 64])
def test_hash_fused_bwd_matches_plain(cuda, dmr, mode):
    meta, ea, eb, x = _hash_case(dmr)
    lt = thash.level_tables(meta)
    n, L = x.shape[0], lt.n_levels
    gen = torch.Generator().manual_seed(1)
    cts = [torch.randn(n, 2 * L, generator=gen),
           torch.randn(2 * L, 3, n, generator=gen),
           torch.randn(n, 2 * L, generator=gen)]
    u_b = torch.rand(3, lt.n_hashed, n, generator=gen)
    u_a = torch.rand(lt.n_hashed, n, generator=gen)
    if mode != "exact" and lt.n_hashed:
        keep = torch.ones(L, n, dtype=torch.bool)
        keep[lt.n_dense:] = ~thash.near_flip_pairs(x, lt, cts[0], cts[1],
                                                   u_b, u_a, mode)
        cts[0] = cts[0] * keep.T.repeat_interleave(2, 1)
        cts[1] = cts[1] * keep.repeat_interleave(2, 0)[:, None, :]
        cts[2] = cts[2] * keep.T.repeat_interleave(2, 1)
    ref = thash.fused_bwd_plain(x, ea.shape[0], *cts, lt, mode, u_b, u_a)[:2]
    dev = [t.to(cuda) for t in (x, *cts, u_b, u_a)]
    n0 = thash.fused_bwd.launches
    first = thash.fused_bwd(dev[0], ea.shape[0], *dev[1:4], lt, mode,
                            *dev[4:])
    second = thash.fused_bwd(dev[0], ea.shape[0], *dev[1:4], lt, mode,
                             *dev[4:])
    torch.cuda.synchronize()
    assert thash.fused_bwd.launches == n0 + 2
    for r, g, g2 in zip(ref, first, second):
        _close(g, r)
        _close(g2, g.cpu())


def _bwd_case(x, meta, mode, seed=1):
    """Random cotangents and uniforms for H1-bwd on points x (CPU), the
    pairs whose sampled corner may flip in the last bit zeroed."""
    lt = thash.level_tables(meta)
    n, L = x.shape[0], lt.n_levels
    gen = torch.Generator().manual_seed(seed)
    cts = [torch.randn(n, 2 * L, generator=gen),
           torch.randn(2 * L, 3, n, generator=gen),
           torch.randn(n, 2 * L, generator=gen)]
    u_b = torch.rand(3, lt.n_hashed, n, generator=gen)
    u_a = torch.rand(lt.n_hashed, n, generator=gen)
    if mode != "exact" and lt.n_hashed:
        keep = torch.ones(L, n, dtype=torch.bool)
        keep[lt.n_dense:] = ~thash.near_flip_pairs(x, lt, cts[0], cts[1],
                                                   u_b, u_a, mode)
        cts[0] = cts[0] * keep.T.repeat_interleave(2, 1)
        cts[1] = cts[1] * keep.repeat_interleave(2, 0)[:, None, :]
        cts[2] = cts[2] * keep.T.repeat_interleave(2, 1)
    return lt, cts, u_b, u_a


def _bwd_vs_plain(cuda, x, rows, meta, mode):
    lt, cts, u_b, u_a = _bwd_case(x, meta, mode)
    ref = thash.fused_bwd_plain(x, rows, *cts, lt, mode, u_b, u_a)[:2]
    dev = [t.to(cuda) for t in (x, *cts, u_b, u_a)]
    first = thash.fused_bwd(dev[0], rows, *dev[1:4], lt, mode, *dev[4:])
    second = thash.fused_bwd(dev[0], rows, *dev[1:4], lt, mode, *dev[4:])
    torch.cuda.synchronize()
    for r, g, g2 in zip(ref, first, second):
        _close(g, r)
        _close(g2, g.cpu())


def _clustered_points(n_rays=96, per_ray=32, seed=3):
    """Ray-major points as the render's fine tier lays them out: per ray
    `per_ray` consecutive samples within 0.02 of one surface point, so a
    warp's lanes fall into the same cells at the coarse levels."""
    rng = np.random.default_rng(seed)
    centre = rng.uniform(0.2, 0.8, (n_rays, 1, 3))
    d = rng.normal(size=(n_rays, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.sort(rng.uniform(-0.02, 0.02, (n_rays, per_ray, 1)), 1)
    return torch.as_tensor((centre + t * d).reshape(-1, 3),
                           dtype=torch.float32)


@pytest.mark.parametrize("mode", ["exact", "sampled", "sampled_all"])
def test_hash_fused_bwd_clustered_rays(cuda, mode):
    """32 samples a ray along one ray: the lanes of a warp contend for the
    same rows (the warp-aggregated scatter's case), 16 levels."""
    meta = thash.HashGridMeta(num_levels=16, level_dim=2, base_resolution=16,
                              log2_hashmap_size=14, desired_resolution=512)
    x = _clustered_points()
    _bwd_vs_plain(cuda, x, meta.table_rows, meta, mode)


def test_hash_fused_bwd_exact_dense_heavy(cuda):
    """Exact mode where every level is dense (8 corners x 2 tables a level
    everywhere), on clustered points and on uniform ones."""
    meta = thash.HashGridMeta(num_levels=12, level_dim=2, base_resolution=4,
                              log2_hashmap_size=19, desired_resolution=64)
    assert thash.level_tables(meta).n_hashed == 0
    for x in (_clustered_points(64), _hash_case(0, n=2048)[3]):
        _bwd_vs_plain(cuda, x, meta.table_rows, meta, "exact")


@pytest.mark.parametrize("levels", [16, 11])
def test_hash_fused_fwd_many_levels(cuda, levels):
    """More levels than a tile has warps (each warp takes several), a
    ragged last tile: bitwise repeatable, plain within tolerance."""
    meta = thash.HashGridMeta(num_levels=levels, level_dim=2,
                              base_resolution=4, log2_hashmap_size=10,
                              desired_resolution=256)
    _, ea, eb, x = _hash_case(0, n=1000, levels=levels, end=256, logmap=10)
    lt = thash.level_tables(meta)
    ref = thash.fused_fwd_plain(x, ea, eb, lt)
    args = (x.to(cuda), ea.to(cuda), eb.to(cuda), lt)
    first, second = thash.fused_fwd(*args), thash.fused_fwd(*args)
    torch.cuda.synchronize()
    for r, g, g2 in zip(ref, first, second):
        assert torch.equal(g, g2)
        _close(g, r)
    _bwd_vs_plain(cuda, x, meta.table_rows, meta, "sampled_all")


@pytest.mark.parametrize("dmr", [0, 16])
def test_hash_sampler_matches_plain(cuda, dmr):
    meta, ea, _, x = _hash_case(dmr, levels=16, end=128, logmap=10)
    lt = thash.level_tables(meta, 8)
    ref = thash.sampler_fwd_plain(x, ea, lt)
    n0 = thash.sampler_fwd.launches
    a = thash.sampler_fwd(x.to(cuda), ea.to(cuda), lt)
    b = thash.sampler_fwd(x.to(cuda), ea.to(cuda), lt)
    torch.cuda.synchronize()
    assert thash.sampler_fwd.launches == n0 + 2
    assert torch.equal(a, b)
    _close(a, ref)


def test_hash_sampler_packed_at_an_extraction_chunk(cuda):
    """H2 in its packed mode (mesh extraction's grid evaluation) at the
    flagship meta (16 levels 16-2048, 2^19 rows) on the last chunk of a
    512^3 extraction grid over [-1, 1]^3: 262,144 points on the x01 = 1
    plane, its edges at y, z = 0 and 1 included. Two launches bitwise
    equal, plain within H_REL of the largest value."""
    meta = thash.HashGridMeta(num_levels=16, level_dim=2, base_resolution=16,
                              log2_hashmap_size=19, desired_resolution=2048)
    rng = np.random.default_rng(5)
    emb = torch.as_tensor(rng.uniform(-0.5, 0.5, (meta.table_rows, 2)),
                          dtype=torch.float32)
    axis = torch.linspace(-1.0, 1.0, 512)
    gy, gz = torch.meshgrid(axis, axis, indexing="ij")
    x = torch.stack([torch.ones_like(gy), gy, gz], -1).reshape(-1, 3)
    x01 = ((x + 1.0) * 0.5).contiguous()
    assert x01.shape[0] == 1 << 18 and (x01[:, 0] == 1.0).all()
    lt = thash.level_tables(meta)
    ref = thash.sampler_fwd_plain(x01, emb, lt, packed=True)
    n0 = thash.sampler_fwd.launches
    args = (x01.to(cuda), emb.to(cuda), lt, True)
    a, b = thash.sampler_fwd(*args), thash.sampler_fwd(*args)
    torch.cuda.synchronize()
    assert thash.sampler_fwd.launches == n0 + 2
    assert torch.equal(a, b)
    _close(a, ref)
    assert not torch.equal(a.cpu(), thash.sampler_fwd_plain(x01, emb, lt))


def _h2_on_card(cuda, x, emb, lt, packed):
    """H2 on the card against its plain version: launched once a call,
    two launches bitwise equal, plain within H_REL of the largest value.
    Returns the card's output (on the card)."""
    ref = thash.sampler_fwd_plain(x, emb, lt, packed)
    n0 = thash.sampler_fwd.launches
    args = (x.to(cuda), emb.to(cuda), lt, packed)
    a, b = thash.sampler_fwd(*args), thash.sampler_fwd(*args)
    torch.cuda.synchronize()
    assert thash.sampler_fwd.launches == n0 + 2
    assert a.shape == (x.shape[0], 2 * lt.n_levels)
    assert torch.equal(a, b)
    _close(a, ref)
    return a


# H2's metas: 6 dense levels then hashed ones at odd offsets; 24 levels
# (more than a block encodes between two stores), 8 dense; all dense; all
# hashed
H2_METAS = {
    "mixed": dict(num_levels=16, base_resolution=4, log2_hashmap_size=10,
                  desired_resolution=128, dense_max_res=16),
    "deep": dict(num_levels=24, base_resolution=4, log2_hashmap_size=10,
                 desired_resolution=256, dense_max_res=16),
    "dense": dict(num_levels=4, base_resolution=4, log2_hashmap_size=12,
                  desired_resolution=16),
    "hashed": dict(num_levels=8, base_resolution=8, log2_hashmap_size=8,
                   desired_resolution=64),
}


def _h2_points(n, seed):
    """n points: random in [0, 1]^3, then points outside it, on its
    faces and at its corners (as many as n leaves room for)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (n, 3))
    edge = np.array([[1.2, 0.5, 0.5], [-0.1, 0.3, 0.3], [0.5, 0.5, 1.01],
                     [0.5, -1e-7, 0.5], [0.0, 0.0, 0.0], [1.0, 1.0, 1.0],
                     [0.0, 0.4, 1.0], [1.0, 0.0, 0.7], [0.3, 1.0, 0.0]])
    k = min(n // 2, len(edge))
    x[n - k:] = edge[:k]
    return torch.as_tensor(x, dtype=torch.float32)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("levels", [1, 4, 8, 16, 24])
@pytest.mark.parametrize("n", [1, 33, 1000])
def test_hash_sampler_tiles_and_level_groups(cuda, n, levels, packed):
    """H2 at point counts that leave a ragged last tile (1, 33, 1000 are
    not multiples of its 64 points) and at 1, 4, 8, 16 and 24 levels (a
    coarse prefix of the table, and more levels than a block encodes
    between two stores), on the 24-level meta with points on and outside
    the unit cube's faces."""
    meta = thash.HashGridMeta(level_dim=2, **H2_METAS["deep"])
    emb = torch.as_tensor(np.random.default_rng(levels).uniform(
        -0.5, 0.5, (meta.table_rows, 2)), dtype=torch.float32)
    _h2_on_card(cuda, _h2_points(n, n), emb, thash.level_tables(meta, levels),
                packed)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("kind", sorted(H2_METAS))
def test_hash_sampler_metas(cuda, kind, packed):
    """H2 on each of H2_METAS, on random points, the x01 = 0 and x01 = 1
    planes of a 33^2 grid, and points outside [0, 1]; the same bits from
    a copy of the table 8 bytes past a 16-byte boundary."""
    meta = thash.HashGridMeta(level_dim=2, **H2_METAS[kind])
    lt = thash.level_tables(meta)
    emb = torch.as_tensor(np.random.default_rng(7).uniform(
        -0.5, 0.5, (meta.table_rows, 2)), dtype=torch.float32)
    axis = torch.linspace(0.0, 1.0, 33)
    gy, gz = (g.reshape(-1) for g in torch.meshgrid(axis, axis,
                                                      indexing="ij"))
    planes = [torch.stack([torch.full_like(gy, v), gy, gz], -1)
              for v in (0.0, 1.0)]
    x = torch.cat([_h2_points(2000, 3)] + planes)
    got = _h2_on_card(cuda, x, emb, lt, packed)
    # the same rows 8 bytes past a 16-byte boundary
    shifted = torch.cat([torch.zeros(1, 2), emb]).to(cuda)[1:]
    assert shifted.data_ptr() % 16 == 8
    assert torch.equal(thash.sampler_fwd(x.to(cuda), shifted, lt, packed),
                       got)


def test_hash_sampler_packed_at_a_mid_grid_chunk(cuda):
    """H2 packed at the flagship meta on chunk 256 of a 512^3 extraction
    grid over [-1, 1]^3 (the x-plane x01 = 256/511, where points do not
    share the x cell of the last chunk's plane), against plain."""
    meta = thash.HashGridMeta(num_levels=16, level_dim=2, base_resolution=16,
                              log2_hashmap_size=19, desired_resolution=2048)
    emb = torch.as_tensor(np.random.default_rng(6).uniform(
        -0.5, 0.5, (meta.table_rows, 2)), dtype=torch.float32)
    axis = torch.as_tensor(np.linspace(-1.0, 1.0, 512, dtype=np.float32))
    gy, gz = torch.meshgrid(axis, axis, indexing="ij")
    x = torch.stack([torch.full_like(gy, float(axis[256])), gy, gz],
                    -1).reshape(-1, 3)
    x01 = ((x + 1.0) * 0.5).contiguous()
    assert x01.shape[0] == 1 << 18
    _h2_on_card(cuda, x01, emb, thash.level_tables(meta), True)


def test_grid_evaluator_on_card_matches_the_h1_route(cuda):
    """implicit_sdf_raw_grid (H2, packed) on the card against
    implicit_sdf_raw (H1-fwd) on the card and against itself on the CPU,
    on every point of a 33^3 grid over [-1, 1]^3 (whole planes at x01 = 0
    and 1): within 1e-5 of the largest |SDF|; H2 launched once, H1-fwd
    not at all, by the grid evaluator."""
    from holoscene_tpu_torch.models import fields as tf

    cfg = tf.ImplicitNetworkConfig(feature_vector_size=16, d_out=3,
                                   dims=(32, 32), multires=2, num_levels=8,
                                   base_size=4, end_size=96, logmap=10)
    net = tf.ImplicitNetwork(cfg, seed=3)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        net.mlp["lin0"].v.normal_(0, 0.3, generator=gen)
        net.grid.uniform_(-0.1, 0.1, generator=gen)
    axis = torch.linspace(-1.0, 1.0, 33)
    x = torch.stack(torch.meshgrid(axis, axis, axis, indexing="ij"),
                    -1).reshape(-1, 3)
    ref_cpu = tf.implicit_sdf_raw_grid(net, x)
    net = net.to(cuda)
    n2, n1 = thash.sampler_fwd.launches, thash.fused_fwd.launches
    got = tf.implicit_sdf_raw_grid(net, x.to(cuda))
    torch.cuda.synchronize()
    assert (thash.sampler_fwd.launches, thash.fused_fwd.launches) \
        == (n2 + 1, n1)
    h1 = tf.implicit_sdf_raw(net, x.to(cuda)).detach()
    _close(got, h1.cpu(), 1e-5)
    _close(got, ref_cpu, 1e-5)


@pytest.mark.parametrize("lin2", ["init", "perturbed"])
def test_vjp_get_outputs_on_card_matches_cpu(cuda, lin2):
    """The vjp gradient mode's field (implicit_get_outputs: H1-fwd, the
    inner pullback, H1-bwd exact under the outer backward) on the card
    against the same on the CPU: outputs and every parameter's gradient
    within 1e-4 of its largest value (atomics and float32 sums in another
    order). "perturbed" moves the objects' SDFs apart. "init" keeps the
    geometric init's last layer, under which objects 1 and 2 agree to
    ~1e-4 and at 12 of the points to < 1e-6 (one exact tie): rounding in
    another order hands such a point's min to the other object, which
    moves its cotangent between rows 1 and 2 of the last layer (on the
    CPU, object 2's bias moved by 1e-7 changes lin2.v's gradient by 0.23
    and the SDF by 9e-8). There the last layer's gradients are held row 0
    and rows 1 + 2 summed, every other tensor as in "perturbed"."""
    from holoscene_tpu_torch.models import fields as tf

    cfg = tf.ImplicitNetworkConfig(feature_vector_size=16, d_out=3,
                                   dims=(32, 32), multires=2, num_levels=8,
                                   base_size=4, end_size=96, logmap=10)
    x = torch.as_tensor(np.random.default_rng(4).uniform(-0.95, 0.95,
                                                         (777, 3)),
                        dtype=torch.float32)
    results = []
    for dev in ("cpu", cuda):
        net = tf.ImplicitNetwork(cfg, seed=3)
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            # grid inputs live (the geometric init zeroes them)
            net.mlp["lin0"].v.normal_(0, 0.3, generator=gen)
            if lin2 == "perturbed":
                net.mlp["lin2"].v.add_(torch.randn(net.mlp["lin2"].v.shape,
                                                   generator=gen))
        net = net.to(dev)
        outs = tf.implicit_get_outputs(net, x.to(dev))
        gen = torch.Generator().manual_seed(2)
        (sum((o * torch.randn(o.shape, generator=gen).to(dev)).sum()
             for o in outs)).backward()
        results.append(([o.detach().cpu() for o in outs],
                        {k: p.grad.cpu() for k, p in net.named_parameters()}))
    (ref_o, ref_g), (got_o, got_g) = results
    errs = {f"output {i}": (g, r) for i, (g, r) in enumerate(zip(got_o,
                                                                 ref_o))}
    errs.update({k: (got_g[k], r) for k, r in ref_g.items()})
    if lin2 == "init":
        two = torch.topk(ref_o[4], 2, -1, largest=False)
        assert float((two.values[:, 1] - two.values[:, 0]).min()) < 1e-6
        assert set(two.indices[:, :1].unique().tolist()) >= {1, 2}
        for k in ("mlp.lin2.v", "mlp.lin2.g", "mlp.lin2.b"):
            g, r = errs.pop(k)
            errs[k] = (torch.stack([g[0], g[1] + g[2]]),
                       torch.stack([r[0], r[1] + r[2]]))
    for k, (g, r) in errs.items():
        err = float((g - r).abs().max())
        assert torch.isfinite(g).all(), k
        assert err <= 1e-4 * float(r.abs().max()) + 1e-7, (k, err)
    assert ref_g["grid"].any() and ref_g["color_grid"].any()


def test_hash_encode_autograd_on_card(cuda):
    """hash_encode_fused_dual through autograd on the card (H1-fwd, then
    H1-bwd from the Function's backward) against the same on the CPU."""
    meta, ea, eb, x = _hash_case(0)
    grads = []
    for dev in ("cpu", cuda):
        a = ea.detach().clone().to(dev).requires_grad_(True)
        b = eb.detach().clone().to(dev).requires_grad_(True)
        fa, J, fb = thash.hash_encode_fused_dual(x.to(dev), a, b, meta)
        (fa.sum() + (J * J).sum() + fb.square().sum()).backward()
        grads.append((a.grad, b.grad))
    for r, g in zip(*grads):
        _close(g, r, rel=1e-4)
    with pytest.raises(NotImplementedError, match="points"):
        xx = x.to(cuda).requires_grad_(True)
        thash.hash_encode_fused_dual(xx, ea.to(cuda), eb.to(cuda),
                                     meta)[0].sum().backward()


def _stage2_case(dev):
    """A tiny vjp-mode model (grid inputs live, the objects' SDFs moved
    apart), one finetune step's batch, generated view, collision points
    and draws, all made on the CPU from seeds and moved to `dev`."""
    from holoscene_tpu_torch.models import fields as tf
    from holoscene_tpu_torch.models import holoscene as ths
    from holoscene_tpu_torch.ops.sampler import SamplerConfig
    from holoscene_tpu_torch.stage2.refine import FinetuneDraws

    cfg = ths.HoloSceneConfig(
        implicit=tf.ImplicitNetworkConfig(
            feature_vector_size=16, d_out=3, dims=(32, 32), multires=2,
            num_levels=6, base_size=4, end_size=48, logmap=8),
        rendering=tf.RenderingNetworkConfig(
            feature_vector_size=16, dims=(32, 32), multires_view=2,
            multires_point=2, multires_normal=2),
        sampler=SamplerConfig(N_samples=8, N_samples_eval=16,
                              N_samples_extra=4, max_total_iters=3,
                              beta_iters=4),
        use_bg_reg=False, sampler_grid_levels=4)
    model = ths.init_holoscene(cfg, 5)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        model.implicit.mlp["lin0"].v.normal_(0, 0.3, generator=gen)
        model.implicit.mlp["lin2"].v.add_(torch.randn(
            model.implicit.mlp["lin2"].v.shape, generator=gen))
        model.implicit.grid.uniform_(-0.1, 0.1, generator=gen)
        model.implicit.color_grid.uniform_(-0.1, 0.1, generator=gen)
    rng = np.random.default_rng(0)
    n, m, p = 64, 48, 128
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.1, 0.05, -0.4]
    batch = {"uv": rng.uniform(0, 32, (n, 2)), "pose": pose,
             "intrinsics": np.array([[20.0, 0, 16], [0, 20.0, 16],
                                     [0, 0, 1]]),
             "rgb": rng.uniform(0, 1, (n, 3)),
             "depth": rng.uniform(0.5, 2.0, (n, 1)),
             "normal": rng.normal(size=(n, 3)), "mask": np.ones((n, 1))}
    batch = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32)
             for k, v in batch.items()}
    batch["segs"] = torch.as_tensor(rng.integers(0, 3, n))
    vpose = np.eye(4, dtype=np.float32)
    vpose[:3, 3] = [0.05, 0.0, -0.6]
    view = {"pose": vpose, "half_extent": np.float32(0.6),
            "rgb": rng.uniform(0, 1, (m, 3)),
            "normal": rng.normal(size=(m, 3)),
            "mask": rng.uniform(size=m) > 0.3,
            "nm_mask": rng.uniform(size=m) > 0.3,
            "inp_mask": rng.uniform(size=m) > 0.5,
            "depth": rng.uniform(0.5, 1.5, m),
            "depth_mask": rng.uniform(size=m) > 0.3,
            "uv": rng.uniform(-1, 1, (m, 2)), "mask_boost": np.float32(25.0)}
    view = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32)
            for k, v in view.items()}
    coll = (torch.as_tensor(rng.uniform(-0.5, 0.5, (p, 3)),
                            dtype=torch.float32),
            torch.as_tensor(rng.uniform(-0.2, 0.2, p), dtype=torch.float32))
    draws = FinetuneDraws.make(model, n, m,
                               torch.Generator().manual_seed(2), "cpu")

    def move(obj):
        if isinstance(obj, torch.Tensor):
            return obj.to(dev)
        if isinstance(obj, dict):
            return {k: move(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(move(v) for v in obj)
        if obj is None:
            return None
        return type(obj)(**{f: move(getattr(obj, f))
                            for f in obj.__dataclass_fields__})

    return (model.to(dev), move(batch), move(view), move(coll),
            move(draws), (n, m, p))


def test_stage2_finetune_step_on_card_matches_cpu(cuda):
    """One Stage-2 object finetune step (the class-targeted render, the
    invisible view, the collision loss; SGD lr 1) on the card against the
    same step on the CPU (the kernels' plain versions) with the same
    draws: every loss term within 1e-4 relative, every parameter's
    gradient within 1e-4 of its largest value (the vjp card test's
    tolerance: atomics and float32 sums in another order); H1-fwd and
    H1-bwd launched four times (render, eikonal points, invisible render,
    collision points), H2 in every sampler round."""
    from holoscene_tpu_torch.losses.holoscene_loss import LossConfig
    from holoscene_tpu_torch.stage2 import refine as tr

    results = []
    for dev in ("cpu", cuda):
        model, batch, view, (pts, sdf), draws, (n, m, p) = _stage2_case(dev)
        fcfg = tr.FinetuneConfig(rays_per_step=n, invis_pixels=m,
                                 collision_pts=p, depth_weight=2.0,
                                 lama_rgb_weight=2.0, smooth_weight=0.3)
        before = {k: v.detach().clone() for k, v in
                  model.state_dict().items()}
        counts = (thash.fused_fwd.launches, thash.fused_bwd.launches,
                  thash.sampler_fwd.launches)
        metrics = tr.finetune_step(
            model, torch.optim.SGD(model.parameters(), lr=1.0), None,
            LossConfig(), fcfg, 1, batch, view, 1.0, pts, sdf, draws)
        if dev != "cpu":
            torch.cuda.synchronize()
            h1f, h1b, h2 = (thash.fused_fwd.launches - counts[0],
                            thash.fused_bwd.launches - counts[1],
                            thash.sampler_fwd.launches - counts[2])
            assert (h1f, h1b) == (4, 4) and h2 >= 2, (h1f, h1b, h2)
        results.append(({k: float(v) for k, v in metrics.items()},
                        {k: (before[k] - v).cpu() for k, v in
                         model.state_dict().items()}))
    (ref_m, ref_g), (got_m, got_g) = results
    assert set(got_m) == set(ref_m) and "invis_loss" in got_m
    for k, r in ref_m.items():
        assert abs(got_m[k] - r) <= 1e-4 * abs(r) + 1e-7, (k, got_m[k], r)
    for k, r in ref_g.items():
        err = float((got_g[k] - r).abs().max())
        assert torch.isfinite(got_g[k]).all(), k
        assert err <= 1e-4 * float(r.abs().max()) + 1e-7, (k, err)


@pytest.mark.parametrize("dmr", [0, 64])
def test_hash_fused_bwd_without_jacobian_matches_plain(cuda, dmr):
    """H1-bwd with ct_J None (the packed encode's table gradient: one
    table, exact mode, no jacobian term) against plain, at the small metas
    and at 16 levels on clustered points."""
    meta, ea, _, x = _hash_case(dmr)
    big = thash.HashGridMeta(num_levels=16, level_dim=2, base_resolution=16,
                             log2_hashmap_size=14, desired_resolution=512)
    for m, pts in ((meta, x), (big, _clustered_points())):
        lt = thash.level_tables(m)
        ct = torch.randn(pts.shape[0], 2 * lt.n_levels,
                         generator=torch.Generator().manual_seed(2))
        ref = thash.fused_bwd_plain(pts, m.table_rows, ct, None, None, lt,
                                    "exact")[0]
        n0 = thash.fused_bwd.launches
        first, second = (thash.fused_bwd(pts.to(cuda), m.table_rows,
                                         ct.to(cuda), None, None, lt,
                                         "exact")[0] for _ in range(2))
        torch.cuda.synchronize()
        assert thash.fused_bwd.launches == n0 + 2
        _close(first, ref)
        _close(second, first.cpu())


def test_color_step_on_card_matches_cpu(cuda):
    """One Stage-3 colour step (training/stage3.py::color_step, with SGD;
    the gradients it leaves are compared) on the card against the CPU
    (the plain versions) at a 16-level field, the same points and draws:
    the loss within 1e-4 relative, every gradient within 1e-4 of its
    largest value (atomics and float32 sums in another order); H2 and
    H1-bwd launched once, H1-fwd never. The hidden layers' weights are
    scaled by 0.1 and their biases set to 1, so every ReLU input stays
    near 1: one that rounds across 0 on one device only flips its
    derivative there, which no tolerance covers (seen at the default
    init: 6% of the table's largest gradient on one row)."""
    from holoscene_tpu_torch.models.fields import ColorField, ColorFieldConfig
    from holoscene_tpu_torch.training.stage3 import color_step

    cfg = ColorFieldConfig(logmap=14, end_size=512, hidden=64)
    rng = np.random.default_rng(4)
    wp = torch.as_tensor(rng.uniform(-1.5, 1.5, (5000, 3)), dtype=torch.float32)
    gt = torch.as_tensor(rng.uniform(0, 1, (5000, 3)), dtype=torch.float32)
    idx = torch.as_tensor(rng.integers(0, 5000, 4096))
    results = []
    for dev in ("cpu", cuda):
        field = ColorField(cfg, torch.Generator().manual_seed(0))
        with torch.no_grad():
            field.grid.uniform_(-0.5, 0.5,
                                generator=torch.Generator().manual_seed(1))
            for i in range(3):
                field.mlp[f"lin{i}"].w.mul_(0.1)
                field.mlp[f"lin{i}"].b.fill_(1.0)
        field = field.to(dev)
        opt = torch.optim.SGD(field.parameters(), lr=1.0)
        counts = (thash.fused_fwd.launches, thash.fused_bwd.launches,
                  thash.sampler_fwd.launches)
        loss = color_step(field, opt,
                          torch.optim.lr_scheduler.ExponentialLR(opt, 1.0),
                          wp.to(dev), torch.tensor(True, device=dev),
                          gt.to(dev), idx.to(dev))
        if dev != "cpu":
            torch.cuda.synchronize()
            assert (thash.fused_fwd.launches - counts[0],
                    thash.fused_bwd.launches - counts[1],
                    thash.sampler_fwd.launches - counts[2]) == (0, 1, 1)
        results.append((float(loss), {k: p.grad.cpu() for k, p
                                      in field.named_parameters()}))
    (ref_l, ref_g), (got_l, got_g) = results
    assert abs(got_l - ref_l) <= 1e-4 * ref_l
    for k, r in ref_g.items():
        err = float((got_g[k] - r).abs().max())
        assert err <= 1e-4 * float(r.abs().max()) + 1e-7, (k, err)


def _render_multi_case(dev, training):
    """render_rays_multi_obj of objects (1, 2) and query_point_colors of
    _stage2_case's model on `dev`: outputs, and with training the
    parameter gradients of a random functional of the render and the
    colours."""
    from holoscene_tpu_torch.models import holoscene as ths
    from holoscene_tpu_torch.ops.rays import get_orthographic_rays
    from holoscene_tpu_torch.ops.sampler import SamplerDraws

    model = _stage2_case(dev)[0]
    r = 256
    gen = torch.Generator().manual_seed(7)
    uv = torch.rand(r, 2, generator=gen) * 2 - 1
    pose = torch.eye(4)
    pose[:3, 3] = torch.tensor([0.05, 0.0, -0.6])
    ro, rd = get_orthographic_rays(uv, pose, 0.6)
    draws = SamplerDraws.make(model.cfg.sampler, r, gen, "cpu") \
        if training else None
    if draws is not None:
        draws = SamplerDraws(*(getattr(draws, f).to(dev)
                               for f in draws.__dataclass_fields__))
    out = ths.render_rays_multi_obj(
        model, ro.to(dev), rd.to(dev), torch.ones(r, 1, device=dev),
        pose[:3, :3].T.to(dev), (1, 2), draws, training=training)
    pts = torch.rand(300, 3, generator=gen) * 1.6 - 0.8
    dirs = torch.nn.functional.normalize(torch.randn(300, 3, generator=gen),
                                         dim=-1)
    rgb, normals = ths.query_point_colors(model, pts.to(dev), dirs.to(dev))
    outs = {k: v for k, v in out.items()}
    outs.update(point_rgb=rgb, point_normals=normals)
    grads = None
    if training:
        cg = torch.Generator().manual_seed(8)
        sum((v * torch.randn(v.shape, generator=cg).to(dev)).sum()
            for k, v in outs.items() if v.dtype == torch.float32
            and k not in ("z_vals", "sdf")).backward()
        grads = {k: p.grad.cpu() for k, p in model.named_parameters()
                 if p.grad is not None}
    return {k: v.detach().cpu() for k, v in outs.items()}, grads


@pytest.mark.parametrize("training", [False, True])
def test_render_multi_obj_and_point_colors_on_card_match_cpu(cuda, training):
    """render_rays_multi_obj (H2 in the sampler, H1-fwd / H1-bwd exact in
    the field) and query_point_colors on the card against the CPU (the
    plain versions): every output within 1e-4 absolute, and in training
    (the sampler's draws made on the CPU) every parameter gradient within
    1e-4 of its largest value (atomics and float32 sums in another
    order). The sample depths and the SDF at them are held to the
    sampler's stated margin instead (tests/test_torch_sampler.py: 90%
    within 1e-4, all within 5e-3): H2's last bit can move a sample within
    its section of the refined buffer (4.4e-4 seen on the card in
    training), where the composited outputs barely move."""
    counts = (thash.fused_fwd.launches, thash.sampler_fwd.launches)
    ref_o, ref_g = _render_multi_case("cpu", training)
    got_o, got_g = _render_multi_case(cuda, training)
    torch.cuda.synchronize()
    assert thash.fused_fwd.launches - counts[0] == 2      # render, points
    assert thash.sampler_fwd.launches > counts[1]
    for k, r in ref_o.items():
        assert torch.isfinite(got_o[k]).all(), k
        err = (got_o[k] - r).abs()
        if k in ("z_vals", "sdf"):
            assert float((err > 1e-4).float().mean()) <= 0.1, k
            assert float(err.max()) <= 5e-3, (k, float(err.max()))
        else:
            assert float(err.max()) <= 1e-4, (k, float(err.max()))
    if training:
        assert set(got_g) == set(ref_g)
        for k, r in ref_g.items():
            err = float((got_g[k] - r).abs().max())
            assert err <= 1e-4 * float(r.abs().max()) + 1e-7, (k, err)


def test_hash_encode_world_on_card_matches_cpu(cuda):
    """hash_encode_world (H2 packed forward, H1-bwd without the jacobian
    backward) on the card against the CPU: features within 1e-4 of the
    largest, the table gradient within 1e-4 of its largest (atomics). The
    features' tolerance is not H2's (1e-5, held in the tests above): on a
    CUDA tensor PyTorch divides by a scalar through its reciprocal, so
    the world-to-[0, 1] map rounds a point differently in 2627 of these
    15000 coordinates, and the finest level (scale 511) amplifies that
    ulp to 8.7e-6 on features of 0.099 (8.8e-5 of the largest, measured
    on the CPU by mapping with the reciprocal; 3.4e-5 on the gradient).
    Run with -s, it prints both errors."""
    meta = thash.HashGridMeta(num_levels=16, level_dim=2, base_resolution=16,
                              log2_hashmap_size=14, desired_resolution=512)
    gen = torch.Generator().manual_seed(3)
    x = torch.rand(5000, 3, generator=gen) * 5.0 - 2.5
    emb = torch.rand(meta.table_rows, 2, generator=gen) * 0.2 - 0.1
    ct = torch.randn(5000, 32, generator=gen)
    res = []
    for dev in ("cpu", cuda):
        e = emb.clone().to(dev).requires_grad_(True)
        n0 = (thash.sampler_fwd.launches, thash.fused_bwd.launches)
        f = thash.hash_encode_world(x.to(dev), e, meta, size=2.5)
        (f * ct.to(dev)).sum().backward()
        if dev != "cpu":
            torch.cuda.synchronize()
            assert (thash.sampler_fwd.launches - n0[0],
                    thash.fused_bwd.launches - n0[1]) == (1, 1)
        res.append((f.detach().cpu(), e.grad.cpu()))
    (rf, rg), (gf, gg) = res
    errs = [float((g - r).abs().max()) / float(r.abs().max())
            for g, r in ((gf, rf), (gg, rg))]
    print(f"hash_encode_world card vs CPU, max abs err over the largest "
          f"value: features {errs[0]:.3g}, table gradient {errs[1]:.3g}")
    _close(gf, rf, 1e-4)
    assert errs[1] <= 1e-4


@pytest.mark.parametrize("ortho", [False, True])
def test_peeled_rasterizer_on_card_matches_cpu(cuda, ortho):
    """rasterize_mesh_list_peeled of two nested spheres on the card against
    the CPU: per layer the masks, face ids and instance ids on >= 99.9% of
    the pixels (a fragment's depth rounds in another order on the card,
    which can hand a tie to the other face), depths within 1e-5 where both
    cover."""
    from holoscene_tpu_torch.ops import rasterizer as tr
    from holoscene_tpu_torch.utils.mc import marching_tetrahedra

    axis = np.linspace(-1, 1, 40)
    x, y, z = np.meshgrid(axis, axis, axis, indexing="ij")
    meshes = []
    for r in (0.6, 0.3):
        v, f = marching_tetrahedra(np.sqrt(x * x + y * y + z * z) - r,
                                   origin=(-1, -1, -1),
                                   spacing=(2.0 / 39,) * 3)
        meshes.append((v, f))
    pose = np.eye(4)
    pose[2, 3] = -2.0
    intr = np.array([[90.0, 0, 48], [0, 90.0, 48], [0, 0, 1.0]])
    kw = dict(n_layers=4, peel_eps=0.05,
              ortho_half_extent=0.8 if ortho else None)
    ref = tr.rasterize_mesh_list_peeled(meshes, pose, intr, (96, 96), **kw)
    got = tr.rasterize_mesh_list_peeled(meshes, pose, intr, (96, 96),
                                        device=cuda, **kw)
    for k, (g, r) in enumerate(zip(got, ref)):
        for key in ("mask", "face_id", "instance_id"):
            same = (g[key].cpu() == r[key]).float().mean()
            assert float(same) >= 0.999, (k, key, float(same))
        both = g["mask"].cpu() & r["mask"]
        err = (g["depth"].cpu()[both] - r["depth"][both]).abs()
        assert both.any() and float(err.max()) <= 1e-5, k
    assert bool(ref[3]["mask"].any())      # four surfaces at the centre


def _trace_cloud(n, r, seed):
    """Random particles in front of a ray fan (dead slots included)."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    means[:, 2] += 3.0
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = rng.uniform(0.02, 0.3, (n, 3)).astype(np.float32)
    scales[::5, 2] = 1e-4                  # flat, as Gaussian-on-Mesh
    opac = rng.uniform(0.0, 1.0, n).astype(np.float32)
    opac[::17] = 0.0
    ro = (rng.normal(size=(r, 3)) * 0.1).astype(np.float32)
    rd = (rng.normal(size=(r, 3)) * 0.3).astype(np.float32)
    rd[:, 2] = 1.0
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return means, quats, scales, opac, ro, rd


@pytest.mark.parametrize("degree", [1, 2, 4, 8])
def test_t1_matches_plain(cuda, degree):
    """T1 (csrc/gs_trace_select.cu) against select_hits_plain on the card:
    the same indices and counts, bit for bit, and two launches equal."""
    means, quats, scales, opac, ro, rd = _trace_cloud(3000, 1000, 4)
    g13 = ttrace.pack_gaussians(*(torch.tensor(a) for a in (
        means, quats, scales, opac))).to(cuda)
    ro_d, rd_d = (torch.tensor(a, device=cuda) for a in (ro, rd))
    args = (64, 0.0113, 1.0 / 255.0, 1e-4, degree)
    before = ttrace.select_hits.launches
    idx, cnt = ttrace.select_hits(g13, ro_d, rd_d, *args)
    idx2, cnt2 = ttrace.select_hits(g13, ro_d, rd_d, *args)
    assert ttrace.select_hits.launches == before + 2
    ref_i, ref_c = ttrace.select_hits_plain(g13, ro_d, rd_d, *args)
    assert torch.equal(idx, idx2) and torch.equal(cnt, cnt2)
    assert torch.equal(cnt, ref_c)
    assert torch.equal(idx, ref_i)
    assert int(cnt.max()) == 64 and int(cnt.min()) < 64


def test_trace_on_card_matches_cpu(cuda):
    """trace_gaussians (T1 + the composite) on the card against the CPU's
    plain run: the same hit sets, outputs within 1e-5."""
    means, quats, scales, opac, ro, rd = _trace_cloud(2000, 512, 5)
    sh = np.random.default_rng(6).normal(0, 0.5, (2000, 4, 3)).astype(
        np.float32)
    host = [torch.tensor(a) for a in (means, quats, scales, opac, sh, ro,
                                      rd)]
    ref = ttrace.trace_gaussians(*host, sh_degree=1, max_hits=32,
                                 with_normal=True)
    got = ttrace.trace_gaussians(*(t.to(cuda) for t in host), sh_degree=1,
                                 max_hits=32, with_normal=True)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].cpu().numpy(), v.numpy(),
                                   atol=1e-5, err_msg=k)
