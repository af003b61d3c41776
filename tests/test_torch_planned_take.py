"""The payload gather's transpose plan and H4 (holoscene_tpu_torch/ops/
splat_flat.py: take_plan, planned_take_bwd, _PlannedTake) against the JAX
reference: the plan (perm / bounds) against holoscene_tpu's build_flat_bins
on tests/test_torch_splat_flat.py's scenes, the plain twin's VJP against
jax.vjp of _planned_take_sliced (flat path) and of jnp.take (top-K path),
both against float64 segment sums, and select_topk's ties and dead entries
against the reference's selection on the CPU. The tests marked cuda hold
H4 to its plain twin on the card (bitwise, twice); JAX is imported only
inside the tests that compare with it, so this file also runs where JAX is
not installed:

    python -m pytest --noconftest tests/test_torch_planned_take.py -m cuda

Tolerances. The port sums each payload row's run sequentially in float32,
so against exact (float64) sums a row of L terms is within
(L - 1) u sum |terms| (u = 2^-24, the recursive-summation bound). JAX takes
differences of a two-level cumsum (128-blocks, then block offsets): each
prefix is a sum of at most 128 + c / 128 rounded terms, so a difference is
within 2 (128 + c / 128) u P, P the largest prefix of |terms|; the port
against JAX gets the sum of the two bounds. jnp.take's VJP (top-K) is a
scatter-add in some order: (L - 1) u sum |terms| again."""

import numpy as np
import pytest
import torch

from holoscene_tpu_torch.ops import splat as tsplat
from holoscene_tpu_torch.ops import splat_flat as tflat
from test_torch_threads import few_torch_threads  # noqa: F401

U32 = 2.0 ** -24
FLAT_SCENES = ("empty_tiles", "random32", "random40", "saturated")


def _flat_case(name, trimmed=False):
    """JAX's and the port's bins on one of test_torch_splat_flat.py's
    scenes (trimmed: the saturation-trimmed rebin of the wall scene)."""
    from test_torch_splat_flat import SCENES, _bins_both, _jax_walk, \
        _project, _cand_rows

    sc = SCENES[name]()
    xy, depth, conic, opac, valid, rgb = _project(sc)
    res = sc["res"]
    plan, jb, tb = _bins_both(xy, depth, conic, opac, valid, res)
    if trimmed:
        from holoscene_tpu.ops import splat_flat as jflat

        out, _ = _jax_walk(_cand_rows(xy, depth, conic, opac, rgb,
                                      jb["gidx"]),
                           jb["tile_chunk_start"], jb["tile_chunk_cnt"], res)
        used = out[:, 0, 5].astype(np.int32)
        plan = jflat.plan_trimmed(plan, jb["tile_chunk_cnt"], used,
                                  trim_slack=1, round_chunks=4)
        plan, jb, tb = _bins_both(xy, depth, conic, opac, valid, res,
                                  used=used, plan=plan)
        assert jb["trimmed"].sum() > 0
    return xy.shape[0], jb, tb


def _runs(bounds):
    return [slice(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]


@pytest.mark.parametrize("name", FLAT_SCENES + ("saturated_trimmed",))
def test_take_plan_matches_jax_build_flat_bins(name):
    """bounds exactly JAX's; perm equal to JAX's run by run as a multiset
    (JAX's sort orders equal ids arbitrarily) and ascending in each run;
    the dead slots' run (row N) last."""
    n, jb, tb = _flat_case(name.replace("_trimmed", ""),
                           trimmed=name.endswith("_trimmed"))
    perm, bounds = tb["perm"].numpy(), tb["bounds"].numpy()
    assert tb["perm"].dtype == tb["bounds"].dtype == torch.int32
    assert bounds.shape == (n + 2,)
    np.testing.assert_array_equal(bounds, jb["bounds"])
    gidx = tb["gidx"].numpy()
    assert bounds[-1] == gidx.shape[0]
    for s, run in enumerate(_runs(bounds)):
        np.testing.assert_array_equal(np.sort(perm[run]),
                                      np.sort(jb["perm"][run]))
        assert (np.diff(perm[run]) > 0).all(), s
        assert (gidx[perm[run]] == s).all(), s
    assert bounds[n + 1] - bounds[n] > 0   # padding and dummies


def _exact_and_bound(ct, perm, bounds, cols):
    """float64 segment sums of ct's rows over each run, and the
    recursive-summation bound (L - 1) u sum |terms| of each [row, col]."""
    rows = ct[perm][:, :cols].astype(np.float64)
    exact = np.zeros((bounds.shape[0] - 1, cols))
    bound = np.zeros_like(exact)
    for s, run in enumerate(_runs(bounds)):
        r = rows[run]
        exact[s] = r.sum(0)
        bound[s] = max(r.shape[0] - 1, 0) * U32 * np.abs(r).sum(0)
    return exact, bound


@pytest.mark.parametrize("name", FLAT_SCENES)
def test_flat_plan_vjp_matches_jax_planned_take_sliced(name):
    import jax
    import jax.numpy as jnp

    from holoscene_tpu.ops import splat_flat as jflat

    n, jb, tb = _flat_case(name)
    rng = np.random.default_rng(3)
    payload = rng.normal(size=(n + 1, 16)).astype(np.float32)
    ct = rng.normal(size=(tb["gidx"].shape[0], 16)).astype(np.float32)
    _, vjp = jax.vjp(lambda p: jflat._planned_take_sliced(
        p, jnp.asarray(jb["gidx"]), jnp.asarray(jb["perm"]),
        jnp.asarray(jb["bounds"]), 11), jnp.asarray(payload))
    (j_d,) = vjp(jnp.asarray(ct))
    j_d = np.asarray(j_d)
    t_d = tflat.planned_take_bwd(torch.as_tensor(ct), tb["perm"],
                                 tb["bounds"]).numpy()
    assert t_d.shape == (n + 1, 16)
    # columns past bwd_cols and the trash row (dropped by the payload's
    # concatenation in both) are zero
    assert not t_d[:, tflat.BWD_COLS:].any() and not t_d[n].any()
    assert not j_d[:, tflat.BWD_COLS:].any()
    perm, bounds = tb["perm"].numpy(), tb["bounds"].numpy()
    exact, bound = _exact_and_bound(ct, perm, bounds, tflat.BWD_COLS)
    c = ct.shape[0]
    prefix = np.abs(ct[perm][:, :tflat.BWD_COLS]).astype(np.float64).sum(0)
    j_bound = 2 * (tflat.CHUNK + c // tflat.CHUNK) * U32 * prefix
    cols = slice(0, tflat.BWD_COLS)
    assert (np.abs(t_d[:n, cols] - exact[:n]) <= bound[:n]).all()
    assert (np.abs(j_d[:n, cols] - exact[:n]) <= j_bound).all()
    assert (np.abs(t_d[:n, cols] - j_d[:n, cols])
            <= bound[:n] + j_bound).all()
    # and the port's order is the kernel's: bitwise the sequential sum
    seq = np.zeros((n, tflat.BWD_COLS), np.float32)
    rows = ct[perm][:, cols]
    for s, run in enumerate(_runs(bounds)[:n]):
        for r in rows[run]:
            seq[s] = seq[s] + r
    np.testing.assert_array_equal(t_d[:n, cols], seq)


def _topk_scene(n, seed, res=48, ties=False):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-6, res + 6, (n, 2)).astype(np.float32)
    if ties:   # 12 depth values for n gaussians: ties inside and at the cut
        depth = (rng.integers(0, 12, n) * 0.25 + 1.0).astype(np.float32)
    else:
        depth = rng.permutation(n).astype(np.float32) * 0.01 + 1.0
    radius = rng.uniform(1.0, 12.0, n).astype(np.float32)
    valid = rng.uniform(size=n) > 0.1
    return xy, depth, radius, valid


def _reference_selection(xy, depth, radius, valid, res, k):
    """holoscene_tpu/ops/splat.py's select_tile_chunk on the CPU: the
    overlap test and jax.lax.approx_max_k over -depth."""
    import jax
    import jax.numpy as jnp

    x0, y0 = tsplat._tile_origins(res, res, 16, "cpu")
    gx, gy, r = xy[None, :, 0], xy[None, :, 1], radius[None, :]
    jx0 = jnp.asarray(x0.numpy())[:, None]
    jy0 = jnp.asarray(y0.numpy())[:, None]
    overlap = ((gx + r >= jx0) & (gx - r <= jx0 + 16)
               & (gy + r >= jy0) & (gy - r <= jy0 + 16))
    neg = jnp.where(overlap, -jnp.where(valid, depth, jnp.inf)[None, :],
                    -jnp.inf)
    vals, idx = jax.lax.approx_max_k(neg, k)
    return np.asarray(idx), np.isfinite(np.asarray(vals))


@pytest.mark.parametrize("ties", [False, True])
def test_select_topk_ties_and_dead_entries_match_reference(ties):
    """Lists entry for entry the reference's on the CPU (order included:
    equal depths to the smaller index, also where a tie straddles the
    k-th place); dead entries at the end, pointing at row N."""
    n, res = 600, 48
    xy, depth, radius, valid = _topk_scene(n, 11, res, ties)
    for k in (32, 512):
        idx, live, _ = tsplat.select_topk(
            *map(torch.as_tensor, (xy, depth, radius, valid)), res, res, 16,
            k)
        jidx, jlive = _reference_selection(xy, depth, radius, valid, res, k)
        np.testing.assert_array_equal(live.numpy(), jlive)
        assert live.any() and (~live).any() if k == 512 else live.all()
        got = idx.numpy()
        np.testing.assert_array_equal(got[jlive], jidx[jlive])
        assert (got[~jlive] == n).all()
        # live is a prefix of every list
        assert (np.diff(live.numpy().astype(int), axis=1) <= 0).all()
        if ties and k == 32:   # a tie straddles the k-th place somewhere
            x0, y0 = tsplat._tile_origins(res, res, 16, "cpu")
            hit = tsplat._overlap(torch.as_tensor(xy),
                                  torch.as_tensor(radius), x0, y0,
                                  16).numpy() & valid[None, :]
            cut = depth[got[:, -1]]
            assert any((depth[hit[t]] == cut[t]).sum()
                       > (depth[got[t]] == cut[t]).sum()
                       for t in range(got.shape[0]))


def test_topk_plan_vjp_matches_jax_take():
    """The top-K path's plan (take_plan of the lists, dead entries at the
    trash row) against jnp.take's VJP on the same indices and cotangent,
    and against float64 segment sums."""
    import jax
    import jax.numpy as jnp

    n, res, k = 500, 48, 128
    xy, depth, radius, valid = _topk_scene(n, 5, res, ties=True)
    idx, live, _ = tsplat.select_topk(
        *map(torch.as_tensor, (xy, depth, radius, valid)), res, res, 16, k)
    gidx = idx.reshape(-1)
    perm, bounds = tflat.take_plan(gidx, n)
    rng = np.random.default_rng(8)
    payload = rng.normal(size=(n + 1, 16)).astype(np.float32)
    ct = rng.normal(size=(gidx.shape[0], 16)).astype(np.float32)
    _, vjp = jax.vjp(lambda p: jnp.take(p, jnp.asarray(gidx.numpy()), axis=0),
                     jnp.asarray(payload))
    (j_d,) = vjp(jnp.asarray(ct))
    j_d = np.asarray(j_d)
    t_d = tflat.planned_take_bwd(torch.as_tensor(ct), perm, bounds).numpy()
    exact, bound = _exact_and_bound(ct, perm.numpy(), bounds.numpy(),
                                    tflat.BWD_COLS)
    cols = slice(0, tflat.BWD_COLS)
    assert int(bounds[n + 1] - bounds[n]) == int((~live).sum())
    assert (np.diff(bounds.numpy()[:n + 1]) > 8).any()   # long runs
    assert (np.abs(t_d[:n, cols] - exact[:n]) <= bound[:n]).all()
    assert (np.abs(t_d[:n, cols] - j_d[:n, cols]) <= 2 * bound[:n]).all()
    assert not t_d[n].any() and not t_d[:, tflat.BWD_COLS:].any()


def test_gather_payload_transposes_through_h4():
    """_PlannedTake's backward is planned_take_bwd (the same bits), the
    forward index_select's rows; given no plan, the backward builds
    take_plan's and gives the same bits."""
    n = 40
    rng = np.random.default_rng(1)
    xs = [torch.tensor(rng.normal(size=s).astype(np.float32),
                       requires_grad=True)
          for s in ((n, 2), (n,), (n, 3), (n,), (n, 3))]
    gidx = torch.as_tensor(rng.integers(0, n + 1, 700))
    perm, bounds = tflat.take_plan(gidx, n)
    cand = tflat.gather_payload(*xs, gidx, perm, bounds)
    ct = torch.as_tensor(rng.normal(size=(700, 16)).astype(np.float32))
    ct[:, tflat.GRAD_ROWS:] = 0.0
    grads = torch.autograd.grad(cand, xs, ct)
    dpay = tflat.planned_take_bwd(ct, perm, bounds)
    for g, cols in zip(grads, (slice(0, 2), 9, slice(2, 5), 5,
                               slice(6, 9))):
        assert torch.equal(g, dpay[:n, cols])
    with torch.no_grad():
        assert torch.equal(tflat.gather_payload(*xs, gidx), cand)
    unplanned = torch.autograd.grad(tflat.gather_payload(*xs, gidx), xs, ct)
    for g, u in zip(grads, unplanned):
        assert torch.equal(g, u)
    with pytest.raises(ValueError):
        tflat.planned_take_bwd(ct, perm.long(), bounds)
    with pytest.raises(ValueError):
        tflat.planned_take_bwd(ct[:, :8].contiguous(), perm, bounds)


def test_mcmc_draw_is_an_exact_inverse_cdf():
    """gs_train's relocation targets and Stage 3's pixels (ops/draws.py::
    draw_by_weight): proportional to the weights, zero weights never
    drawn, the same indices from the same generator state, and each draw
    the inverse of the integer CDF at its uniform."""
    from holoscene_tpu_torch.ops.draws import draw_by_weight

    w = torch.tensor([0.0, 0.1, 0.3, 0.0, 0.6, 0.0])
    idx = draw_by_weight(w, 100_000, torch.Generator().manual_seed(0))
    freq = np.bincount(idx.numpy(), minlength=6) / 100_000
    np.testing.assert_allclose(freq, w.numpy(), atol=0.01)
    assert freq[[0, 3, 5]].sum() == 0
    again = draw_by_weight(w, 100_000, torch.Generator().manual_seed(0))
    assert torch.equal(idx, again)
    u = torch.rand(100_000, generator=torch.Generator().manual_seed(0),
                   dtype=torch.float64)
    cdf = np.cumsum(np.round(w.double().numpy() / 0.6 * 2.0 ** 32))
    want = np.searchsorted(cdf, np.floor(u.numpy() * cdf[-1]), side="right")
    np.testing.assert_array_equal(idx.numpy(), want)
    assert draw_by_weight(torch.zeros(4), 3).shape == (3,)


def test_stage3_and_mcmc_draw_through_draw_by_weight(tmp_path, monkeypatch):
    """Stage3Runner._draw and mcmc_relocate both call ops/draws.py::
    draw_by_weight (looked up on the module, so one swap reaches both),
    and each returns its draw unchanged: the indices of draw_by_weight on
    the same weights from the same generator state."""
    from holoscene_tpu_torch.models import gaussians_free as tgf
    from holoscene_tpu_torch.ops import draws
    from holoscene_tpu_torch.training.stage3 import Stage3Runner

    calls = []
    draw = draws.draw_by_weight

    def recording(weights, n, generator=None):
        calls.append(n)
        return draw(weights, n, generator)

    monkeypatch.setattr(draws, "draw_by_weight", recording)
    runner = Stage3Runner([], None, pixels_per_step=64, seed=3,
                          out_dir=str(tmp_path), quiet=True, device="cpu")
    w = (torch.arange(50) % 3 == 0).float()
    idx = runner._draw(w)
    assert torch.equal(idx, draw(w, 64, torch.Generator().manual_seed(3)))
    assert (idx % 3 == 0).all()

    cfg = tgf.FreeGaussianConfig(capacity=200)
    params, state = tgf.init_free_gaussians(
        cfg, generator=torch.Generator().manual_seed(0))
    params["opacity_logits"] = torch.linspace(-3.0, 3.0, 200)
    _, _, stats = tgf.mcmc_relocate(params, state, cfg,
                                    generator=torch.Generator().manual_seed(5))
    opac = torch.sigmoid(params["opacity_logits"]) * state["alive"]
    target = draw(opac, 10, torch.Generator().manual_seed(5))
    assert calls == [64, 10]
    want = torch.zeros(200, dtype=torch.bool)
    want[torch.argsort(torch.where(state["alive"], opac,
                                   torch.full_like(opac, float("inf"))),
                       stable=True)[:10]] = True
    want[target] = True
    assert torch.equal(stats["reset_mask"], want)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


# plans made from a seed with numpy (rows, live slots a row, dead slots):
# 100 runs of 40-299 slots, each crossing the kernel's 128-slot chunks and
# some its blocks' shares of the work, one row of 12,000 slots (a run many
# shares long), mostly empty rows, no rows at all, every slot dead, and
# the chain frame's ~0.82 live slots a row with 10x as many dead
H4_SYNTHETIC = ("straddle", "long_run", "empty_rows", "no_rows", "all_dead",
                "chain_scale")


def _synthetic_plan(name, dev):
    """(ct, perm, bounds, n) of a plan by name (H4_SYNTHETIC): the runs'
    lengths from a seed, the slots in random order, the dead slots' rows
    of ct NaN (a sum that took one would show)."""
    rng = np.random.default_rng(H4_SYNTHETIC.index(name))
    n, dead = {"straddle": (1000, 500), "long_run": (600, 1000),
               "empty_rows": (2000, 300), "no_rows": (0, 100),
               "all_dead": (500, 700), "chain_scale": (200_000, 1_640_000)
               }[name]
    lens = rng.integers(0, 3, n)
    if name == "straddle":
        lens[200:300] = rng.integers(40, 300, 100)
    elif name == "long_run":
        lens[300] = 12_000
    elif name == "empty_rows":
        lens = np.where(rng.uniform(size=n) < 0.9, 0, rng.integers(1, 6, n))
    elif name == "all_dead":
        lens[:] = 0
    elif name == "chain_scale":
        lens = rng.poisson(0.82, n)
    gidx = rng.permutation(np.concatenate(
        [np.repeat(np.arange(n), lens), np.full(dead, n)]))
    gidx = torch.as_tensor(gidx, device=dev)
    perm, bounds = tflat.take_plan(gidx, n)
    ct = torch.randn(gidx.shape[0], 16, device=dev,
                     generator=torch.Generator(dev).manual_seed(1))
    ct[gidx == n] = float("nan")
    return ct, perm, bounds, n


@pytest.mark.cuda
@pytest.mark.parametrize("path", ("flat", "topk") + H4_SYNTHETIC)
def test_h4_matches_plain_bitwise_twice(cuda, path):
    """H4 on the card: two launches and the plain twin the same bits, on
    the flat bins and the top-K lists of a projected scene (the top-K
    plan's dead entries in the trash row) and on the synthetic plans;
    columns 11-15 and the trash row zero, no dead slot summed."""
    if path in H4_SYNTHETIC:
        ct, perm, bounds, n = _synthetic_plan(path, cuda)
    else:
        ct, perm, bounds, n = _scene_plan(path, cuda)
    before = tflat.planned_take_bwd.launches
    a = tflat.planned_take_bwd(ct, perm, bounds)
    b = tflat.planned_take_bwd(ct, perm, bounds)
    torch.cuda.synchronize()
    assert tflat.planned_take_bwd.launches == before + 2
    plain = tflat.planned_take_bwd_plain(ct, perm, bounds)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(a.view(torch.int32), plain.view(torch.int32))
    assert a.shape == (n + 1, 16) and torch.isfinite(a).all()
    assert not a[n].any() and not a[:, tflat.BWD_COLS:].any()
    live = int(bounds[n])
    assert bool(a[:n, :tflat.BWD_COLS].abs().sum() > 0) == (live > 0)


def _scene_plan(path, dev):
    """(ct, perm, bounds, n): the flat bins' or the top-K lists' plan of
    3000 random gaussians projected to 96^2, a random cotangent."""
    from holoscene_tpu_torch.ops import gaussians as tg

    rng = np.random.default_rng(4)
    n, res = 3000, 96
    means = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.6, 0.6, n),
                      rng.uniform(1.2, 3.0, n)], -1)
    intr = torch.tensor([[res * 0.8, 0, res / 2], [0, res * 0.8, res / 2],
                         [0, 0, 1.0]], device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    xy, depth, conic, radius, valid = tg.project_gaussians_fused(
        torch.as_tensor(means, **f32),
        torch.as_tensor(rng.normal(size=(n, 4)), **f32),
        torch.as_tensor(rng.uniform(0.02, 0.08, (n, 3)), **f32),
        torch.eye(4, device=dev), intr, res, res)
    if path == "flat":
        opac = torch.full((n,), 0.8, device=dev)
        tiles = res // 16
        plan = tflat.plan_flat(xy, conic, opac, valid, tiles, tiles, 16)
        bins = tflat.build_flat_bins(xy, depth, conic, opac, valid,
                                     tiles_x=tiles, tiles_y=tiles,
                                     tile_size=16, plan=plan)
        perm, bounds = bins["perm"], bins["bounds"]
    else:
        idx = tsplat.select_topk(xy, depth, radius, valid, res, res, 16,
                                 256)[0]
        perm, bounds = tflat.take_plan(idx.reshape(-1), n)
        assert int(bounds[n + 1] - bounds[n]) > 0    # dead entries
    ct = torch.randn(perm.shape[0], 16, device=dev,
                     generator=torch.Generator(dev).manual_seed(0))
    return ct, perm, bounds, n
