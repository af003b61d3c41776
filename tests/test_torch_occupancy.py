"""The port's occupancy grid (holoscene_tpu_torch/ops/occupancy.py) and its
Stage-1 wiring against the JAX package's, on the CPU.

The grid's arithmetic is bitwise JAX's: the cell of a point, the update
(scatter-min of |sdf|, decay of the unprobed cells), the occupied mask,
and ray_range's taps and decisions (its near / far to 1e-6). Stage-1
steps from identical parameters and draws: with an all-occupied grid the
step is the step without one (as tests/test_occupancy.py asserts for
JAX); an update step and a restricted step match JAX's
make_train_step(..., occ=...) at test_torch_stage1.py's tolerances
(losses rtol 1e-4, every gradient within 1e-3 of its tensor's largest),
and the grid after the update step matches JAX's where the two samplers
probed the same cells (sampler placements are last-bit sensitive, see
test_torch_sampler.py), to 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401
from torch_stage1_cases import batch, cfgs, jax_params, port_model, step_draws

from holoscene_tpu.losses.holoscene_loss import LossConfig as JLossConfig
from holoscene_tpu.ops import occupancy as jocc
from holoscene_tpu.training import stage1 as js1
from holoscene_tpu_torch.convert import (
    occ_grid_from_jax,
    stage1_params_from_jax,
)
from holoscene_tpu_torch.losses.holoscene_loss import LossConfig
from holoscene_tpu_torch.ops import occupancy as tocc
from holoscene_tpu_torch.ops.sampler import _near_far, linspace
from holoscene_tpu_torch.training import stage1 as ts1

RES, TAPS = 16, 32
LOSS_RTOL, GRAD_REL = 1e-4, 1e-3


def _cfgs(res=RES, taps=TAPS, bound=1.0):
    return (jocc.OccGridConfig(resolution=res, taps=taps, bound=bound),
            tocc.OccGridConfig(resolution=res, taps=taps, bound=bound))


@pytest.mark.parametrize("taps", [16, 32, 64, 100, 128])
def test_taps_are_jnp_linspace_bitwise(taps):
    """torch.linspace(0, 1, 64) differs from jnp.linspace in about half
    of the values by one ulp; the port's taps do not."""
    want = np.asarray(jnp.linspace(0.0, 1.0, taps))
    got = linspace(0.0, 1.0, taps, "cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_cell_index_and_update_are_bitwise():
    jc, tc = _cfgs()
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1.3, 1.3, (4000, 3)).astype(np.float32)
    pts[:50] = np.round(pts[:50] * 8) / 8          # points on cell faces
    sdf = rng.normal(0, 0.3, 4000).astype(np.float32)
    occ = rng.uniform(0, 0.5, RES ** 3).astype(np.float32)
    ji, jin = jocc._cell_index(jnp.asarray(pts), jc)
    ti, tin = tocc._cell_index(torch.tensor(pts), tc)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
    want = np.asarray(jocc.update_occ_grid(jnp.asarray(occ), jnp.asarray(pts),
                                           jnp.asarray(sdf), jc))
    got = tocc.update_occ_grid(torch.tensor(occ), torch.tensor(pts),
                               torch.tensor(sdf), tc).numpy()
    np.testing.assert_array_equal(got, want)
    # repeated cells keep the min |sdf|; outside points are dropped
    assert (got != occ * np.float32(tc.decay)).any()
    for beta in (0.001, 0.05, torch.tensor(0.2)):
        jb = jnp.asarray(float(beta))
        np.testing.assert_array_equal(
            tocc.occupied_mask(torch.tensor(got), beta, tc).numpy(),
            np.asarray(jocc.occupied_mask(jnp.asarray(want), jb, jc)))


def test_update_with_a_rank_reduce_is_the_update_of_both_batches():
    """Two ranks' probe batches, each reduced to per-cell minima and
    combined with an elementwise min (what the all-reduce MIN does), give
    the grid of one update over both batches."""
    _, tc = _cfgs()
    rng = np.random.default_rng(3)
    pts = torch.tensor(rng.uniform(-1, 1, (600, 3)).astype(np.float32))
    sdf = torch.tensor(rng.normal(0, 0.2, 600).astype(np.float32))
    occ = torch.tensor(rng.uniform(0, 0.3, RES ** 3).astype(np.float32))
    other = tocc.occ_batch_min(occ, pts[300:], sdf[300:], tc)
    split = tocc.update_occ_grid(occ, pts[:300], sdf[:300], tc,
                                 reduce_min=lambda m: torch.minimum(m, other))
    assert torch.equal(split, tocc.update_occ_grid(occ, pts, sdf, tc))


def test_ray_range_matches_jax():
    jc, tc = _cfgs()
    rng = np.random.default_rng(1)
    occ = rng.uniform(0, 0.6, RES ** 3).astype(np.float32)
    occ[rng.uniform(size=RES ** 3) < 0.7] = 5.0      # mostly empty cells
    n = 300
    rays_o = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    rays_d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    near = rng.uniform(0, 0.2, (n, 1)).astype(np.float32)
    far = near + rng.uniform(0.5, 2.5, (n, 1)).astype(np.float32)
    beta = np.float32(0.02)
    jn, jf = jocc.ray_range(*(jnp.asarray(a) for a in
                              (occ, rays_o, rays_d, near, far)), beta, jc)
    tn, tf = tocc.ray_range(*(torch.tensor(a) for a in
                              (occ, rays_o, rays_d, near, far)),
                            torch.tensor(beta), tc)
    # the tap decisions: the same cells and the same occupied taps
    t = linspace(0.0, 1.0, TAPS, "cpu")[None]
    z = torch.tensor(near) * (1 - t) + torch.tensor(far) * t
    pts = torch.tensor(rays_o)[:, None] + z[..., None] * torch.tensor(
        rays_d)[:, None]
    jt = np.asarray(jnp.asarray(near) * (1.0 - jnp.linspace(0.0, 1.0, TAPS))
                    + jnp.asarray(far) * jnp.linspace(0.0, 1.0, TAPS))
    np.testing.assert_array_equal(z.numpy(), jt)
    ti, tin = tocc._cell_index(pts.reshape(-1, 3), tc)
    ji, jin = jocc._cell_index(jnp.asarray(pts.numpy().reshape(-1, 3)), jc)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=1e-6)
    restricted = (tn.numpy() > near) | (tf.numpy() < far)
    full = (tn.numpy() == near) & (tf.numpy() == far)
    assert restricted.sum() > n // 4 and full.sum() > 0
    assert (tn.numpy() >= near).all() and (tf.numpy() <= far).all()


def _occ_cfgs(res=8, taps=16):
    jc, tc = cfgs("exact")
    sbs = jc.scene_bounding_sphere
    jo, to = _cfgs(res, taps, sbs)
    return (dataclasses.replace(jc, use_occupancy=True, occupancy=jo),
            dataclasses.replace(tc, use_occupancy=True, occupancy=to))


def _step_both(jc, tc, occ_np, update_occ, seed=5):
    """(JAX metrics, JAX delta, JAX grid, port metrics, port delta, port
    grid) of one SGD (lr 1) step from the same parameters and draws."""
    params = jax_params(jc)
    before = jax.tree_util.tree_map(np.asarray, params)
    model = port_model(tc, params)
    b = batch()
    key = jax.random.PRNGKey(seed)
    draws = step_draws(key, jc, tc)
    opt = optax.sgd(1.0)
    step = js1.make_train_step(jc, JLossConfig(), opt)
    p2, _, jm, jgrid = step(params, opt.init(params), key,
                            {k: jnp.asarray(v) for k, v in b.items()}, 0,
                            call_reg=False, with_bg=False,
                            occ=jnp.asarray(occ_np), update_occ=update_occ)
    jdelta = stage1_params_from_jax(jax.tree_util.tree_map(
        lambda a, c: np.asarray(c) - a, before, p2))
    t_before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    optimizer = torch.optim.SGD(model.parameters(), lr=1.0)
    tb = ts1.batch_to_device(b, b, "cpu")
    tm, tgrid = ts1.train_step(model, optimizer, None, LossConfig(), tb,
                               draws, 0, occ=occ_grid_from_jax(occ_np),
                               update_occ=update_occ)
    tdelta = {k: v - t_before[k] for k, v in model.state_dict().items()}
    return jm, jdelta, np.asarray(jgrid), tm, tdelta, tgrid.numpy()


def _check_step(jm, jd, tm, td):
    for k in ("loss", "rgb_loss", "eikonal_loss", "depth_loss", "normal_l1",
              "semantic_loss", "psnr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    for k, ref in jd.items():
        scale = float(ref.abs().max())
        err = float((td[k] - ref).abs().max())
        assert err <= GRAD_REL * scale + 1e-9, (k, err, scale)


@pytest.fixture(scope="module")
def update_run():
    jc, tc = _occ_cfgs()
    occ0 = np.zeros(8 ** 3, np.float32)
    return jc, tc, _step_both(jc, tc, occ0, update_occ=True)


@pytest.mark.parametrize("update_occ", [True, False])
def test_all_occupied_grid_step_is_the_plain_step(update_occ):
    """An all-occupied grid restricts nothing: the step equals the step
    without a grid (its loss and every parameter after it), and without
    update_occ the grid comes back unchanged."""
    _, tc = _occ_cfgs()
    b = batch()
    jcf, _ = cfgs("exact")
    draws = step_draws(jax.random.PRNGKey(5), jcf, tc)
    params = jax_params(jcf)
    out = []
    for occ in (None, torch.zeros(8 ** 3)):
        model = port_model(tc, params)
        opt = torch.optim.SGD(model.parameters(), lr=1.0)
        res = ts1.train_step(model, opt, None, LossConfig(),
                             ts1.batch_to_device(b, b, "cpu"), draws, 0,
                             occ=occ, update_occ=update_occ)
        out.append((res, model.state_dict()))
    (m0, s0), ((m1, grid), s1) = out
    assert float(m1["loss"]) == float(m0["loss"])
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    if update_occ:
        assert float(grid.max()) > 0
    else:
        assert torch.equal(grid, torch.zeros(8 ** 3))


def test_update_step_matches_jax(update_run):
    _, tc, (jm, jd, jgrid, tm, td, tgrid) = update_run
    _check_step(jm, jd, tm, td)
    both = np.isfinite(jgrid) & (jgrid > 0) & (tgrid > 0)
    assert both.sum() >= 0.9 * max((jgrid > 0).sum(), (tgrid > 0).sum())
    np.testing.assert_allclose(tgrid[both], jgrid[both], rtol=1e-5,
                               atol=1e-6)


def test_restricted_step_matches_jax():
    """A restricted step on a grid that is empty outside a ball of radius
    0.6 (so that most rays are cut): the same loss and gradients as JAX's,
    and the grid handed back unchanged. The draws are those of the key
    test_torch_stage1.py's steps use (5). Measured over keys 5, 9, 11,
    13, 17: ray_range's near / far bitwise JAX's, the largest gradient
    deviation 5e-4 of its tensor except beta's at key 9, 2.7e-3 (a
    scalar whose gradient is a cancelling sum over every sample; the
    step without a grid shows the same spread, up to 6.7e-4)."""
    jc, tc = _occ_cfgs()
    c = (np.arange(8) + 0.5) / 8 * 2 * jc.scene_bounding_sphere \
        - jc.scene_bounding_sphere
    cx, cy, cz = np.meshgrid(c, c, c, indexing="ij")
    grid = np.where(np.sqrt(cx ** 2 + cy ** 2 + cz ** 2) < 0.6, 0.0,
                    5.0).astype(np.float32).reshape(-1)
    b = batch()
    ro, rd, _, _ = ts1.rays_from_batch(*(torch.tensor(b[k]) for k in
                                         ("uv", "pose", "intrinsics")))
    near, far = _near_far(ro, rd, tc.sampler, None, None)
    nr, fr = tocc.ray_range(torch.tensor(grid), ro, rd, near, far, 0.1,
                            tc.occupancy)
    assert ((nr > near) | (fr < far)).float().mean() > 0.5
    jm, jd, jgrid2, tm, td, tgrid2 = _step_both(jc, tc, grid,
                                                update_occ=False)
    _check_step(jm, jd, tm, td)
    np.testing.assert_array_equal(tgrid2, grid)
    np.testing.assert_array_equal(jgrid2, grid)
