"""Gaussian-on-Mesh model of the port against holoscene_tpu.models.gom:
seeding and init (directly and through convert.py), the reparameterised
means/scales/quats/opacities (with a visible mask too), render_gom (chw,
flat path; top-K path with a visible mask, perspective and orthographic),
gom_loss, the flat telemetry keys render_gom must forward, and the PLY round
trip."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holoscene_tpu.datasets.ns_dataset import NSDataset
from holoscene_tpu.datasets.synthetic import generate_scene
from holoscene_tpu.models import gom as jgom
from holoscene_tpu.ops import splat_flat as jflat
from holoscene_tpu_torch import convert
from holoscene_tpu_torch.datasets.synthetic import scene_meshes
from holoscene_tpu_torch.models import gom as tgom
from holoscene_tpu_torch.ops import splat_flat as tflat
from test_torch_threads import few_torch_threads  # noqa: F401

AREA = 0.05
FWD_ATOL = 2e-4       # K1's parity tolerance (tests/test_torch_splat_flat.py)
LOSS_RTOL = 1e-4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("tgom")
    generate_scene(str(root / "scene_0"), n_images=2, img_res=(40, 40))
    ds = NSDataset(str(root), "scene_0", img_res=(40, 40))
    meshes = scene_meshes(8)
    jcfg = jgom.GoMConfig(sh_degree=2)
    tcfg = tgom.GoMConfig(sh_degree=2)
    jstatic = jgom.seed_gaussians_from_meshes(meshes, AREA, jcfg)
    jparams = jgom.init_gom_params(jstatic, jcfg)
    # perturb away from the init so the clamps and SH terms are exercised
    rng = np.random.default_rng(0)
    jparams = {k: np.asarray(v) + rng.normal(0, 0.05, np.shape(v)).astype(
        np.float32) for k, v in jparams.items()}
    return ds, meshes, jcfg, tcfg, jstatic, jparams


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def test_seeding_and_init_match_jax(setup):
    _ds, meshes, jcfg, tcfg, jstatic, _ = setup
    tstatic = tgom.seed_gaussians_from_meshes(meshes, AREA, tcfg)
    assert 100 <= tstatic["num_gaussians"] == jstatic["num_gaussians"] < 2000
    assert tstatic["instance_ranges"] == jstatic["instance_ranges"]
    conv = convert.gom_static_from_jax(jstatic)
    assert conv["instance_ranges"] == jstatic["instance_ranges"]
    for k, v in jstatic.items():
        if k in ("instance_ranges", "num_gaussians"):
            continue
        np.testing.assert_allclose(_np(tstatic[k]), np.asarray(v), atol=1e-6,
                                   rtol=1e-5, err_msg=k)
        np.testing.assert_array_equal(_np(conv[k]), np.asarray(v))
    jp = jgom.init_gom_params(jstatic, jcfg)
    tp = tgom.init_gom_params(tstatic, tcfg)
    assert set(tp) == set(jp)
    for k in jp:
        assert tp[k].requires_grad
        np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]), atol=1e-6,
                                   rtol=1e-5, err_msg=k)
    back = convert.params_to_numpy(convert.gom_params_from_jax(jp))
    for k in jp:
        np.testing.assert_array_equal(back[k], np.asarray(jp[k]))


def test_reparameterisations_match_jax(setup):
    _ds, _m, jcfg, tcfg, jstatic, jparams = setup
    tstatic = convert.gom_static_from_jax(jstatic)
    tparams = convert.gom_params_from_jax(jparams)
    for jf, tf in ((jgom.gom_means, tgom.gom_means),
                   (jgom.gom_scales, tgom.gom_scales),
                   (jgom.gom_quats, tgom.gom_quats)):
        np.testing.assert_allclose(
            _np(tf(tparams, tstatic, tcfg)),
            np.asarray(jf(jparams, jstatic, jcfg)), atol=1e-5, rtol=1e-5,
            err_msg=jf.__name__)
    np.testing.assert_allclose(_np(tgom.gom_opacities(tparams)),
                               np.asarray(jgom.gom_opacities(jparams)),
                               atol=1e-6)


def test_render_gom_and_loss_match_jax(setup):
    ds, _m, jcfg, tcfg, jstatic, jparams = setup
    tstatic = convert.gom_static_from_jax(jstatic)
    tparams = convert.gom_params_from_jax(jparams)
    h, w = ds.img_res
    pose, intr = ds.pose_all[1], ds.intrinsics[:3, :3]
    bg = np.array([0.2, 0.5, 0.7], np.float32)

    xy, depth, conic, valid = jgom.gom_project(
        jparams, jstatic, jcfg, jnp.asarray(pose), jnp.asarray(intr), w, h)
    tiles = -(-w // 16)
    plan = jflat.plan_flat(xy, conic, jgom.gom_opacities(jparams), valid,
                           tiles, tiles, 16)
    jbins = jgom.gom_flat_bins(jparams, jstatic, jcfg, jnp.asarray(pose),
                               jnp.asarray(intr), w, h, plan)
    tplan = tflat.FlatPlan(plan.span_x, plan.span_y, plan.c_max)
    tbins = tgom.gom_flat_bins(tparams, tstatic, tcfg, pose, intr, w, h,
                               tplan)
    jout = jgom.render_gom(jparams, jstatic, jcfg, jnp.asarray(pose),
                           jnp.asarray(intr), w, h, jnp.asarray(bg),
                           flat_plan=plan, flat_bins=jbins, chw=True)
    tout = tgom.render_gom(tparams, tstatic, tcfg, pose, intr, w, h,
                           torch.as_tensor(bg), flat_plan=tplan,
                           flat_bins=tbins, chw=True)
    assert tout["rgb"].shape == (3, h, w)
    for k in ("rgb", "accumulation"):
        np.testing.assert_allclose(_np(tout[k]), np.asarray(jout[k]),
                                   atol=FWD_ATOL, err_msg=k)
    cover = np.asarray(jout["accumulation"]) > 0.1
    assert cover.mean() > 0.3
    np.testing.assert_allclose(_np(tout["depth"])[cover],
                               np.asarray(jout["depth"])[cover],
                               atol=FWD_ATOL, rtol=1e-4)
    # regression guard: the flat telemetry survives render_gom
    for k in ("used_chunks", "stale", "overflow", "xy_drift"):
        assert k in tout, k
    for k in ("used_chunks", "stale", "overflow"):
        np.testing.assert_array_equal(_np(tout[k]), np.asarray(jout[k]),
                                      err_msg=k)
    # same params at bin and render time: JAX reports only the rounding
    # jitter between its eager and jitted projections (a few 1e-3 px)
    assert float(tout["xy_drift"]) < 1e-2 and float(jout["xy_drift"]) < 1e-2
    assert int(tout["used_chunks"].max()) >= 1

    rng = np.random.default_rng(3)
    gt = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    acm = (rng.uniform(0, 1, (h, w)) > 0.3).astype(np.float32)
    mdepth = rng.uniform(0.5, 2.0, (h, w)).astype(np.float32)
    jl = jgom.gom_loss(jout, {"image": jnp.asarray(gt), "acm": jnp.asarray(acm),
                              "mesh_depth": jnp.asarray(mdepth)}, jcfg,
                       with_scale_reg=True, chw=True,
                       scales_linear=jgom.gom_scales(jparams, jstatic, jcfg))
    tl = tgom.gom_loss(tout, {"image": torch.as_tensor(gt),
                              "acm": torch.as_tensor(acm),
                              "mesh_depth": torch.as_tensor(mdepth)}, tcfg,
                       with_scale_reg=True, chw=True,
                       scales_linear=tgom.gom_scales(tparams, tstatic, tcfg))
    assert set(tl) == set(jl)
    for k in jl:
        np.testing.assert_allclose(tl[k].item(), float(jl[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)


def test_opacities_with_visible_mask_match_jax(setup):
    _ds, _m, _jcfg, _tcfg, jstatic, jparams = setup
    tparams = convert.gom_params_from_jax(jparams)
    lo, hi = jstatic["instance_ranges"][1]
    mask = np.zeros(jstatic["num_gaussians"], bool)
    mask[lo:hi] = True
    got = tgom.gom_opacities(tparams, torch.as_tensor(mask))
    np.testing.assert_allclose(
        _np(got), np.asarray(jgom.gom_opacities(jparams, jnp.asarray(mask))),
        atol=1e-7)
    assert float(got.detach()[~torch.as_tensor(mask)].max()) < 2e-6
    got.sum().backward()
    grad = _np(tparams["opacities"].grad)[:, 0]
    assert not grad[~mask].any() and grad[mask].all()


@pytest.mark.parametrize("ortho", [False, True])
def test_render_gom_topk_visible_mask_matches_jax(setup, ortho):
    """The top-K path of render_gom (no flat plan) on one object's
    gaussians, as the invisible-view step renders it."""
    import dataclasses

    ds, _m, jcfg, tcfg, jstatic, jparams = setup
    jcfg = dataclasses.replace(jcfg, max_per_tile=200, use_pallas=True)
    tcfg = dataclasses.replace(tcfg, max_per_tile=200)
    tstatic = convert.gom_static_from_jax(jstatic)
    tparams = convert.gom_params_from_jax(jparams)
    h, w = ds.img_res
    pose = ds.pose_all[1]
    if ortho:
        half = 0.6
        intr = np.array([[w / (2 * half), 0, w / 2], [0, h / (2 * half), h / 2],
                         [0, 0, 1]], np.float32)
    else:
        intr = np.asarray(ds.intrinsics[:3, :3], np.float32)
    lo, hi = jstatic["instance_ranges"][1]
    mask = np.zeros(jstatic["num_gaussians"], bool)
    mask[lo:hi] = True
    bg = np.array([0.2, 0.5, 0.7], np.float32)
    jout = jgom.render_gom(jparams, jstatic, jcfg, jnp.asarray(pose),
                           jnp.asarray(intr), w, h, jnp.asarray(bg),
                           visible_mask=jnp.asarray(mask), ortho=ortho)
    tout = tgom.render_gom(tparams, tstatic, tcfg, pose, intr, w, h,
                           torch.as_tensor(bg),
                           visible_mask=torch.as_tensor(mask), ortho=ortho)
    assert tout["rgb"].shape == (h, w, 3)
    for k in ("rgb", "accumulation"):
        np.testing.assert_allclose(_np(tout[k]), np.asarray(jout[k]),
                                   atol=FWD_ATOL, err_msg=k)
    cover = np.asarray(jout["accumulation"]) > 0.1
    assert 0.02 < cover.mean() < 0.9      # the object, not the room
    np.testing.assert_allclose(_np(tout["depth"])[cover],
                               np.asarray(jout["depth"])[cover],
                               atol=FWD_ATOL, rtol=1e-4)
    assert "used_chunks" in tout and "stale" not in tout


def test_ply_round_trip(setup, tmp_path):
    _ds, _m, _jcfg, tcfg, jstatic, jparams = setup
    tstatic = convert.gom_static_from_jax(jstatic)
    tparams = convert.gom_params_from_jax(jparams)
    g = tgom.compose_for_export(tparams, tstatic, tcfg)
    ref = jgom.compose_for_export(jparams, jstatic, jgom.GoMConfig(sh_degree=2))
    for k in ref:
        np.testing.assert_allclose(g[k], ref[k], atol=1e-5, rtol=1e-5,
                                   err_msg=k)
    p = str(tmp_path / "g.ply")
    tgom.write_gaussian_ply(p, g)
    back = tgom.read_gaussian_ply(p)
    # the JAX reader reads the port's file identically
    jback = jgom.read_gaussian_ply(p)
    for k in g:
        np.testing.assert_allclose(back[k].reshape(g[k].shape), g[k],
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        np.testing.assert_array_equal(back[k], jback[k])
