"""The whole Stage-4 slice of the port against the JAX Stage4Runner, each
from identical state (losses, gradients, Adam update): one flat training
step, one top-K training step with the auto-calibrated depth, and one
invisible-view step on an analytic pack.
The port-only run, the CLI and the device rule are in
test_torch_stage4_run.py (split to keep each file's time short)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from holoscene_tpu.datasets.ns_dataset import NSDataset
from holoscene_tpu.datasets.synthetic import generate_scene
from holoscene_tpu.models import gom as jgom
from holoscene_tpu.training.stage4 import Stage4Runner as JaxStage4Runner
from holoscene_tpu_torch.convert import gom_params_from_jax
from holoscene_tpu_torch.datasets.synthetic import (
    DEFAULT_SPHERES,
    scene_meshes,
    sphere_view_packs,
)
from holoscene_tpu_torch.models.gom import GoMConfig
from holoscene_tpu_torch.training.stage4 import Stage4Runner
from test_torch_threads import few_torch_threads  # noqa: F401

AREA = 5e-3
LOSS_RTOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 5e-4, 5e-3   # as the JAX flat backward's own test
# The compositor's alpha has two discontinuities (the 1/255 cut and the 0.999
# clamp): a candidate sitting on one flips between the two frameworks' exp
# roundings and moves one gaussian's gradient by more than any tolerance on
# sums. FRAME is a training frame of this scene on which no candidate does;
# frame 0, where one does, is compared with exactly the gaussians left out
# that have a candidate within THRESH_EPS of a discontinuity (the one
# gaussian whose gradient disagrees there, by 4e-3 in normal_elevates, has a
# candidate 1.4e-6 from one: the frameworks' projections round differently,
# and that enters alpha through the quadratic form).
FRAME = 2
THRESH_EPS = 2e-6


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("ts4")
    generate_scene(str(root / "scene_0"), n_images=6, img_res=(32, 32))
    return NSDataset(str(root), "scene_0", img_res=(32, 32)), str(root)


@pytest.fixture(scope="module")
def meshes():
    return scene_meshes(12)


@pytest.fixture(scope="module")
def jax_flat(scene, meshes, tmp_path_factory):
    """The JAX flat runner and its jitted step loss (value and gradient),
    built once for the two flat-step tests and the invisible-view test:
    none changes the runner's parameters or optimizer state (the JAX steps
    are functional), and the loss takes the frame's inputs as arguments,
    so it compiles once. max_per_tile 0 (256 on the flat path) and
    use_pallas are the invisible-view step's; the flat steps never read
    them."""
    ds, _ = scene
    jcfg = jgom.GoMConfig(sh_degree=1, tile_size=16, use_flat=True,
                          max_per_tile=0, use_pallas=True)
    jr = JaxStage4Runner(meshes, ds, cfg=jcfg, area_to_subdivide=AREA,
                         max_total_iters=40,
                         out_dir=str(tmp_path_factory.mktemp("j")),
                         quiet=True)
    static = {**jr._static_host, **jr._static_arr}
    h, w = ds.img_res

    @jax.jit
    def value_and_grad(params, pose, intr, bins, bg, image, acm, mesh_depth):
        def loss_fn(p):      # stage4.step_fn's loss, with bg passed in
            out = jgom.render_gom(p, static, jr.cfg, pose, intr, w, h, bg,
                                  flat_plan=jr.flat_plan, flat_bins=bins,
                                  chw=True)
            batch = {"image": image * acm[None]
                     + (1 - acm[None]) * bg[:, None, None],
                     "acm": acm, "mesh_depth": mesh_depth, "mask": None}
            losses = jgom.gom_loss(out, batch, jr.cfg, chw=True)
            return (losses["main_loss"] * jr.loss_scale
                    + losses["scale_reg"], losses)

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    return jr, value_and_grad


def _port_runner(meshes, ds, out_dir, use_flat=True, **kw):
    cfg = GoMConfig(sh_degree=1, tile_size=16, use_flat=use_flat, **kw)
    return Stage4Runner(meshes, ds, cfg=cfg, area_to_subdivide=AREA,
                        max_total_iters=40, out_dir=out_dir, quiet=True,
                        device="cpu")


def test_one_step_matches_jax(scene, meshes, jax_flat, tmp_path):
    _flat_step_both(scene, meshes, jax_flat, tmp_path, FRAME)


def test_one_step_matches_jax_off_the_alpha_thresholds(scene, meshes,
                                                       jax_flat, tmp_path):
    """Frame 0: every gaussian's gradient and update agree but for those
    with a (pixel, candidate) alpha within THRESH_EPS of the 1/255 cut or
    the 0.999 clamp, and these are a handful."""
    _flat_step_both(scene, meshes, jax_flat, tmp_path, 0,
                    skip_near_thresholds=True)


def _near_thresholds(tr, frame):
    """Indices of the gaussians with a candidate alpha (before the clamp)
    within THRESH_EPS of a discontinuity at some pixel of `frame`."""
    from holoscene_tpu_torch.models import gom
    from holoscene_tpu_torch.ops import splat_flat as sf

    h, w = tr.dataset.img_res
    pose, intr = tr._pose_intr(frame)
    bins = tr._get_bins(frame, pose, intr)
    n = tr.static["num_gaussians"]
    tiles_x = -(-w // 16)
    with torch.no_grad():
        xy, depth, conic, _valid = gom.gom_project(
            tr.params, tr.static, tr.cfg, pose, intr, w, h)
        chunks = sf.gather_payload(
            xy, depth, conic, gom.gom_opacities(tr.params),
            xy.new_zeros(n, 3), bins["gidx"]).reshape(-1, sf.CHUNK, 16)
        gidx = bins["gidx"].reshape(-1, sf.CHUNK)
        px, py, _ = sf._tile_pixels(bins["tile_chunk_cnt"].shape[0], tiles_x,
                                    16, w, h, "cpu")
        near = set()
        for t, (c0, cnt) in enumerate(zip(bins["tile_chunk_start"].tolist(),
                                          bins["tile_chunk_cnt"].tolist())):
            for c in range(c0, c0 + cnt):
                a_pre = sf._chunk_alpha(px[t:t + 1], py[t:t + 1],
                                        chunks[c:c + 1])[4][0]
                hit = ((a_pre - 1 / 255).abs() < THRESH_EPS) \
                    | ((a_pre - 0.999).abs() < THRESH_EPS)
                near |= set(gidx[c][hit.any(0)].tolist())
    return np.array(sorted(near - {n}), dtype=np.int64)


def _flat_step_both(scene, meshes, jax_flat, tmp_path, frame,
                    skip_near_thresholds=False):
    ds, _ = scene
    jr, value_and_grad = jax_flat
    tr = _port_runner(meshes, ds, str(tmp_path / "t"))
    assert tr.static["num_gaussians"] == jr.static["num_gaussians"]
    assert tr.instance_ranges == jr.instance_ranges
    assert tr.flat_plan == type(tr.flat_plan)(**vars(jr.flat_plan))
    before = _copy_state(tr, jr)
    skip = None
    if skip_near_thresholds:
        skip = _near_thresholds(tr, frame)
        assert 0 < skip.size <= 16, skip

    h, w = ds.img_res
    acm, mesh_depth = jr._frame_mesh_raster(frame)
    image = ds.rgb_images[frame].reshape(h, w, 3).transpose(2, 0, 1)
    pose = jnp.asarray(ds.pose_all[frame])
    intr = jnp.asarray(ds.intrinsics[:3, :3])
    bg = jax.random.uniform(jax.random.PRNGKey(3), (3,))
    jbins = jr._get_bins(frame, pose, intr)
    (jtotal, jlosses), jgrads = value_and_grad(
        jr.params, pose, intr, jbins, bg, jnp.asarray(image),
        jnp.asarray(acm), jnp.asarray(mesh_depth))
    upd, _ = jr.optimizer.update(jgrads, jr.opt_state, jr.params)
    jnew = optax.apply_updates(jr.params, upd)

    tbins = tr._get_bins(frame, *tr._pose_intr(frame))
    for k in ("tile_chunk_start", "tile_chunk_cnt"):
        np.testing.assert_array_equal(tbins[k].numpy(), np.asarray(jbins[k]))
    metrics, used, _stale, _drift = tr._step(
        *tr._pose_intr(frame), *(torch.tensor(np.array(x)) for x in (
            image, acm, mesh_depth)), tbins, torch.tensor(np.array(bg)))

    np.testing.assert_allclose(float(metrics["loss"]), float(jtotal),
                               rtol=LOSS_RTOL)
    for k in ("l1", "ssim_loss", "acm_loss", "depth_loss"):
        np.testing.assert_allclose(float(metrics[k]), float(jlosses[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    assert int(used.max()) >= 1
    _check_grads_and_update(tr, before, jgrads, jnew, skip)


def _copy_state(tr, jr):
    """Start the port's runner from the JAX runner's parameters (the port
    seeds the same numbers; copy to be exact to the last bit)."""
    jp = {k: np.asarray(v) for k, v in jr.params.items()}
    for k, v in gom_params_from_jax(jp).items():
        np.testing.assert_allclose(tr.params[k].detach().numpy(),
                                   v.detach().numpy(), atol=1e-6, rtol=1e-5,
                                   err_msg=k)
        with torch.no_grad():
            tr.params[k].copy_(v)
    return {k: v.detach().clone() for k, v in tr.params.items()}


def _check_grads_and_update(tr, before, jgrads, jnew, skip=None):
    """skip: indices of gaussians (rows of every parameter) left out."""
    skip = np.zeros(0, np.int64) if skip is None else skip
    moved = 0.0
    for k, p in tr.params.items():
        g = np.delete(np.asarray(jgrads[k]), skip, axis=0)
        np.testing.assert_allclose(np.delete(p.grad.numpy(), skip, axis=0), g,
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=f"grad {k}")
        # Adam's first step is lr * sign(g): compare where the sign is sure
        sure = np.abs(g) > 1e-6
        np.testing.assert_allclose(np.delete(p.detach().numpy(), skip,
                                             axis=0)[sure],
                                   np.delete(np.asarray(jnew[k]), skip,
                                             axis=0)[sure], atol=1e-6,
                                   rtol=1e-5, err_msg=f"update {k}")
        moved = max(moved, float((p.detach() - before[k]).abs().max()))
    # regression guard: a step must change the params
    assert moved > 0.0


def test_one_topk_step_matches_jax(scene, meshes, tmp_path):
    """GoMConfig(use_flat=False, max_per_tile=0): both runners calibrate
    the same compositing depth, and one step through the top-K compositor
    (the Pallas kernels in interpret mode on the JAX side) moves the
    parameters alike."""
    ds, _ = scene
    jcfg = jgom.GoMConfig(sh_degree=1, tile_size=16, use_flat=False,
                          max_per_tile=0, use_pallas=True)
    jr = JaxStage4Runner(meshes, ds, cfg=jcfg, area_to_subdivide=AREA,
                         max_total_iters=40, out_dir=str(tmp_path / "j"),
                         quiet=True)
    tr = _port_runner(meshes, ds, str(tmp_path / "t"), use_flat=False,
                      max_per_tile=0)
    assert not tr.use_flat and tr.flat_plan is None
    assert 64 <= tr.cfg.max_per_tile == jr.cfg.max_per_tile <= tr.k_geom
    before = _copy_state(tr, jr)

    h, w = ds.img_res
    acm, mesh_depth = jr._frame_mesh_raster(FRAME)
    image = ds.rgb_images[FRAME].reshape(h, w, 3).transpose(2, 0, 1)
    pose = jnp.asarray(ds.pose_all[FRAME])
    intr = jnp.asarray(ds.intrinsics[:3, :3])
    bg = jax.random.uniform(jax.random.PRNGKey(5), (3,))
    static = {**jr._static_host, **jr._static_arr}

    def loss_fn(p):      # stage4.step_fn's loss, with bg passed in
        out = jgom.render_gom(p, static, jr.cfg, pose, intr, w, h, bg,
                              chw=True)
        batch = {"image": jnp.asarray(image) * acm[None]
                 + (1 - acm[None]) * bg[:, None, None],
                 "acm": jnp.asarray(acm), "mesh_depth": jnp.asarray(mesh_depth),
                 "mask": None}
        losses = jgom.gom_loss(out, batch, jr.cfg, chw=True)
        return losses["main_loss"] * jr.loss_scale + losses["scale_reg"], losses

    (jtotal, jlosses), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jr.params)
    upd, _ = jr.optimizer.update(jgrads, jr.opt_state, jr.params)
    jnew = optax.apply_updates(jr.params, upd)

    metrics, used, stale, _drift = tr._step(
        *tr._pose_intr(FRAME), *(torch.tensor(np.array(x)) for x in (
            image, acm, mesh_depth)), None, torch.tensor(np.array(bg)))
    np.testing.assert_allclose(float(metrics["loss"]), float(jtotal),
                               rtol=LOSS_RTOL)
    for k in ("l1", "ssim_loss", "acm_loss", "depth_loss"):
        np.testing.assert_allclose(float(metrics[k]), float(jlosses[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    assert used.shape == (4,) and int(used.max()) >= 1 and int(stale) == 0
    _check_grads_and_update(tr, before, jgrads, jnew)


def test_one_invisible_view_step_matches_jax(scene, meshes, jax_flat,
                                            tmp_path):
    """One invisible-view step of the flat trainer on an analytic pack of
    sphere 0 (mesh 1): only that object's gaussians render, orthographic,
    through the top-K compositor at the flat trainer's depth."""
    ds, _ = scene
    jr, _ = jax_flat
    tr = _port_runner(meshes, ds, str(tmp_path / "t"), max_per_tile=0)
    assert tr.cfg.max_per_tile == jr.cfg.max_per_tile == 256
    before = _copy_state(tr, jr)

    pack = sphere_view_packs(DEFAULT_SPHERES[0], n_views=2, res=32)[1]
    obj_i = 1
    bg = jax.random.uniform(jax.random.PRNGKey(7), (3,))
    static = {**jr._static_host, **jr._static_arr}
    h = w = 32
    half = pack["half_extent"]
    jintr = jnp.array([[w / (2 * half), 0.0, w / 2.0],
                       [0.0, h / (2 * half), h / 2.0], [0.0, 0.0, 1.0]])
    jmask = jnp.asarray(pack["mask"])
    jvis = jr._visible_mask(obj_i)
    np.testing.assert_array_equal(tr._visible_mask(obj_i).numpy(),
                                  np.asarray(jvis))

    def loss_fn(p):      # stage4.invis_step_fn's loss, with bg passed in
        out = jgom.render_gom(p, static, jr.cfg, jnp.asarray(pack["pose"]),
                              jintr, w, h, bg, visible_mask=jvis, ortho=True)
        m = jmask[..., None]
        gt = jnp.asarray(pack["rgb"]) * m + (1 - m) * bg
        l1 = jnp.mean(jnp.abs(out["rgb"] - gt))
        acm = jnp.mean(jnp.abs(out["accumulation"] - jmask))
        return l1 + acm, (l1, acm, out["accumulation"])

    (_, (jl1, _jacm, jalpha)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jr.params)
    # the pack sees the object: the render (at the initial opacity 0.1)
    # lies on the mask's disc and not around it
    inside = float(jalpha[jmask > 0].mean())
    assert inside > 0.05 and float(jalpha[jmask == 0].mean()) < 0.2 * inside
    upd, _ = jr.optimizer.update(jgrads, jr.opt_state, jr.params)
    jnew = optax.apply_updates(jr.params, upd)

    l1 = tr._invis_step(
        torch.as_tensor(pack["pose"]), float(half),
        torch.as_tensor(pack["rgb"]), torch.as_tensor(pack["mask"]),
        tr._visible_mask(obj_i), torch.tensor(np.array(bg)))
    np.testing.assert_allclose(float(l1), float(jl1), rtol=LOSS_RTOL)
    assert tr.invis_steps == 1
    lo, hi = tr.instance_ranges[obj_i]
    other = np.ones(tr.static["num_gaussians"], bool)
    other[lo:hi] = False
    for k, p in tr.params.items():      # the other objects get no gradient
        assert not p.grad.numpy()[other].any(), k
    _check_grads_and_update(tr, before, jgrads, jnew)
