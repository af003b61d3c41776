"""The whole Stage-4 slice of the port against the JAX Stage4Runner: one
training step from identical state (losses, gradients, Adam update).
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
from holoscene_tpu_torch.datasets.synthetic import scene_meshes
from holoscene_tpu_torch.models.gom import GoMConfig
from holoscene_tpu_torch.training.stage4 import Stage4Runner

AREA = 5e-3
LOSS_RTOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 5e-4, 5e-3   # as the JAX flat backward's own test


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("ts4")
    generate_scene(str(root / "scene_0"), n_images=6, img_res=(32, 32))
    return NSDataset(str(root), "scene_0", img_res=(32, 32)), str(root)


@pytest.fixture(scope="module")
def meshes():
    return scene_meshes(12)


def _port_runner(meshes, ds, out_dir, **kw):
    cfg = GoMConfig(sh_degree=1, tile_size=16, use_flat=True, **kw)
    return Stage4Runner(meshes, ds, cfg=cfg, area_to_subdivide=AREA,
                        max_total_iters=40, out_dir=out_dir, quiet=True,
                        device="cpu")


def test_one_step_matches_jax(scene, meshes, tmp_path):
    ds, _ = scene
    jcfg = jgom.GoMConfig(sh_degree=1, tile_size=16, use_flat=True)
    jr = JaxStage4Runner(meshes, ds, cfg=jcfg, area_to_subdivide=AREA,
                         max_total_iters=40, out_dir=str(tmp_path / "j"),
                         quiet=True)
    tr = _port_runner(meshes, ds, str(tmp_path / "t"))
    assert tr.static["num_gaussians"] == jr.static["num_gaussians"]
    assert tr.instance_ranges == jr.instance_ranges
    assert tr.flat_plan == type(tr.flat_plan)(**vars(jr.flat_plan))
    # identical starting state (the port seeds the same numbers; copy to be
    # exact to the last bit)
    jp = {k: np.asarray(v) for k, v in jr.params.items()}
    for k, v in gom_params_from_jax(jp).items():
        np.testing.assert_allclose(tr.params[k].detach().numpy(),
                                   v.detach().numpy(), atol=1e-6, rtol=1e-5,
                                   err_msg=k)
        with torch.no_grad():
            tr.params[k].copy_(v)

    h, w = ds.img_res
    acm, mesh_depth = jr._frame_mesh_raster(0)
    image = ds.rgb_images[0].reshape(h, w, 3).transpose(2, 0, 1)
    pose = jnp.asarray(ds.pose_all[0])
    intr = jnp.asarray(ds.intrinsics[:3, :3])
    bg = jax.random.uniform(jax.random.PRNGKey(3), (3,))
    jbins = jr._get_bins(0, pose, intr)
    static = {**jr._static_host, **jr._static_arr}

    def loss_fn(p):      # stage4.step_fn's loss, with bg passed in
        out = jgom.render_gom(p, static, jr.cfg, pose, intr, w, h, bg,
                              flat_plan=jr.flat_plan, flat_bins=jbins,
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

    tbins = tr._get_bins(0, *tr._pose_intr(0))
    for k in ("tile_chunk_start", "tile_chunk_cnt"):
        np.testing.assert_array_equal(tbins[k].numpy(), np.asarray(jbins[k]))
    before = {k: v.detach().clone() for k, v in tr.params.items()}
    metrics, used, _stale, _drift = tr._step(
        *tr._pose_intr(0), *(torch.tensor(np.array(x)) for x in (
            image, acm, mesh_depth)), tbins, torch.tensor(np.array(bg)))

    np.testing.assert_allclose(float(metrics["loss"]), float(jtotal),
                               rtol=LOSS_RTOL)
    for k in ("l1", "ssim_loss", "acm_loss", "depth_loss"):
        np.testing.assert_allclose(float(metrics[k]), float(jlosses[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    assert int(used.max()) >= 1
    moved = 0.0
    for k, p in tr.params.items():
        g = np.asarray(jgrads[k])
        np.testing.assert_allclose(p.grad.numpy(), g, atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=f"grad {k}")
        # Adam's first step is lr * sign(g): compare where the sign is sure
        sure = np.abs(g) > 1e-6
        np.testing.assert_allclose(p.detach().numpy()[sure],
                                   np.asarray(jnew[k])[sure], atol=1e-6,
                                   rtol=1e-5, err_msg=f"update {k}")
        moved = max(moved, float((p.detach() - before[k]).abs().max()))
    # regression guard: a step must change the params
    assert moved > 0.0

