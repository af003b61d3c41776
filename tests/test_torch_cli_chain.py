"""The port's stage CLIs chained at micro scale on the CPU (the plain
versions of the kernels), the chain of tests/test_cli_chain.py with the
same micro conf and assertions: exp_runner -> mv_predict ->
exp_runner_post -> exp_runner_texture -> exp_runner_gaussian, then the
export CLI (glb). One step more than JAX's: Stage 0's priors, written by
the port's stage0.priors CLI with scripted toy models on a copy of the
scene, which NSDataset then reads."""

import os
import shutil

import numpy as np
import torch
from PIL import Image
from test_cli_chain import workdir  # noqa: F401  (the micro conf + scene)
from test_torch_stage0_priors import ToyDepth, scripted_prior_models
from test_torch_threads import few_torch_threads  # noqa: F401

CPU = ["--device", "cpu"]


def test_stage0_priors_on_a_copy_of_the_scene(workdir, tmp_path):  # noqa: F811
    from holoscene_tpu_torch.datasets.ns_dataset import NSDataset
    from holoscene_tpu_torch.stage0 import priors

    src = workdir / "data" / "scene_0"
    root = tmp_path / "data_s0"
    shutil.copytree(src, root / "scene_0")
    dp, npth = scripted_prior_models(tmp_path)
    depth, normal = priors.main([
        "--scene_dir", str(root / "scene_0"), "--depth_checkpoint", dp,
        "--normal_checkpoint", npth, "--overwrite", *CPU])
    assert len(depth) == len(normal) == len(os.listdir(src / "images")) == 5
    ds = NSDataset(str(root), "scene_0", img_res=(24, 24))
    img = np.asarray(Image.open(sorted((src / "images").iterdir())[0])
                     .convert("RGB"), np.float32) / 255.0
    with torch.no_grad():
        want = ToyDepth()(torch.from_numpy(img).permute(2, 0, 1)[None])
    np.testing.assert_allclose(ds.depth_images[0].reshape(24, 24),
                               want[0, 0].numpy(), atol=1e-6)
    # the original scene keeps its own priors
    assert not np.allclose(np.load(src / "depth" / os.path.basename(
        depth[0])), np.load(depth[0]))


def test_cli_chain(workdir, monkeypatch):  # noqa: F811
    monkeypatch.chdir(workdir)
    for var in ("HOLOSCENE_VIEW_CACHE", "HOLOSCENE_W3D_CKPT"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HOLOSCENE_PHYSICS", "quasistatic")
    from holoscene_tpu_torch.physics import sim

    monkeypatch.setattr(sim, "_PROVIDER", None)
    from holoscene_tpu_torch.training import exp_runner

    r1 = exp_runner.main(["--conf", "micro.conf", "--quiet", *CPU])
    assert os.path.exists(os.path.join(r1.checkpoints_path,
                                       "ModelParameters", "latest.pth"))

    # mv_predict (the reference's run_mv_prediction.py analog): each
    # object's novel-view cache, which the post stage can replay
    from holoscene_tpu_torch.stage2 import mv_predict
    from holoscene_tpu_torch.stage2.providers import load_vis_info

    caches = mv_predict.main(["--conf", "micro.conf", "--mesh_resolution",
                              "24", "--seeds", "42", "--quiet", *CPU])
    assert caches and all(os.path.exists(p) for p in caches)
    views = load_vis_info(caches[0])
    assert views and {"pose", "rgb", "normal", "mask"} <= set(views[0])

    from holoscene_tpu_torch.training import exp_runner_post

    r2 = exp_runner_post.main(["--conf", "micro.conf", "--finetune_iters",
                               "1", "--mesh_resolution", "32", "--quiet",
                               *CPU])
    assert any(m is not None for m in r2.result["meshes"])
    plots = os.path.join("exps", "cli_micro", r1.timestamp, "plots")
    assert os.path.exists(os.path.join(plots, "coarse_recon_obj_0.ply"))

    from holoscene_tpu_torch.training import exp_runner_texture

    r3 = exp_runner_texture.main(["--conf", "micro.conf", "--max_niters",
                                  "10", "--texture_res", "64", "--quiet",
                                  *CPU])
    assert r3.paths and all(os.path.exists(p) for p in r3.paths)

    from holoscene_tpu_torch.training import exp_runner_gaussian

    # --use_pallas: JAX's flag, accepted as a no-op
    r4 = exp_runner_gaussian.main(["--conf", "micro.conf", "--max_niters",
                                   "8", "--area_to_subdivide", "0.01",
                                   "--quiet", "--use_pallas", *CPU])
    assert r4.cfg.use_pallas is True
    assert os.path.exists(os.path.join(plots, "gauss_scene.ply"))
    assert np.isfinite(r4.history[-1]["loss"])
    assert len(r4.meshes) == len(r3.meshes)     # Stage 3's surfaces

    from holoscene_tpu_torch.export import cli as export_cli

    export_cli.main(["glb", "--conf", "micro.conf"])
    assert os.path.exists(os.path.join(plots, "scene.glb"))
