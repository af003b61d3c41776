"""The port's Stage-3 CLI (holoscene_tpu_torch/training/exp_runner_texture.py)
on a run dir holding Stage 2's meshes, then the export CLI
(export/cli.py glb / usd) on its output, read back with load_scene, on the
CPU (the kernels' plain versions) at the shipped colour-field width; and
the rule that --device defaults to cuda, which never falls back to the
CPU. Parity with JAX is in tests/test_torch_stage3.py."""

import os
import pickle

import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_threads import few_torch_threads  # noqa: F401

from holoscene_tpu_torch.datasets.synthetic import generate_scene, scene_meshes
from holoscene_tpu_torch.export import cli as export_cli
from holoscene_tpu_torch.export.load_scene import load_scene
from holoscene_tpu_torch.training import exp_runner_texture
from holoscene_tpu_torch.utils.mesh import read_obj, write_ply

EXP, STAMP = "s3_run", "2026_01_01_00_00_00"


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("s3run")
    generate_scene(str(root / "data" / "scene_0"), n_images=4,
                   img_res=(32, 32))
    plots = root / "exps" / EXP / STAMP / "plots"
    os.makedirs(plots)
    meshes = scene_meshes(res=16)
    for i, m in enumerate(meshes):
        write_ply(str(plots / f"coarse_recon_obj_{i}.ply"), m)
    with open(plots / "translation_dict.pkl", "wb") as f:
        pickle.dump({2: np.asarray([0.0, 0.02, 0.0], np.float32)}, f)
    conf = root / "tex.conf"
    conf.write_text(f"""train{{
 expname = {EXP}
 learning_rate = 5.0e-4
 lr_factor_for_grid = 20.0
}}
dataset{{
 data_root_dir = {root / 'data'}
 data_dir = scene_0
 img_res = [32, 32]
}}
""")
    return root, conf, plots, len(meshes)


def _argv(root, conf, *extra):
    return ["--conf", str(conf), "--exps_folder", str(root / "exps"),
            "--max_niters", "20", "--texture_res", "64", "--quiet", *extra]


def test_cli_writes_textures_and_the_export_reads_back(run):
    root, conf, plots, n = run
    runner = exp_runner_texture.main(_argv(root, conf, "--device", "cpu"))
    assert runner.device.type == "cpu"
    assert runner.paths == [str(plots / f"surface_{i}.obj") for i in range(n)]
    assert runner.steps == {0: {"image": 20, "invisible": 0},
                            **{i: {"image": 2, "invisible": 0}
                               for i in range(1, n)}}
    for i in range(n):
        mesh = read_obj(str(plots / f"surface_{i}.obj"))
        assert mesh.uvs is not None and len(mesh.uvs) == len(mesh.vertices)
        assert (plots / f"surface_{i}.mtl").exists()
        tex = np.asarray(Image.open(plots / f"surface_{i}.png"))
        assert tex.shape[2] == 3 and np.ptp(tex) > 0
    assert {k.split(" ", 2)[2] for k in runner.timer.seconds} == {
        "rasterization", "training", "atlas", "uv rasterization",
        "field query", "gutter fill", "writing"}

    argv = ["--conf", str(conf), "--exps_folder", str(root / "exps")]
    glb = export_cli.main(["glb", *argv])
    usd = export_cli.main(["usd", *argv])
    assert glb == str(plots / "scene.glb")
    assert usd == str(plots / "usd" / "scene.usda")
    scene = load_scene(str(plots))
    assert len(scene["glb"]["meshes"]) == n
    assert len(scene["glb"].get("images", [])) == n
    prims = scene["usd"]["prims"]
    assert sorted(prims) == [f"object_{i}" for i in range(n)]
    for i in range(n):
        p = prims[f"object_{i}"]
        want = [0.0, 0.02, 0.0] if i == 2 else [0.0, 0.0, 0.0]
        np.testing.assert_allclose(p["translate"], want, atol=1e-6)
        assert p["dynamic"] == (i != 0)
        assert len(p["points"]) == 3 * len(p["faces"])


def test_cli_device_defaults_to_cuda(run, monkeypatch):
    root, conf, _, _ = run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        exp_runner_texture.main(_argv(root, conf))
