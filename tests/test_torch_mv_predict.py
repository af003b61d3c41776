"""The port's multiview-prediction CLI (holoscene_tpu_torch/stage2/
mv_predict.py) against JAX's (holoscene_tpu/stage2/mv_predict.py) on the
CPU: the micro conf of tests/test_cli_chain.py, one Stage-1 model
initialised by the JAX package and saved as a checkpoint of each package
(the port's converted by convert.py::stage1_params_from_jax), each CLI run
with the model-render fallback as the novel-view provider.

The extraction is held to JAX's in tests/test_torch_stage2_runner.py; on
an untrained field the disentangled SDF ties between objects, and two
extractions can differ there (that file says why), so JAX's CLI extracts
the port's meshes here. From the same meshes the caches must hold the same
objects, poses and half extents (equal), and views that match: colours
within 1e-5 absolute + 1e-4 relative and normals within NORMAL_ATOL where
both masks hold (the Stage-2 render tests' tolerances,
tests/test_torch_stage2_refine.py and tests/test_torch_render_multi_obj.py),
and masks (acc > 0.5) equal on all but MASK_SHARE of the pixels. The masks
differ on rays that miss the object: the volume renderer gives the last
sample a 1e10 distance, and the Laplace density there (0.5 + 0.5 expm1(
-sdf / beta), ~2e-8) is a cancellation quantised to float32 steps of 3e-8
near 0.5, so a last-bit difference of expm1 between the frameworks makes
such a ray's acc 0 or 1 (up to 1.03% of a 64^2 view here, along the
object's silhouette)."""

import os

import jax
import numpy as np
import pytest
from test_cli_chain import workdir  # noqa: F401  (the micro conf + scene)
from test_torch_threads import few_torch_threads  # noqa: F401

import holoscene_tpu.stage2.runner as jrunner
import holoscene_tpu_torch.stage2.runner as trunner
from holoscene_tpu.config import ConfigFactory as JConfigFactory
from holoscene_tpu.models.holoscene import HoloSceneConfig as JHoloSceneConfig
from holoscene_tpu.models.holoscene import init_holoscene as jinit
from holoscene_tpu.stage2 import mv_predict as jmv
from holoscene_tpu.training import checkpoints as jckpt
from holoscene_tpu.utils.mesh import Mesh as JMesh
from holoscene_tpu_torch.config import ConfigFactory
from holoscene_tpu_torch.convert import stage1_params_from_jax
from holoscene_tpu_torch.datasets.ns_dataset import NSDataset
from holoscene_tpu_torch.models.holoscene import HoloSceneConfig, init_holoscene
from holoscene_tpu_torch.stage2 import mv_predict as tmv
from holoscene_tpu_torch.stage2.providers import load_vis_info
from holoscene_tpu_torch.training import checkpoints as tckpt

STAMP = "2026_01_01_00_00_00"
MASK_SHARE = 0.02
OUT_ATOL, OUT_RTOL, NORMAL_ATOL = 1e-5, 1e-4, 1e-4


def _checkpoints(workdir):  # noqa: F811
    """The JAX-initialised model saved under exps_jax/ (msgpack) and
    exps_torch/ (the port's format), with d_out from the scene as the
    CLIs set it."""
    d_out = len(NSDataset(str(workdir / "data"), "scene_0",
                          img_res=(24, 24)).label_mapping)
    jconf = JConfigFactory.parse_file(str(workdir / "micro.conf"))
    jconf.put("model.implicit_network.d_out", d_out)
    jcfg = JHoloSceneConfig.from_conf(jconf.get_config("model"))
    params = jinit(jax.random.PRNGKey(0), jcfg)
    jckpt.save_checkpoint(str(workdir / "exps_jax" / "cli_micro" / STAMP
                              / "checkpoints"), 0, params)
    conf = ConfigFactory.parse_file(str(workdir / "micro.conf"))
    conf.put("model.implicit_network.d_out", d_out)
    model = init_holoscene(HoloSceneConfig.from_conf(conf.get_config("model")))
    model.load_state_dict(stage1_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    tckpt.save_checkpoint(str(workdir / "exps_torch" / "cli_micro" / STAMP
                              / "checkpoints"), 0, model)


def test_mv_predict_matches_jax(workdir, monkeypatch):  # noqa: F811
    monkeypatch.chdir(workdir)
    for var in ("HOLOSCENE_VIEW_CACHE", "HOLOSCENE_W3D_CKPT"):
        monkeypatch.delenv(var, raising=False)
    _checkpoints(workdir)
    meshes = []
    extract = trunner.Stage2Runner.extract_meshes

    def record(self):
        meshes.extend(extract(self))
        return meshes

    monkeypatch.setattr(trunner.Stage2Runner, "extract_meshes", record)
    argv = ["--conf", "micro.conf", "--mesh_resolution", "24", "--seeds",
            "42", "--quiet"]
    got = tmv.main(argv + ["--exps_folder", "exps_torch", "--out", "mv_torch",
                           "--device", "cpu"])
    monkeypatch.setattr(
        jrunner.Stage2Runner, "extract_meshes",
        lambda self: [None if m is None else JMesh(m.vertices, m.faces)
                      for m in meshes])
    ref = jmv.main(argv + ["--exps_folder", "exps_jax", "--out", "mv_jax"])
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in ref]
    assert got and len(got) == sum(m is not None for m in meshes[1:])
    for g_path, r_path in zip(got, ref):
        gv, rv = load_vis_info(g_path), load_vis_info(r_path)
        assert len(gv) == len(rv) == 6
        for g, r in zip(gv, rv):
            assert set(g) == set(r)
            np.testing.assert_array_equal(g["pose"], r["pose"])
            assert g["half_extent"] == r["half_extent"]
            assert g["front"] == r["front"]
            assert (g["mask"] != r["mask"]).mean() <= MASK_SHARE
            both = g["mask"] & r["mask"]
            assert both.sum() > 0.05 * both.size
            np.testing.assert_allclose(g["rgb"][both], r["rgb"][both],
                                       atol=OUT_ATOL, rtol=OUT_RTOL)
            np.testing.assert_allclose(g["normal"][both], r["normal"][both],
                                       atol=NORMAL_ATOL)


def test_mv_predict_defaults_to_the_card(workdir, monkeypatch):  # noqa: F811
    """No CPU fallback: the default device is cuda, which raises without a
    card before anything is written."""
    import torch

    monkeypatch.chdir(workdir)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tmv.main(["--conf", "micro.conf", "--exps_folder", "exps_torch",
                  "--out", "mv_default"])
    assert not os.path.exists("mv_default")
