"""Stage 2 as a whole in the port: Stage2Runner on the fixture of
tests/test_stage2_runner.py (6 images at 32^2, mesh resolution 32, 2
finetune iterations, the same JAX-initialised parameters), and the CLI
(training/exp_runner_post.py) on a checkpoint of the port's own Stage-1
CLI, on the CPU.

The JAX runner takes minutes here, so it is not run again: the meshes
extract_meshes() gives are held against JAX's own extraction functions
(vertices within 1e-5, the same faces), the chosen views (poses equal,
weights within WEIGHT_ATOL) and the view coverage (within 1e-6) against
JAX's view functions on the same meshes, and the graph, the object order
and the artifact files with their keys against what the JAX runner
recorded in tests/fixtures/stage2_runner_tiny.json
(tests/fixtures/make_stage2_runner_fixture.py writes it)."""

import copy
import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch
from test_stage2_runner import tiny_cfg
from test_torch_threads import few_torch_threads  # noqa: F401

import holoscene_tpu.stage2.views as jviews
import holoscene_tpu_torch.physics.sim as tsim
import holoscene_tpu_torch.stage2.runner as trunner
from holoscene_tpu.models import fields as jf
from holoscene_tpu.models.holoscene import init_holoscene as jinit
from holoscene_tpu.utils.mesh import Mesh as JMesh
from holoscene_tpu.utils.plots import extract_object_meshes as jextract
from holoscene_tpu_torch.convert import stage1_params_from_jax
from holoscene_tpu_torch.datasets.ns_dataset import NSDataset
from holoscene_tpu_torch.datasets.synthetic import (
    DEFAULT_SPHERES,
    generate_scene,
)
from holoscene_tpu_torch.losses.holoscene_loss import LossConfig
from holoscene_tpu_torch.models.fields import (
    ImplicitNetworkConfig,
    RenderingNetworkConfig,
    implicit_sdf_raw_grid,
)
from holoscene_tpu_torch.models.holoscene import HoloSceneConfig, init_holoscene
from holoscene_tpu_torch.ops.sampler import SamplerConfig
from holoscene_tpu_torch.stage2.providers import save_vis_info
from holoscene_tpu_torch.stage2.refine import FinetuneConfig
from holoscene_tpu_torch.training import exp_runner, exp_runner_post
from holoscene_tpu_torch.utils.mesh import Mesh

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "fixtures", "stage2_runner_tiny.json")
# written only on some physics outcomes (a clamped settle translation, a
# scene of fewer than two meshes); "physics" is the port's addition
CONDITIONAL_KEYS = {"clamped", "note"}
# a view weight is (object pixels in the joint render) / (alone): the two
# rasterizers disagree on a few boundary pixels of a large mesh
# (tests/test_torch_rasterizer.py), here one pixel of ~240 on one view of
# the four (0.0042); the poses chosen are the same
WEIGHT_ATOL = 1e-2
_AX = np.linspace(-1.0, 1.0, 64, dtype=np.float32)
COARSE = np.stack(np.meshgrid(_AX, _AX, _AX, indexing="ij"), -1).reshape(-1, 3)


def port_tiny_cfg(d_out: int) -> HoloSceneConfig:
    """tests/test_stage2_runner.py::tiny_cfg in the port's classes."""
    return HoloSceneConfig(
        implicit=ImplicitNetworkConfig(
            feature_vector_size=16, d_out=d_out, dims=(16, 16), multires=2,
            num_levels=3, level_dim=2, base_size=4, end_size=16, logmap=8),
        rendering=RenderingNetworkConfig(
            feature_vector_size=16, dims=(16, 16), multires_view=2,
            multires_point=2, multires_normal=2),
        sampler=SamplerConfig(N_samples=6, N_samples_eval=8,
                              N_samples_extra=2, beta_iters=3,
                              max_total_iters=2),
        use_bg_reg=False)


def _keys(obj):
    if isinstance(obj, dict):
        return {str(k): _keys(v) for k, v in obj.items()}
    if isinstance(obj, list) and obj and isinstance(obj[0], dict):
        return [sorted(map(str, o)) for o in obj]
    return None


def _artifact_keys(out_dir):
    got = {}
    for name in sorted(os.listdir(out_dir)):
        path = os.path.join(out_dir, name)
        if name.endswith(".pkl"):
            with open(path, "rb") as f:
                got[name] = _keys(pickle.load(f))
        elif name.endswith(".json"):
            with open(path) as f:
                got[name] = sorted(json.load(f))
    return got


def test_stage2_runner_matches_jax_on_the_tiny_fixture(tmp_path, monkeypatch):
    with open(FIXTURE) as f:
        want = json.load(f)
    generate_scene(str(tmp_path / "scene_0"), n_images=6, img_res=(32, 32))
    ds = NSDataset(str(tmp_path), "scene_0", img_res=(32, 32))
    k = len(ds.label_mapping)
    jc = tiny_cfg(k)
    params = jinit(jax.random.PRNGKey(0), jc)
    cfg = port_tiny_cfg(k)
    model = init_holoscene(cfg)
    model.load_state_dict(stage1_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    monkeypatch.setattr(tsim, "_PROVIDER", None)
    before = copy.deepcopy(model)     # the runner finetunes model in place

    views, coverage, extracted = [], [], []  # the runner's own
    select, integrate = trunner.select_best_views, \
        trunner.integrated_view_coverage
    extract = trunner.Stage2Runner.extract_meshes

    def record_views(*a, **kw):
        views.append(select(*a, **kw))
        return views[-1]

    def record_coverage(*a, **kw):
        coverage.append(integrate(*a, **kw)[0])
        return coverage[-1], None

    def record_meshes(self):
        extracted.append(extract(self))
        return extracted[-1]

    monkeypatch.setattr(trunner, "select_best_views", record_views)
    monkeypatch.setattr(trunner, "integrated_view_coverage", record_coverage)
    monkeypatch.setattr(trunner.Stage2Runner, "extract_meshes", record_meshes)
    out = tmp_path / "s2"
    runner = trunner.Stage2Runner(
        model, cfg, ds, out_dir=str(out),
        loss_cfg=LossConfig(depth_weight=0.1, semantic_weight=0.5),
        finetune_cfg=FinetuneConfig(iters=2, rays_per_step=64,
                                    invis_pixels=64, collision_pts=128),
        mesh_resolution=32, view_render_res=24, candidate_levels=(0.0,),
        quiet=True, device="cpu")
    result = runner.run(finetune_iters=2)

    # the pre-finetune meshes against JAX's extraction (coarse sweep,
    # bboxes, the disentangling shift, marching tetrahedra) of the port's
    # own object SDFs: the shift is discontinuous where two objects' SDFs
    # tie inside the scene, and there the last bit of the SDF (float32
    # sums in another order) decides the winner, so JAX's grid evaluator
    # is held to the port's separately, within 1e-5 of the largest |SDF|
    def port_raw(p, c, x, packed=True):
        return jax.numpy.asarray(implicit_sdf_raw_grid(
            before.implicit, torch.tensor(np.asarray(x))).numpy())

    jraw = np.asarray(jf.implicit_sdf_raw(params["implicit"], jc.implicit,
                                          COARSE))
    np.testing.assert_allclose(port_raw(None, None, COARSE), jraw, rtol=0,
                               atol=1e-5 * np.abs(jraw).max())
    monkeypatch.setattr(jf, "implicit_sdf_raw", port_raw)
    jmeshes = jextract(lambda pts: jf.implicit_shift_sdf_raw(
        params["implicit"], jc.implicit, pts), k, resolution=32)
    assert [m is not None for m in jmeshes] == want["meshes"]
    for tm, jm in zip(extracted[0], jmeshes):
        np.testing.assert_array_equal(tm.faces, jm.faces)
        np.testing.assert_allclose(tm.vertices, jm.vertices, rtol=0,
                                   atol=1e-5)

    assert {str(i): v for i, v in result["graph"].items()} == want["graph"]
    assert runner.object_order == want["object_order"]
    # object 1's chosen views and coverage against JAX's view functions on
    # the same meshes (object 2 runs the same functions; each costs JAX
    # ~15 s here)
    assert len(views) == len(coverage) == len(runner.object_order)
    jm = [JMesh(m.vertices, m.faces) for m in extracted[0]]
    others = jm[:1] + jm[2:]
    ref = jviews.select_best_views(jm[1], others, n_views=4, img_res=24)
    assert len(views[0]) == len(ref) == 4
    for (pose, w), (rpose, rw) in zip(views[0], ref):
        np.testing.assert_array_equal(pose, rpose)
        assert abs(w - rw) <= WEIGHT_ATOL
    frames = np.linspace(0, ds.n_images - 1, min(8, ds.n_images)).astype(int)
    vis = jviews.training_view_vertex_visibility(
        jm[1], others, [ds.pose_all[f] for f in frames],
        ds.intrinsics[:3, :3], tuple(ds.img_res))
    assert abs(coverage[0]
               - jviews.integrated_view_coverage(jm[1], vis)[0]) <= 1e-6

    assert sorted(os.listdir(out)) == want["files"]
    got = _artifact_keys(out)
    settle = set(got.pop("scene_settle.json"))
    want_settle = set(want["artifact_keys"].pop("scene_settle.json"))
    assert settle - CONDITIONAL_KEYS - {"physics"} \
        == want_settle - CONDITIONAL_KEYS
    assert got == want["artifact_keys"]
    assert set(result) == set(want["result_keys"]) | {"physics"}
    with open(out / "scene_settle.json") as f:
        assert json.load(f)["physics"] == result["physics"] \
            == tsim.provider_report()
    for t in result["translations"].values():
        assert np.all(np.isfinite(t))
    for r in runner.object_report.values():
        assert r["errors"] == []
        assert (r["novel_views"] is None) == (r["coarse_recon"] is None)
        assert r["novel_views"] != 0 and r["coarse_recon"] != 0
    steps = runner.finetune_history
    assert [s["obj"] for s in steps] == [0, 0, 1, 1, 2, 2]
    assert all("invis_loss" in s and "collision_loss" in s
               for s in steps if s["obj"])
    assert all(np.isfinite(float(v)) for s in steps for v in s.values())
    assert set(runner.timer.seconds) >= {
        "extraction", "background finetune", "obj 1 view selection",
        "obj 1 visibility", "obj 1 packs", "obj 1 finetune", "obj 1 ladder",
        "intersection", "settle"}


def _tiny_conf(tmp_path) -> str:
    """The Stage-1 conf of a one-sphere 32^2 scene at the tiny widths of
    port_tiny_cfg, with the post confs' invis_loss section (64 rays)."""
    generate_scene(str(tmp_path / "data" / "scene_0"), n_images=4,
                   img_res=(32, 32), spheres=DEFAULT_SPHERES[:1])
    conf = tmp_path / "tiny_post.conf"
    conf.write_text(f"""
train{{
 expname = tiny_s2
 num_pixels = 64
 checkpoint_freq = 1000
 max_total_iters = 2
}}
loss{{
 rgb_loss = l1
 depth_weight = 0.1
 semantic_weight = 0.5
}}
invis_loss{{
 lambda_nm_l1 = 25.0
 lambda_nm_cos = 25.0
 lambda_rgb = 2.0
 lambda_mask = 5.0
 lambda_depth = 20.0
 lambda_smooth = 0.5
 lambda_lama_rgb = 2.0
 lambda_lama_nm_l1 = 20.0
 lambda_lama_nm_cos = 20.0
 num_rays = 64
 bg_nm_l1 = 25.0
 bg_nm_cos = 25.0
}}
dataset{{
 data_root_dir = {tmp_path / 'data'}
 data_dir = scene_0
 img_res = [32, 32]
}}
model{{
 feature_vector_size = 16
 use_bg_reg = False
 implicit_network{{
  dims = [16, 16]
  multires = 2
  num_levels = 3
  base_size = 4
  end_size = 16
  logmap = 8
 }}
 rendering_network{{
  dims = [16, 16]
  multires_view = 2
  multires_point = 2
  multires_normal = 2
 }}
 ray_sampler{{
  N_samples = 6
  N_samples_eval = 8
  N_samples_extra = 2
  max_total_iters = 2
  beta_iters = 3
 }}
}}
""")
    return str(conf)


def test_cli_runs_stage2_on_a_port_stage1_checkpoint(tmp_path, monkeypatch):
    """exp_runner_post on the checkpoint of two steps of the port's Stage-1
    CLI, with recorded novel views replayed (HOLOSCENE_VIEW_CACHE) and the
    quasi-static oracle: every artifact written, the cached views emitted
    as the object's vis_info, the conf's invis_loss weights in effect, the
    provider named; --device cuda without a card raises."""
    conf = _tiny_conf(tmp_path)
    exps = str(tmp_path / "exps")
    exp_runner.main(["--conf", conf, "--exps_folder", exps, "--quiet",
                     "--device", "cpu"])
    cache = tmp_path / "cache"
    cache.mkdir()
    rng = np.random.default_rng(0)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.35, -0.45, -1.0]
    save_vis_info(str(cache / "vis_info_1.pkl"), [
        {"pose": pose, "half_extent": 0.5,
         "rgb": rng.uniform(0, 1, (16, 16, 3)).astype(np.float32),
         "normal": np.tile(np.float32([0, 0, -1]), (16, 16, 1)),
         "mask": np.ones((16, 16), bool)} for _ in range(6)])
    monkeypatch.setenv("HOLOSCENE_VIEW_CACHE", str(cache))
    monkeypatch.setenv("HOLOSCENE_PHYSICS", "quasistatic")
    monkeypatch.setattr(tsim, "_PROVIDER", None)
    args = ["--conf", conf, "--exps_folder", exps, "--mesh_resolution", "32",
            "--finetune_iters", "1", "--quiet"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            exp_runner_post.main(args)
    runner = exp_runner_post.main(args + ["--device", "cpu"])
    plots = runner.out_dir
    assert sorted(os.listdir(plots)) >= [
        "bg_info.pkl", "coarse_recon_obj_0.ply", "coarse_recon_obj_1.ply",
        "graph_node_dict.pkl", "scene_settle.json", "translation_dict.pkl",
        "vis_info_1.pkl"]
    assert runner.fcfg.invis_pixels == 64 and runner.fcfg.smooth_weight == 0.5
    with open(os.path.join(plots, "vis_info_1.pkl"), "rb") as f:
        packs = pickle.load(f)
    assert sum(p.get("front") is not None for p in packs) == 6
    with open(os.path.join(plots, "scene_settle.json")) as f:
        assert json.load(f)["physics"] == {"provider": "quasistatic"}
    assert runner.result["physics"] == {"provider": "quasistatic"}
    report = runner.object_report[1]
    assert report["novel_views"] == 6 and report["coarse_recon"] > 0 \
        and report["errors"] == []
    steps = runner.finetune_history
    assert [s["obj"] for s in steps] == [0, 1]
    assert "invis_loss" in steps[1] and "collision_loss" in steps[1]


def test_novel_view_failures_are_recorded():
    """The novel-view seed ladder catches a provider's errors, as JAX's
    does; each caught error and the count of views it ended with land in
    the runner's object_report, where a caller can hold them."""
    class Failing:
        def generate_views(self, rgb, mask, rig, seed, obj_i):
            raise ValueError(f"no views for seed {seed}")

    runner = object.__new__(trunner.Stage2Runner)
    runner.providers = {"novel_view": Failing()}
    runner.seeds = (3, 7)
    runner.quiet = True
    runner.object_report = {}
    runner.render_object_view = lambda obj_i, pose, half_extent: {
        "rgb": np.zeros((4, 4, 3), np.float32), "mask": np.ones((4, 4), bool)}
    mesh = Mesh(np.eye(3), np.array([[0, 1, 2]]))
    assert runner.generate_novel_views(2, mesh, 0.5) == []
    assert runner.object_report == {2: {
        "novel_views": None, "coarse_recon": None,
        "errors": ["novel-view seed 3: ValueError('no views for seed 3')",
                   "novel-view seed 7: ValueError('no views for seed 7')"]}}


def _analytic_sdf(pts: np.ndarray) -> np.ndarray:
    """Two objects' SDFs [N, 2] (float32): object 0 a sphere with a small
    separate sphere beside it (a second component), object 1 a sphere."""
    def sphere(c, r):
        return np.linalg.norm(pts - np.asarray(c, np.float32), axis=-1) - r

    return np.stack([np.minimum(sphere((0.3, 0.0, 0.0), 0.35),
                                sphere((-0.55, 0.5, 0.0), 0.12)),
                     sphere((-0.4, -0.4, 0.2), 0.25)], -1).astype(np.float32)


@pytest.mark.parametrize("only", [None, {0}])
def test_extract_object_meshes_only_matches_jax(only):
    """utils/plots.py::extract_object_meshes with `only` (Stage 2's
    re-extraction of the emptied objects) against JAX's on the same
    analytic field: the same faces, vertices within 1e-6 (one
    interpolation along a grid edge in float32 in both)."""
    from holoscene_tpu_torch.utils.plots import extract_object_meshes

    got = extract_object_meshes(
        lambda p: torch.from_numpy(_analytic_sdf(p.numpy())), 2,
        resolution=32, device="cpu", only=only)
    want = jextract(lambda p: jax.numpy.asarray(_analytic_sdf(np.asarray(p))),
                    2, resolution=32, only=only)
    assert [m is None for m in got] == [m is None for m in want] \
        == [False, only is not None]
    for g, w in zip(got, want):
        if g is not None:
            np.testing.assert_array_equal(g.faces, w.faces)
            np.testing.assert_allclose(g.vertices, w.vertices, rtol=0,
                                       atol=1e-6)
    assert len(np.unique(got[0].connected_components())) == 2
