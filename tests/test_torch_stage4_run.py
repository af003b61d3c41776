"""The port's Stage-4 trainer on its own (CPU, plain kernel versions): a
short run with eval and export, a run with invisible-view packs loaded, the
CLI, and the rule that device='cuda' never falls back to the CPU. Parity with the JAX trainer is in
test_torch_stage4.py."""

import os

import numpy as np
import pytest
import torch

from holoscene_tpu_torch.datasets.ns_dataset import NSDataset
from holoscene_tpu_torch.datasets.synthetic import (
    generate_scene,
    scene_meshes,
    write_stage3_meshes,
    write_vis_info,
)
from holoscene_tpu_torch.models.gom import GoMConfig
from holoscene_tpu_torch.ops import splat_flat, splat_topk
from holoscene_tpu_torch.training.stage4 import Stage4Runner
from test_torch_threads import few_torch_threads  # noqa: F401

AREA = 5e-3


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("ts4r")
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


def test_short_run_eval_export(scene, meshes, tmp_path):
    ds, _ = scene
    tr = _port_runner(meshes, ds, str(tmp_path / "out"), rebin_every=2)
    hist = tr.run(n_iters=8, log_every=4)
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert hist[-1]["l1"] < hist[0]["l1"] * 1.05  # optimizing, not diverging
    # cached used_chunks are real per-tile walk telemetry, not a default
    u = next(iter(tr._used_cache.values()))
    assert u.dim() == 1 and int(u.max()) >= 1
    assert max(tr._bins_age.values()) >= 1
    with pytest.warns(UserWarning, match="LPIPS"):
        ev = tr.eval_split("train", max_frames=1)
    assert np.isfinite(ev["psnr"]) and np.isnan(ev["lpips"])
    paths = tr.export()
    assert len(paths) == 5 and all(os.path.exists(p) for p in paths)
    # a directory without packs loads nothing, and no invisible-view step
    # was taken
    tr.load_vis_info(str(tmp_path))
    assert not any(tr.vis_info_list) and tr.invis_steps == 0
    # an eval render at another resolution goes through the top-K path
    pose, intr = tr._pose_intr(0)
    small = intr.clone()
    small[:2] *= 24 / 32
    out = tr.render_eval(pose, small, 24, 24)
    assert out["rgb"].shape == (24, 24, 3) and "stale" not in out
    assert "stale" in tr.render_eval(pose, intr, 32, 32)
    assert float(out["accumulation"].mean()) > 0.05


def _count_calls(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def counted(*args, **kw):
        calls.append(name)
        return real(*args, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


def test_run_with_packs_takes_an_invisible_view_step_per_iteration(
        scene, meshes, tmp_path, monkeypatch):
    """Packs loaded through load_vis_info: every iteration of run() takes
    one flat step (the K1/K2 wrappers) and one invisible-view step (the
    K3/K4 wrappers; on the CPU they run the plain versions and count no
    launch), drawing object and pack from the runner's rng."""
    ds, _ = scene
    tr = _port_runner(meshes, ds, str(tmp_path / "out"))
    paths = write_vis_info(str(tmp_path), n_views=2, res=32)
    assert [os.path.basename(p) for p in paths] == ["vis_info_1.pkl",
                                                    "vis_info_2.pkl"]
    tr.load_vis_info(str(tmp_path))
    assert [len(v) for v in tr.vis_info_list] == [0, 2, 2]
    real_fwd = splat_topk.composite_fwd
    launches = real_fwd.launches
    calls = {(m.__name__.rsplit(".", 1)[1], n): _count_calls(monkeypatch, m, n)
             for m, n in ((splat_flat, "flat_fwd"), (splat_flat, "flat_bwd"),
                          (splat_topk, "composite_fwd"),
                          (splat_topk, "composite_bwd"))}
    before = {k: v.detach().clone() for k, v in tr.params.items()}
    hist = tr.run(n_iters=4, log_every=1)
    assert tr.invis_steps == 4
    assert {k: len(v) for k, v in calls.items()} == {
        ("splat_flat", "flat_fwd"): 4, ("splat_flat", "flat_bwd"): 4,
        ("splat_topk", "composite_fwd"): 4, ("splat_topk", "composite_bwd"): 4}
    assert real_fwd.launches == launches   # CPU: no launch
    assert all(np.isfinite(h["invis_l1"]) and np.isfinite(h["loss"])
               for h in hist)
    # two optimizer updates per iteration
    assert tr.scheduler.last_epoch == 8
    assert any(float((tr.params[k] - before[k]).abs().max()) > 0
               for k in before)


def test_cli_runs_on_cpu(scene, meshes, tmp_path, monkeypatch):
    from holoscene_tpu_torch.training import exp_runner_gaussian

    _, root = scene
    monkeypatch.chdir(tmp_path)
    plots = tmp_path / "exps" / "torch_s4" / "2026_01_01_00_00_00" / "plots"
    plots.mkdir(parents=True)
    write_stage3_meshes(str(plots), meshes)
    # Stage-2 packs beside the meshes: the CLI never loads them (as the
    # JAX CLI; Stage4Runner.load_vis_info is their entry point)
    (plots / "bg_info.pkl").write_bytes(b"")
    (tmp_path / "s4.conf").write_text(
        "train{\n expname = torch_s4\n}\n"
        f"dataset{{\n data_root_dir = {root}\n data_dir = scene_0\n"
        " img_res = [32, 32]\n test_split = True\n}\n")
    r = exp_runner_gaussian.main(
        ["--conf", "s4.conf", "--max_niters", "2", "--area_to_subdivide",
         "0.01", "--device", "cpu", "--quiet"])
    assert np.isfinite(r.history[-1]["loss"])
    assert (plots / "gauss_scene.ply").exists()
    assert (plots / "gauss_scene.usdz").exists()


def test_cuda_device_never_falls_back(scene, meshes, tmp_path, monkeypatch):
    ds, _ = scene
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Stage4Runner(meshes, ds, cfg=GoMConfig(sh_degree=1),
                     area_to_subdivide=AREA, out_dir=str(tmp_path / "c"),
                     quiet=True, device="cuda")
