"""The port's standalone renderer (training/gs_render.py) against the JAX
package's on the same checkpoint and dataset: the float renders of
`render_views` (atol 2e-4, the top-K compositor's tolerance; the PNGs are
uint8 and the metrics follow from the renders), and the CLI's outputs,
including the ray tracer and a UT-projected distorted camera against
JAX's CLI."""

import json

import numpy as np
import pytest
from PIL import Image

from holoscene_tpu.training import gs_render as jrender
from holoscene_tpu_torch.datasets.ns_dataset import NSDataset
from holoscene_tpu_torch.datasets.synthetic import generate_scene, scene_meshes
from holoscene_tpu_torch.models.gom import GoMConfig, read_gaussian_ply
from holoscene_tpu_torch.training import gs_render as trender
from holoscene_tpu_torch.training.stage4 import Stage4Runner
from test_torch_threads import few_torch_threads  # noqa: F401

FWD_ATOL = 2e-4


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """A generated scene and the gauss_scene.ply of a tiny trained runner."""
    root = tmp_path_factory.mktemp("tgsr")
    generate_scene(str(root / "scene_0"), n_images=8, img_res=(32, 32))
    ds = NSDataset(str(root), "scene_0", img_res=(32, 32), test_split=True)
    tr = Stage4Runner(scene_meshes(10), ds, cfg=GoMConfig(sh_degree=3),
                      area_to_subdivide=0.01, max_total_iters=20,
                      out_dir=str(root / "out"), quiet=True, device="cpu")
    tr.run(n_iters=3)
    tr.export()
    return root, ds, str(root / "out" / "gauss_scene.ply")


def test_render_views_match_jax(exported):
    _root, ds, ply = exported
    g = read_gaussian_ply(ply)
    poses = ds.pose_all[:2]
    intr = ds.intrinsics[:3, :3]
    ref = list(jrender.render_views(g, poses, intr, ds.img_res, sh_degree=3))
    got = list(trender.render_views(g, poses, intr, ds.img_res, sh_degree=3,
                                    device="cpu"))
    assert len(got) == 2
    for a, b in zip(got, ref):
        assert a.shape == (32, 32, 3) and a.dtype == np.float32
        np.testing.assert_allclose(a, np.asarray(b), atol=FWD_ATOL)
        assert 0.05 < a.std()             # a picture, not a flat colour
    # a fixed depth and per-view intrinsics take the same path
    fixed = list(trender.render_views(
        g, poses[:1], intr, ds.img_res, sh_degree=3, max_per_tile=64,
        intrinsics_all=np.stack([intr]), device="cpu"))
    ref64 = list(jrender.render_views(g, poses[:1], intr, ds.img_res,
                                      sh_degree=3, max_per_tile=64))
    np.testing.assert_allclose(fixed[0], np.asarray(ref64[0]), atol=FWD_ATOL)


def test_cli_writes_pngs_and_metrics(exported, tmp_path):
    root, _ds, ply = exported
    out = tmp_path / "renders"
    with pytest.warns(UserWarning, match="LPIPS"):
        summary = trender.main(
            ["--ply", ply, "--dataset", "ns", "--data_root",
             str(root / "scene_0"), "--split", "train", "--out", str(out),
             "--device", "cpu"])
    pngs = sorted(p.name for p in out.glob("render_*.png"))
    assert pngs == [f"render_{i:04d}.png" for i in range(len(pngs))]
    assert len(pngs) >= 6
    with open(out / "metrics.json") as f:
        metrics = json.load(f)
    assert len(metrics["per_view"]) == len(pngs)
    assert metrics["mean"]["psnr"] == summary["psnr"]
    assert np.isfinite(summary["psnr"]) and 0 < summary["ssim"] <= 1
    assert np.isnan(summary["lpips"])


@pytest.mark.parametrize("extra", [
    ["--renderer", "trace"],
    ["--camera", "opencv", "--dist", "0.05", "0.01", "0.002", "0"],
], ids=["ray tracer", "unscented"])
def test_cli_trace_and_ut_camera_match_jax(tmp_path, extra):
    """The ray tracer and the UT-projected opencv camera through both CLIs
    on one nerf-synthetic scene (JAX's CLI cannot load an ns scene without
    its resolution) and a cloud of round particles (scale >= 0.1: JAX's
    tracer cancels catastrophically on flat ones, see ops/gs_trace.py):
    the same PNGs within one uint8 level and the same per-view PSNR
    within 0.05 dB."""
    from test_gs_datasets import _write_nerf_scene

    from holoscene_tpu_torch.models.gom import write_gaussian_ply

    rng = np.random.default_rng(5)
    n = 400
    ply = str(tmp_path / "cloud.ply")
    # in front of every camera (they look down -z from z in [-2, 2]), at
    # least 3 units away. A particle beside a camera projects at |x/z| ~
    # 100, where the opencv polynomial's r^6 term turns a last-bit
    # difference between the libraries into ~1e-2 of colour (both packages
    # compute the same, ill-conditioned, value there)
    means = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    means[:, 2] = rng.uniform(-8, -5, n)
    write_gaussian_ply(ply, {
        "means": means,
        "quats": rng.normal(size=(n, 4)).astype(np.float32),
        "log_scales": np.log(rng.uniform(0.1, 0.3, (n, 3))).astype(
            np.float32),
        "opacity_logits": rng.normal(0, 1, n).astype(np.float32),
        "features_dc": rng.normal(0, 1, (n, 3)).astype(np.float32),
        "features_rest": rng.normal(0, 0.2, (n, 15, 3)).astype(np.float32)})
    scene = tmp_path / "lego"
    scene.mkdir()
    _write_nerf_scene(scene, n=3, res=16)
    outs = {}
    for name, main in (("jax", jrender.main), ("port", trender.main)):
        out = tmp_path / name
        main(["--ply", ply, "--dataset", "nerf", "--data_root", str(scene),
              "--split", "train", "--out", str(out), *extra]
             + (["--device", "cpu"] if name == "port" else []))
        outs[name] = out
    pngs = sorted(p.name for p in outs["port"].glob("render_*.png"))
    assert pngs == sorted(p.name for p in outs["jax"].glob("render_*.png"))
    assert len(pngs) == 3
    for name in pngs:
        a = np.asarray(Image.open(outs["port"] / name), np.int16)
        b = np.asarray(Image.open(outs["jax"] / name), np.int16)
        assert np.abs(a - b).max() <= 1, name
    with open(outs["port"] / "metrics.json") as f:
        got = json.load(f)["per_view"]
    with open(outs["jax"] / "metrics.json") as f:
        ref = json.load(f)["per_view"]
    np.testing.assert_allclose([m["psnr"] for m in got],
                               [m["psnr"] for m in ref], atol=0.05)
