"""Stage 0 of the port (holoscene_tpu_torch/stage0/priors.py) against the
JAX package's (holoscene_tpu/stage0/priors.py, torch already) on the CPU:
the same scripted TorchScript depth and normal models through both
generate_priors write the same files (depth .npy within 1e-6, normal PNGs
equal), the CLI and the cached replay, and the default device (cuda, which
raises without a card: no CPU fallback)."""

import os

import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_threads import few_torch_threads  # noqa: F401

from holoscene_tpu.stage0 import priors as jp
from holoscene_tpu_torch.stage0 import priors as tp


class ToyDepth(torch.nn.Module):
    """Depth from brightness and position (non-constant, positive)."""

    def forward(self, image):
        h = image.shape[2]
        ramp = torch.arange(h, dtype=image.dtype).view(1, 1, h, 1) / h
        return image.mean(dim=1, keepdim=True) * 2.0 + 0.5 + ramp


class ToyNormal(torch.nn.Module):
    """Unnormalised normals from the colour channels, facing the camera."""

    def forward(self, image):
        n = image * 2.0 - 1.0
        return torch.cat([n[:, :2], -(1.0 + image[:, 2:3])], dim=1)


def scripted_prior_models(tmp_path):
    """The two scripted models saved as TorchScript files: (depth, normal)
    paths."""
    dp, npth = str(tmp_path / "depth.pt"), str(tmp_path / "normal.pt")
    torch.jit.save(torch.jit.script(ToyDepth()), dp)
    torch.jit.save(torch.jit.script(ToyNormal()), npth)
    return dp, npth


def scene_with_images(root, n=3, res=(20, 24)):
    img_dir = root / "scene_0" / "images"
    img_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, res + (3,), dtype=np.uint8),
                        "RGB").save(img_dir / f"{i:04d}.png")
    return root / "scene_0"


def test_generate_priors_matches_jax(tmp_path):
    dp, npth = scripted_prior_models(tmp_path)
    ours = scene_with_images(tmp_path / "port")
    theirs = scene_with_images(tmp_path / "jax")
    td, tn = tp.generate_priors(
        str(ours), provider=tp.TorchScriptPriorProvider(dp, npth, "cpu"))
    jd, jn = jp.generate_priors(
        str(theirs), provider=jp.TorchScriptPriorProvider(dp, npth, "cpu"))
    assert [os.path.basename(p) for p in td] == \
        [os.path.basename(p) for p in jd] == ["0000.npy", "0001.npy",
                                              "0002.npy"]
    assert [os.path.basename(p) for p in tn] == \
        [os.path.basename(p) for p in jn]
    for a, b in zip(td, jd):
        d = np.load(a)
        assert d.dtype == np.float32 and d.shape == (20, 24)
        np.testing.assert_allclose(d, np.load(b), atol=1e-6)
        assert np.ptp(d) > 0.1
    for a, b in zip(tn, jn):
        na, nb = np.asarray(Image.open(a)), np.asarray(Image.open(b))
        np.testing.assert_array_equal(na, nb)
        n = na.astype(np.float32) / 255 * 2 - 1
        np.testing.assert_allclose(np.linalg.norm(n, axis=-1), 1.0,
                                   atol=0.03)


def test_cli_and_cached_replay(tmp_path):
    """The CLI on --device cpu writes a prior per image; a second scene
    replays them from the first as a cache; existing files are kept unless
    --overwrite."""
    dp, npth = scripted_prior_models(tmp_path)
    scene = scene_with_images(tmp_path / "a")
    d, n = tp.main(["--scene_dir", str(scene), "--depth_checkpoint", dp,
                    "--normal_checkpoint", npth, "--device", "cpu"])
    assert len(d) == len(n) == 3 and all(map(os.path.exists, d + n))
    second = scene_with_images(tmp_path / "b")
    d2, n2 = tp.main(["--scene_dir", str(second), "--cache_dir", str(scene)])
    for a, b in zip(d + n, d2 + n2):
        assert open(a, "rb").read() == open(b, "rb").read()
    np.save(d2[0], np.zeros((2, 2), np.float32))
    tp.generate_priors(str(second), cache_dir=str(scene))
    assert np.load(d2[0]).shape == (2, 2)            # kept
    tp.generate_priors(str(second), cache_dir=str(scene), overwrite=True)
    np.testing.assert_array_equal(np.load(d2[0]), np.load(d[0]))
    cached = tp.CachedPriorProvider(str(scene))
    np.save(d2[0], np.zeros((2, 2), np.float32))
    tp.generate_priors(str(second), provider=cached, overwrite=True)
    np.testing.assert_array_equal(np.load(d2[0]), np.load(d[0]))
    with pytest.raises(NotImplementedError, match="by name"):
        cached.infer_depth(np.zeros((2, 2, 3), np.float32))
    with pytest.raises(SystemExit):
        tp.main(["--scene_dir", str(second)])
    with pytest.raises(ValueError, match="cache_dir"):
        tp.generate_priors(str(second), overwrite=True)
    only_depth = tp.TorchScriptPriorProvider(dp, device="cpu")
    with pytest.raises(RuntimeError, match="normal checkpoint"):
        tp.generate_priors(str(second), provider=only_depth, overwrite=True)


def test_default_device_is_cuda_and_raises_without_a_card(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dp, npth = scripted_prior_models(tmp_path)
    scene = scene_with_images(tmp_path / "c")
    with pytest.raises(RuntimeError, match="cuda"):
        tp.TorchScriptPriorProvider(dp, npth)
    with pytest.raises(RuntimeError, match="cuda"):
        tp.main(["--scene_dir", str(scene), "--depth_checkpoint", dp])
    assert not os.path.exists(scene / "depth" / "0000.npy")
