"""Stage 2's providers in the port (holoscene_tpu_torch/stage2/providers.py):
the contracts of tests/test_stage2_providers.py, with tiny TorchScript
modules scripted inside the tests (no file from outside the repo), and the
checkpoint-free providers against the JAX package's on the same numpy
inputs (host code: equal results)."""

import numpy as np
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401

import holoscene_tpu.stage2.providers as jp
import holoscene_tpu_torch.stage2.providers as tp


class FakeLama(torch.nn.Module):
    """The big-lama JIT contract (image [1,3,H,W], mask [1,1,H,W]) ->
    [1,3,H,W]: the masked region filled with the known region's mean."""

    def forward(self, image, mask):
        mean = (image * (1.0 - mask)).sum(dim=(2, 3), keepdim=True) \
            / torch.clamp((1.0 - mask).sum(), min=1.0)
        return image * (1.0 - mask) + mean * mask


class FakeSR(torch.nn.Module):
    """The Real-ESRGAN JIT contract: nearest x4 (exact, so a tiling seam
    shows as any deviation)."""

    def forward(self, image):
        return torch.nn.functional.interpolate(image, scale_factor=4.0,
                                               mode="nearest")


class FakeNormals(torch.nn.Module):
    """The Omnidata JIT contract: [1,3,H,W] in [0,1] -> [1,3,H,W]."""

    def forward(self, image):
        return image * 2.0 - 1.0


class BoxSegmenter(torch.nn.Module):
    """Mock SAM: logits positive exactly inside the box and dark."""

    def forward(self, image, box):
        h, w = image.shape[2], image.shape[3]
        yy = torch.arange(h).view(1, 1, h, 1).float()
        xx = torch.arange(w).view(1, 1, 1, w).float()
        inside = ((xx >= box[0, 0]) & (xx <= box[0, 2])
                  & (yy >= box[0, 1]) & (yy <= box[0, 3]))
        dark = image.mean(dim=1, keepdim=True) < 0.8
        return torch.where(inside & dark, torch.ones(1), -torch.ones(1))


class StandInW3D(torch.nn.Module):
    """The Wonder3D+ joint denoiser contract of
    tests/test_stage2_providers.py: model(imgs_in [2Nv,3,H,W], cam
    [2Nv,7], noise) -> [2Nv,3,H,W] in [0,1], the first Nv normal-domain
    (constant +z in the conditioning frame), the last Nv colours darkened
    by the azimuth, plus a little of the noise."""

    def forward(self, imgs, cam, noise):
        az = cam[:, 2].view(-1, 1, 1, 1)
        is_normal = cam[:, 5].view(-1, 1, 1, 1)
        colors = 1.0 - (1.0 - imgs) * (0.5 + 0.4 * torch.cos(az))
        colors = colors + 0.01 * noise
        normal01 = torch.zeros_like(imgs)
        normal01[:, 0] = 0.5
        normal01[:, 1] = 0.5
        normal01[:, 2] = 1.0
        return torch.clamp(is_normal * normal01 + (1.0 - is_normal) * colors,
                           0.0, 1.0)


ENV_VARS = ("HOLOSCENE_LAMA_CKPT", "HOLOSCENE_NORMAL_CKPT",
            "HOLOSCENE_SR_CKPT", "HOLOSCENE_VIEW_CACHE", "HOLOSCENE_W3D_CKPT",
            "HOLOSCENE_SAM_TS")


def _script(module, path):
    torch.jit.save(torch.jit.script(module), str(path))
    return str(path)


def _cluttered_scene():
    img = np.ones((64, 64, 3), np.float32)
    img[20:40, 24:34] = 0.2   # main body
    img[44:52, 26:32] = 0.3   # separated part
    img[4:60, 0:3] = 0.1      # off-prompt border clutter
    return img


def test_torch_lama_provider_matches_jax_and_keeps_the_known_region(tmp_path):
    ckpt = _script(FakeLama(), tmp_path / "big-lama.pt")
    provider = tp.TorchLamaProvider(ckpt, device="cpu")
    img = np.full((31, 33, 3), 0.25, np.float32)   # odd dims: padding
    img[5:10, 5:10] = 0.9
    mask = np.zeros((31, 33), bool)
    mask[5:10, 5:10] = True
    out = provider.inpaint(img, mask)
    np.testing.assert_array_equal(out, jp.TorchLamaProvider(ckpt).inpaint(
        img, mask))
    np.testing.assert_allclose(out[~mask], img[~mask])
    assert np.abs(out[mask] - 0.25).max() < 0.05
    d = np.linspace(0, 1, 31 * 33).reshape(31, 33, 1).astype(np.float32)
    out_d = provider.inpaint(d, mask)
    assert out_d.shape == d.shape
    np.testing.assert_allclose(out_d[~mask], d[~mask])
    with pytest.raises(FileNotFoundError):
        tp.TorchLamaProvider(str(tmp_path / "nope.pt"), device="cpu")


def test_torchscript_upsampler_matches_jax(tmp_path):
    ckpt = _script(FakeSR(), tmp_path / "sr.pt")
    up = tp.TorchScriptUpsampler(ckpt, device="cpu", tile=16, tile_pad=4)
    assert up._native_scale == 4
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (37, 29, 3)).astype(np.float32)
    out = up.upsample(img, scale=4)
    np.testing.assert_allclose(
        out, np.repeat(np.repeat(img, 4, axis=0), 4, axis=1), atol=1e-6)
    ref = jp.TorchScriptUpsampler(ckpt, tile=16, tile_pad=4)
    for im, s in ((img, 2), (rng.uniform(0, 1, (16, 16, 1))
                             .astype(np.float32), 4)):
        np.testing.assert_array_equal(up.upsample(im, scale=s),
                                      ref.upsample(im, scale=s))
    with pytest.raises(FileNotFoundError):
        tp.TorchScriptUpsampler(str(tmp_path / "nope.pt"), device="cpu")


def test_torchscript_normal_estimator_matches_jax(tmp_path):
    ckpt = _script(FakeNormals(), tmp_path / "omnidata.pt")
    img = np.random.default_rng(1).uniform(0, 1, (12, 10, 3)).astype(
        np.float32)
    got = tp.TorchScriptNormalEstimator(ckpt, device="cpu").infer_normal(img)
    np.testing.assert_allclose(
        got, jp.TorchScriptNormalEstimator(ckpt).infer_normal(img),
        rtol=0, atol=1e-7)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_checkpoint_free_providers_match_jax():
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 1, (20, 24, 3)).astype(np.float32)
    mask = np.zeros((20, 24), bool)
    mask[4:9, 6:15] = True
    np.testing.assert_array_equal(tp.NullInpaintProvider().inpaint(img, mask),
                                  jp.NullInpaintProvider().inpaint(img, mask))
    depth = rng.uniform(1, 2, (20, 24))
    np.testing.assert_array_equal(
        tp.DepthGradientNormalEstimator(2.0).infer_normal(img, depth),
        jp.DepthGradientNormalEstimator(2.0).infer_normal(img, depth))
    np.testing.assert_array_equal(tp.BicubicUpsampler().upsample(img, 2),
                                  jp.BicubicUpsampler().upsample(img, 2))
    scene = _cluttered_scene()
    for name in ("ThresholdForegroundExtractor",
                 "BoxGuidedThresholdExtractor"):
        np.testing.assert_array_equal(getattr(tp, name)().extract(scene),
                                      getattr(jp, name)().extract(scene))
    np.testing.assert_array_equal(
        tp.PromptableForegroundExtractor.central_box(100, 200),
        jp.PromptableForegroundExtractor.central_box(100, 200))
    boxed = tp.BoxGuidedThresholdExtractor().extract(scene)
    assert boxed[30, 29] and boxed[48, 29] and not boxed[30, 1]


def test_torchscript_promptable_extractor(tmp_path):
    ckpt = _script(BoxSegmenter(), tmp_path / "sam.pt")
    ext = tp.TorchScriptPromptableExtractor(ckpt, device="cpu")
    img = _cluttered_scene()
    mask = ext.extract_box(img, np.array([20.0, 16.0, 40.0, 56.0]))
    assert mask.shape == (64, 64) and mask.dtype == bool
    assert mask[30, 29] and mask[48, 29] and not mask[30, 1]
    mask2 = ext.extract(img)
    assert mask2[30, 29] and not mask2[30, 1]


def test_default_providers_env_attach_on_the_device(tmp_path, monkeypatch):
    for var in ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    p = tp.default_providers(device="cpu")
    assert isinstance(p["inpaint"], tp.NullInpaintProvider)
    assert p["novel_view"] is None
    cache = tmp_path / "views"
    cache.mkdir()
    monkeypatch.setenv("HOLOSCENE_LAMA_CKPT",
                       _script(FakeLama(), tmp_path / "lama.pt"))
    monkeypatch.setenv("HOLOSCENE_NORMAL_CKPT",
                       _script(FakeNormals(), tmp_path / "n.pt"))
    monkeypatch.setenv("HOLOSCENE_SR_CKPT",
                       _script(FakeSR(), tmp_path / "sr.pt"))
    monkeypatch.setenv("HOLOSCENE_VIEW_CACHE", str(cache))
    p = tp.default_providers(render_fn=lambda pose, seed: {}, device="cpu")
    assert isinstance(p["inpaint"], tp.TorchLamaProvider)
    assert isinstance(p["normal"], tp.TorchScriptNormalEstimator)
    assert isinstance(p["upsample"], tp.TorchScriptUpsampler)
    assert isinstance(p["novel_view"], tp.CachedArtifactNovelViewProvider)
    assert {p[k].device for k in ("inpaint", "normal", "upsample")} == {"cpu"}
    monkeypatch.setenv("HOLOSCENE_SR_CKPT", str(tmp_path / "missing.pt"))
    with pytest.raises(FileNotFoundError):     # set-but-broken fails loudly
        tp.default_providers(device="cpu")
    monkeypatch.setenv("HOLOSCENE_SR_CKPT", str(tmp_path / "sr.pt"))
    monkeypatch.setenv("HOLOSCENE_W3D_CKPT", str(tmp_path / "w3d"))
    with pytest.raises(FileNotFoundError):
        tp.default_providers(device="cpu")
    # the live Wonder3D+ provider wins over the cache, with the SR pass
    monkeypatch.setenv("HOLOSCENE_W3D_CKPT",
                       _script(StandInW3D(), tmp_path / "w3d.pt"))
    p = tp.default_providers(device="cpu")
    nv = p["novel_view"]
    assert isinstance(nv, tp.DiffusersNovelViewProvider)
    assert nv.device == torch.device("cpu") and nv.sr_scale == 4
    assert nv.upsampler is p["upsample"]


def test_cached_provider_replays_vis_info(tmp_path):
    rng = np.random.default_rng(0)
    views = [{"pose": np.eye(4, dtype=np.float32), "half_extent": 0.7,
              "rgb": rng.uniform(0, 1, (8, 8, 3)).astype(np.float32),
              "normal": np.tile(np.float32([0, 0, -1]), (8, 8, 1)),
              "mask": np.ones((8, 8), bool)} for _ in range(3)]
    tp.save_vis_info(str(tmp_path / "vis_info_2.pkl"), views)
    loaded = jp.load_vis_info(str(tmp_path / "vis_info_2.pkl"))
    np.testing.assert_array_equal(loaded[1]["rgb"], views[1]["rgb"])
    provider = tp.CachedArtifactNovelViewProvider(str(tmp_path))
    out = provider.generate_views(None, None, [np.eye(4)] * 2, obj_i=2)
    assert len(out) == 2
    np.testing.assert_allclose(out[0]["rgb"], views[0]["rgb"])
    with pytest.raises(FileNotFoundError):
        provider.generate_views(None, None, [np.eye(4)], obj_i=5)


# ---------------------------------------------------------------------------
# the live Wonder3D+ provider and the foreground extractors
# ---------------------------------------------------------------------------

W3D_ATOL = 1e-5


def _front_view(res=64, seed=0):
    rng = np.random.default_rng(seed)
    rgb = np.ones((res, res, 3), np.float32)
    mask = np.zeros((res, res), bool)
    mask[res // 4: 3 * res // 4, res // 3: 3 * res // 4] = True
    rgb[mask] = rng.uniform(0.0, 0.4, (mask.sum(), 3))
    return rgb, mask


def _check_views(got, ref):
    """Port views against JAX's: rgb and normals within W3D_ATOL, masks and
    front flags equal."""
    assert len(got) == len(ref) == 6
    for g, r in zip(got, ref):
        assert set(g) == set(r) == {"rgb", "normal", "mask", "front"}
        for k in ("rgb", "normal"):
            assert g[k].shape == r[k].shape and g[k].dtype == np.float32, k
            np.testing.assert_allclose(g[k], r[k], atol=W3D_ATOL, err_msg=k)
        np.testing.assert_array_equal(g["mask"], r["mask"])
        assert g["front"] == r["front"]


@pytest.mark.parametrize("front_res", [64, 48])
def test_diffusers_provider_matches_jax(tmp_path, front_res):
    """The TorchScript joint denoiser path against JAX's provider on the
    same stand-in and seed: the conditioning (the front view on white,
    resized bilinear to img_size when front_res differs), the camera and
    task embeddings, the noise from a CPU generator, the masks and the
    normals rotated into each view's frame; the contract of JAX's test
    (the back view's +z normal, the mask of the object region) and seed
    determinism."""
    from holoscene_tpu.stage2.views import wonder3d_camera_rig

    ckpt = _script(StandInW3D(), tmp_path / "w3d.pt")
    kw = dict(img_size=64)
    prov = tp.DiffusersNovelViewProvider(
        ckpt, "cpu", fg_extractor=tp.ThresholdForegroundExtractor(), **kw)
    ref = jp.DiffusersNovelViewProvider(
        ckpt, fg_extractor=jp.ThresholdForegroundExtractor(), **kw)
    rgb, mask = _front_view(front_res)
    rig = wonder3d_camera_rig(np.zeros(3), 1.0)
    views = prov.generate_views(rgb, mask, rig, seed=42)
    _check_views(views, ref.generate_views(rgb, mask, rig, seed=42))
    assert views[0]["mask"][32, 32] and not views[0]["mask"][2, 2]
    np.testing.assert_allclose(views[3]["normal"][32, 32], [0, 0, 1],
                               atol=1e-3)
    np.testing.assert_allclose(views[0]["normal"][32, 32], [0, 0, -1],
                               atol=1e-3)
    again = prov.generate_views(rgb, mask, rig, seed=42)
    np.testing.assert_array_equal(views[1]["rgb"], again[1]["rgb"])
    other = prov.generate_views(rgb, mask, rig, seed=7)
    assert np.abs(views[1]["rgb"] - other[1]["rgb"]).max() > 1e-5


def test_diffusers_provider_sr_pass_matches_jax(tmp_path):
    """The SR pass on the colours (x2 bicubic), the masks repeated and the
    normals resized bilinear to the upsampled size and renormalised."""
    ckpt = _script(StandInW3D(), tmp_path / "w3d.pt")
    kw = dict(img_size=32, sr_scale=2)
    prov = tp.DiffusersNovelViewProvider(
        ckpt, "cpu", fg_extractor=tp.ThresholdForegroundExtractor(),
        upsampler=tp.BicubicUpsampler(), **kw)
    ref = jp.DiffusersNovelViewProvider(
        ckpt, fg_extractor=jp.ThresholdForegroundExtractor(),
        upsampler=jp.BicubicUpsampler(), **kw)
    rgb, mask = _front_view(32, seed=1)
    views = prov.generate_views(rgb, mask, [np.eye(4)] * 6, seed=1)
    _check_views(views, ref.generate_views(rgb, mask, [np.eye(4)] * 6,
                                           seed=1))
    for v in views:
        assert v["rgb"].shape == v["normal"].shape == (64, 64, 3)
        assert v["mask"].shape == (64, 64)
        np.testing.assert_allclose(np.linalg.norm(v["normal"], axis=-1), 1.0,
                                   atol=1e-5)


def test_diffusers_provider_checkpoint_errors_match_jax(tmp_path):
    """A missing checkpoint raises FileNotFoundError and a directory (the
    diffusers layout) without the `diffusers` / `mv_diffusion_30`
    packages a RuntimeError naming them, in both packages."""
    missing = str(tmp_path / "nope.pt")
    with pytest.raises(FileNotFoundError):
        tp.DiffusersNovelViewProvider(missing, "cpu")
    with pytest.raises(FileNotFoundError):
        jp.DiffusersNovelViewProvider(missing)
    folder = tmp_path / "wonder3d-v1.0"
    (folder / "unet").mkdir(parents=True)
    for make in (lambda: tp.DiffusersNovelViewProvider(str(folder), "cpu"),
                 lambda: jp.DiffusersNovelViewProvider(str(folder))):
        with pytest.raises(RuntimeError, match="diffusers"):
            make()


def test_diffusers_provider_defaults_to_the_card(tmp_path, monkeypatch):
    """No CPU fallback: the default device is cuda, which raises without
    a card."""
    ckpt = _script(StandInW3D(), tmp_path / "w3d.pt")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tp.DiffusersNovelViewProvider(ckpt)


def test_w3d_env_attach_matches_jax(tmp_path, monkeypatch):
    """HOLOSCENE_W3D_CKPT attaches the live provider in both packages, over
    a recorded cache, with each package's default foreground extractor
    (the box-guided threshold without rembg); their views agree."""
    from holoscene_tpu.stage2.views import wonder3d_camera_rig

    for var in ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HOLOSCENE_VIEW_CACHE", str(tmp_path))
    monkeypatch.setenv("HOLOSCENE_W3D_CKPT",
                       _script(StandInW3D(), tmp_path / "w3d.pt"))
    got = tp.default_providers(device="cpu")["novel_view"]
    ref = jp.default_providers()["novel_view"]
    assert isinstance(got, tp.DiffusersNovelViewProvider)
    assert isinstance(ref, jp.DiffusersNovelViewProvider)
    assert type(got.fg_extractor).__name__ == type(ref.fg_extractor).__name__
    got.img_size = ref.img_size = 64
    rgb, mask = _front_view(64, seed=2)
    rig = wonder3d_camera_rig(np.array([0.1, 0.0, -0.2]), 0.8)
    _check_views(got.generate_views(rgb, mask, rig, seed=3),
                 ref.generate_views(rgb, mask, rig, seed=3))


def test_default_foreground_extractor(tmp_path, monkeypatch):
    """Without HOLOSCENE_SAM_TS: rembg where it is installed, else the
    box-guided threshold (JAX's choice too). With it: the TorchScript SAM
    on the device. A set-but-broken HOLOSCENE_SAM_TS raises in the port,
    where JAX's falls through (a deliberate difference, ROADMAP.md C)."""
    import importlib.util

    monkeypatch.delenv("HOLOSCENE_SAM_TS", raising=False)
    has_rembg = importlib.util.find_spec("rembg") is not None
    ext = tp.default_foreground_extractor("cpu")
    assert type(ext).__name__ == type(jp.default_foreground_extractor()
                                      ).__name__
    if has_rembg:
        assert isinstance(ext, tp.RembgForegroundExtractor)
    else:
        assert isinstance(ext, tp.BoxGuidedThresholdExtractor)
        with pytest.raises(ImportError, match="rembg"):
            tp.RembgForegroundExtractor()
    monkeypatch.setenv("HOLOSCENE_SAM_TS",
                       _script(BoxSegmenter(), tmp_path / "sam.pt"))
    sam = tp.default_foreground_extractor("cpu")
    assert isinstance(sam, tp.TorchScriptPromptableExtractor)
    img = _cluttered_scene()
    np.testing.assert_array_equal(
        sam.extract(img), jp.default_foreground_extractor().extract(img))
    monkeypatch.setenv("HOLOSCENE_SAM_TS", str(tmp_path / "missing.pt"))
    with pytest.raises(FileNotFoundError, match="HOLOSCENE_SAM_TS"):
        tp.default_foreground_extractor("cpu")
    broken = tmp_path / "broken.pt"
    broken.write_bytes(b"not a TorchScript archive")
    monkeypatch.setenv("HOLOSCENE_SAM_TS", str(broken))
    with pytest.raises(RuntimeError):
        tp.default_foreground_extractor("cpu")
    assert not isinstance(jp.default_foreground_extractor(),
                          jp.TorchScriptPromptableExtractor)
