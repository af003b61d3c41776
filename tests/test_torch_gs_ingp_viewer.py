"""The port's .ingp exporter and export_gaussian_artifact (the same bytes as
the JAX package's), the adaptive Gaussian-on-Mesh model (models/
gom_adaptive.py, against JAX with the same draws) and the viewer (its
orbit renderers against JAX's, artifact dispatch, one HTTP round trip).

Tolerances: the exporters write the same bytes (same file names in two
directories: gzip and the USDZ text carry the name; the gzip header's
mtime pinned for both writes); gom_adaptive's parameters 1e-6 (rtol 2e-6:
the log of the seed scales rounds differently in the two libraries) and its
renders 2e-4 (the compositor's); viewer frames 2e-4 (the top-K
compositor's) and the rasterized mesh frame exactly, apart from pixels
whose covering face differs between the two rasterizers (<= 0.5%)."""

import dataclasses
import gzip
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_gs_usdz import _fake_gaussians
from test_torch_threads import few_torch_threads  # noqa: F401

from holoscene_tpu import viewer as jviewer
from holoscene_tpu.export import export_gaussian_artifact as jexport
from holoscene_tpu.export import gs_ingp as jingp
from holoscene_tpu.models import gom_adaptive as jga
from holoscene_tpu.models.gom import GoMConfig as JGoMConfig
from holoscene_tpu.models.gom import seed_gaussians_from_meshes
from holoscene_tpu.utils.mc import marching_tetrahedra
from holoscene_tpu.utils.mesh import Mesh
from holoscene_tpu_torch import viewer as tviewer
from holoscene_tpu_torch.convert import (
    gom_params_from_jax,
    gom_static_from_jax,
    params_to_numpy,
)
from holoscene_tpu_torch.export import export_gaussian_artifact
from holoscene_tpu_torch.export import gs_ingp as tingp
from holoscene_tpu_torch.models import gom_adaptive as tga
from holoscene_tpu_torch.models.gom import GoMConfig, write_gaussian_ply
from holoscene_tpu_torch.utils.mesh import write_ply


@pytest.fixture
def fixed_gzip_mtime(monkeypatch):
    """gzip stamps the write time into its header: pin it, so two writes
    of the same payload are the same bytes."""
    monkeypatch.setattr(gzip.time, "time", lambda: 1.7e9)


def _gauss(n=60, shift=0.0):
    g = _fake_gaussians(n=n)
    g["means"] = g["means"] + np.float32(shift)
    g["means"] = (g["means"] * 0.3).astype(np.float32)
    g["log_scales"] = np.full((n, 3), -2.5, np.float32)
    g["opacity_logits"] = np.full((n,), 2.0, np.float32)
    return g


@pytest.mark.parametrize("half", [False, True])
def test_ingp_bytes_equal_jax(tmp_path, fixed_gzip_mtime, half):
    g = _gauss()
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    a, b = tmp_path / "jax" / "g.ingp", tmp_path / "port" / "g.ingp"
    jingp.export_gaussians_ingp(str(a), g, force_half=half)
    tingp.export_gaussians_ingp(str(b), g, force_half=half)
    assert a.read_bytes() == b.read_bytes()
    back = tingp.read_gaussians_ingp(str(b))
    ref = jingp.read_gaussians_ingp(str(a))
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k])
    if not half:
        for k in g:
            np.testing.assert_array_equal(back[k], g[k].reshape(back[k]
                                                                .shape))
    # the CLI: a PLY in, the same .ingp out
    ply = tmp_path / "g.ply"
    write_gaussian_ply(str(ply), g)
    (tmp_path / "cli").mkdir()
    tingp.main([str(ply), "--output_file", str(tmp_path / "cli" / "g.ingp")]
               + (["--half"] if half else []))
    assert (tmp_path / "cli" / "g.ingp").read_bytes() == a.read_bytes()


def test_export_gaussian_artifact_bytes_equal_jax(tmp_path,
                                                  fixed_gzip_mtime):
    g = _gauss(40, shift=0.1)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    for ext in (".ply", ".usdz", ".ingp"):
        a, b = tmp_path / "jax" / f"g{ext}", tmp_path / "port" / f"g{ext}"
        assert jexport(str(a), g) == str(a)
        assert export_gaussian_artifact(str(b), g) == str(b)
        assert a.read_bytes() == b.read_bytes(), ext
    with pytest.raises(ValueError, match="expected .ply, .usdz or .ingp"):
        export_gaussian_artifact(str(tmp_path / "x.obj"), g)


# ---------------------------------------------------------------------------
# adaptive Gaussian-on-Mesh
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def adaptive():
    axis = np.linspace(-1, 1, 16)
    x, y, z = np.meshgrid(axis, axis, axis, indexing="ij")
    sdf = np.sqrt(x * x + y * y + z * z) - 0.4
    v, f = marching_tetrahedra(sdf, origin=(-1,) * 3, spacing=(2.0 / 15,) * 3,
                               use_native=False)
    jcfg = JGoMConfig(sh_degree=1, max_per_tile=64)
    static = seed_gaussians_from_meshes([Mesh(v, f)], area_to_subdivide=1e-1,
                                        cfg=jcfg)
    cap = static["num_gaussians"] + 64
    jp, js = jga.init_adaptive_gom(static, jcfg, cap)
    tstatic = gom_static_from_jax(
        {k: (np.asarray(val) if k not in ("instance_ranges", "num_gaussians")
             else val) for k, val in static.items()})
    return static, jcfg, jp, js, tstatic, GoMConfig(sh_degree=1,
                                                    max_per_tile=64), cap


def test_gom_adaptive_init_render_and_accumulate(adaptive):
    static, jcfg, jp, js, tstatic, cfg, cap = adaptive
    tp, ts = tga.init_adaptive_gom(tstatic, cfg, cap)
    for k, val in jp.items():
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(val),
                                   rtol=2e-6, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(ts["face_idx"].numpy(),
                                  np.asarray(js["face_idx"]))
    np.testing.assert_array_equal(ts["alive"].numpy(),
                                  np.asarray(js["alive"]))
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = -2.0
    intr = np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1.0]], np.float32)
    # K covers every slot: the dead slots are clones of face 0 at its
    # depth, a tie that ops/splat.py::select_topk breaks to the lower
    # index, as JAX does; K stays whole so the check does not rest on it
    ref = jga.render_adaptive_gom(
        jp, js, static, dataclasses.replace(jcfg, max_per_tile=1024),
        jnp.asarray(pose), jnp.asarray(intr), 32, 32, jnp.zeros(3))
    # from JAX's parameters: a last-bit scale difference can move a 3-sigma
    # radius across its ceil
    tp = gom_params_from_jax({k: np.asarray(v) for k, v in jp.items()})
    got = tga.render_adaptive_gom(
        tp, ts, tstatic, dataclasses.replace(cfg, max_per_tile=1024), pose,
        intr, 32, 32, torch.zeros(3))
    for k in ("rgb", "accumulation", "depth"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(ref[k]), atol=2e-4, err_msg=k)
    assert float(got["accumulation"].max()) > 0.1
    g = np.zeros((cap, 2), np.float32)
    g[0] = [3.0, 4.0]
    s2 = tga.accumulate_grads(ts, torch.tensor(g))
    assert float(s2["grad_accum"][0]) == 5.0
    assert float(s2["grad_count"][0]) == 1.0


@pytest.mark.parametrize("mode", ["split", "cull_dup"])
def test_refine_adaptive_matches_jax_with_the_same_draws(adaptive, mode):
    static, jcfg, jp, js, tstatic, cfg, cap = adaptive
    jp = dict(jp)
    js = dict(js)
    kw = {}
    if mode == "split":
        js["grad_accum"] = js["alive"].astype(jnp.float32)
        js["grad_count"] = js["alive"].astype(jnp.float32)
        kw = dict(densify_grad_thresh=0.5, densify_size_ratio=0.0)
    else:
        rng = np.random.default_rng(2)
        jp["opacities"] = jp["opacities"].at[:10].set(-10.0)
        js["grad_accum"] = jnp.asarray(rng.uniform(0, 1e-3, cap)
                                       .astype(np.float32))
        js["grad_count"] = jnp.ones(cap)
    key = jax.random.PRNGKey(4)
    rp, rs, rst = jga.refine_adaptive(key, jp, js, static, jcfg, **kw)
    k1, k2 = jax.random.split(key)
    uv = (np.asarray(jax.random.uniform(k1, (cap, 1))),
          np.asarray(jax.random.uniform(k2, (cap, 1))))
    tp = gom_params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                             requires_grad=False)
    ts = {"face_idx": torch.tensor(np.asarray(js["face_idx"])).long(),
          "alive": torch.tensor(np.asarray(js["alive"])),
          "grad_accum": torch.tensor(np.asarray(js["grad_accum"])),
          "grad_count": torch.tensor(np.asarray(js["grad_count"]))}
    gp, gs, gst = tga.refine_adaptive(tp, ts, tstatic, cfg, uv=uv, **kw)
    assert int(gst["n_spawned"]) > 0
    for k in ("n_culled", "n_spawned", "n_alive", "reset_mask"):
        np.testing.assert_array_equal(gst[k].numpy(), np.asarray(rst[k]))
    np.testing.assert_array_equal(gs["face_idx"].numpy(),
                                  np.asarray(rs["face_idx"]))
    np.testing.assert_array_equal(gs["alive"].numpy(), np.asarray(rs["alive"]))
    for k, val in params_to_numpy(gp).items():
        np.testing.assert_allclose(val, np.asarray(rp[k]), atol=1e-6,
                                   err_msg=k)
    means = tga.adaptive_activations(gp, gs, tstatic, cfg)[0]
    r = np.linalg.norm(means.detach().numpy()[gs["alive"].numpy()], axis=1)
    assert abs(np.median(r) - 0.4) < 0.1


# ---------------------------------------------------------------------------
# viewer
# ---------------------------------------------------------------------------


def _cube_ply(tmp_path):
    v = np.array([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)],
                 np.float32)
    f = np.array(
        [[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
         [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]],
        np.int32)
    p = str(tmp_path / "cube.ply")
    from holoscene_tpu_torch.utils.mesh import Mesh as TMesh

    write_ply(p, TMesh(v, f))
    return p


@pytest.mark.parametrize("ext", [".ply", ".usdz", ".ingp"])
def test_gaussian_orbit_renderer_matches_jax(tmp_path, ext):
    path = str(tmp_path / f"g{ext}")
    export_gaussian_artifact(path, _gauss(200))
    ref = jviewer.GaussianOrbitRenderer(path)
    got = tviewer.GaussianOrbitRenderer(path, device="cpu")
    assert got.sh_degree == ref.sh_degree and got.radius0 == ref.radius0
    for az, el, zoom in ((30, 15, 1.0), (120, -10, 1.4)):
        a = got.render(az, el, zoom, 48)
        b = ref.render(az, el, zoom, 48)
        assert a.shape == (48, 48, 3)
        np.testing.assert_allclose(a, b, atol=2e-4)
    assert float(np.abs(a - 0.12).max()) > 0.05


def test_mesh_orbit_renderer_matches_jax_and_dispatch(tmp_path):
    p = _cube_ply(tmp_path)
    got = tviewer.make_renderer(p, device="cpu")
    assert isinstance(got, tviewer.MeshOrbitRenderer)
    ref = jviewer.MeshOrbitRenderer(p)
    a = got.render(40, 25, 1.0, 64)
    b = ref.render(40, 25, 1.0, 64)
    differ = np.abs(a - b).max(axis=-1) > 1e-5
    assert differ.mean() <= 0.005
    assert float(np.abs(a[24:40, 24:40] - 0.12).max()) > 0.05
    g = str(tmp_path / "g.ply")
    write_gaussian_ply(g, _gauss())
    assert isinstance(tviewer.make_renderer(g, device="cpu"),
                      tviewer.GaussianOrbitRenderer)


def test_http_round_trip(tmp_path):
    g = str(tmp_path / "g.ply")
    write_gaussian_ply(g, _gauss())
    srv = tviewer.serve(tviewer.GaussianOrbitRenderer(g, device="cpu"),
                        port=0, res=32)
    port = srv.server_address[1]
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        page = urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                      timeout=30).read()
        assert b"viewer" in page and b"width=32" in page
        png = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/render?az=10&el=5&zoom=1.2&res=32",
            timeout=120).read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
    finally:
        srv.shutdown()
        t.join(timeout=10)
