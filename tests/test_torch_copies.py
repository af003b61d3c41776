"""The host-side modules the port keeps its own copy of (numpy / PIL only),
each against its source in the JAX package on the same inputs: identical
results, since the code is the same."""

import filecmp
import os
import zipfile

import numpy as np
import pytest
from test_gs_datasets import _write_colmap_scene, _write_nerf_scene

import holoscene_tpu.config as jconfig
import holoscene_tpu.datasets.gs_datasets as jgs
import holoscene_tpu.datasets.ns_dataset as jns
import holoscene_tpu.datasets.synthetic as jsyn
import holoscene_tpu.export.gs_usdz as jusdz
import holoscene_tpu.utils.eval_rgb as jeval
import holoscene_tpu.utils.mc as jmc
import holoscene_tpu.utils.mesh as jmesh
import holoscene_tpu_torch.config as tconfig
import holoscene_tpu_torch.datasets.gs_datasets as tgs
import holoscene_tpu_torch.datasets.ns_dataset as tns
import holoscene_tpu_torch.datasets.synthetic as tsyn
import holoscene_tpu_torch.export.gs_usdz as tusdz
import holoscene_tpu_torch.utils.eval_rgb as teval
import holoscene_tpu_torch.utils.mc as tmc
import holoscene_tpu_torch.utils.mesh as tmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _equal_attrs(a, b, min_arrays):
    """Every numpy attribute of two loader objects is equal."""
    n = 0
    for k, v in vars(a).items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(v, getattr(b, k), err_msg=k)
            n += 1
    assert n >= min_arrays, n


@pytest.mark.parametrize("conf", ["replica_room0.conf",
                                  "replica_room0_tex.conf"])
def test_config_parses_to_the_same_dict(conf):
    path = os.path.join(REPO, "confs", conf)
    ref = jconfig.ConfigFactory.parse_file(path)
    got = tconfig.ConfigFactory.parse_file(path)
    assert got.as_plain_dict() == ref.as_plain_dict() and len(got) >= 3
    assert got.get_config("dataset").as_plain_dict() \
        == ref.get_config("dataset").as_plain_dict()
    text = "a{\n b = [1, 2.5, x]\n c = true\n}\nd = 3\n"
    assert tconfig.ConfigFactory.parse_string(text).as_plain_dict() \
        == jconfig.ConfigFactory.parse_string(text).as_plain_dict()
    assert got.get_string("train.expname") == ref.get_string("train.expname")


def test_generate_scene_writes_the_same_files_and_nsdataset_loads_them_alike(
        tmp_path):
    jsyn.generate_scene(str(tmp_path / "j" / "scene_0"), n_images=4,
                        img_res=(24, 24))
    tsyn.generate_scene(str(tmp_path / "t" / "scene_0"), n_images=4,
                        img_res=(24, 24))
    cmp = filecmp.dircmp(tmp_path / "j" / "scene_0", tmp_path / "t" / "scene_0")
    assert not cmp.left_only and not cmp.right_only and not cmp.diff_files
    for sub in ("images", "depth", "normal", "instance_mask"):
        names = sorted(os.listdir(tmp_path / "j" / "scene_0" / sub))
        assert len(names) == 4
        _, mismatch, errors = filecmp.cmpfiles(
            tmp_path / "j" / "scene_0" / sub, tmp_path / "t" / "scene_0" / sub,
            names, shallow=False)
        assert not mismatch and not errors, sub
    assert tsyn.DEFAULT_SPHERES == jsyn.DEFAULT_SPHERES
    assert tsyn.ROOM_HALF == jsyn.ROOM_HALF

    kw = dict(img_res=(24, 24), test_split=True)
    ref = jns.NSDataset(str(tmp_path / "j"), "scene_0", **kw)
    got = tns.NSDataset(str(tmp_path / "t"), "scene_0", **kw)
    assert got.n_images == ref.n_images and got.img_res == ref.img_res
    _equal_attrs(ref, got, 4)
    for k, v in ref.test.items():
        np.testing.assert_array_equal(np.asarray(got.test[k]), np.asarray(v),
                                      err_msg=k)
    # the scene's normalization is what the analytic meshes assume
    np.testing.assert_allclose(got.scene_center, tsyn.NORMALIZE_CENTER,
                               atol=1e-6)
    np.testing.assert_allclose(got.scene_scale, tsyn.NORMALIZE_SCALE,
                               atol=1e-6)


def test_gs_datasets_load_alike(tmp_path):
    _write_nerf_scene(tmp_path / "nerf")
    ref = jgs.NerfSyntheticDataset(str(tmp_path / "nerf"))
    got = tgs.NerfSyntheticDataset(str(tmp_path / "nerf"))
    assert got.img_res == ref.img_res == (20, 20)
    _equal_attrs(ref, got, 3)
    np.testing.assert_array_equal(got.test["pose_all"], ref.test["pose_all"])
    _write_colmap_scene(tmp_path / "colmap")
    ref = jgs.ColmapDataset(str(tmp_path / "colmap"), test_every=4)
    got = tgs.ColmapDataset(str(tmp_path / "colmap"), test_every=4)
    assert got.n_images == ref.n_images == 3
    _equal_attrs(ref, got, 3)
    for a, b in zip(got.seed_points(), ref.seed_points()):
        np.testing.assert_array_equal(a, b)


def test_marching_tetrahedra_and_mesh_io_match(tmp_path):
    axis = np.linspace(-1.0, 1.0, 14)
    x, y, z = np.meshgrid(axis, axis, axis, indexing="ij")
    sdf = np.sqrt(x ** 2 + (y - 0.1) ** 2 + z ** 2) - 0.6
    kw = dict(origin=(-1,) * 3, spacing=(2 / 13,) * 3)
    rv, rf = jmc.marching_tetrahedra(sdf, use_native=False, **kw)
    gv, gf = tmc.marching_tetrahedra(sdf, **kw)
    assert len(gf) > 200
    np.testing.assert_array_equal(gv, rv)
    np.testing.assert_array_equal(gf, rf)

    colors = (np.random.default_rng(0).uniform(0, 255, (len(gv), 3))
              .astype(np.uint8))
    ref, got = jmesh.Mesh(rv, rf, colors), tmesh.Mesh(gv, gf, colors)
    np.testing.assert_array_equal(got.face_normals, ref.face_normals)
    np.testing.assert_array_equal(got.face_areas, ref.face_areas)
    rd, gd = ref.decimate(150), got.decimate(150)
    assert len(gd.faces) <= 150
    np.testing.assert_array_equal(gd.vertices, rd.vertices)
    np.testing.assert_array_equal(gd.faces, rd.faces)

    jmesh.write_obj(str(tmp_path / "j.obj"), ref)
    tmesh.write_obj(str(tmp_path / "t.obj"), got)
    assert filecmp.cmp(tmp_path / "j.obj", tmp_path / "t.obj", shallow=False)
    back, jback = tmesh.read_obj(str(tmp_path / "t.obj")), \
        jmesh.read_obj(str(tmp_path / "t.obj"))
    np.testing.assert_array_equal(back.vertices, jback.vertices)
    np.testing.assert_array_equal(back.faces, jback.faces)
    np.testing.assert_array_equal(back.faces, gf)
    np.testing.assert_allclose(back.vertices, gv, atol=1e-6)
    jmesh.write_ply(str(tmp_path / "j.ply"), ref)
    tmesh.write_ply(str(tmp_path / "t.ply"), got)
    assert filecmp.cmp(tmp_path / "j.ply", tmp_path / "t.ply", shallow=False)
    pback = tmesh.read_ply(str(tmp_path / "j.ply"))
    np.testing.assert_array_equal(pback.faces, gf)
    np.testing.assert_array_equal(pback.vertex_colors, colors)


def test_psnr_ssim_match_and_lpips_is_nan_with_a_warning():
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 1, (40, 36, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    assert teval.psnr(a, b) == jeval.psnr(a, b)
    assert teval.ssim(a, b) == jeval.ssim(a, b)
    assert 15 < teval.psnr(a, b) < 40 and 0 < teval.ssim(a, b) < 1
    with pytest.warns(UserWarning, match="LPIPS"):
        m = teval.eval_rgb(a, b)
    assert m["psnr"] == jeval.psnr(a, b) and np.isnan(m["lpips"])


def test_usdz_bytes_match(tmp_path):
    rng = np.random.default_rng(2)
    n = 50
    g = {"means": rng.normal(size=(n, 3)), "quats": rng.normal(size=(n, 4)),
         "log_scales": rng.normal(-3, 0.3, (n, 3)),
         "opacity_logits": rng.normal(size=n),
         "features_dc": rng.normal(size=(n, 3)),
         "features_rest": rng.normal(0, 0.1, (n, 15, 3))}
    g = {k: v.astype(np.float32) for k, v in g.items()}
    jpath, tpath = str(tmp_path / "j" / "g.usdz"), str(tmp_path / "t" / "g.usdz")
    jusdz.export_from_gaussian_dict(jpath, g, sh_degree=3)
    tusdz.export_from_gaussian_dict(tpath, g, sh_degree=3)
    # member for member (the archive's own header carries the write time)
    with zipfile.ZipFile(jpath) as zj, zipfile.ZipFile(tpath) as zt:
        assert zt.namelist() == zj.namelist() and len(zt.namelist()) == 3
        for name in zj.namelist():
            assert zt.read(name) == zj.read(name), name
            assert len(zt.read(name)) > 50
    back = tusdz.read_gaussians_usdz(tpath)
    ref = jusdz.read_gaussians_usdz(jpath)
    assert set(back) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(v),
                                      err_msg=k)


def test_uv_atlas_matches(tmp_path):
    """The chart atlas (the port grows charts with array operations) on a
    few-thousand-face mesh with degenerate faces: the same adjacency, the
    same charts at three caps, the same atlas."""
    import holoscene_tpu.utils.uv_atlas as juv
    import holoscene_tpu_torch.utils.uv_atlas as tuv

    axis = np.linspace(-1.0, 1.0, 24)
    x, y, z = np.meshgrid(axis, axis, axis, indexing="ij")
    sdf = np.sqrt(x * x + y * y + z * z) - 0.5 \
        + 0.05 * np.sin(9 * x) * np.cos(7 * y)
    v, f = jmc.marching_tetrahedra(sdf, use_native=False, origin=(-1,) * 3,
                                   spacing=(2 / 23,) * 3)
    f = np.concatenate([f, f[:3, [0, 0, 1]]])
    assert len(f) > 3000
    adj = juv.face_adjacency(f)
    ptr, nbr = tuv.face_adjacency(f)
    assert [nbr[ptr[i]:ptr[i + 1]].tolist() for i in range(len(f))] \
        == [[int(j) for j in a] for a in adj]
    for cap in (4096, 50, 7):
        ref, got = juv.grow_charts(v, f, 0.8, cap), tuv.grow_charts(v, f, 0.8,
                                                                   cap)
        assert len(got) == len(ref) > 10
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    ref, got = juv.build_chart_atlas(v, f, 256), tuv.build_chart_atlas(v, f,
                                                                      256)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def _without_gzip_mtime(name: str, data: bytes) -> bytes:
    """A .nurec member is a gzip stream whose header holds the second it
    was written (bytes 4-8, both packages leave gzip's default): two
    exports that straddle a second differ there and nowhere else."""
    return data[:4] + bytes(4) + data[8:] if name.endswith(".nurec") \
        else data


def test_export_modules_write_the_same_files(tmp_path):
    """export/{glb,usd,load_scene,cli}: the export CLI's three targets on
    tests/test_export_cli.py's fake run dir give the same bytes (the USDA
    text up to the run dir's own path), and load_scene reads them back
    alike; a textured OBJ is written alike."""
    import holoscene_tpu.export.cli as jcli
    import holoscene_tpu.export.load_scene as jload
    import holoscene_tpu_torch.export.cli as tcli
    import holoscene_tpu_torch.export.load_scene as tload
    from test_export_cli import _conf, _fake_rundir

    plots = {}
    for name, cli in (("j", jcli), ("t", tcli)):
        root = tmp_path / name
        root.mkdir()
        plots[name] = _fake_rundir(root) / "plots"
        for what in ("glb", "usd", "gs"):
            cli.main([what, "--conf", _conf(root), "--exps_folder",
                      str(root / "exps")])
    j, t = plots["j"], plots["t"]
    assert filecmp.cmp(j / "scene.glb", t / "scene.glb", shallow=False)
    with zipfile.ZipFile(j / "scene_gs.usdz") as zj, \
            zipfile.ZipFile(t / "scene_gs.usdz") as zt:
        assert zt.namelist() == zj.namelist()
        assert all(_without_gzip_mtime(n, zt.read(n))
                   == _without_gzip_mtime(n, zj.read(n))
                   for n in zj.namelist())
    usda = [(p / "usd" / "scene.usda").read_text().replace(str(p), "RUN")
            for p in (j, t)]
    assert usda[0] == usda[1] and "def Mesh" in usda[0]
    ref, got = jload.load_scene(str(j)), tload.load_scene(str(t))
    assert got["glb"] == ref["glb"]
    assert got["usd"]["gravity"] == ref["usd"]["gravity"]
    assert set(got["usd"]["prims"]) == set(ref["usd"]["prims"]) \
        == {"object_0", "object_1"}
    for name, prim in ref["usd"]["prims"].items():
        for k, v in prim.items():
            g = got["usd"]["prims"][name][k]
            assert type(g) is type(v), (name, k)
            if isinstance(v, np.ndarray):
                assert g.dtype == v.dtype and g.shape == v.shape, (name, k)
            np.testing.assert_array_equal(g, v, err_msg=f"{name} {k}")

    rng = np.random.default_rng(3)
    m = jmesh.read_obj(str(j / "surface_1.obj"))
    uvs = rng.uniform(0, 1, (len(m.vertices), 2))
    jmesh.write_obj(str(tmp_path / "j.obj"), jmesh.Mesh(m.vertices, m.faces,
                                                        uvs=uvs),
                    mtl_name="j.mtl", texture_png="x.png")
    tmesh.write_obj(str(tmp_path / "t.obj"), tmesh.Mesh(m.vertices, m.faces,
                                                        uvs=uvs),
                    mtl_name="j.mtl", texture_png="x.png")
    assert filecmp.cmp(tmp_path / "j.obj", tmp_path / "t.obj", shallow=False)
