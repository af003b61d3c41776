"""Mesh extraction of the port (models/fields.py implicit_sdf_raw_grid and
implicit_shift_sdf_raw, utils/mc.py, native/, utils/plots.py,
ops/rasterizer.py rasterize_mesh, utils/eval_geometry.py,
utils/mesh.py connected_components, training/pruning.py,
Stage1Runner.extract_meshes and the quality gate) against the JAX package
on the CPU, from the same inputs.

Tolerances, each stated where it is used: SDF values 1e-5 of the largest
|SDF| (float32 sums in another order); features 1e-6 of the largest;
meshes from the same grid equal to the bit; rasterized masks up to 0.5% of
the pixels apart (the fragment sampling at coverage boundaries) and
depths 1e-4 on shared pixels, as tests/test_torch_rasterizer.py holds
them."""

import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401
from torch_stage1_cases import cfgs, jax_params

from holoscene_tpu.models import fields as jf
from holoscene_tpu.native import marching_tetrahedra_native as jnative
from holoscene_tpu.ops import hashgrid as jh
from holoscene_tpu.ops import rasterizer as jr
from holoscene_tpu.training import pruning as jpruning
from holoscene_tpu.utils import eval_geometry as jeval
from holoscene_tpu.utils import mc as jmc
from holoscene_tpu.utils import mesh as jmesh
from holoscene_tpu.utils import plots as jplots
from holoscene_tpu_torch import native as tnative
from holoscene_tpu_torch.convert import stage1_params_from_jax
from holoscene_tpu_torch.models import fields as tf
from holoscene_tpu_torch.ops import hashgrid as th
from holoscene_tpu_torch.ops import rasterizer as tr
from holoscene_tpu_torch.training import pruning as tpruning
from holoscene_tpu_torch.utils import eval_geometry as teval
from holoscene_tpu_torch.utils import mc as tmc
from holoscene_tpu_torch.utils import mesh as tmesh
from holoscene_tpu_torch.utils import plots as tplots

SDF_REL = 1e-5        # SDF values, of the largest |SDF|
FEAT_REL = 1e-6       # hash features, of the largest feature
MASK_MISMATCH = 0.005
DEPTH_ATOL = 1e-4


def _implicit(seed=1):
    """(JAX cfg, JAX params, port network) of the tiny Stage-1 width
    (tests/torch_stage1_cases.py: 6 levels, the first dense at scale 3)."""
    jc, tc = cfgs("exact")
    params = jax_params(jc, seed)["implicit"]
    net = tf.ImplicitNetwork(tc.implicit)
    net.load_state_dict(stage1_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jc.implicit, params, net


def _grid_points(res, lo=-1.0, hi=1.0):
    """Every point of an extraction grid, in the order evaluate_grid makes
    them (the boundary planes x01 = 0 and x01 = 1 included)."""
    axis = np.linspace(lo, hi, res, dtype=np.float32)
    xs, ys, zs = np.meshgrid(axis, axis, axis, indexing="ij")
    return np.stack([xs, ys, zs], -1).reshape(-1, 3)


def _close(got, ref, rel, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    scale = float(np.abs(ref).max())
    assert scale > 0, what
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, (what, err, scale)


def _dense_rows_differ(x01, meta):
    """[N] bool: a dense level's corner rows under the packed encode's wrap
    differ from the clamped cell's (H1 / H2)."""
    lt = th.level_tables(meta)
    clamped, _ = th._fused_rows_frac(x01, lt)
    ld = lt.n_dense
    res, sizes, offs = (torch.as_tensor(a[:ld])
                        for a in (lt.res, lt.sizes, lt.offsets))
    pos = torch.as_tensor(lt.scales[:ld])[:, None, None] * x01.T[None]
    wrapped = (th._dense_rows(torch.floor(pos).long(), res,
                              torch.zeros_like(offs))
               % sizes[:, None, None] + offs[:, None, None])
    return (wrapped != clamped[:ld]).any(1)          # [ld, N]


def test_grid_evaluator_matches_jax_sdf_raw_on_an_extraction_grid():
    """implicit_sdf_raw_grid (H2 in its packed mode, plain here) against
    JAX implicit_sdf_raw (the packed encode) on every point of a 17^3
    extraction grid over [-1, 1]^3 (divide_factor 1: whole planes at
    x01 = 0 and x01 = 1, where the packed encode wraps the dense row and
    H2 clamps the cell); within SDF_REL of the largest |SDF|."""
    jic, params, net = _implicit()
    x = _grid_points(17)
    x01 = torch.tensor((x / jic.divide_factor + 1.0) * 0.5)
    differs = _dense_rows_differ(x01, net.cfg.grid_meta).any(0).numpy()
    assert differs.any() and (x[differs] == 1.0).any(-1).all()
    ref = jf.implicit_sdf_raw(params, jic, jnp.asarray(x))
    got = tf.implicit_sdf_raw_grid(net, torch.tensor(x))
    assert not got.requires_grad
    _close(got.numpy(), ref, SDF_REL, "sdf_raw")
    _close(got[differs].numpy(), np.asarray(ref)[differs], SDF_REL,
           "sdf_raw at the wrapped rows")
    # and the H1 route (implicit_sdf_raw) to rounding
    _close(tf.implicit_sdf_raw(net, torch.tensor(x)).detach().numpy(),
           got.numpy(), SDF_REL, "H1 route")


def test_packed_h2_matches_the_packed_encode_on_flagship_boundary_planes():
    """At the flagship meta (16 levels 16-2048, 2^19 rows; levels 0-4
    dense, level 0 at the integer scale 15): the six boundary planes of
    the coarse 64^3 grid and every 16th line of the 512^3 grid's. H2's
    packed mode clamps the dense cell where the packed encode wraps its
    row; the rows differ at x01 = 1 on level 0, and there the differing
    corners carry zero weight: all 16 levels' features agree within
    FEAT_REL of the largest."""
    meta_kw = dict(num_levels=16, level_dim=2, base_resolution=16,
                   log2_hashmap_size=19, desired_resolution=2048)
    jm, tm = jh.HashGridMeta(**meta_kw), th.HashGridMeta(**meta_kw)
    assert th.dense_level_count(tm) == 5
    rng = np.random.default_rng(0)
    emb = rng.uniform(-0.5, 0.5, (tm.table_rows, 2)).astype(np.float32)
    planes = []
    for res, step in ((64, 1), (512, 16)):
        axis = np.linspace(-1.0, 1.0, res, dtype=np.float32)
        u, v = np.meshgrid(axis[::step], axis, indexing="ij")
        u, v = u.reshape(-1), v.reshape(-1)
        for d in range(3):
            for side in (-1.0, 1.0):
                p = np.empty((u.size, 3), np.float32)
                p[:, d] = side
                p[:, (d + 1) % 3], p[:, (d + 2) % 3] = u, v
                planes.append(p)
    x01 = (np.concatenate(planes) + 1.0) * 0.5
    assert set(np.unique(x01[:, 0])) >= {0.0, 1.0}
    differs = _dense_rows_differ(torch.tensor(x01), tm)
    assert differs[0].any() and (x01[differs[0].numpy()] == 1.0).any(-1).all()
    ref = np.asarray(jh.hash_encode(jnp.asarray(x01), jnp.asarray(emb), jm))
    got = th.hash_encode_sampler(torch.tensor(x01), torch.tensor(emb), tm,
                                 packed=True).numpy()
    _close(got, ref, FEAT_REL, "features")
    for lvl in range(5):
        cols = slice(2 * lvl, 2 * lvl + 2)
        at = differs[lvl].numpy()
        if at.any():
            _close(got[at, cols], ref[at, cols], FEAT_REL,
                   f"dense level {lvl} at the wrapped rows")
    # without packed, the dense levels read exact float32 values
    exact = th.hash_encode_sampler(torch.tensor(x01), torch.tensor(emb), tm)
    assert not torch.equal(exact[:, :10], torch.tensor(got[:, :10]))
    np.testing.assert_array_equal(exact[:, 10:].numpy(), got[:, 10:])


def test_shift_sdf_raw_matches_jax():
    """implicit_shift_sdf_raw against JAX's on the extraction grid, within
    SDF_REL; the winning object keeps the scene SDF."""
    jic, params, net = _implicit()
    x = _grid_points(13)
    ref = np.asarray(jf.implicit_shift_sdf_raw(params, jic, jnp.asarray(x)))
    got = tf.implicit_shift_sdf_raw(net, torch.tensor(x)).numpy()
    _close(got, ref, SDF_REL, "shifted")
    raw = tf.implicit_sdf_raw_grid(net, torch.tensor(x)).numpy()
    np.testing.assert_array_equal(got.min(-1), raw.min(-1))
    inside = raw.min(-1) < 0
    assert inside.any() and (got[inside] >= -raw.min(-1)[inside, None]
                             - 1e-7).sum(-1).min() >= raw.shape[1] - 1


def _sphere_sdf_jax(pts):
    return jnp.sqrt(jnp.sum((pts - jnp.array([0.1, -0.05, 0.0])) ** 2,
                            -1)) - 0.6


def _sphere_sdf_torch(pts):
    return torch.sqrt(torch.sum((pts - torch.tensor([0.1, -0.05, 0.0])) ** 2,
                                -1)) - 0.6


def test_evaluate_sdf_grid_and_extract_mesh_match_jax():
    """An analytic SDF over a 23^3 grid in chunks of 1000 points (the last
    one partial: JAX pads it, the port does not): the grids within 1e-6
    (float32 sqrt on both sides), origin and spacing equal, and the meshes
    of the two grids equal (no grid value within 1e-4 of the level)."""
    ref = jmc.evaluate_sdf_grid(jax.jit(_sphere_sdf_jax), 23, chunk=1000)
    got = tmc.evaluate_sdf_grid(_sphere_sdf_torch, 23, chunk=1000,
                                device="cpu")
    np.testing.assert_allclose(got[0], ref[0], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[2], ref[2])
    assert np.abs(ref[0]).min() > 1e-4
    rv, rf = jmc.extract_mesh(jax.jit(_sphere_sdf_jax), 23, chunk=1000)
    gv, gf = tmc.extract_mesh(_sphere_sdf_torch, 23, chunk=1000, device="cpu")
    assert len(gf) > 500
    np.testing.assert_array_equal(gf, rf)
    np.testing.assert_allclose(gv, rv, atol=1e-6, rtol=0)


def _same_mesh(va, fa, vb, fb, atol):
    """Two meshes numbered differently are the same oriented triangles on
    vertices within atol: each vertex of a has one of b within atol, and
    the faces of a, renumbered so, rotated to start at their smallest
    index, are those of b."""
    from scipy.spatial import cKDTree

    assert len(va) == len(vb) and len(fa) == len(fb)
    d, idx = cKDTree(vb).query(va)
    assert d.max() <= atol and len(np.unique(idx)) == len(vb)

    def canon(f):
        r = np.argmin(f, 1)
        f = np.stack([f[np.arange(len(f)), (r + k) % 3] for k in range(3)], 1)
        return f[np.lexsort(f.T[::-1])]

    np.testing.assert_array_equal(canon(idx[fa]), canon(fb))


def test_native_marching_tetrahedra_match_numpy_and_jax():
    """The port's C++ extractor against its numpy path (the same oriented
    triangles on vertices within 1e-6, numbered differently: the library
    interpolates a float32 copy of the grid) and against the
    JAX package's extractors (native: the same arrays; numpy: the port's
    numpy arrays)."""
    axis = np.linspace(-1.0, 1.0, 30)
    x, y, z = np.meshgrid(axis, axis, axis, indexing="ij")
    sdf = (np.sqrt((x - 0.1) ** 2 + y ** 2 + z ** 2) - 0.5) \
        * (np.abs(z) - 0.8)                 # a sphere and two slabs
    kw = dict(origin=(-1,) * 3, spacing=(2 / 29,) * 3)
    nv, nf = tmc._marching_tetrahedra_native(sdf, 0.0, **kw)
    pv, pf = tmc.marching_tetrahedra(sdf, **kw)
    assert len(nf) > 1000
    # the library reads the grid as float32: vertices within 1e-6
    _same_mesh(nv, nf, pv, pf, 1e-6)
    jv, jfc = jmc.marching_tetrahedra(sdf, use_native=True, **kw)
    np.testing.assert_array_equal(nv, jv)
    np.testing.assert_array_equal(nf, jfc)
    jv, jfc = jmc.marching_tetrahedra(sdf, use_native=False, **kw)
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pf, jfc)
    # the raw library: the same welded vertices and faces as the JAX one
    raw = tnative.marching_tetrahedra_native(sdf.astype(np.float32))
    for a, b in zip(raw, jnative(sdf.astype(np.float32))):
        np.testing.assert_array_equal(a, b)
    # marching_tetrahedra sends grids of 64^3 points and more to the library
    calls = []
    orig = tnative.marching_tetrahedra_native
    try:
        tnative.marching_tetrahedra_native = \
            lambda *a, **k: calls.append(1) or orig(*a, **k)
        big = np.pad(sdf, ((0, 34), (0, 34), (0, 34)), constant_values=1.0)
        tmc.marching_tetrahedra(big, **kw)
        tmc.marching_tetrahedra(sdf, **kw)
    finally:
        tnative.marching_tetrahedra_native = orig
    assert calls == [1]


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A failed g++ build raises: nothing falls back to the numpy path."""
    monkeypatch.setattr(tnative, "LIB", tmp_path / "libmc_native.so")
    monkeypatch.setattr(tnative, "GXX_FLAGS", ("-O3", "--no-such-flag"))
    tnative.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            tnative.marching_tetrahedra_native(np.ones((2, 2, 2), np.float32))
    finally:
        tnative.library.cache_clear()
    assert not list(tmp_path.iterdir())


def _record_grids(monkeypatch, module):
    """Record the (grid, origin, spacing) of every marching_tetrahedra call
    made through `module`."""
    calls = []
    orig = module.marching_tetrahedra

    def rec(grid, **kw):
        calls.append((np.array(grid), np.array(kw["origin"]),
                      np.array(kw["spacing"])))
        return orig(grid, **kw)

    monkeypatch.setattr(module, "marching_tetrahedra", rec)
    return calls


def test_extract_object_meshes_matches_jax(monkeypatch):
    """extract_object_meshes at resolution 32 / coarse 16 from the same
    converted parameters: the same None pattern and bboxes, every fine grid
    within SDF_REL of the largest |SDF|, the port's triangulation of JAX's
    grid equal to JAX's mesh, and the port's own meshes equal to JAX's
    where no grid value lies within the grid tolerance of the level: faces
    to the bit, vertices within 1e-3 of the voxel (a crossing moves by the
    SDF difference over the difference across its edge, up to 5e-4 of the
    voxel here); where one does, the sign can flip there, and the meshes
    are held by two-way chamfer instead (mean within a hundredth of the
    voxel)."""
    jic, params, net = _implicit()
    jfn = jax.jit(lambda pts: jf.implicit_sdf_raw(params, jic, pts))
    kw = dict(resolution=32, coarse_resolution=16, chunk=4096)
    jgrids = _record_grids(monkeypatch, jplots)
    tgrids = _record_grids(monkeypatch, tplots)
    ref = jplots.extract_object_meshes(jfn, jic.d_out, **kw)
    seconds = {}
    got = tplots.extract_object_meshes(
        lambda pts: tf.implicit_sdf_raw_grid(net, pts), jic.d_out,
        device="cpu", seconds=seconds, **kw)
    assert [m is None for m in got] == [m is None for m in ref]
    assert sum(m is not None for m in ref) >= 2
    assert set(seconds) == {"grid_eval", "marching_tetrahedra"}
    assert len(jgrids) == len(tgrids) >= 2
    for (jg, jo, js), (tg, to, ts), r, g in zip(
            jgrids, tgrids, [m for m in ref if m is not None],
            [m for m in got if m is not None]):
        np.testing.assert_array_equal(to, jo)
        np.testing.assert_array_equal(ts, js)
        _close(tg, jg, SDF_REL, "fine grid")
        v, f = tmc.marching_tetrahedra(jg, origin=jo, spacing=js)
        np.testing.assert_array_equal(f, r.faces)
        np.testing.assert_array_equal(v, r.vertices)
        if np.abs(jg).min() > SDF_REL * np.abs(jg).max():
            np.testing.assert_array_equal(g.faces, r.faces)
            np.testing.assert_allclose(g.vertices, r.vertices,
                                       atol=1e-3 * js.max())
        else:       # a value within the tolerance of 0: compare geometry
            m = teval.calc_3d_metric(g, tmesh.Mesh(r.vertices, r.faces),
                                     n_samples=5000, align=False)
            assert max(m["accuracy"], m["completion"]) < 0.01 * js.max()


def test_bbox_json_and_surface_ply_match_jax(tmp_path):
    """generate_bbox and save_object_meshes write the files JAX writes, byte
    for byte (names surface_{epoch}_{k}.ply and bbox/bbox_{k}.json, keys
    min / max / center / scale)."""
    rng = np.random.default_rng(3)
    arrays = [None, (rng.normal(size=(40, 3)), rng.integers(0, 40, (60, 3))),
              (rng.normal(size=(20, 3)) + 2.0, rng.integers(0, 20, (30, 3)))]
    tm = [None if a is None else tmesh.Mesh(*a) for a in arrays]
    jm = [None if a is None else jmesh.Mesh(*a) for a in arrays]
    for d in ("j", "t"):
        os.makedirs(tmp_path / d)
    jb = jplots.generate_bbox(jm, str(tmp_path / "j"), pad=0.1)
    tb = tplots.generate_bbox(tm, str(tmp_path / "t"), pad=0.1)
    assert tb == jb and set(tb) == {1, 2}
    jp = jplots.save_object_meshes(jm, str(tmp_path / "j"), 7)
    tp = tplots.save_object_meshes(tm, str(tmp_path / "t"), 7)
    assert [p and os.path.basename(p) for p in tp] \
        == [p and os.path.basename(p) for p in jp] \
        == [None, "surface_7_1.ply", "surface_7_2.ply"]
    for name in ("surface_7_1.ply", "surface_7_2.ply", "bbox/bbox_1.json",
                 "bbox/bbox_2.json"):
        assert filecmp.cmp(tmp_path / "j" / name, tmp_path / "t" / name,
                           shallow=False), name
    with open(tmp_path / "t" / "bbox" / "bbox_2.json") as f:
        assert set(json.load(f)) == {"min", "max", "center", "scale"}


def _box_room(half=2.0, subdiv=6):
    """Inward-facing box (a room) of large triangles: (verts, faces)."""
    import itertools

    lin = np.linspace(-half, half, subdiv)
    verts, faces = [], []
    for axis, sign in itertools.product(range(3), (-1.0, 1.0)):
        base = len(verts)
        for a in lin:
            for b in lin:
                p = np.zeros(3)
                p[axis] = sign * half
                p[(axis + 1) % 3] = a
                p[(axis + 2) % 3] = b
                verts.append(p)
        for i in range(subdiv - 1):
            for j in range(subdiv - 1):
                v0 = base + i * subdiv + j
                v1, v2, v3 = v0 + 1, v0 + subdiv, v0 + subdiv + 1
                faces += [[v0, v1, v2], [v1, v3, v2]]
    return np.asarray(verts, np.float32), np.asarray(faces, np.int64)


def _sphere(r=0.6, center=(0.0, 0.0, 0.0), res=20):
    axis = np.linspace(-1, 1, res)
    x, y, z = np.meshgrid(axis, axis, axis, indexing="ij")
    sdf = np.sqrt((x - center[0]) ** 2 + (y - center[1]) ** 2
                  + (z - center[2]) ** 2) - r
    v, f = tmc.marching_tetrahedra(sdf, origin=(-1,) * 3,
                                   spacing=(2 / (res - 1),) * 3)
    return v.astype(np.float32), f


def _look_at(eye, target=(0.0, 0.0, 0.0)):
    """OpenCV camera-to-world (x right, y down, z forward)."""
    eye = np.asarray(eye, np.float64)
    z = np.asarray(target) - eye
    z /= np.linalg.norm(z)
    x = np.cross(z, [0.0, 1.0, 0.0])
    x /= np.linalg.norm(x)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([x, np.cross(z, x), z], 1)
    c2w[:3, 3] = eye
    return c2w.astype(np.float32)


@pytest.mark.parametrize("case", ["perspective", "cull_backfaces",
                                  "orthographic"])
def test_rasterize_mesh_matches_jax(case):
    """rasterize_mesh against JAX's on a room of large triangles (split by
    the coverage guard, so face_id, bary and pix_verts are reported in the
    caller's frame) with a sphere in it: masks up to MASK_MISMATCH of the
    pixels apart, depth within DEPTH_ATOL on shared pixels; where the face
    ids agree (>= 99% of the shared pixels: depth ties break differently)
    the world positions within 1e-4, the barycentrics within 1e-3 (the
    inverse of a triangle a fraction of a pixel wide scales the float32
    rounding of its screen positions up) and the corner vertices equal. Backface culling keeps only the faces that face the
    camera; the orthographic camera maps a half extent of 0.8."""
    rv, rf = _box_room()
    sv, sf = _sphere(0.5, (0.2, 0.1, 0.3))
    verts = np.concatenate([rv, sv])
    faces = np.concatenate([rf, sf + len(rv)])
    kw = dict(img_res=(40, 48))
    pose = _look_at((0.3, -0.4, -1.6), (0.1, 0.2, 0.4))
    intr = np.array([[30.0, 0, 24.0], [0, 30.0, 20.0], [0, 0, 1]], np.float32)
    if case == "cull_backfaces":
        kw["cull_backfaces"] = True
    if case == "orthographic":
        pose = _look_at((0.2, 0.3, -3.0))
        kw = dict(img_res=(40, 40), ortho_half_extent=0.8)
        verts, faces = sv, sf
    ref = jr.rasterize_mesh(verts, faces, pose, intr, **kw)
    got = tr.rasterize_mesh(verts, faces, pose, intr, device="cpu", **kw)
    jm, tm = np.asarray(ref["mask"]), got["mask"].numpy()
    assert tm.shape == kw["img_res"] and 0.2 < tm.mean()
    assert (jm != tm).mean() <= MASK_MISMATCH
    both = jm & tm
    np.testing.assert_allclose(got["depth"].numpy()[both],
                               np.asarray(ref["depth"])[both],
                               atol=DEPTH_ATOL)
    jf_, tf_ = np.asarray(ref["face_id"]), got["face_id"].numpy()
    assert tf_.max() < len(faces) and (tf_[~tm] == -1).all()
    same = both & (jf_ == tf_)
    assert same.sum() >= 0.99 * both.sum()
    for k, tol in (("bary", 1e-3), ("world_pos", 1e-4)):
        np.testing.assert_allclose(got[k].numpy()[same],
                                   np.asarray(ref[k])[same], atol=tol,
                                   err_msg=k)
    np.testing.assert_array_equal(got["pix_verts"].numpy()[same],
                                  np.asarray(ref["pix_verts"])[same])
    if case == "cull_backfaces":
        # every face the room shows faces the camera
        full = tr.rasterize_mesh(verts, faces, pose, intr, img_res=(40, 48),
                                 device="cpu")
        assert tm.sum() < full["mask"].numpy().sum()


@pytest.mark.parametrize("cull_backfaces", [False, True])
def test_rasterize_face_chunks_match_one_pass(monkeypatch, cull_backfaces):
    """The fragments scattered a few faces at a time (chunks of 7, the
    sphere's faces split across chunks) give the same depth and face-id
    buffers, to the bit, as one pass over every face."""
    rv, rf = _box_room()
    sv, sf = _sphere(0.5, (0.2, 0.1, 0.3))
    verts = np.concatenate([rv, sv])
    faces = np.concatenate([rf, sf + len(rv)])
    pose = _look_at((0.3, -0.4, -1.6), (0.1, 0.2, 0.4))
    intr = np.array([[30.0, 0, 24.0], [0, 30.0, 20.0], [0, 0, 1]], np.float32)
    w2c = tr.view_matrix(pose, "cpu")
    v = torch.as_tensor(verts)
    xy, z = tr.perspective_project(v, w2c, torch.as_tensor(intr))
    f = torch.as_tensor(faces, dtype=torch.int64)
    one = tr._rasterize_core(xy, z, f, 40, 48, 6, cull_backfaces)
    monkeypatch.setattr(tr, "FACE_CHUNK", 7)
    chunked = tr._rasterize_core(xy, z, f, 40, 48, 6, cull_backfaces)
    assert (one[1] >= 0).float().mean() > 0.2
    for a, b in zip(one, chunked):
        assert torch.equal(a, b)


def test_depth_metric_matches_jax():
    """calc_2d_metric: depth renders of the room shifted by 0.3 against the
    room, 2 random interior views through each package's rasterizer, at
    the same seed: the same views used and the depth L1 within 1e-4 of
    JAX's (relative); the room against itself ~0."""
    rv, rf = _box_room()
    shifted = rv + np.array([0.3, 0.0, 0.0], np.float32)
    kw = dict(n_imgs=2, img_res=(64, 64), focal=38.0, seed=0)
    ref = jeval.calc_2d_metric(jmesh.Mesh(shifted, rf), jmesh.Mesh(rv, rf),
                               **kw)
    got = teval.calc_2d_metric(tmesh.Mesh(shifted, rf), tmesh.Mesh(rv, rf),
                               device="cpu", **kw)
    assert got["n_views"] == ref["n_views"] == 2
    assert got["depth_l1"] > 0.02
    assert got["depth_l1"] == pytest.approx(ref["depth_l1"], rel=1e-4)
    assert got["depth_l1_cm"] == pytest.approx(100 * got["depth_l1"])
    same = teval.calc_2d_metric(tmesh.Mesh(rv, rf), tmesh.Mesh(rv, rf),
                                device="cpu", **kw)
    assert same["depth_l1"] == pytest.approx(0.0, abs=1e-5)


def test_chamfer_metric_matches_jax():
    """calc_3d_metric (numpy and cKDTree on both sides, ICP on) against
    JAX's at the same seed: the same dict."""
    sv, sf = _sphere(0.5)
    tv, tfc = _sphere(0.45, (0.05, 0.0, 0.0))
    ref = jeval.calc_3d_metric(jmesh.Mesh(sv, sf), jmesh.Mesh(tv, tfc),
                               n_samples=3000)
    got = teval.calc_3d_metric(tmesh.Mesh(sv, sf), tmesh.Mesh(tv, tfc),
                               n_samples=3000)
    assert got == ref and got["accuracy"] > 0


def test_connected_components_match_jax():
    """Mesh.connected_components (scipy's csgraph in the port, the
    reference's min-label propagation in JAX) on the synthetic scene's
    three meshes and 40 single triangles in one mesh, with isolated
    vertices and the vertex and face order scrambled: the same labels."""
    from holoscene_tpu_torch.datasets.synthetic import scene_meshes

    rng = np.random.default_rng(0)
    parts = [(m.vertices, m.faces) for m in scene_meshes(24)]
    parts += [(rng.normal(size=(3, 3)), np.array([[0, 1, 2]]))
              for _ in range(40)]
    parts.append((rng.normal(size=(5, 3)), np.zeros((0, 3), np.int64)))
    offs = np.cumsum([0] + [len(v) for v, _ in parts])
    verts = np.concatenate([v for v, _ in parts])
    faces = np.concatenate([f + o for (_, f), o in zip(parts, offs)])
    perm = rng.permutation(len(verts))
    verts, faces = verts[perm], np.argsort(perm)[faces]
    faces = faces[rng.permutation(len(faces))]
    ref = jmesh.Mesh(verts, faces).connected_components()
    got = tmesh.Mesh(verts, faces).connected_components()
    assert ref.max() == 42
    np.testing.assert_array_equal(got, ref)


def test_visibility_pruning_keeps_the_components_jax_keeps(tmp_path):
    """instance_meshes_post_pruning on the synthetic scene (6 views at
    48^2) with the analytic meshes and a floater added to object 1 (a small
    sphere above the others, where the instance masks say room): the port
    keeps exactly the components JAX keeps, the floater goes and object 1's
    sphere stays."""
    from holoscene_tpu.datasets.ns_dataset import NSDataset as JNSDataset
    from holoscene_tpu_torch.datasets.ns_dataset import NSDataset
    from holoscene_tpu_torch.datasets.synthetic import (
        generate_scene,
        scene_meshes,
    )

    generate_scene(str(tmp_path / "scene_0"), n_images=6, img_res=(48, 48))
    meshes = scene_meshes(16)
    fv, ff = _sphere(0.06, (0.0, 0.3, 0.0), res=40)
    one = meshes[1]
    meshes[1] = tmesh.Mesh(np.concatenate([one.vertices, fv]),
                           np.concatenate([one.faces, ff + len(one.vertices)]))
    assert meshes[1].connected_components().max() == 1
    got = tpruning.instance_meshes_post_pruning(
        meshes, NSDataset(str(tmp_path), "scene_0", img_res=(48, 48)),
        device="cpu")
    ref = jpruning.instance_meshes_post_pruning(
        [jmesh.Mesh(m.vertices, m.faces) for m in meshes],
        JNSDataset(str(tmp_path), "scene_0", img_res=(48, 48)))
    assert [m is None for m in got] == [m is None for m in ref]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.faces, r.faces)
        np.testing.assert_array_equal(g.vertices, r.vertices)
    assert len(got[1].faces) == len(one.faces)
    assert len(got[0].faces) == len(meshes[0].faces)


def test_runner_extracts_and_writes_meshes_on_the_plot_cadence(
        tmp_path, monkeypatch):
    """Stage1Runner.run(plot_freq=2, extract_meshes_on_plot=True) on the
    CPU at a tiny width: the plot at step 1 writes its PNGs, the surviving
    objects' surface_1_{k}.ply and bbox/bbox_{k}.json, at the conf's
    plot.resolution; the grid evaluation encodes through H2's wrapper (one
    call a chunk: the coarse 64^3 sweep is one, each object's fine grid
    one more) and never through H1; the wall table has every part."""
    from test_torch_stage1 import _scene_conf

    from holoscene_tpu_torch.training import exp_runner

    conf = _scene_conf(tmp_path, 2)
    conf.write_text(conf.read_text()
                    + "plot{\n resolution = 24\n grid_boundary = [-1.0, 1.0]\n}\n")
    runner = exp_runner.main(["--conf", str(conf), "--exps_folder",
                              str(tmp_path / "exps"), "--max_niters", "0",
                              "--quiet", "--device", "cpu"])
    calls = []
    orig = th.sampler_fwd
    monkeypatch.setattr(th, "sampler_fwd",
                        lambda x01, emb, lt, packed=False, *rest:
                        calls.append((x01.shape[0], packed))
                        or orig(x01, emb, lt, packed, *rest))
    runner.run(n_iters=2, log_every=1, plot_freq=2,
               extract_meshes_on_plot=True)
    plots = runner.plots_dir
    assert os.path.exists(os.path.join(plots, "rendering_1.png"))
    names = sorted(os.listdir(plots))
    kept = [k for k in range(3) if f"surface_1_{k}.ply" in names]
    assert kept and sorted(os.listdir(os.path.join(plots, "bbox"))) \
        == [f"bbox_{k}.json" for k in kept]
    assert set(runner.extract_seconds) == {
        "grid_eval", "marching_tetrahedra", "pruning", "writing", "total"}
    extract = [c for c in calls if c[1]]
    assert extract[0] == (64 ** 3, True)
    assert all(n <= 24 ** 3 for n, _ in extract[1:]) and len(extract) >= 2

    def no_h1(*args):
        raise AssertionError("grid evaluation went through H1")

    monkeypatch.setattr(th, "fused_fwd", no_h1)
    calls.clear()
    meshes = runner.extract_meshes(resolution=20, prune=False, save=False)
    assert len(calls) == 1 + sum(m is not None for m in meshes) \
        and all(p for _, p in calls)


def test_quality_gate_runs_on_the_cpu(tmp_path, capsys):
    """quality_gate.main at 3 iterations on a 32^2 scene: its lines, a
    finite PSNR, the chamfer dict of the room and one face count a
    mesh."""
    from holoscene_tpu_torch.training import quality_gate

    out = quality_gate.main(["--iters", "3", "--res", "32", "--work",
                             str(tmp_path), "--device", "cpu"])
    text = capsys.readouterr().out
    for line in ("quality run: top_m=56 grad_mode=fused", "train wall: ",
                 "FINAL eval psnr: ", "bg chamfer: {'accuracy': ",
                 "mesh 0: ", "mesh 2: "):
        assert line in text, line
    assert np.isfinite(out["psnr"]) and len(out["faces"]) == 3
    assert set(out["chamfer"]) == {"accuracy", "completion",
                                   "completion_ratio"}
    assert all(np.isfinite(v) for v in out["chamfer"].values())
    assert [h["iter"] for h in out["history"]] == [0, 2]


def test_quality_gate_passes_its_seed(tmp_path, monkeypatch):
    """--seed reaches the runner, which seeds the model's init, the draws
    and the pixel batches with it."""
    from holoscene_tpu_torch.training import quality_gate

    seen = {}

    class Built(Exception):
        pass

    def runner(*args, **kw):
        seen.update(kw)
        raise Built

    monkeypatch.setattr(quality_gate, "Stage1Runner", runner)
    with pytest.raises(Built):
        quality_gate.main(["--iters", "1", "--res", "16", "--work",
                           str(tmp_path), "--device", "cpu", "--seed", "2"])
    assert seen["seed"] == 2 and seen["device"] == "cpu"
