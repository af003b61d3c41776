"""Mesh mask/depth rasterization of the port against
holoscene_tpu.ops.rasterizer: rasterize_mesh_list (perspective), the
depth-peeled rasterizer (one mesh and a list), visible_faces_multiview with
prune_invisible_faces, and subdivide_mesh. The winner pass breaks depth
ties differently, so face ids are compared where they can tie only as a
share: the masks must agree except on a few boundary pixels, the depth on
shared pixels."""

import numpy as np
import pytest

from holoscene_tpu.datasets.ns_dataset import NSDataset
from holoscene_tpu.datasets.synthetic import generate_scene
from holoscene_tpu.ops import rasterizer as jr
from holoscene_tpu.ops.rasterizer import rasterize_mesh_list as jraster
from holoscene_tpu.utils import mc as jmc
from holoscene_tpu_torch.ops import rasterizer as tr
from holoscene_tpu_torch.datasets.synthetic import scene_meshes
from holoscene_tpu_torch.ops.rasterizer import BIG_DEPTH
from holoscene_tpu_torch.ops.rasterizer import rasterize_mesh_list as traster
from test_torch_threads import few_torch_threads  # noqa: F401

MASK_MISMATCH = 0.005   # fraction of pixels (coverage-boundary sampling)
DEPTH_ATOL = 1e-4


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("trast")
    generate_scene(str(root / "scene_0"), n_images=3, img_res=(36, 44))
    return NSDataset(str(root), "scene_0", img_res=(36, 44))


@pytest.mark.parametrize("frame", [0, 2])
def test_rasterize_mesh_list_matches_jax(scene, frame):
    meshes = [(m.vertices, m.faces) for m in scene_meshes(12)]
    pose = scene.pose_all[frame]
    intr = scene.intrinsics[:3, :3]
    j = jraster(meshes, pose, intr, scene.img_res)
    t = traster(meshes, pose, intr, scene.img_res)
    jm, tm = np.asarray(j["mask"]), t["mask"].numpy()
    assert tm.shape == scene.img_res and tm.mean() > 0.5
    assert (jm != tm).mean() <= MASK_MISMATCH
    both = jm & tm
    np.testing.assert_allclose(t["depth"].numpy()[both],
                               np.asarray(j["depth"])[both], atol=DEPTH_ATOL)
    assert (t["depth"].numpy()[~tm] == BIG_DEPTH).all()
    # instance ids index the input mesh list
    inst = t["instance_id"].numpy()
    assert set(np.unique(inst[tm])) <= set(range(len(meshes)))
    assert (inst[~tm] == -1).all()


# ---------------------------------------------------------------------------
# the depth-peeled rasterizer, multiview visibility, pruning, subdivision
# ---------------------------------------------------------------------------

def _sphere_mesh(r=0.5, res=40, center=(0.0, 0.0, 0.0)):
    axis = np.linspace(-1, 1, res)
    x, y, z = np.meshgrid(axis, axis, axis, indexing="ij")
    sp = 2.0 / (res - 1)
    v, f = jmc.marching_tetrahedra(np.sqrt(x * x + y * y + z * z) - r,
                                   origin=(-1, -1, -1), spacing=(sp,) * 3)
    return np.asarray(v, np.float32) + np.float32(center), np.asarray(f)


def _camera(img=64, f=80.0, cam_z=-2.0):
    intr = np.array([[f, 0, img / 2], [0, f, img / 2], [0, 0, 1.0]])
    pose = np.eye(4)
    pose[2, 3] = cam_z
    return pose, intr, (img, img)


def _check_layers(got, ref, face_ids=True):
    """Per layer: masks up to MASK_MISMATCH of the pixels apart, depth
    within DEPTH_ATOL where both cover, face ids equal on >= 99% of those
    pixels (ties in a winner pass break differently)."""
    assert len(got) == len(ref)
    for k, (g, r) in enumerate(zip(got, ref)):
        gm, rm = g["mask"].numpy(), np.asarray(r["mask"])
        assert (gm != rm).mean() <= MASK_MISMATCH, k
        both = gm & rm
        np.testing.assert_allclose(g["depth"].numpy()[both],
                                   np.asarray(r["depth"])[both],
                                   atol=DEPTH_ATOL, err_msg=str(k))
        assert (g["depth"].numpy()[~gm] == BIG_DEPTH).all()
        if face_ids and both.any():
            same = g["face_id"].numpy()[both] == np.asarray(r["face_id"])[both]
            assert same.mean() >= 0.99, (k, same.mean())


@pytest.mark.parametrize("case", ["perspective", "orthographic",
                                  "cull_backfaces", "default_eps"])
def test_rasterize_mesh_peeled_matches_jax(case):
    """A sphere seen from outside, three layers (front at 1.5, back at
    2.5, nothing): layers 1.0 apart, far beyond peel_eps (0.05; JAX's
    absolute default 1e-3 in "default_eps"), so the comparison does not
    rest on the peel threshold JAX sets too small for tessellated surfaces
    (ROADMAP.md C)."""
    verts, faces = _sphere_mesh()
    pose, intr, res = _camera()
    kw = dict(n_layers=3, peel_eps=0.05)
    if case == "orthographic":
        kw["ortho_half_extent"] = 0.8
    if case == "cull_backfaces":
        kw["cull_backfaces"] = True
    if case == "default_eps":
        del kw["peel_eps"]
    ref = jr.rasterize_mesh_peeled(verts, faces, pose, intr, res, **kw)
    got = tr.rasterize_mesh_peeled(verts, faces, pose, intr, res, **kw)
    _check_layers(got, ref)
    m0, m1, m2 = (g["mask"].numpy() for g in got)
    assert m0[32, 32] and not m2[32, 32]
    assert m1[32, 32] != (case == "cull_backfaces")   # culling: no back face
    if case == "perspective":
        assert float(got[0]["depth"][32, 32]) == pytest.approx(1.5, abs=0.03)
        assert float(got[1]["depth"][32, 32]) == pytest.approx(2.5, abs=0.05)


def test_rasterize_mesh_peeled_keeps_one_plane_one_layer():
    """A flat quad (two triangles): the fragment grid's depths across them
    do not bring the plane back as a second layer, as in JAX."""
    verts = np.array([[-0.6, -0.6, 0.0], [0.6, -0.6, 0.0],
                      [0.6, 0.6, 0.0], [-0.6, 0.6, 0.0]])
    faces = np.array([[0, 1, 2], [0, 2, 3]])
    pose, intr, res = _camera()
    got = tr.rasterize_mesh_peeled(verts, faces, pose, intr, res, n_layers=2)
    ref = jr.rasterize_mesh_peeled(verts, faces, pose, intr, res, n_layers=2)
    _check_layers(got, ref)
    assert got[0]["mask"][32, 32] and not got[1]["mask"].any()


def test_rasterize_mesh_list_peeled_matches_jax():
    """Two spheres in line: the back sphere first appears in layer 2 with
    its own instance id; instance ids equal where both cover."""
    v1, f1 = _sphere_mesh(0.4)
    v2, f2 = _sphere_mesh(0.3, center=(0.0, 0.0, 1.2))
    pose, intr, res = _camera()
    meshes = [(v1, f1), (v2, f2)]
    ref = jr.rasterize_mesh_list_peeled(meshes, pose, intr, res, n_layers=3,
                                        peel_eps=0.05)
    got = tr.rasterize_mesh_list_peeled(meshes, pose, intr, res, n_layers=3,
                                        peel_eps=0.05)
    _check_layers(got, ref)
    for g, r in zip(got, ref):
        both = g["mask"].numpy() & np.asarray(r["mask"])
        np.testing.assert_array_equal(g["instance_id"].numpy()[both],
                                      np.asarray(r["instance_id"])[both])
        assert (g["instance_id"].numpy()[~g["mask"].numpy()] == -1).all()
    assert int(got[0]["instance_id"][32, 32]) == 0
    assert int(got[2]["instance_id"][32, 32]) == 1


def _shells():
    shells = [_sphere_mesh(r, 24) for r in (0.5, 0.35, 0.1)]
    verts = np.concatenate([v for v, _ in shells])
    offs = np.cumsum([0] + [len(v) for v, _ in shells[:-1]])
    faces = np.concatenate([f + o for (_, f), o in zip(shells, offs)])
    owner = np.concatenate([np.full(len(f), i)
                            for i, (_, f) in enumerate(shells)])
    return verts, faces, owner


@pytest.mark.parametrize("seeded", [False, True])
def test_visible_faces_multiview_and_pruning_match_jax(seeded):
    """Three nested spheres, 8 equatorial orthographic views peeled 2 deep:
    the keep sets agree on >= 99% of the faces (a face seen at one pixel
    of one view can flip with a tie), the innermost sphere is pruned by
    both; seeded: the front-surface confirmation from a face paint that
    marks the outer sphere's upper half. prune_invisible_faces of one keep
    set is JAX's exactly. The keep set is JAX's stricter one (ROADMAP.md
    C: copied, not fixed)."""
    verts, faces, owner = _shells()
    paint = None
    if seeded:
        paint = (owner == 0) & (verts[faces[:, 0], 2] > 0)
    kw = dict(face_visible=paint, n_thetas=8, n_layers=2, img_res=(96, 96),
              ortho_half_extent=0.7, peel_eps=0.02)
    ref = np.asarray(jr.visible_faces_multiview(verts, faces, **kw))
    got = tr.visible_faces_multiview(verts, faces, **kw)
    assert got.dtype == bool and got.shape == (len(faces),)
    assert (got == ref).mean() >= 0.99
    assert got[owner == 2].sum() == ref[owner == 2].sum() == 0
    assert got[owner == 0].mean() > (0.4 if seeded else 0.8)
    for a, b in zip(tr.prune_invisible_faces(verts, faces, ref),
                    jr.prune_invisible_faces(verts, faces, ref)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("case", ["triangle", "sphere"])
def test_subdivide_mesh_matches_jax(case):
    """Midpoint subdivision: the same vertices and faces in the same order
    as JAX's face loop, every edge within max_edge."""
    if case == "triangle":
        verts = np.array([[0, 0, 0], [4.0, 0, 0], [0, 4.0, 0]])
        faces = np.array([[0, 1, 2]])
        max_edge = 0.5
    else:
        verts, faces = _sphere_mesh(0.6, 10)
        max_edge = 0.12
    rv, rf = jr.subdivide_mesh(verts, faces, max_edge)
    gv, gf = tr.subdivide_mesh(verts, faces, max_edge)
    assert len(gf) > len(faces)
    np.testing.assert_array_equal(gv, rv)
    np.testing.assert_array_equal(gf, rf)
    e = np.concatenate([gf[:, [0, 1]], gf[:, [1, 2]], gf[:, [2, 0]]])
    assert np.linalg.norm(gv[e[:, 0]] - gv[e[:, 1]], axis=1).max() \
        <= max_edge + 1e-9
