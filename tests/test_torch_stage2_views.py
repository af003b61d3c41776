"""Stage 2's view machinery in the port (holoscene_tpu_torch/stage2/views.py,
inpaint_views.py and rasterize_mesh_list's orthographic / culling options)
against the JAX package on the same numpy meshes, on the CPU: the view
weights, the chosen views, the training-view vertex visibility and
coverage, the occlusion masks and the inpainted packs. Every count of
pixels comes from the same rasterization in both packages, so these are
compared exactly (floats within 1e-6); the raw buffers of the orthographic
and culled rasterizations within tests/test_torch_rasterizer.py's
tolerances (the winner pass breaks depth ties differently)."""

import numpy as np
import pytest
from test_torch_threads import few_torch_threads  # noqa: F401
from torch_stage2_cases import box

import holoscene_tpu.stage2.inpaint_views as jiv
import holoscene_tpu.stage2.views as jv
import holoscene_tpu_torch.stage2.inpaint_views as tiv
import holoscene_tpu_torch.stage2.views as tv
from holoscene_tpu.ops.rasterizer import rasterize_mesh_list as jraster
from holoscene_tpu.stage2.providers import NullInpaintProvider as JNull
from holoscene_tpu.utils.mesh import Mesh as JMesh
from holoscene_tpu_torch.ops.rasterizer import rasterize_mesh_list as traster
from holoscene_tpu_torch.stage2.providers import NullInpaintProvider as TNull
from holoscene_tpu_torch.stage2.remesh import icosphere
from holoscene_tpu_torch.utils.mesh import Mesh as TMesh

MASK_MISMATCH = 0.005   # tests/test_torch_rasterizer.py's
DEPTH_ATOL = 1e-4
RES = 24


def _scene():
    """(JAX meshes, port meshes): an icosphere with a hole (back faces show
    through it), a slab in front of it and a floor below (y down)."""
    sph = icosphere(0.3, (0.0, 0.1, 0.0), subdivisions=2)
    keep = np.ones(len(sph.faces), bool)
    keep[:20] = False
    parts = [(sph.vertices, sph.faces[keep]),
             box((0.0, 0.1, -0.45), (0.35, 0.15, 0.05)),
             box((0, 0.45, 0), (1.0, 0.05, 1.0))]
    return ([JMesh(*p) for p in parts], [TMesh(*p) for p in parts])


def _views(mesh):
    b = mesh.bounds
    center = (b[0] + b[1]) / 2
    radius = float(np.linalg.norm(b[1] - b[0]) / 2) * 2
    return [tv.camera_on_sphere(center, radius, a, e)
            for a, e in tv.view_grid(16, 4)]


@pytest.mark.parametrize("cull", [False, True])
def test_rasterize_mesh_list_ortho_and_culling_match_jax(cull):
    jm, tm = _scene()
    pose = _views(tm[0])[21]
    meshes = [(m.vertices, m.faces) for m in tm]
    j = jraster(meshes, pose, None, (RES, RES), ortho_half_extent=0.5,
                cull_backfaces=cull)
    t = traster(meshes, pose, None, (RES, RES), ortho_half_extent=0.5,
                cull_backfaces=cull, device="cpu")
    jmask, tmask = np.asarray(j["mask"]), t["mask"].numpy()
    assert 0.1 < tmask.mean() < 1.0
    assert (jmask != tmask).mean() <= MASK_MISMATCH
    both = jmask & tmask
    np.testing.assert_allclose(t["depth"].numpy()[both],
                               np.asarray(j["depth"])[both], atol=DEPTH_ATOL)
    np.testing.assert_array_equal(t["instance_id"].numpy()[both],
                                  np.asarray(j["instance_id"])[both])


def test_view_weights_and_best_views_match_jax():
    jm, tm = _scene()
    views = _views(tm[0])
    jw = jv.object_view_weights(jm[0], jm[1:], views, RES)
    tw = tv.object_view_weights(tm[0], tm[1:], views, RES, device="cpu")
    np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-6)
    assert tw.min() < 0.2 and (tw == 1.0).any()     # occluded and clear
    jb = jv.select_best_views(jm[0], jm[1:], n_views=4, img_res=RES)
    tb = tv.select_best_views(tm[0], tm[1:], n_views=4, img_res=RES,
                              device="cpu")
    assert len(tb) == len(jb) == 4
    for (tp, tw_), (jp, jw_) in zip(tb, jb):
        np.testing.assert_array_equal(tp, jp)
        assert abs(tw_ - jw_) <= 1e-6


def test_training_view_visibility_and_coverage_match_jax():
    """Vertex visibility over perspective training cameras, and the
    coverage integrated over the direction grid."""
    jm, tm = _scene()
    intr = np.array([[30.0, 0, 16], [0, 30.0, 16], [0, 0, 1]])
    poses = [tv.camera_on_sphere(np.array([0.0, 0.1, 0.0]), 1.5, a, e)
             for a, e in ((0.0, 0.3), (1.5, 0.2), (3.0, 0.5), (4.5, 0.1))]
    jvis = jv.training_view_vertex_visibility(jm[0], jm[1:], poses, intr,
                                              (32, 32))
    tvis = tv.training_view_vertex_visibility(tm[0], tm[1:], poses, intr,
                                              (32, 32), device="cpu")
    np.testing.assert_array_equal(tvis, jvis)
    assert 0.0 < tvis.mean() < 1.0
    jc, jmap = jv.integrated_view_coverage(jm[0], jvis)
    tc, tmap = tv.integrated_view_coverage(tm[0], tvis)
    assert abs(tc - jc) <= 1e-6
    np.testing.assert_allclose(tmap, jmap, rtol=0, atol=1e-6)


def test_occlusion_masks_and_inpainted_pack_match_jax():
    """occluded_region of the sphere behind the slab, then the inpainted,
    normal-gated pack of a view built from it (NullInpaintProvider in
    both packages)."""
    jm, tm = _scene()
    pose = tv.camera_on_sphere(np.array([0.0, 0.1, 0.0]), 1.2, -np.pi / 2,
                               0.0)
    half = 0.5
    jocc, jself = jiv.occluded_region(jm[0], jm[1:], pose, half, 32)
    tocc, tself = tiv.occluded_region(tm[0], tm[1:], pose, half, 32,
                                      device="cpu")
    np.testing.assert_array_equal(tocc, jocc)
    np.testing.assert_array_equal(tself, jself)
    assert tocc.sum() > 20 and tself.sum() > 20
    rng = np.random.default_rng(0)
    alone = traster([(tm[0].vertices, tm[0].faces)], pose, None, (32, 32),
                    ortho_half_extent=half, device="cpu")
    n = rng.normal(size=(32, 32, 3)).astype(np.float32)
    view = {"rgb": rng.uniform(0, 1, (32, 32, 3)).astype(np.float32),
            "normal": n / np.linalg.norm(n, axis=-1, keepdims=True),
            "depth": np.where(alone["mask"].numpy(),
                              alone["depth"].numpy(), 0.0).astype(np.float32),
            "mask": tself}
    jp = jiv.inpaint_object_view(view, jocc, jself, JNull(), half)
    tp = tiv.inpaint_object_view(view, tocc, tself, TNull(), half)
    assert set(tp) == set(jp)
    for k in jp:
        np.testing.assert_allclose(np.asarray(tp[k], np.float64),
                                   np.asarray(jp[k], np.float64), rtol=0,
                                   atol=1e-6, err_msg=k)
    assert tp["sm_mask"].sum() > tocc.sum()
