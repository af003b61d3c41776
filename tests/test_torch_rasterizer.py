"""Mesh mask/depth rasterization of the port against
holoscene_tpu.ops.rasterizer.rasterize_mesh_list (perspective). The winner
pass breaks depth ties differently, so face ids are not compared: the mask
must agree except on a few boundary pixels, the depth on shared pixels."""

import numpy as np
import pytest

from holoscene_tpu.datasets.ns_dataset import NSDataset
from holoscene_tpu.datasets.synthetic import generate_scene
from holoscene_tpu.ops.rasterizer import rasterize_mesh_list as jraster
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
