"""The room generator: the same seed gives the same room, every seed the
same sizes."""

from __future__ import annotations

import numpy as np

from port_bench import scene


def test_same_seed_same_room():
    a = scene.make_room(2 ** 31 + 5, n_frames=4, res=64)
    b = scene.make_room(2 ** 31 + 5, n_frames=4, res=64)
    for k in ("rgb", "depth", "normal", "mask", "poses"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    assert a.spheres == b.spheres


def test_seeds_move_the_spheres_not_their_sizes():
    a = scene.make_room(1, n_frames=4, res=64)
    b = scene.make_room(2, n_frames=4, res=64)
    assert [s["radius"] for s in a.spheres] == list(scene.RADII)
    assert [s["radius"] for s in b.spheres] == list(scene.RADII)
    assert a.spheres != b.spheres
    assert a.n_objects == 31


def test_spheres_are_disjoint_and_on_the_floor():
    room = scene.make_room(7, n_frames=4, res=64)
    c = np.array([s["center"] for s in room.spheres])
    r = np.array([s["radius"] for s in room.spheres])
    assert np.allclose(c[:, 1], -scene.ROOM_HALF + r)
    d = np.linalg.norm(c[:, None, [0, 2]] - c[None, :, [0, 2]], axis=2)
    np.fill_diagonal(d, np.inf)
    assert (d > r[:, None] + r[None, :]).all()


def test_meshes_and_view_packs():
    room = scene.make_room(3, n_frames=4, res=64)
    meshes = scene.room_meshes(room)
    assert len(meshes) == 32
    v, f, col = meshes[0]
    assert f.shape == (12, 3) and col.dtype == np.uint8
    packs = scene.object_view_packs(room, 0, res=32)
    assert len(packs) == 6
    assert all(p["mask"].sum() > 0 for p in packs)
