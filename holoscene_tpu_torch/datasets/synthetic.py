"""The synthetic scene (holoscene_tpu.datasets.synthetic, numpy only) and its
analytic meshes: the room box and the spheres, extracted by marching
tetrahedra in the NORMALIZED coordinates NSDataset loads the scene in. They
stand in for the Stage-3 meshes when Stage 4 is driven on its own."""

from __future__ import annotations

import os

import numpy as np

from holoscene_tpu.datasets.synthetic import (  # noqa: F401 (re-exported)
    DEFAULT_SPHERES,
    ROOM_HALF,
    generate_scene,
)
from holoscene_tpu.utils.mc import marching_tetrahedra
from holoscene_tpu.utils.mesh import Mesh, write_obj

# generate_scene puts the cameras on a ring of radius 0.65; NSDataset
# normalizes by the camera bbox extent (the ring diameter)
NORMALIZE_SCALE = 1.3


def scene_meshes(res: int = 20) -> list[Mesh]:
    """[room, sphere_0, sphere_1, ...] on a res^3 grid over [-1, 1]^3."""
    axis = np.linspace(-1.0, 1.0, res)
    x, y, z = np.meshgrid(axis, axis, axis, indexing="ij")
    sp = 2.0 / (res - 1)
    room = np.maximum.reduce([np.abs(x), np.abs(y), np.abs(z)]) \
        - ROOM_HALF / NORMALIZE_SCALE
    sdfs = [-room]
    for s in DEFAULT_SPHERES:
        c = np.asarray(s["center"]) / NORMALIZE_SCALE
        r = s["radius"] / NORMALIZE_SCALE
        sdfs.append(np.sqrt((x - c[0]) ** 2 + (y - c[1]) ** 2
                            + (z - c[2]) ** 2) - r)
    meshes = []
    for sdf in sdfs:
        v, f = marching_tetrahedra(sdf, origin=(-1,) * 3, spacing=(sp,) * 3)
        meshes.append(Mesh(v, f))
    return meshes


def write_stage3_meshes(plots_dir: str, meshes: list[Mesh]) -> None:
    """Write meshes where the Stage-4 CLI looks for Stage 3's output:
    plots_dir/surface_{i}.obj."""
    for i, m in enumerate(meshes):
        write_obj(os.path.join(plots_dir, f"surface_{i}.obj"), m)
