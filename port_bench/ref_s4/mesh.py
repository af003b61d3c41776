# Frozen copy of holoscene_tpu_torch/utils/mesh.py at commit badb067, for the
# benchmark's plain reference: imports rewired to port_bench.ref_s4, cut to
# the paths the benchmark's Stage-4 configuration runs, in plain PyTorch.
# Do not edit to follow the port.
"""Host-side mesh container (the port's copy of holoscene_tpu/utils/mesh.py,
cut to the container the Stage-4 seeding and raster read)."""

from __future__ import annotations

import numpy as np


class Mesh:
    """Minimal triangle mesh: verts [V,3] f64, faces [F,3] i64, optional
    per-vertex colors [V,3] u8 and UVs [V,2]."""

    def __init__(self, vertices, faces, vertex_colors=None, uvs=None):
        self.vertices = np.asarray(vertices, dtype=np.float64).reshape(-1, 3)
        self.faces = np.asarray(faces, dtype=np.int64).reshape(-1, 3)
        self.vertex_colors = (
            None if vertex_colors is None else np.asarray(vertex_colors)
        )
        self.uvs = None if uvs is None else np.asarray(uvs)
