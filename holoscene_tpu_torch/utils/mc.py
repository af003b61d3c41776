"""Isosurface extraction: vectorized marching tetrahedra + chunked SDF-grid
evaluation (port of holoscene_tpu/utils/mc.py).

Marching tetrahedra (each cube split into 6 tets) is table-free and correct
by construction: every tet has at most one sign-crossing quad/triangle,
derived from the 16 sign cases directly. Shared vertices are welded by edge
identity so the output is watertight across cube and tet boundaries. Grids
of 64^3 points and more go to the C++ extractor (holoscene_tpu_torch/native,
built with g++ on first use; a failed build raises); the numpy path is the
reference implementation.

The SDF grid is evaluated on the device in fixed chunks of at most 262,144
points (the reference's marching-cubes batches, utils/plots.py:350): the
points of a chunk are made on the device from the grid's three float32
axes, and the values stream back to the host, where the triangulation runs.
"""

from __future__ import annotations

import numpy as np
import torch

# 6-tetrahedra decomposition of the unit cube (corner ids 0..7 with
# corner k at bits (x=k&1, y=(k>>1)&1, z=(k>>2)&1)); all share the 0-7
# diagonal, consistent orientation.
_TETS = np.array(
    [
        [0, 5, 1, 7],
        [0, 1, 3, 7],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
        [0, 4, 5, 7],
    ],
    dtype=np.int64,
)

_CORNER_OFFSETS = np.array(
    [[(k & 1), (k >> 1) & 1, (k >> 2) & 1] for k in range(8)], dtype=np.int64
)


def _edge_key(a: np.ndarray, b: np.ndarray, n_pts: int) -> np.ndarray:
    lo = np.minimum(a, b)
    hi = np.maximum(a, b)
    return lo * np.int64(n_pts) + hi


def marching_tetrahedra(
    sdf: np.ndarray,
    level: float = 0.0,
    origin=(0.0, 0.0, 0.0),
    spacing=(1.0, 1.0, 1.0),
):
    """Extract the `level` isosurface of a dense SDF grid.

    sdf: [X, Y, Z] float array. Returns (verts [V,3] float64, faces [F,3]
    int64) with outward orientation for SDF convention (negative inside).
    Grids of 64^3 points or more run the C++ extractor, which gives the
    same vertices and faces.
    """
    if np.asarray(sdf).size >= 64 ** 3:
        return _marching_tetrahedra_native(sdf, level, origin, spacing)
    sdf = np.asarray(sdf, dtype=np.float64) - level
    nx, ny, nz = sdf.shape
    if min(nx, ny, nz) < 2:
        return np.zeros((0, 3)), np.zeros((0, 3), dtype=np.int64)

    # grid-point linear ids
    def pid(ix, iy, iz):
        return (ix * ny + iy) * nz + iz

    cx, cy, cz = np.mgrid[0 : nx - 1, 0 : ny - 1, 0 : nz - 1]
    cx = cx.ravel()
    cy = cy.ravel()
    cz = cz.ravel()

    # corner point-ids and values for every cube: [Ncubes, 8]
    corner_ids = np.stack(
        [
            pid(cx + ox, cy + oy, cz + oz)
            for ox, oy, oz in _CORNER_OFFSETS
        ],
        axis=1,
    )
    corner_vals = sdf.ravel()[corner_ids]

    # quick cull: cubes with uniform sign can't produce triangles
    has_neg = (corner_vals < 0).any(axis=1)
    has_pos = (corner_vals >= 0).any(axis=1)
    active = has_neg & has_pos
    corner_ids = corner_ids[active]
    corner_vals = corner_vals[active]
    n_pts = nx * ny * nz

    tri_edges = []  # list of [M, 3, 2] (point-id pairs per triangle vertex)

    for tet in _TETS:
        tv = corner_vals[:, tet]  # [M, 4]
        tp = corner_ids[:, tet]  # [M, 4]
        inside = tv < 0  # [M, 4]
        count = inside.sum(axis=1)

        # --- one vertex inside (or outside): single triangle ---
        for flip, cnt in ((False, 1), (True, 3)):
            sel = count == cnt
            if not sel.any():
                continue
            tv_s, tp_s = tv[sel], tp[sel]
            ins = tv_s < 0 if cnt == 1 else tv_s >= 0
            apex = np.argmax(ins, axis=1)  # the lone vertex
            # the three non-apex corners, in tet order (preserves orientation)
            order = np.tile(np.arange(4), (tp_s.shape[0], 1))
            mask = order != apex[:, None]
            others = order[mask].reshape(-1, 3)
            a = tp_s[np.arange(len(tp_s)), apex][:, None]  # [m,1]
            b = np.take_along_axis(tp_s, others, axis=1)  # [m,3]
            tri = np.stack(
                [np.broadcast_to(a, b.shape), b], axis=-1
            )  # [m, 3, 2] edges apex->other
            # orientation: flip winding when the apex is the inside vertex
            # depending on apex parity within the tet
            parity = (apex + (1 if cnt == 3 else 0)) % 2 == 1
            tri_flip = tri[:, ::-1, :]
            tri = np.where(parity[:, None, None], tri_flip, tri)
            tri_edges.append(tri)

        # --- two inside: quad -> two triangles ---
        sel = count == 2
        if sel.any():
            tv_s, tp_s = tv[sel], tp[sel]
            ins = tv_s < 0
            order = np.argsort(~ins, axis=1)  # two inside first (stable)
            i0 = order[:, 0]
            i1 = order[:, 1]
            o0 = order[:, 2]
            o1 = order[:, 3]
            m = len(tp_s)
            r = np.arange(m)
            p_i0, p_i1 = tp_s[r, i0], tp_s[r, i1]
            p_o0, p_o1 = tp_s[r, o0], tp_s[r, o1]
            # quad vertices: e(i0,o0), e(i0,o1), e(i1,o1), e(i1,o0)
            e00 = np.stack([p_i0, p_o0], axis=-1)
            e01 = np.stack([p_i0, p_o1], axis=-1)
            e11 = np.stack([p_i1, p_o1], axis=-1)
            e10 = np.stack([p_i1, p_o0], axis=-1)
            t1 = np.stack([e00, e01, e11], axis=1)
            t2 = np.stack([e00, e11, e10], axis=1)
            # consistent orientation from the (i0, i1) index parity
            swap = ((i0 + i1) % 2 == 0)
            t1 = np.where(swap[:, None, None], t1[:, ::-1, :], t1)
            t2 = np.where(swap[:, None, None], t2[:, ::-1, :], t2)
            tri_edges.append(t1)
            tri_edges.append(t2)

    if not tri_edges:
        return np.zeros((0, 3)), np.zeros((0, 3), dtype=np.int64)

    tris = np.concatenate(tri_edges, axis=0)  # [T, 3, 2] point-id pairs
    flat_a = tris[..., 0].ravel()
    flat_b = tris[..., 1].ravel()
    keys = _edge_key(flat_a, flat_b, n_pts)
    uniq_keys, inverse = np.unique(keys, return_inverse=True)

    # interpolate one vertex per unique edge
    ka = (uniq_keys // n_pts).astype(np.int64)
    kb = (uniq_keys % n_pts).astype(np.int64)
    va = sdf.ravel()[ka]
    vb = sdf.ravel()[kb]
    t = va / (va - vb)
    t = np.clip(np.nan_to_num(t, nan=0.5), 0.0, 1.0)

    def unpack(p):
        iz = p % nz
        iy = (p // nz) % ny
        ix = p // (ny * nz)
        return np.stack([ix, iy, iz], axis=-1).astype(np.float64)

    pa = unpack(ka)
    pb = unpack(kb)
    verts = pa + t[:, None] * (pb - pa)
    verts = verts * np.asarray(spacing)[None, :] + np.asarray(origin)[None, :]

    faces = inverse.reshape(-1, 3)
    # drop degenerate triangles (two vertices on the same edge)
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    faces = faces[ok]

    # fix global orientation: make normals follow the SDF gradient
    verts, faces = _orient_outward(sdf, verts, faces, origin, spacing)
    return verts, faces


def _marching_tetrahedra_native(sdf, level, origin, spacing):
    """marching_tetrahedra through the C++ extractor."""
    from holoscene_tpu_torch.native import marching_tetrahedra_native

    verts, faces = marching_tetrahedra_native(np.asarray(sdf), level=level)
    if len(faces) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), dtype=np.int64)
    verts = verts * np.asarray(spacing)[None, :] + np.asarray(origin)[None, :]
    sdf64 = np.asarray(sdf, dtype=np.float64) - level
    return _orient_outward(sdf64, verts, faces, origin, spacing)


def _orient_outward(sdf, verts, faces, origin, spacing):
    """Flip faces whose normal disagrees with the local SDF gradient."""
    if len(faces) == 0:
        return verts, faces
    gx, gy, gz = np.gradient(sdf)
    centers = verts[faces].mean(axis=1)
    ij = (centers - np.asarray(origin)[None, :]) / np.asarray(spacing)[None, :]
    ij = np.clip(np.round(ij).astype(np.int64), 0, np.array(sdf.shape) - 1)
    grad = np.stack(
        [g[ij[:, 0], ij[:, 1], ij[:, 2]] for g in (gx, gy, gz)], axis=-1
    )
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    normal = np.cross(v1 - v0, v2 - v0)
    flip = np.sum(normal * grad, axis=-1) < 0
    faces = faces.copy()
    faces[flip] = faces[flip][:, ::-1]
    return verts, faces


def evaluate_grid(fn, axes, chunk: int = 262144, device="cuda") -> np.ndarray:
    """fn ([M, 3] float32 points on `device` -> [M] or [M, K] values) over
    the "ij" meshgrid of three float32 axes, at most `chunk` points a call:
    [X * Y * Z] or [X * Y * Z, K] float32 on the host, point (i, j, k) at
    row (i * Y + j) * Z + k."""
    dev = torch.device(device)
    ax = [torch.as_tensor(np.asarray(a, np.float32), device=dev)
          for a in axes]
    ny, nz = len(ax[1]), len(ax[2])
    n = len(ax[0]) * ny * nz
    out = None
    for start in range(0, n, chunk):
        i = torch.arange(start, min(start + chunk, n), device=dev)
        pts = torch.stack([ax[0][i // (ny * nz)], ax[1][(i // nz) % ny],
                           ax[2][i % nz]], -1)
        vals = fn(pts).detach().to("cpu", torch.float32).numpy()
        if out is None:
            out = np.empty((n,) + vals.shape[1:], dtype=np.float32)
        out[start:start + len(vals)] = vals
    return out


def evaluate_sdf_grid(
    sdf_fn,
    resolution: int,
    bounds=(-1.0, 1.0),
    chunk: int = 262144,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Evaluate sdf_fn ([M, 3] -> [M]) over a dense grid in device chunks.

    Returns (grid [R,R,R], origin [3], spacing [3])."""
    lo, hi = bounds
    axis = np.linspace(lo, hi, resolution, dtype=np.float32)
    vals = evaluate_grid(sdf_fn, (axis,) * 3, chunk, device)
    grid = vals.reshape(resolution, resolution, resolution)
    spacing = np.full(3, (hi - lo) / (resolution - 1))
    origin = np.full(3, lo)
    return grid, origin, spacing


def extract_mesh(
    sdf_fn,
    resolution: int = 128,
    bounds=(-1.0, 1.0),
    level: float = 0.0,
    chunk: int = 262144,
    device="cuda",
):
    """Grid-evaluate + marching tetrahedra; returns (verts, faces)."""
    grid, origin, spacing = evaluate_sdf_grid(sdf_fn, resolution, bounds,
                                              chunk, device)
    return marching_tetrahedra(grid, level=level, origin=origin,
                               spacing=spacing)
