"""Chart-packed UV atlas for Stage-3 texture baking (the port's copy of
holoscene_tpu/utils/uv_atlas.py, numpy only).

  1. CHART GROWTH: breadth-first over face adjacency from the lowest
     unassigned face, admitting faces whose normal stays inside a cone
     around the seed normal (cos > `cos_thresh`) up to `max_chart_faces`.
  2. PARAMETERIZATION: orthographic projection of each chart onto its
     seed-normal plane, vertices split per face.
  3. PACKING: charts become axis-aligned rects (+gutter) at one global
     texel density, shelf-packed tallest-first; the density backs off
     geometrically until everything fits the atlas.

The reference builds the adjacency with a dict of edges and grows each
chart with Python loops over faces, which takes minutes on a 1.9M-face
room. Here the adjacency is one CSR array built by sorting, in the
reference's order (edges by first appearance, then the faces on an edge
in face order), and a chart grows one breadth-first level at a time with
array operations: the candidates of a level are the frontier's neighbours
in the reference's visiting order, and the first occurrence of each
admitted face is kept up to the cap, which is the order in which the
reference's loop appends them. The charts, and so the atlas, are the
reference's.
"""

from __future__ import annotations

import numpy as np


def face_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
    e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
    n = np.cross(e1, e2)
    return n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)


def face_adjacency(faces: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Adjacent-over-an-edge faces as CSR (ptr [F+1], nbr): face i's
    neighbours are nbr[ptr[i]:ptr[i+1]], in the order of the reference's
    lists (edges in order of first appearance over (f0, f1), (f1, f2),
    (f2, f0) of each face; on an edge, the other faces in face order, and
    for every occurrence of face i on the edge once)."""
    f = np.asarray(faces, dtype=np.int64)
    n_f = len(f)
    a = f.reshape(-1)
    b = f[:, [1, 2, 0]].reshape(-1)
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    key = lo * (int(hi.max(initial=0)) + 1) + hi
    _, first, inv = np.unique(key, return_index=True, return_inverse=True)
    rank = np.empty(len(first), dtype=np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(first))
    g = rank[inv]                       # edge rank of each half-edge
    order = np.lexsort((np.arange(len(g)), g))
    gs = g[order]
    starts = np.flatnonzero(np.r_[True, gs[1:] != gs[:-1]])
    sizes = np.diff(np.r_[starts, len(gs)])
    size_of = np.repeat(sizes, sizes)
    start_of = np.repeat(starts, sizes)
    pos = np.arange(len(gs)) - start_of
    # every ordered pair (member p, member q) of each edge's member list
    rep = np.repeat(np.arange(len(gs)), size_of)
    q = np.arange(len(rep)) - np.repeat(np.cumsum(size_of) - size_of, size_of)
    fi = order[rep] // 3
    fj = order[start_of[rep] + q] // 3
    keep = fi != fj
    fi, fj = fi[keep], fj[keep]
    srt = np.lexsort((q[keep], pos[rep][keep], gs[rep][keep], fi))
    nbr = fj[srt]
    ptr = np.zeros(n_f + 1, dtype=np.int64)
    np.cumsum(np.bincount(fi, minlength=n_f), out=ptr[1:])
    return ptr, nbr


def grow_charts(
    verts: np.ndarray,
    faces: np.ndarray,
    cos_thresh: float = 0.8,
    max_chart_faces: int = 4096,
) -> list[np.ndarray]:
    """Partition faces into normal-cone charts. Returns a list of
    face-index arrays (seed first, then each breadth-first level)."""
    normals = face_normals(verts, faces)
    ptr, nbr = face_adjacency(faces)
    n_f = len(faces)
    assigned = np.full(n_f, -1, dtype=np.int64)
    charts: list[np.ndarray] = []
    seed = 0
    while True:
        while seed < n_f and assigned[seed] >= 0:
            seed += 1
        if seed == n_f:
            break
        ci = len(charts)
        seed_n = normals[seed]
        assigned[seed] = ci
        parts = [np.array([seed], dtype=np.int64)]
        count = 1
        frontier = parts[0]
        while len(frontier) and count < max_chart_faces:
            lo, hi = ptr[frontier], ptr[frontier + 1]
            lens = hi - lo
            idx = np.repeat(lo - np.cumsum(lens) + lens, lens) \
                + np.arange(int(lens.sum()))
            cand = nbr[idx]
            cand = cand[assigned[cand] < 0]
            cand = cand[normals[cand] @ seed_n > cos_thresh]
            _, first = np.unique(cand, return_index=True)
            cand = cand[np.sort(first)][:max_chart_faces - count]
            assigned[cand] = ci
            parts.append(cand)
            count += len(cand)
            frontier = cand
        charts.append(np.concatenate(parts))
    return charts


def _plane_basis(n: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    a = np.array([1.0, 0.0, 0.0])
    if abs(n @ a) > 0.9:
        a = np.array([0.0, 1.0, 0.0])
    u = np.cross(n, a)
    u /= max(np.linalg.norm(u), 1e-12)
    v = np.cross(n, u)
    return u, v


def build_chart_atlas(
    verts: np.ndarray,
    faces: np.ndarray,
    tex_res: int,
    cos_thresh: float = 0.8,
    max_chart_faces: int = 4096,
    gutter_px: float = 2.0,
    fill_margin: float = 1.35,
):
    """Returns (tri_verts [F*3,3], new_faces [F,3], uv_px [F*3,2] atlas
    pixel coords, n_charts, tex_res); tex_res may have been grown when the
    requested atlas could not hold the chart count. Vertices are split per
    face (UVs are chart-continuous, so bilinear sampling has no
    intra-chart seams)."""
    verts = np.asarray(verts, dtype=np.float64)
    faces = np.asarray(faces, dtype=np.int64)
    charts = grow_charts(verts, faces, cos_thresh, max_chart_faces)
    normals = face_normals(verts, faces)

    # feasibility: the gutters alone must fit; grow the atlas otherwise
    min_area = len(charts) * (2.0 * gutter_px + 2.0) ** 2 * 1.5
    while tex_res ** 2 < min_area and tex_res < 8192:
        tex_res *= 2

    # project each chart to 2D (world units)
    chart_uv: list[np.ndarray] = []   # per chart: [Fc, 3, 2]
    sizes = []
    for c in charts:
        n = normals[c[0]]
        u, v = _plane_basis(n)
        p = verts[faces[c]]           # [Fc, 3, 3]
        uv = np.stack([p @ u, p @ v], axis=-1)
        lo = uv.reshape(-1, 2).min(axis=0)
        uv = uv - lo
        chart_uv.append(uv)
        sizes.append(uv.reshape(-1, 2).max(axis=0))
    sizes = np.asarray(sizes)         # [C, 2] world units

    # global density: fit total area with margin, then shelf-pack with
    # geometric back-off
    area = float((sizes[:, 0] * sizes[:, 1]).sum()) + 1e-12
    usable = tex_res - 2 * gutter_px
    density = usable / np.sqrt(area * fill_margin)
    for _attempt in range(60):
        wh = sizes * density + 2 * gutter_px
        order = np.argsort(-wh[:, 1])
        origins = np.zeros((len(charts), 2))
        x = y = shelf_h = 0.0
        ok = True
        for ci in order:
            w, h = wh[ci]
            if w > tex_res or h > tex_res:
                ok = False
                break
            if x + w > tex_res:
                x = 0.0
                y += shelf_h
                shelf_h = 0.0
            if y + h > tex_res:
                ok = False
                break
            origins[ci] = (x, y)
            x += w
            shelf_h = max(shelf_h, h)
        if ok:
            break
        density *= 0.9
    else:
        raise RuntimeError("atlas packing failed to converge")

    f_total = len(faces)
    uv_px = np.zeros((f_total, 3, 2))
    for ci, c in enumerate(charts):
        uv_px[c] = (
            chart_uv[ci] * density + origins[ci][None, None] + gutter_px
        )

    tri_verts = verts[faces].reshape(-1, 3).astype(np.float32)
    new_faces = np.arange(f_total * 3).reshape(-1, 3)
    return tri_verts, new_faces, uv_px.reshape(-1, 2), len(charts), tex_res
