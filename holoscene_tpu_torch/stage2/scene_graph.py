"""Scene-graph inference from meshes + intersection resolution (the port's
own copy of holoscene_tpu/stage2/scene_graph.py: numpy / scipy on the host).

Reference semantics: utils/general.py —
  * create_scene_graph_from_meshes (:4015) / mesh adjacency (:3856): objects
    are adjacent when their surfaces come within a contact threshold; the
    background (object 0) is the root; a BFS tree gives parent/desc/layer
    (consumed by update_graph_node_dict, training/holoscene_train_post.py:4041);
  * detect_collision / pair_mesh_collision (:3269, :3369): point-sample
    penetration tests;
  * solve_intersection (:3797, :3970): iteratively push intersecting objects
    apart along mean contact normals -> translation_dict.

The penetration test here uses sampled surface points against the other
mesh's interior, decided by ray-parity (even-odd crossings along +x),
replacing open3d's raycasting scene.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from holoscene_tpu_torch.datasets.ns_dataset import extract_graph_node_properties
from holoscene_tpu_torch.utils.mesh import Mesh


def points_inside_mesh(points: np.ndarray, mesh: Mesh,
                       chunk: int = 2048) -> np.ndarray:
    """Even-odd ray-crossing test along +x. points [N,3] -> bool [N].

    Ray origins are nudged by an irrational-ish epsilon in y/z so rays never
    pass exactly through shared triangle edges (which would double-count
    crossings in the parity test)."""
    v = mesh.vertices
    corners = [v[mesh.faces[:, k]] for k in range(3)]   # 3 x [F, 3]
    # triangle bboxes for quick culling (the reference's tri.min(axis=1) /
    # tri.max(axis=1) of tri = v[faces], without the [F, 3, 3] copy)
    tri_min = np.minimum(np.minimum(corners[0], corners[1]), corners[2])
    tri_max = np.maximum(np.maximum(corners[0], corners[1]), corners[2])
    scale = float(np.linalg.norm(tri_max.max(axis=0) - tri_min.min(axis=0)))
    points = np.asarray(points, dtype=np.float64) + np.array(
        [0.0, 1.37e-5, 2.71e-5]
    ) * max(scale, 1e-6)
    n = len(points)
    inside = np.zeros(n, dtype=bool)

    for i0 in range(0, n, chunk):
        p = points[i0 : i0 + chunk]  # [M, 3]
        # candidate (point, face) pairs: bbox overlap in y/z and
        # max_x >= p_x (the reference tests every pair of an [M, F]
        # broadcast; the same pairs come from a y/z grid here)
        mi, fi = _candidate_pairs(p, tri_min, tri_max)
        if len(mi) == 0:
            continue
        orig = p[mi]
        a, b, c = (corner[fi] for corner in corners)
        e1 = b - a
        e2 = c - a
        # dir = (1,0,0): h = dir x e2 = (0, -e2z, e2y)
        h = np.stack([np.zeros(len(fi)), -e2[:, 2], e2[:, 1]], axis=1)
        det = np.sum(e1 * h, axis=1)
        ok = np.abs(det) > 1e-12
        inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
        s = orig - a
        u = np.sum(s * h, axis=1) * inv
        q = np.cross(s, e1)
        vv = q[:, 0] * inv  # dot(dir, q) with dir=+x
        t = np.sum(e2 * q, axis=1) * inv
        hit = ok & (u >= 0) & (u <= 1) & (vv >= 0) & (u + vv <= 1) & (t > 1e-9)
        counts = np.bincount(mi[hit], minlength=len(p))
        inside[i0 : i0 + len(p)] = counts % 2 == 1
    return inside


def _candidate_pairs(p: np.ndarray, tri_min: np.ndarray,
                     tri_max: np.ndarray, grid: int = 32):
    """Every (point, face) pair with the point inside the face's y/z box
    and p_x <= the face's max x, as (point index, face index) arrays in no
    particular order. The points are binned on a grid x grid lattice over
    their y/z box and each face meets only the cells its box covers, so
    the work follows the pairs that overlap, not points x faces (a small
    object against a room mesh of a million faces)."""
    lo, hi = p[:, 1:].min(axis=0), p[:, 1:].max(axis=0)
    near = np.flatnonzero(
        np.all(tri_max[:, 1:] >= lo, axis=1)
        & np.all(tri_min[:, 1:] <= hi, axis=1)
        & (tri_max[:, 0] >= p[:, 0].min())
    )
    span = np.maximum(hi - lo, 1e-12)

    def cell(v):
        return np.clip(np.floor((v - lo) / span * grid).astype(np.int64),
                       0, grid - 1)

    pc = cell(p[:, 1:])
    pid = pc[:, 0] * grid + pc[:, 1]
    order = np.argsort(pid, kind="stable")
    counts = np.bincount(pid, minlength=grid * grid)
    starts = np.cumsum(counts) - counts
    c0, c1 = cell(tri_min[near, 1:]), cell(tri_max[near, 1:])
    nz = c1[:, 1] - c0[:, 1] + 1
    n_cells = (c1[:, 0] - c0[:, 0] + 1) * nz
    f_rep = np.repeat(np.arange(len(near)), n_cells)
    k = np.arange(len(f_rep)) - np.repeat(np.cumsum(n_cells) - n_cells,
                                          n_cells)
    cid = (c0[f_rep, 0] + k // nz[f_rep]) * grid + c0[f_rep, 1] + k % nz[f_rep]
    cnt = counts[cid]
    j = np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    mi = order[np.repeat(starts[cid], cnt) + j]
    fi = near[np.repeat(f_rep, cnt)]
    ok = (
        (p[mi, 1] >= tri_min[fi, 1]) & (p[mi, 1] <= tri_max[fi, 1])
        & (p[mi, 2] >= tri_min[fi, 2]) & (p[mi, 2] <= tri_max[fi, 2])
        & (p[mi, 0] <= tri_max[fi, 0])
    )
    return mi[ok], fi[ok]


def pair_mesh_collision(
    mesh_a: Mesh, mesh_b: Mesh, n_samples: int = 2000, seed: int = 0
) -> tuple[bool, np.ndarray, float]:
    """Does A penetrate B? Returns (collides, mean push-out direction for A,
    penetration depth estimate) (reference pair_mesh_collision,
    utils/general.py:3369)."""
    if len(mesh_a.faces) == 0 or len(mesh_b.faces) == 0:
        return False, np.zeros(3), 0.0
    rng = np.random.default_rng(seed)
    pts = mesh_a.sample_surface(n_samples, rng)
    inside = points_inside_mesh(pts, mesh_b)
    if not inside.any():
        return False, np.zeros(3), 0.0
    pen_pts = pts[inside]
    # push direction: from B's surface toward the penetrating points' mean
    b_pts = mesh_b.sample_surface(min(20000, 10 * n_samples), rng)
    tree = cKDTree(b_pts)
    d, idx = tree.query(pen_pts, k=1)
    dirs = pen_pts - b_pts[idx]
    norms = np.linalg.norm(dirs, axis=1, keepdims=True)
    dirs = dirs / np.maximum(norms, 1e-12)
    # penetrating points sit INSIDE b, so push A along -mean(dir to surface)
    push = -dirs.mean(axis=0)
    push_n = np.linalg.norm(push)
    push = push / max(push_n, 1e-12)
    depth = float(d.mean())
    return True, push, depth


def mesh_contact_distance(mesh_a: Mesh, mesh_b: Mesh, n_samples: int = 3000,
                          seed: int = 0) -> float:
    rng = np.random.default_rng(seed)
    pa = mesh_a.sample_surface(n_samples, rng)
    pb = mesh_b.sample_surface(n_samples, rng)
    tree = cKDTree(pb)
    d, _ = tree.query(pa, k=1)
    return float(d.min())


def create_scene_graph_from_meshes(
    meshes: list[Mesh | None],
    contact_threshold: float = 0.02,
) -> dict[int, dict]:
    """Adjacency from surface proximity -> BFS tree rooted at the background
    (reference create_scene_graph_from_meshes, utils/general.py:4015;
    consumed like graph.json via extract_graph_node_properties)."""
    n = len(meshes)
    adjacency: list[dict] = [
        {"node_id": i, "adj_nodes": []} for i in range(n)
    ]
    for i in range(n):
        if meshes[i] is None:
            continue
        for j in range(i + 1, n):
            if meshes[j] is None:
                continue
            if mesh_contact_distance(meshes[i], meshes[j]) < contact_threshold:
                adjacency[i]["adj_nodes"].append(j)
                adjacency[j]["adj_nodes"].append(i)
    # guarantee connectivity to the root: attach orphans to the background
    for i in range(1, n):
        if meshes[i] is not None and not adjacency[i]["adj_nodes"]:
            adjacency[i]["adj_nodes"].append(0)
            adjacency[0]["adj_nodes"].append(i)
    return extract_graph_node_properties(adjacency)


def solve_intersection(
    meshes: list[Mesh | None],
    graph_node_dict: dict[int, dict] | None = None,
    max_iters: int = 20,
    step_scale: float = 0.6,
) -> dict[int, np.ndarray]:
    """Iteratively translate objects out of their ancestors/siblings
    (reference solve_intersection, utils/general.py:3797/:3970 ->
    translation_dict.pkl). Objects are processed by distance-to-root so
    supports move before the things resting on them."""
    n = len(meshes)
    translations = {i: np.zeros(3) for i in range(n)}
    if graph_node_dict is None:
        graph_node_dict = create_scene_graph_from_meshes(meshes)

    order = sorted(
        (i for i in range(1, n) if meshes[i] is not None),
        key=lambda i: graph_node_dict.get(i, {}).get("dist_to_root", 1),
    )
    current = {
        i: (meshes[i].copy() if meshes[i] is not None else None)
        for i in range(n)
    }
    for obj_i in order:
        others = [
            j for j in range(n)
            if j != obj_i and current[j] is not None
        ]
        for _ in range(max_iters):
            moved = False
            for j in others:
                collides, push, depth = pair_mesh_collision(
                    current[obj_i], current[j]
                )
                if collides and depth > 1e-5:
                    delta = push * depth * step_scale
                    translations[obj_i] = translations[obj_i] + delta
                    current[obj_i] = current[obj_i].apply_translation(delta)
                    moved = True
            if not moved:
                break
    return translations
