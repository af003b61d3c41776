"""Continuous remeshing: mesh-from-multiview-normals optimization (port of
holoscene_tpu/stage2/remesh.py: the edge operations are the reference's
numpy; coarse_recon's per-view vertex gradient is autograd through the
port's rasterizer on the caller's `device`).

Reference semantics: MVMeshRecon (SURVEY.md §2 #18) — sphere-initialized
"continuous remeshing" (Palfinger 2022) driven by multiview normal maps:
vertices move under rendered-vs-target normal/mask gradients while edges are
split/collapsed/flipped to keep triangle quality; orchestrated by
`coarse_recon` (utils/general.py:3058-3174) to rebuild a mesh from
Wonder3D-generated views; the edge ops live in
MVMeshRecon/remeshing/core/remesh.py (the only unit-tested module in the
reference).

Layout here: the per-iteration vertex update (render silhouettes/normals via
the fragment-scatter rasterizer, compare to targets, gradient step with
momentum) runs on the device; the discrete
edge operations (split long edges, collapse short ones, flip for valence)
run host-side in numpy between optimization rounds — topology changes are
inherently dynamic-shape and belong on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from holoscene_tpu_torch import as_tensor
from holoscene_tpu_torch.ops.rasterizer import rasterize_mesh
from holoscene_tpu_torch.utils.mesh import Mesh


# ---------------------------------------------------------------------------
# host-side edge operations (remeshing core)
# ---------------------------------------------------------------------------


def calc_edges(faces: np.ndarray):
    """Unique undirected edges + per-face edge ids
    (reference test_calc_edges.py's contract)."""
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    e_sorted = np.sort(e, axis=1)
    edges, inverse = np.unique(e_sorted, axis=0, return_inverse=True)
    face_to_edge = inverse.reshape(3, -1).T
    return edges, face_to_edge


def calc_edge_lengths(verts: np.ndarray, edges: np.ndarray) -> np.ndarray:
    return np.linalg.norm(verts[edges[:, 0]] - verts[edges[:, 1]], axis=1)


def split_edges(verts: np.ndarray, faces: np.ndarray,
                split_mask: np.ndarray, edges: np.ndarray,
                face_to_edge: np.ndarray):
    """Split marked edges at midpoints (1->2 faces per marked edge per
    incident face; reference test_split_edges.py contract). Faces with
    multiple marked edges split on their longest marked edge only (simpler
    invariant, converges over rounds)."""
    if not split_mask.any():
        return verts, faces
    edge_mid = np.full(len(edges), -1, dtype=np.int64)
    marked = np.flatnonzero(split_mask)
    mids = (verts[edges[marked, 0]] + verts[edges[marked, 1]]) / 2
    edge_mid[marked] = len(verts) + np.arange(len(marked))
    verts = np.vstack([verts, mids])

    new_faces = []
    lengths = calc_edge_lengths(verts, edges)
    for fi, f in enumerate(faces):
        fe = face_to_edge[fi]
        m = [e for e in fe if edge_mid[e] >= 0]
        if not m:
            new_faces.append(f)
            continue
        e = max(m, key=lambda x: lengths[x])
        mid = edge_mid[e]
        a, b = edges[e]
        c = [v for v in f if v != a and v != b][0]
        # preserve winding: order (a, b) as they appear in the face cycle
        fa = list(f)
        ia = fa.index(a)
        if fa[(ia + 1) % 3] == b:
            new_faces.append([a, mid, c])
            new_faces.append([mid, b, c])
        else:
            new_faces.append([b, mid, c])
            new_faces.append([mid, a, c])
    return verts, np.asarray(new_faces, dtype=np.int64)


def collapse_edges(verts: np.ndarray, faces: np.ndarray,
                   collapse_mask: np.ndarray, edges: np.ndarray):
    """Collapse marked edges to midpoints (reference
    test_collapse_edges.py contract). Conflicting collapses (sharing a
    vertex) are dropped; degenerate faces removed."""
    if not collapse_mask.any():
        return verts, faces
    used = np.zeros(len(verts), dtype=bool)
    target = np.arange(len(verts), dtype=np.int64)
    for e in np.flatnonzero(collapse_mask):
        a, b = edges[e]
        if used[a] or used[b]:
            continue
        mid = (verts[a] + verts[b]) / 2
        verts[a] = mid
        target[b] = a
        used[a] = used[b] = True
    faces = target[faces]
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    faces = faces[ok]
    # compact vertices
    used_v = np.unique(faces)
    remap = np.full(len(verts), -1, dtype=np.int64)
    remap[used_v] = np.arange(len(used_v))
    return verts[used_v], remap[faces]


def flip_edges(verts: np.ndarray, faces: np.ndarray):
    """Valence-improving edge flips (reference test_flip_edges.py contract):
    flip an interior edge when it reduces total squared valence deviation
    from 6."""
    edges, face_to_edge = calc_edges(faces)
    # map edge -> the (up to 2) incident faces
    edge_faces: dict[int, list[int]] = {}
    for fi in range(len(faces)):
        for e in face_to_edge[fi]:
            edge_faces.setdefault(int(e), []).append(fi)

    valence = np.zeros(len(verts), dtype=np.int64)
    np.add.at(valence, faces.ravel(), 1)

    faces = faces.copy()
    touched = np.zeros(len(faces), dtype=bool)
    for e, flist in edge_faces.items():
        if len(flist) != 2:
            continue
        f0, f1 = flist
        if touched[f0] or touched[f1]:
            continue
        a, b = edges[e]
        c = [v for v in faces[f0] if v != a and v != b][0]
        d = [v for v in faces[f1] if v != a and v != b][0]
        if c == d:
            continue
        dev = lambda v: (valence[v] - 6) ** 2
        before = dev(a) + dev(b) + dev(c) + dev(d)
        valence_after = valence.copy()
        valence_after[[a, b]] -= 1
        valence_after[[c, d]] += 1
        after = sum((valence_after[v] - 6) ** 2 for v in (a, b, c, d))
        if after < before:
            # rebuild the two faces around edge (c, d), keep orientation of f0
            fa = list(faces[f0])
            ia = fa.index(a)
            if fa[(ia + 1) % 3] == b:
                faces[f0] = [a, d, c]
                faces[f1] = [b, c, d]
            else:
                faces[f0] = [a, c, d]
                faces[f1] = [b, d, c]
            valence = valence_after
            touched[f0] = touched[f1] = True
    return verts, faces


def remesh_step(verts: np.ndarray, faces: np.ndarray, target_edge_len: float):
    """One split/collapse/flip round toward uniform edge length
    (reference remeshing core loop)."""
    edges, f2e = calc_edges(faces)
    lengths = calc_edge_lengths(verts, edges)
    verts, faces = split_edges(
        verts.copy(), faces, lengths > 1.33 * target_edge_len, edges, f2e
    )
    edges, _ = calc_edges(faces)
    lengths = calc_edge_lengths(verts, edges)
    verts, faces = collapse_edges(
        verts.copy(), faces, lengths < 0.66 * target_edge_len, edges
    )
    verts, faces = flip_edges(verts, faces)
    return verts, faces


# ---------------------------------------------------------------------------
# sphere init + normal-driven optimization (coarse_recon)
# ---------------------------------------------------------------------------


def icosphere(radius: float = 1.0, center=(0, 0, 0), subdivisions: int = 3):
    """Icosahedron subdivision sphere (the reference's sphere init)."""
    t = (1 + np.sqrt(5)) / 2
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    for _ in range(subdivisions):
        edges = np.concatenate(
            [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]
        )
        edges = np.sort(edges, axis=1)
        uniq, inv = np.unique(edges, axis=0, return_inverse=True)
        mid_ids = len(verts) + np.arange(len(uniq))
        verts = np.vstack([verts, verts[uniq].mean(axis=1)])
        f = len(faces)
        m01 = mid_ids[inv[:f]]
        m12 = mid_ids[inv[f : 2 * f]]
        m20 = mid_ids[inv[2 * f :]]
        faces = np.concatenate(
            [
                np.stack([faces[:, 0], m01, m20], 1),
                np.stack([faces[:, 1], m12, m01], 1),
                np.stack([faces[:, 2], m20, m12], 1),
                np.stack([m01, m12, m20], 1),
            ]
        )
        verts = verts / np.linalg.norm(verts, axis=1, keepdims=True)
    verts = verts / np.linalg.norm(verts, axis=1, keepdims=True)
    return Mesh(verts * radius + np.asarray(center), faces)


@dataclasses.dataclass(frozen=True)
class CoarseReconConfig:
    iters: int = 200
    remesh_every: int = 50
    lr: float = 0.05
    normal_weight: float = 1.0
    mask_weight: float = 1.0
    laplacian_weight: float = 0.4
    img_res: int = 96


def resize_bilinear(img: np.ndarray, res) -> np.ndarray:
    """[H, W] or [H, W, C] float32 -> [res, res(, C)] (res an int) or
    [h, w(, C)] (res = (h, w)): jax.image.resize's "bilinear" (half-pixel
    centres, a triangle kernel widened by the scale when it downsamples,
    i.e. antialiased)."""
    size = (res, res) if isinstance(res, int) else tuple(res)
    t = torch.from_numpy(np.ascontiguousarray(img, dtype=np.float32))
    t = t[None, None] if t.ndim == 2 else t.permute(2, 0, 1)[None]
    out = F.interpolate(t, size=size, mode="bilinear",
                        align_corners=False, antialias=True)[0]
    return (out[0] if img.ndim == 2 else out.permute(1, 2, 0)).numpy()


def view_grad(verts: np.ndarray, faces: np.ndarray, view: dict,
              cfg: CoarseReconConfig, device) -> np.ndarray:
    """d loss / d vertices [V, 3] (float32) of one view pack: the silhouette
    MSE (no gradient: the mask is a step function), the face normals at
    covered pixels against the target normals (camera frame), and uniform
    Laplacian smoothing; autograd through rasterize_mesh's pix_verts
    without the screen-size split (JAX traces this function, and a traced
    call skips the split)."""
    dev = torch.device(device)
    v = torch.tensor(np.asarray(verts, np.float32), device=dev,
                     requires_grad=True)
    faces_t = as_tensor(faces, dev, torch.int64)
    pose = as_tensor(view["pose"], dev)
    tgt_normal = as_tensor(view["normal"], dev)
    tgt_mask = as_tensor(view["mask"], dev)
    out = rasterize_mesh(v, faces_t, pose, None, (cfg.img_res, cfg.img_res),
                         ortho_half_extent=float(view["half_extent"]),
                         device=dev, auto_subdivide=False)
    mask = out["mask"].to(torch.float32)
    mask_l = ((mask - tgt_mask) ** 2).mean()
    tri = out["pix_verts"]
    n = torch.cross(tri[..., 1, :] - tri[..., 0, :],
                    tri[..., 2, :] - tri[..., 0, :], dim=-1)
    n = n / torch.sqrt((n * n).sum(-1, keepdim=True) + 1e-12)
    n_cam = n @ pose[:3, :3]
    both = (mask * tgt_mask)[..., None]
    normal_l = (both * (n_cam - tgt_normal) ** 2).sum() \
        / torch.clamp(both.sum() * 3, min=1.0)
    e0, e1, e2 = v[faces_t[:, 0]], v[faces_t[:, 1]], v[faces_t[:, 2]]
    lap = ((e0 - e1) ** 2 + (e1 - e2) ** 2 + (e2 - e0) ** 2).mean()
    loss = (cfg.mask_weight * mask_l + cfg.normal_weight * normal_l
            + cfg.laplacian_weight * lap)
    (g,) = torch.autograd.grad(loss, v)
    return g.cpu().numpy()


def coarse_recon(
    views: list[dict],
    center: np.ndarray,
    radius: float,
    cfg: CoarseReconConfig = CoarseReconConfig(),
    seed: int = 0,
    device="cuda",
) -> Mesh:
    """Rebuild a coarse mesh from generated views (reference coarse_recon,
    utils/general.py:3058-3174: sphere init -> continuous remeshing against
    multiview normals/masks -> cleaned mesh).

    views: vis_info-style packs {pose [4,4] c2w, half_extent, normal [H,W,3]
    camera-frame, mask [H,W]} at ANY resolution — targets are resampled to
    cfg.img_res (generated views ship at the provider's img_size, e.g. 128
    or 256). The vertex gradients run on `device`.
    """
    res = cfg.img_res
    resized = []
    for v in views:
        n = np.asarray(v["normal"], np.float32)
        mk = np.asarray(v["mask"], np.float32)
        if n.shape[:2] != (res, res):
            n = resize_bilinear(n, res)
            n = n / np.maximum(
                np.linalg.norm(n, axis=-1, keepdims=True), 1e-8)
        if mk.shape != (res, res):
            mk = (resize_bilinear(mk, res) > 0.5).astype(np.float32)
        resized.append({**v, "normal": n, "mask": mk})
    views = resized

    mesh = icosphere(radius * 0.7, center, subdivisions=1)
    verts = mesh.vertices
    faces = mesh.faces
    target_edge = radius / 8

    rng = np.random.default_rng(seed)
    m = np.zeros_like(verts)  # momentum
    for it in range(cfg.iters):
        view = views[int(rng.integers(len(views)))]
        g = view_grad(verts, faces, view, cfg, device)
        m = 0.9 * m + g
        verts = verts - cfg.lr * m
        # hard trust region: the object lives inside the generated views'
        # ortho volume by construction — unclamped SGD+momentum on a
        # degenerate view once blasted vertices to +-5000 scene units
        lo = np.asarray(center) - 2.0 * radius
        hi = np.asarray(center) + 2.0 * radius
        np.clip(verts, lo, hi, out=verts)
        if (it + 1) % cfg.remesh_every == 0 and it < cfg.iters - 1:
            verts, faces = remesh_step(verts, faces, target_edge)
            m = np.zeros_like(verts)
    return Mesh(verts, faces).largest_component()
