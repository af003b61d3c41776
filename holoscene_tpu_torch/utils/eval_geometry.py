"""Geometry metrics: chamfer accuracy / completion / completion-ratio + ICP,
and the depth-render metric (port of holoscene_tpu/utils/eval_geometry.py;
numpy and scipy, the depth renders through the port's rasterizer on the
caller's device).

Reference semantics: utils/eval_geometry.py:26-210 (nice-slam style) —
  accuracy        = mean_{p in rec} min_{q in gt} ||p - q||
  completion      = mean_{q in gt}  min_{p in rec} ||q - p||
  completion_ratio= mean_{q in gt}  [min dist < tau]   (tau = 5 cm)
with an optional point-to-point ICP alignment of rec onto gt before scoring.
scipy cKDTree replaces open3d.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from holoscene_tpu_torch.utils.mesh import Mesh


def nn_distances(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    tree = cKDTree(dst)
    d, _ = tree.query(src, k=1)
    return d


def accuracy(rec_pts: np.ndarray, gt_pts: np.ndarray) -> float:
    return float(nn_distances(rec_pts, gt_pts).mean())


def completion(rec_pts: np.ndarray, gt_pts: np.ndarray) -> float:
    return float(nn_distances(gt_pts, rec_pts).mean())


def completion_ratio(rec_pts: np.ndarray, gt_pts: np.ndarray,
                     dist_th: float = 0.05) -> float:
    return float((nn_distances(gt_pts, rec_pts) < dist_th).mean())


def icp_align(
    src: np.ndarray,
    dst: np.ndarray,
    iterations: int = 20,
    threshold: float = 0.1,
) -> np.ndarray:
    """Point-to-point ICP; returns a 4x4 transform mapping src -> dst
    (reference eval_geometry.py:54-110 uses open3d ICP)."""
    T = np.eye(4)
    cur = src.copy()
    tree = cKDTree(dst)
    for _ in range(iterations):
        d, idx = tree.query(cur, k=1)
        mask = d < threshold
        if mask.sum() < 10:
            break
        p = cur[mask]
        q = dst[idx[mask]]
        pc = p - p.mean(0)
        qc = q - q.mean(0)
        h = pc.T @ qc
        u, _, vt = np.linalg.svd(h)
        d_sign = np.sign(np.linalg.det(vt.T @ u.T))
        r = vt.T @ np.diag([1, 1, d_sign]) @ u.T
        t = q.mean(0) - r @ p.mean(0)
        step = np.eye(4)
        step[:3, :3] = r
        step[:3, 3] = t
        cur = cur @ r.T + t
        T = step @ T
    return T


def _pca_obb(pts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """PCA-oriented bounding box: returns (extents [3], transform [4,4])
    mapping the unit box frame into world space (the deterministic analog
    of the reference's trimesh.bounds.oriented_bounds at
    eval_geometry.py:212-219 — minimal-volume vs principal-axes makes no
    difference for sampling interior camera positions)."""
    mean = pts.mean(0)
    cov = np.cov((pts - mean).T)
    _, vecs = np.linalg.eigh(cov)
    vecs = vecs[:, ::-1]  # major axis first, like oriented_bounds
    if np.linalg.det(vecs) < 0:
        vecs[:, 2] *= -1
    local = (pts - mean) @ vecs
    lo, hi = local.min(0), local.max(0)
    extents = hi - lo
    center = mean + vecs @ ((lo + hi) / 2)
    t = np.eye(4)
    t[:3, :3] = vecs
    t[:3, 3] = center
    return extents, t


def _viewmatrix(forward: np.ndarray, up: np.ndarray,
                pos: np.ndarray) -> np.ndarray:
    """c2w with columns [right, up', forward, pos]
    (reference eval_geometry.py:17-23)."""
    z = forward / max(np.linalg.norm(forward), 1e-9)
    x = np.cross(up, z)
    x = x / max(np.linalg.norm(x), 1e-9)
    y = np.cross(z, x)
    m = np.eye(4)
    m[:3, :3] = np.stack([x, y, z], 1)
    m[:3, 3] = pos
    return m


def _sees_points(points: np.ndarray, c2w: np.ndarray, intr: np.ndarray,
                 width: int, height: int) -> bool:
    """True if any point projects inside the image with positive depth
    (reference check_proj, eval_geometry.py:71-100)."""
    if points is None or len(points) == 0:
        return False
    w2c = np.linalg.inv(c2w)
    cam = points @ w2c[:3, :3].T + w2c[:3, 3]
    z = cam[:, 2]
    uv = cam @ intr.T
    u = uv[:, 0] / np.maximum(uv[:, 2], 1e-5)
    v = uv[:, 1] / np.maximum(uv[:, 2], 1e-5)
    inside = (z > 0) & (u >= 0) & (u < width) & (v >= 0) & (v < height)
    return bool(inside.any())


def calc_2d_metric(
    rec_mesh: Mesh,
    gt_mesh: Mesh,
    pc_unseen: np.ndarray | None = None,
    n_imgs: int = 100,
    img_res: tuple[int, int] = (500, 500),
    focal: float = 300.0,
    align: bool = False,
    seed: int = 0,
    max_tries: int = 50,
    device="cuda",
) -> dict:
    """2D reconstruction metric: depth-render L1 from random interior views
    (reference utils/eval_geometry.py:222-300).

    Cameras are sampled uniformly inside the gt mesh's oriented bounding
    box (extents shrunk [0.3, 0.7, 0.7], lifted 0.4 along the box's minor
    axis — the reference's get_cam_position), looking at a random target
    with up = [0, 0, -1]; views that would see any `pc_unseen` point (gt
    regions unobserved by the capture) are rejected and resampled. Both
    meshes are depth-rendered with ops/rasterizer.py (the open3d
    visualizer's offscreen depth-buffer analog, on `device`; empty pixels
    read 0 like capture_depth_float_buffer) and scored as mean |gt - rec|
    per view.

    Returns {"depth_l1": meters, "depth_l1_cm": cm, "n_views": used}.
    The reference defaults to n_imgs=1000 at 500x500; this default (100)
    keeps the estimator's std well under the inter-method gaps it judges.
    """
    from holoscene_tpu_torch.ops.rasterizer import BIG_DEPTH, rasterize_mesh

    rng = np.random.default_rng(seed)
    height, width = img_res
    cx, cy = width / 2.0 - 0.5, height / 2.0 - 0.5
    intr = np.array(
        [[focal, 0, cx], [0, focal, cy], [0, 0, 1]], dtype=np.float64)

    rec_v, rec_f = np.asarray(rec_mesh.vertices), np.asarray(rec_mesh.faces)
    gt_v, gt_f = np.asarray(gt_mesh.vertices), np.asarray(gt_mesh.faces)
    if align:
        rng_a = np.random.default_rng(seed)
        rec_pts = rec_mesh.sample_surface(20000, rng_a)
        gt_pts = gt_mesh.sample_surface(20000, rng_a)
        T = icp_align(rec_pts, gt_pts)
        rec_v = rec_v @ T[:3, :3].T + T[:3, 3]

    extents, transform = _pca_obb(gt_v)
    extents = extents * np.array([0.3, 0.7, 0.7])
    transform = transform.copy()
    transform[:3, 3] += transform[:3, 2] * 0.4

    up = np.array([0.0, 0.0, -1.0])

    def render_depth(v, f, c2w):
        out = rasterize_mesh(v, f, c2w, intr, (height, width), device=device)
        d = out["depth"].cpu().numpy()
        return np.where(d >= BIG_DEPTH * 0.5, 0.0, d)  # empty -> 0 (o3d)

    errors = []
    for _ in range(n_imgs):
        c2w = None
        for _try in range(max_tries):
            local = rng.uniform(-0.5, 0.5, 3) * extents
            origin = transform[:3, :3] @ local + transform[:3, 3]
            target = rng.uniform(-10000, 10000, 3)
            fwd = target - origin
            if np.linalg.norm(np.cross(up, fwd)) < 1e-6:
                continue
            cand = _viewmatrix(fwd, up, origin)
            if not _sees_points(pc_unseen, cand, intr, width, height):
                c2w = cand
                break
        if c2w is None:
            continue
        gt_d = render_depth(gt_v, gt_f, c2w)
        rec_d = render_depth(rec_v, rec_f, c2w)
        errors.append(float(np.abs(gt_d - rec_d).mean()))

    mean_err = float(np.mean(errors)) if errors else float("nan")
    return {
        "depth_l1": mean_err,
        "depth_l1_cm": mean_err * 100.0,
        "n_views": len(errors),
    }


def calc_3d_metric(
    rec_mesh: Mesh,
    gt_mesh: Mesh,
    n_samples: int = 200000,
    dist_th: float = 0.05,
    align: bool = True,
    seed: int = 0,
) -> dict:
    """Chamfer metric dict (reference eval_geometry.py:113-210)."""
    rng = np.random.default_rng(seed)
    rec_pts = rec_mesh.sample_surface(n_samples, rng)
    gt_pts = gt_mesh.sample_surface(n_samples, rng)
    if align:
        T = icp_align(rec_pts[:20000], gt_pts[:20000])
        rec_pts = rec_pts @ T[:3, :3].T + T[:3, 3]
    return {
        "accuracy": accuracy(rec_pts, gt_pts),
        "completion": completion(rec_pts, gt_pts),
        "completion_ratio": completion_ratio(rec_pts, gt_pts, dist_th),
    }
