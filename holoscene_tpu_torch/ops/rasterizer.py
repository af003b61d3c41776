"""Mesh mask/depth rasterization (perspective path of
holoscene_tpu/ops/rasterizer.py::rasterize_mesh_list).

Stage 4 rasterizes each training frame's mesh mask and depth once. Same
algorithm as the reference: host-side screen-size subdivision so no
triangle can leave holes, a fixed GxG barycentric fragment grid per face,
a scatter-min depth buffer, a winner pass that writes the face id, and
exact per-pixel barycentrics from the winning face. Plain PyTorch
(`scatter_reduce` "amin" for the z-buffer; ties in the winner pass resolve
to the largest face id).
"""

from __future__ import annotations

import numpy as np
import torch

from holoscene_tpu_torch import as_tensor
from holoscene_tpu_torch.ops.gaussians import view_matrix

BIG_DEPTH = 1e9


def perspective_project(verts, pose_w2c, intrinsics):
    """verts [V,3] world -> (xy [V,2] pixels, z [V] camera depth), OpenCV
    convention (x right, y down, z forward)."""
    cam = verts @ pose_w2c[:3, :3].T + pose_w2c[:3, 3]
    z = cam[:, 2]
    x = intrinsics[0, 0] * cam[:, 0] / z + intrinsics[0, 2]
    y = intrinsics[1, 1] * cam[:, 1] / z + intrinsics[1, 2]
    return torch.stack([x, y], dim=-1), z


def _fragment_grid(n_side: int) -> np.ndarray:
    """[G, 3] barycentric sample points covering the unit triangle."""
    pts = []
    for i in range(n_side):
        for j in range(n_side - i):
            u = (i + 1 / 3) / n_side
            v = (j + 1 / 3) / n_side
            pts.append((1 - u - v, u, v))
    return np.asarray(pts, dtype=np.float32)


def _rasterize_core(xy, z, faces, height: int, width: int, grid_size: int):
    """xy [V,2], z [V], faces [F,3] -> (depth [H,W], face_id [H,W] int64,
    -1 = empty). Faces with a vertex behind the camera are dropped."""
    f_xy = xy[faces]                  # [F, 3, 2]
    f_z = z[faces]                    # [F, 3]
    valid = torch.all(f_z > 1e-6, dim=-1)

    bary = torch.as_tensor(_fragment_grid(grid_size), device=xy.device)
    frag_xy = torch.einsum("gk,fkd->fgd", bary, f_xy)
    frag_z = torch.einsum("gk,fk->fg", bary, f_z)
    px = torch.floor(frag_xy[..., 0]).long()
    py = torch.floor(frag_xy[..., 1]).long()
    inside = (px >= 0) & (px < width) & (py >= 0) & (py < height)
    inside = (inside & valid[:, None]).reshape(-1)
    pix = (py * width + px).reshape(-1)[inside]
    fz = frag_z.reshape(-1)[inside]
    fid = torch.arange(faces.shape[0], device=xy.device).repeat_interleave(
        frag_z.shape[1])[inside]

    depth = torch.full((height * width,), BIG_DEPTH, dtype=torch.float32,
                       device=xy.device)
    depth = depth.scatter_reduce(0, pix, fz, reduce="amin")
    winner = fz <= depth[pix] * (1.0 + 1e-6)
    face_id = torch.full((height * width,), -1, dtype=torch.long,
                         device=xy.device)
    face_id = face_id.scatter_reduce(0, pix[winner], fid[winner],
                                     reduce="amax")
    return depth.reshape(height, width), face_id.reshape(height, width)


def _pixel_barycentrics(xy, faces, face_id, height: int, width: int):
    """Exact screen-space barycentrics [H,W,3] of every pixel centre."""
    tri = faces[torch.clamp(face_id.reshape(-1), min=0)]       # [P, 3]
    p_xy = xy[tri]                                             # [P, 3, 2]
    gy, gx = torch.meshgrid(torch.arange(height, device=xy.device),
                            torch.arange(width, device=xy.device),
                            indexing="ij")
    pc = torch.stack([gx.reshape(-1) + 0.5, gy.reshape(-1) + 0.5], dim=-1)

    v0 = p_xy[:, 1] - p_xy[:, 0]
    v1 = p_xy[:, 2] - p_xy[:, 0]
    v2 = pc - p_xy[:, 0]
    d00 = torch.sum(v0 * v0, -1)
    d01 = torch.sum(v0 * v1, -1)
    d11 = torch.sum(v1 * v1, -1)
    d20 = torch.sum(v2 * v0, -1)
    d21 = torch.sum(v2 * v1, -1)
    denom = d00 * d11 - d01 * d01
    denom = torch.where(torch.abs(denom) < 1e-12,
                        torch.full_like(denom, 1e-12), denom)
    b1 = (d11 * d20 - d01 * d21) / denom
    b2 = (d00 * d21 - d01 * d20) / denom
    bary = torch.stack([1.0 - b1 - b2, b1, b2], dim=-1)
    bary = torch.clamp(bary, 0.0, 1.0)
    bary = bary / torch.sum(bary, dim=-1, keepdim=True)
    return bary.reshape(height, width, 3)


def _screen_subdivide(vertices, faces, pose_c2w, intrinsics, img_res,
                      grid_size):
    """Coverage guard (host numpy, perspective): split faces until every
    screen-space edge fits the fragment grid's coverage (~grid_size px).
    Returns (vertices, faces, parents) with parents mapping each split face
    to the caller's face index."""
    vertices = np.asarray(vertices, dtype=np.float64)
    faces = np.asarray(faces, dtype=np.int64)
    parents = np.arange(len(faces), dtype=np.int64)
    pose = np.asarray(pose_c2w, dtype=np.float64)
    rot = pose[:3, :3].T
    trans = -rot @ pose[:3, 3]
    intr = np.asarray(intrinsics, dtype=np.float64)
    limit = float(grid_size)
    # near-camera geometry could demand unbounded splits: cap the growth
    max_faces = max(4 * len(faces), 200_000)
    for _ in range(12):
        cam = vertices @ rot.T + trans
        z = cam[:, 2]
        zs = np.where(np.abs(z) < 1e-6, 1e-6, z)
        xy = np.stack(
            [intr[0, 0] * cam[:, 0] / zs, intr[1, 1] * cam[:, 1] / zs],
            axis=-1)
        e = xy[faces]
        edge = np.maximum.reduce([
            np.linalg.norm(e[:, 0] - e[:, 1], axis=1),
            np.linalg.norm(e[:, 1] - e[:, 2], axis=1),
            np.linalg.norm(e[:, 2] - e[:, 0], axis=1),
        ])
        split = (edge > limit) & np.all(z[faces] > 1e-6, axis=1)
        if not split.any() or len(faces) >= max_faces:
            break
        if split.sum() * 3 + len(faces) > max_faces:
            order = np.argsort(-edge)
            allow = (max_faces - len(faces)) // 3
            m = np.zeros(len(faces), bool)
            m[order[: max(allow, 1)]] = True
            split &= m
            if not split.any():
                break
        fs = faces[split]
        ps = parents[split]
        edges = np.sort(np.concatenate(
            [fs[:, [0, 1]], fs[:, [1, 2]], fs[:, [2, 0]]], axis=0), axis=1)
        uniq, inv = np.unique(edges, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        mid_ids = len(vertices) + np.arange(len(uniq))
        vertices = np.vstack(
            [vertices, (vertices[uniq[:, 0]] + vertices[uniq[:, 1]]) / 2.0])
        n_s = len(fs)
        m01 = mid_ids[inv[:n_s]]
        m12 = mid_ids[inv[n_s: 2 * n_s]]
        m20 = mid_ids[inv[2 * n_s:]]
        new_faces = np.concatenate([
            np.stack([fs[:, 0], m01, m20], axis=1),
            np.stack([m01, fs[:, 1], m12], axis=1),
            np.stack([m20, m12, fs[:, 2]], axis=1),
            np.stack([m01, m12, m20], axis=1),
        ])
        faces = np.vstack([faces[~split], new_faces])
        parents = np.concatenate([parents[~split], np.tile(ps, 4)])
    return vertices.astype(np.float32), faces, parents


def rasterize_mesh_list(meshes, pose_c2w, intrinsics,
                        img_res: tuple[int, int], grid_size: int = 6,
                        device: str | torch.device = "cpu"):
    """Rasterize several meshes (list of (vertices, faces)) into one buffer.

    Returns dict of tensors on `device`: depth [H,W] (BIG_DEPTH where
    empty), face_id [H,W] (caller's face index into the concatenated
    meshes, -1 empty), mask [H,W] bool, instance_id [H,W] (-1 empty)."""
    height, width = img_res
    verts_list, faces_list, owner = [], [], []
    off = 0
    for i, (v, f) in enumerate(meshes):
        verts_list.append(np.asarray(v, dtype=np.float32))
        faces_list.append(np.asarray(f, dtype=np.int64) + off)
        owner.append(np.full(len(f), i, dtype=np.int64))
        off += len(v)
    vertices, faces, parents = _screen_subdivide(
        np.concatenate(verts_list), np.concatenate(faces_list), pose_c2w,
        intrinsics, img_res, grid_size)

    dev = torch.device(device)
    verts_t = torch.as_tensor(vertices, device=dev)
    faces_t = torch.as_tensor(faces, device=dev)
    xy, z = perspective_project(verts_t, view_matrix(pose_c2w, dev),
                                as_tensor(intrinsics, dev))

    depth, face_id = _rasterize_core(xy, z, faces_t, height, width,
                                     grid_size)
    bary = _pixel_barycentrics(xy, faces_t, face_id, height, width)
    mask = face_id >= 0
    tri = faces_t[torch.clamp(face_id, min=0)]                  # [H, W, 3]
    depth_interp = torch.sum(bary * z[tri], dim=-1)
    parent = torch.as_tensor(parents, device=dev)[torch.clamp(face_id, min=0)]
    face_owner = torch.as_tensor(np.concatenate(owner), device=dev)
    return {
        "depth": torch.where(mask, depth_interp,
                             torch.full_like(depth_interp, BIG_DEPTH)),
        "face_id": torch.where(mask, parent, torch.full_like(parent, -1)),
        "mask": mask,
        "instance_id": torch.where(mask, face_owner[parent],
                                   torch.full_like(parent, -1)),
    }
