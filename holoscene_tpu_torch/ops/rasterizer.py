"""Mesh rasterization (port of holoscene_tpu/ops/rasterizer.py:
rasterize_mesh and rasterize_mesh_list, perspective and orthographic).

Stage 4 rasterizes each training frame's mesh mask and depth once; mesh
extraction's visibility pruning rasterizes every instance mesh into the
training views; the depth metric renders two meshes from random views.
Same algorithm as the reference: screen-size subdivision so no triangle
can leave holes, a fixed GxG barycentric fragment grid per face, a
scatter-min depth buffer, a winner pass that writes the face id, and exact
per-pixel barycentrics from the winning face. Plain PyTorch, all of it on
the caller's `device` (the reference subdivides on the host;
`scatter_reduce` "amin" for the z-buffer; ties in the winner pass resolve
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


def orthographic_project(verts, pose_w2c, half_extent: float,
                         img_res: int):
    """Orthographic screen mapping for Stage-2 object renders: (xy [V,2]
    pixels, z [V] camera depth)."""
    cam = verts @ pose_w2c[:3, :3].T + pose_w2c[:3, 3]
    scale = img_res / (2.0 * half_extent)
    x = cam[:, 0] * scale + img_res / 2.0
    y = cam[:, 1] * scale + img_res / 2.0
    return torch.stack([x, y], dim=-1), cam[:, 2]


def _fragment_grid(n_side: int) -> np.ndarray:
    """[G, 3] barycentric sample points covering the unit triangle."""
    pts = []
    for i in range(n_side):
        for j in range(n_side - i):
            u = (i + 1 / 3) / n_side
            v = (j + 1 / 3) / n_side
            pts.append((1 - u - v, u, v))
    return np.asarray(pts, dtype=np.float32)


FACE_CHUNK = 1 << 20


def _rasterize_core(xy, z, faces, height: int, width: int, grid_size: int,
                    cull_backfaces: bool = False):
    """xy [V,2], z [V], faces [F,3] -> (depth [H,W], face_id [H,W] int64,
    -1 = empty). Faces with a vertex behind the camera are dropped, and
    with cull_backfaces those facing away (screen-space signed area >= 0:
    y points down, so faces counter-clockwise in the world that face the
    camera have a negative cross product here).

    The fragments are made and scattered FACE_CHUNK faces at a time, in
    two passes (the depth buffer, then the winners against the finished
    buffer), so their memory is bounded for any face count; "amin" and
    "amax" give the same buffers in any order."""
    bary = torch.as_tensor(_fragment_grid(grid_size), device=xy.device)

    def fragments(start):
        """(pixel, depth, face id) of the fragments of one face chunk that
        land on the screen."""
        f = faces[start:start + FACE_CHUNK]
        f_xy = xy[f]                      # [C, 3, 2]
        f_z = z[f]                        # [C, 3]
        valid = torch.all(f_z > 1e-6, dim=-1)
        if cull_backfaces:
            e1 = f_xy[:, 1] - f_xy[:, 0]
            e2 = f_xy[:, 2] - f_xy[:, 0]
            valid = valid & (e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0] < 0)
        frag_xy = torch.einsum("gk,fkd->fgd", bary, f_xy)
        frag_z = torch.einsum("gk,fk->fg", bary, f_z)
        px = torch.floor(frag_xy[..., 0]).long()
        py = torch.floor(frag_xy[..., 1]).long()
        inside = (px >= 0) & (px < width) & (py >= 0) & (py < height)
        inside = (inside & valid[:, None]).reshape(-1)
        pix = (py * width + px).reshape(-1)[inside]
        fz = frag_z.reshape(-1)[inside]
        fid = torch.arange(start, start + len(f), device=xy.device
                           ).repeat_interleave(frag_z.shape[1])[inside]
        return pix, fz, fid

    starts = range(0, faces.shape[0], FACE_CHUNK)
    depth = torch.full((height * width,), BIG_DEPTH, dtype=torch.float32,
                       device=xy.device)
    for start in starts:
        pix, fz, _ = fragments(start)
        depth.scatter_reduce_(0, pix, fz, reduce="amin")
    face_id = torch.full((height * width,), -1, dtype=torch.long,
                         device=xy.device)
    for start in starts:
        pix, fz, fid = fragments(start)
        winner = fz <= depth[pix] * (1.0 + 1e-6)
        face_id.scatter_reduce_(0, pix[winner], fid[winner], reduce="amax")
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
                      grid_size, ortho_half_extent=None):
    """Coverage guard: split faces until every screen-space edge fits the
    fragment grid's coverage (~grid_size px). vertices [V,3] float64 and
    faces [F,3] int64 tensors; runs on their device (the reference's host
    numpy loop took minutes a view on the millions of faces of a 512^3
    extraction).

    Returns (vertices, faces, parents, fbary): parents maps each (possibly
    split) face to the caller's face index, and fbary [F,3,3] gives each
    split face's corners in the parent's barycentric coordinates (row k =
    corner k), so per-pixel barycentrics can be reported against the
    caller's faces."""
    dev = vertices.device
    parents = torch.arange(len(faces), device=dev)
    fbary = torch.eye(3, dtype=torch.float64, device=dev).repeat(
        len(faces), 1, 1)
    pose = torch.as_tensor(np.asarray(pose_c2w, dtype=np.float64), device=dev)
    rot = pose[:3, :3].T
    trans = -rot @ pose[:3, 3]
    intr = np.asarray(intrinsics, dtype=np.float64)
    height = img_res[0]
    limit = float(grid_size)
    # near-camera geometry could demand unbounded splits: cap the growth
    max_faces = max(4 * len(faces), 200_000)
    for _ in range(12):
        cam = vertices @ rot.T + trans
        z = cam[:, 2]
        if ortho_half_extent is not None:
            xy = cam[:, :2] * (height / (2.0 * ortho_half_extent))
        else:
            zs = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
            xy = torch.stack([intr[0, 0] * cam[:, 0] / zs,
                              intr[1, 1] * cam[:, 1] / zs], -1)
        e = xy[faces]
        edge = torch.maximum(torch.maximum(
            torch.linalg.norm(e[:, 0] - e[:, 1], dim=1),
            torch.linalg.norm(e[:, 1] - e[:, 2], dim=1)),
            torch.linalg.norm(e[:, 2] - e[:, 0], dim=1))
        split = edge > limit
        if ortho_half_extent is None:   # only faces in front can rasterize
            split &= torch.all(z[faces] > 1e-6, dim=1)
        n_split = int(split.sum())
        if not n_split or len(faces) >= max_faces:
            break
        if n_split * 3 + len(faces) > max_faces:
            allow = (max_faces - len(faces)) // 3
            m = torch.zeros(len(faces), dtype=torch.bool, device=dev)
            m[torch.argsort(-edge)[: max(allow, 1)]] = True
            split &= m
            if not bool(split.any()):
                break
        fs = faces[split]
        ps = parents[split]
        bs = fbary[split]             # [S,3,3] parent-bary of the 3 corners
        edges = torch.sort(torch.cat(
            [fs[:, [0, 1]], fs[:, [1, 2]], fs[:, [2, 0]]]), dim=1).values
        n_v = len(vertices)
        # unique edges in (lo, hi) order, as rows of one int64 key
        uniq, inv = torch.unique(edges[:, 0] * n_v + edges[:, 1],
                                 return_inverse=True)
        mid_ids = n_v + torch.arange(len(uniq), device=dev)
        vertices = torch.cat(
            [vertices, (vertices[uniq // n_v] + vertices[uniq % n_v]) / 2.0])
        n_s = len(fs)
        m01 = mid_ids[inv[:n_s]]
        m12 = mid_ids[inv[n_s: 2 * n_s]]
        m20 = mid_ids[inv[2 * n_s:]]
        new_faces = torch.cat([
            torch.stack([fs[:, 0], m01, m20], 1),
            torch.stack([m01, fs[:, 1], m12], 1),
            torch.stack([m20, m12, fs[:, 2]], 1),
            torch.stack([m01, m12, m20], 1),
        ])
        b01 = (bs[:, 0] + bs[:, 1]) / 2.0
        b12 = (bs[:, 1] + bs[:, 2]) / 2.0
        b20 = (bs[:, 2] + bs[:, 0]) / 2.0
        new_fbary = torch.cat([
            torch.stack([bs[:, 0], b01, b20], 1),
            torch.stack([b01, bs[:, 1], b12], 1),
            torch.stack([b20, b12, bs[:, 2]], 1),
            torch.stack([b01, b12, b20], 1),
        ])
        faces = torch.cat([faces[~split], new_faces])
        parents = torch.cat([parents[~split], ps.repeat(4)])
        fbary = torch.cat([fbary[~split], new_fbary])
    return vertices, faces, parents, fbary


def _prepare_screen(vertices, faces, pose_c2w, intrinsics, img_res,
                    grid_size, ortho_half_extent, dev, auto_subdivide=True):
    """Shared preamble of the rasterization entry points: screen-size-guard
    subdivision (with auto_subdivide), then projection, on `dev`.

    Returns (vertices, faces, xy, z, parents, fbary) as tensors;
    parents / fbary are None when no face was split (face ids already in
    the caller's frame). A vertex tensor that carries a graph keeps it
    (the dtype round trip and the midpoints are differentiable)."""
    parents = fbary = None
    if auto_subdivide:
        verts, faces_t, parents, fbary = _screen_subdivide(
            as_tensor(vertices, dev, torch.float64),
            as_tensor(faces, dev, torch.int64), pose_c2w, intrinsics,
            img_res, grid_size, ortho_half_extent)
        if len(parents) == len(faces) and torch.equal(
                parents, torch.arange(len(faces), device=dev)):
            parents = fbary = None
        else:
            fbary = fbary.to(torch.float32)
    else:
        verts = as_tensor(vertices, dev, torch.float64)
        faces_t = as_tensor(faces, dev, torch.int64)
    verts = verts.to(torch.float32)
    w2c = view_matrix(pose_c2w, dev)
    if ortho_half_extent is not None:
        xy, z = orthographic_project(verts, w2c, ortho_half_extent,
                                     img_res[0])
    else:
        xy, z = perspective_project(verts, w2c, as_tensor(intrinsics, dev))
    return verts, faces_t, xy, z, parents, fbary


def rasterize_mesh(vertices, faces, pose_c2w, intrinsics,
                   img_res: tuple[int, int], grid_size: int = 6,
                   cull_backfaces: bool = False,
                   ortho_half_extent: float | None = None,
                   device: str | torch.device = "cpu",
                   auto_subdivide: bool = True):
    """Rasterize one mesh. Returns a dict of tensors on `device`: depth
    [H,W] (BIG_DEPTH where empty), face_id [H,W] (-1 empty), mask [H,W]
    bool, bary [H,W,3], pix_verts [H,W,3,3] world-space triangle vertices
    (reference rasterize_mesh_return_pixel_vert_and_bary,
    utils/general.py:743), world_pos [H,W,3].

    Screen-oversized triangles are split before scattering so coverage
    is hole-free for any input geometry; face_id, bary and pix_verts are
    reported against the caller's faces. auto_subdivide=False skips the
    split, as JAX does for a traced call (Stage 2's coarse_recon).
    pix_verts and world_pos are differentiable in a vertex tensor that
    carries a graph, with or without the split."""
    height, width = img_res
    dev = torch.device(device)
    orig_vertices, orig_faces = vertices, faces
    vertices, faces, xy, z, parents, fbary = _prepare_screen(
        vertices, faces, pose_c2w, intrinsics, img_res, grid_size,
        ortho_half_extent, dev, auto_subdivide)

    _, face_id = _rasterize_core(xy, z, faces, height, width, grid_size,
                                 cull_backfaces)
    bary = _pixel_barycentrics(xy, faces, face_id, height, width)
    mask = face_id >= 0
    child = torch.clamp(face_id, min=0)
    tri = faces[child]                                     # [H, W, 3]
    pix_verts = vertices[tri]                              # [H, W, 3, 3]
    depth_interp = torch.sum(bary * z[tri], dim=-1)
    world_pos = torch.einsum("hwk,hwkd->hwd", bary, pix_verts)
    if parents is not None:
        # the caller's face ids AND barycentrics / corner vertices in the
        # caller's (parent) frame, so (face_id, bary, pix_verts) stay a
        # consistent triple
        bary = torch.einsum("hwk,hwkj->hwj", bary, fbary[child])
        parent = parents[child]
        tri_p = as_tensor(orig_faces, dev, torch.int64)[parent]
        pix_verts = as_tensor(orig_vertices, dev)[tri_p]
        face_id = torch.where(mask, parent, torch.full_like(parent, -1))
    return {
        "depth": torch.where(mask, depth_interp,
                             torch.full_like(depth_interp, BIG_DEPTH)),
        "face_id": face_id,
        "mask": mask,
        "bary": bary,
        "pix_verts": pix_verts,
        "world_pos": world_pos,
    }


def rasterize_mesh_list(meshes, pose_c2w, intrinsics,
                        img_res: tuple[int, int], grid_size: int = 6,
                        cull_backfaces: bool = False,
                        ortho_half_extent: float | None = None,
                        device: str | torch.device = "cpu"):
    """Rasterize several meshes (list of (vertices, faces)) into one buffer
    (reference rasterize_mesh_list(_front_face), utils/general.py:542-567),
    perspective or orthographic (ortho_half_extent), optionally culling
    back faces.

    Returns rasterize_mesh's outputs, face_id indexing the concatenated
    meshes, plus instance_id [H,W] (the mesh's index in the list, -1
    empty)."""
    verts_list, faces_list, owner = [], [], []
    off = 0
    for i, (v, f) in enumerate(meshes):
        verts_list.append(np.asarray(v, dtype=np.float32))
        faces_list.append(np.asarray(f, dtype=np.int64) + off)
        owner.append(np.full(len(f), i, dtype=np.int64))
        off += len(v)
    out = rasterize_mesh(
        np.concatenate(verts_list), np.concatenate(faces_list), pose_c2w,
        intrinsics, img_res, grid_size, cull_backfaces, ortho_half_extent,
        device)
    fid = out["face_id"]
    face_owner = torch.as_tensor(np.concatenate(owner), device=fid.device)
    out["instance_id"] = torch.where(fid >= 0,
                                     face_owner[torch.clamp(fid, min=0)],
                                     torch.full_like(fid, -1))
    return out
