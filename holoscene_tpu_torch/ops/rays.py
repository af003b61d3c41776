"""Camera rays and the ray/cube slab test (port of
holoscene_tpu/ops/rays.py: lift, get_camera_rays, near_far_from_cube; the
orthographic rays and sphere intersections come with Stage 2)."""

from __future__ import annotations

import torch


def lift(x, y, z, intrinsics):
    """Unproject pixel coords [N] to homogeneous camera space [N, 4]."""
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    sk = intrinsics[0, 1]
    x_lift = (x - cx + cy * sk / fy - sk * y / fy) / fx * z
    y_lift = (y - cy) / fy * z
    return torch.stack([x_lift, y_lift, z, torch.ones_like(z)], -1)


def get_camera_rays(uv, pose, intrinsics, ray_offset=None):
    """uv [N,2], pose [4,4] c2w, intrinsics [3+,3+], ray_offset [N,2] or
    None -> (unit world dirs [N,3], cam_loc [3], depth_scale [N,1])."""
    x, y = uv[:, 0], uv[:, 1]
    if ray_offset is not None:
        x = x + ray_offset[:, 0]
        y = y + ray_offset[:, 1]
    z = torch.ones_like(x)
    pts_cam = lift(x, y, z, intrinsics)
    cam_loc = pose[:3, 3]
    world = (pose @ pts_cam.T).T
    world = world[:, :3] / world[:, 3:4]
    dirs = world - cam_loc[None, :]
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    cam_dirs = pts_cam[:, :3]
    depth_scale = (cam_dirs / torch.linalg.norm(cam_dirs, dim=-1,
                                                keepdim=True))[:, 2:3]
    return dirs, cam_loc, depth_scale


def near_far_from_cube(rays_o, rays_d, bound: float, min_near: float = 0.0,
                       max_far: float = 1e9):
    """AABB slab test against [-bound, bound]^3 -> (near [N,1], far [N,1]);
    misses get near = far = 1e9."""
    tmin = (-bound - rays_o) / (rays_d + 1e-15)
    tmax = (bound - rays_o) / (rays_d + 1e-15)
    near = torch.minimum(tmin, tmax).amax(-1, keepdim=True)
    far = torch.maximum(tmin, tmax).amin(-1, keepdim=True)
    miss = far < near
    near = torch.where(miss, torch.full_like(near, 1e9), near)
    far = torch.where(miss, torch.full_like(far, 1e9), far)
    return near.clamp(min=min_near), far.clamp(max=max_far)
