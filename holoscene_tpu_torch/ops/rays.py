"""Camera rays and the ray/cube slab test (port of
holoscene_tpu/ops/rays.py: lift, get_camera_rays, the orthographic rays of
Stage 2's object views, near_far_from_cube, get_sphere_intersections)."""

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


def get_orthographic_rays(uv_unit, pose, half_extent):
    """Orthographic rays of a camera pose [4, 4] (c2w, OpenCV) for Stage
    2's object views (reference utils/general.py:849-930): origins on the
    image plane at uv_unit [N, 2] in [-1, 1] times half_extent (a float or
    a 0-d tensor) along the camera's x / y axes, directions its z axis.
    Returns (origins [N, 3], dirs [N, 3])."""
    origins = pose[:3, 3][None, :] + (
        uv_unit[:, 0:1] * half_extent * pose[:3, 0][None, :]
        + uv_unit[:, 1:2] * half_extent * pose[:3, 1][None, :])
    return origins, pose[:3, 2][None, :].expand(origins.shape)


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


def get_sphere_intersections(cam_loc, ray_dirs, r: float):
    """Distances [N, 2] to both ray-sphere intersections of rays from
    cam_loc [3] along ray_dirs [N, 3] with the sphere of radius r about the
    origin, clamped to >= 0 (a miss gives the closest approach twice)."""
    dot = (ray_dirs * cam_loc[None, :]).sum(-1, keepdim=True)
    under = torch.clamp(dot ** 2 - ((cam_loc ** 2).sum() - r ** 2), min=0.0)
    sqrt_u = torch.sqrt(under)
    return torch.clamp(torch.cat([-dot - sqrt_u, -dot + sqrt_u], -1),
                       min=0.0)
