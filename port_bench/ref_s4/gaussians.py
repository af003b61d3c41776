# Frozen copy of holoscene_tpu_torch/ops/gaussians.py at commit badb067, for the
# benchmark's plain reference: imports rewired to port_bench.ref_s4, cut to
# the paths the benchmark's Stage-4 configuration runs, in plain PyTorch.
# Do not edit to follow the port.
"""3D Gaussian math: quaternions, the fused EWA projection, spherical
harmonics.

Port of holoscene_tpu/ops/gaussians.py (same conventions: quaternions are
(w, x, y, z), rotation matrices are world-from-local with COLUMNS as local
axes). Plain PyTorch; autograd supplies the backward.
"""

from __future__ import annotations

import torch

from port_bench.ref_s4 import as_tensor

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def num_sh_bases(degree: int) -> int:
    return (degree + 1) ** 2


def rgb_to_sh(rgb: torch.Tensor) -> torch.Tensor:
    return (rgb - 0.5) / SH_C0


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product, (w,x,y,z)."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def axis_angle_to_quat(axis_angle: torch.Tensor) -> torch.Tensor:
    """[...,3] rotation vector -> (w,x,y,z), with NaN-free gradients at zero
    rotation (guarded sqrt + small-angle polynomial; zero is the GoM
    spin/tilt init state)."""
    sq = torch.sum(axis_angle * axis_angle, dim=-1, keepdim=True)
    small = sq < 1e-12
    angle = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    half = 0.5 * angle
    k = torch.where(small, 0.5 - sq / 48.0, torch.sin(half) / angle)
    w = torch.where(small, 1.0 - sq / 8.0, torch.cos(half))
    return torch.cat([w, axis_angle * k], dim=-1)


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """[...,3,3] -> (w,x,y,z), branch-free (Shepperd's method)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    qw = torch.sqrt(torch.clamp(1 + m00 + m11 + m22, min=0.0)) / 2
    qx = torch.sqrt(torch.clamp(1 + m00 - m11 - m22, min=0.0)) / 2
    qy = torch.sqrt(torch.clamp(1 - m00 + m11 - m22, min=0.0)) / 2
    qz = torch.sqrt(torch.clamp(1 - m00 - m11 + m22, min=0.0)) / 2
    qx = torch.copysign(qx, m21 - m12)
    qy = torch.copysign(qy, m02 - m20)
    qz = torch.copysign(qz, m10 - m01)
    q = torch.stack([qw, qx, qy, qz], dim=-1)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def view_matrix(pose_c2w, device) -> torch.Tensor:
    """World-to-camera [4,4] of a camera-to-world pose (numpy or tensor)."""
    pose = as_tensor(pose_c2w, device)
    rot = pose[:3, :3].T
    viewmat = torch.eye(4, device=device)
    viewmat[:3, :3] = rot
    viewmat[:3, 3] = -rot @ pose[:3, 3]
    return viewmat


def project_gaussians_fused(
    means: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,
    viewmat: torch.Tensor,
    intrinsics: torch.Tensor,
    width: int,
    height: int,
    near: float = 0.01,
    blur: float = 0.3,
    ortho: bool = False,
):
    """EWA projection in structure-of-arrays form (every intermediate a flat
    [N] vector). Returns (xy [N,2], depth [N], conic [N,3], radius [N],
    valid [N] bool) exactly as the JAX counterpart."""
    r = viewmat[:3, :3]
    t = viewmat[:3, 3]
    mx, my, mz = means[:, 0], means[:, 1], means[:, 2]
    x = r[0, 0] * mx + r[0, 1] * my + r[0, 2] * mz + t[0]
    y = r[1, 0] * mx + r[1, 1] * my + r[1, 2] * mz + t[1]
    z = r[2, 0] * mx + r[2, 1] * my + r[2, 2] * mz + t[2]
    valid = z > near
    zc = torch.clamp(z, min=near)

    qn = torch.sqrt(quats[:, 0] ** 2 + quats[:, 1] ** 2
                    + quats[:, 2] ** 2 + quats[:, 3] ** 2)
    qw, qx, qy, qz = (quats[:, 0] / qn, quats[:, 1] / qn,
                      quats[:, 2] / qn, quats[:, 3] / qn)
    r00 = 1 - 2 * (qy * qy + qz * qz)
    r01 = 2 * (qx * qy - qw * qz)
    r02 = 2 * (qx * qz + qw * qy)
    r10 = 2 * (qx * qy + qw * qz)
    r11 = 1 - 2 * (qx * qx + qz * qz)
    r12 = 2 * (qy * qz - qw * qx)
    r20 = 2 * (qx * qz - qw * qy)
    r21 = 2 * (qy * qz + qw * qx)
    r22 = 1 - 2 * (qx * qx + qy * qy)
    s0sq = scales[:, 0] ** 2
    s1sq = scales[:, 1] ** 2
    s2sq = scales[:, 2] ** 2

    def cam_row(i):
        return (r[i, 0] * r00 + r[i, 1] * r10 + r[i, 2] * r20,
                r[i, 0] * r01 + r[i, 1] * r11 + r[i, 2] * r21,
                r[i, 0] * r02 + r[i, 1] * r12 + r[i, 2] * r22)

    a0 = cam_row(0)
    a1 = cam_row(1)
    a2 = cam_row(2)

    def wcov(ai, aj):
        return ai[0] * aj[0] * s0sq + ai[1] * aj[1] * s1sq \
            + ai[2] * aj[2] * s2sq

    w00 = wcov(a0, a0)
    w01 = wcov(a0, a1)
    w02 = wcov(a0, a2)
    w11 = wcov(a1, a1)
    w12 = wcov(a1, a2)
    w22 = wcov(a2, a2)

    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    if ortho:
        ca = fx * fx * w00 + blur
        cb = fx * fy * w01
        cc = fy * fy * w11 + blur
        px = fx * x + cx
        py = fy * y + cy
    else:
        lim_x = 1.3 * (width / (2 * fx))
        lim_y = 1.3 * (height / (2 * fy))
        tx = torch.clamp(x / zc, -lim_x, lim_x) * zc
        ty = torch.clamp(y / zc, -lim_y, lim_y) * zc
        j00 = fx / zc
        j02 = -fx * tx / (zc * zc)
        j11 = fy / zc
        j12 = -fy * ty / (zc * zc)
        ca = (j00 * j00 * w00 + 2 * j00 * j02 * w02
              + j02 * j02 * w22) + blur
        cb = (j00 * j11 * w01 + j00 * j12 * w02
              + j02 * j11 * w12 + j02 * j12 * w22)
        cc = (j11 * j11 * w11 + 2 * j11 * j12 * w12
              + j12 * j12 * w22) + blur
        px = fx * x / zc + cx
        py = fy * y / zc + cy

    det = torch.clamp(ca * cc - cb * cb, min=1e-12)
    conic = torch.stack([cc / det, -cb / det, ca / det], dim=-1)
    mid = 0.5 * (ca + cc)
    eig = mid + torch.sqrt(torch.clamp(mid * mid - det, min=1e-12))
    radius = torch.ceil(3.0 * torch.sqrt(eig))
    on_screen = (
        (px + radius > 0) & (px - radius < width)
        & (py + radius > 0) & (py - radius < height)
    )
    xy = torch.stack([px, py], dim=-1)
    return xy, z, conic, radius, valid & (z > near) & on_screen


def eval_sh(sh_coeffs: torch.Tensor, dirs: torch.Tensor,
            degree: int) -> torch.Tensor:
    """sh_coeffs [N, B, 3], dirs [N, 3] unit -> rgb [N, 3] (+0.5 offset)."""
    result = SH_C0 * sh_coeffs[:, 0]
    if degree >= 1:
        x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
        result = (
            result
            - SH_C1 * y * sh_coeffs[:, 1]
            + SH_C1 * z * sh_coeffs[:, 2]
            - SH_C1 * x * sh_coeffs[:, 3]
        )
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        result = (
            result
            + SH_C2[0] * xy * sh_coeffs[:, 4]
            + SH_C2[1] * yz * sh_coeffs[:, 5]
            + SH_C2[2] * (2 * zz - xx - yy) * sh_coeffs[:, 6]
            + SH_C2[3] * xz * sh_coeffs[:, 7]
            + SH_C2[4] * (xx - yy) * sh_coeffs[:, 8]
        )
    if degree >= 3:
        result = (
            result
            + SH_C3[0] * y * (3 * xx - yy) * sh_coeffs[:, 9]
            + SH_C3[1] * xy * z * sh_coeffs[:, 10]
            + SH_C3[2] * y * (4 * zz - xx - yy) * sh_coeffs[:, 11]
            + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh_coeffs[:, 12]
            + SH_C3[4] * x * (4 * zz - xx - yy) * sh_coeffs[:, 13]
            + SH_C3[5] * z * (xx - yy) * sh_coeffs[:, 14]
            + SH_C3[6] * x * (xx - 3 * yy) * sh_coeffs[:, 15]
        )
    return result + 0.5
