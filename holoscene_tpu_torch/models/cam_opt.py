"""SE(3) camera-pose refinement (port of holoscene_tpu/models/cam_opt.py):
a per-image 6-DoF delta (translation, rotation vector) composed with the
camera-to-world poses through the SO(3) x R(3) exponential map. Like the
JAX module it is defined for any runner to enable; no runner wires it in.

The deltas start at exactly zero. Both branches of a torch.where are
evaluated and differentiated, so each divides by a guarded theta^2: at
zero the gradient is finite (the JAX module guards the sine branch only,
and its rotation gradient at exactly zero is NaN)."""

from __future__ import annotations

import torch
from torch import nn


def exp_map_so3xr3(tangent: torch.Tensor) -> torch.Tensor:
    """[..., 6] (translation, rotation vector) -> [..., 3, 4] transforms."""
    t = tangent[..., :3]
    omega = tangent[..., 3:]
    theta_sq = (omega * omega).sum(-1, keepdim=True)
    small = theta_sq < 1e-12
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_sq)

    wx, wy, wz = omega.unbind(-1)
    zeros = torch.zeros_like(wx)
    k = torch.stack([torch.stack([zeros, -wz, wy], -1),
                     torch.stack([wz, zeros, -wx], -1),
                     torch.stack([-wy, wx, zeros], -1)], -2)
    eye = torch.eye(3, dtype=tangent.dtype,
                    device=tangent.device).expand(k.shape)
    small, ts = small[..., None], theta_sq[..., None]
    th, safe = theta[..., None], safe_sq[..., None]
    sin_t = torch.where(small, 1.0 - ts / 6.0, torch.sin(th) / th)
    cos_t = torch.where(small, 0.5 - ts / 24.0, (1.0 - torch.cos(th)) / safe)
    rot = eye + sin_t * k + cos_t * (k @ k)
    return torch.cat([rot, t[..., :, None]], -1)


class CameraOptimizer(nn.Module):
    """pose_deltas [N, 6], zero at init (JAX init_camera_optimizer)."""

    def __init__(self, num_cameras: int, device="cpu"):
        super().__init__()
        self.pose_deltas = nn.Parameter(
            torch.zeros(num_cameras, 6, dtype=torch.float32, device=device))

    def apply(self, pose_c2w: torch.Tensor, camera_idx) -> torch.Tensor:
        """The refined 4x4 c2w of camera camera_idx (JAX
        apply_camera_optimizer)."""
        return apply_camera_optimizer(self.pose_deltas, pose_c2w, camera_idx)

    def pose_delta_regularizer(self, trans_weight: float = 1e-2,
                               rot_weight: float = 1e-3) -> torch.Tensor:
        d = self.pose_deltas
        return trans_weight * (d[:, :3] ** 2).mean() \
            + rot_weight * (d[:, 3:] ** 2).mean()


def apply_camera_optimizer(pose_deltas: torch.Tensor, pose_c2w: torch.Tensor,
                           camera_idx) -> torch.Tensor:
    """Compose the learned delta of camera_idx with a c2w pose [4, 4]."""
    delta = exp_map_so3xr3(pose_deltas[camera_idx])
    rot = delta[..., :3, :3] @ pose_c2w[:3, :3]
    trans = delta[..., :3, :3] @ pose_c2w[:3, 3] + delta[..., :3, 3]
    out = torch.eye(4, dtype=pose_c2w.dtype, device=pose_c2w.device)
    return torch.cat([torch.cat([rot, trans[:, None]], 1), out[3:]], 0)
