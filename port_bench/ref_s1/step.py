# Frozen copy of holoscene_tpu_torch/training/stage1.py at commit badb067
# (make_optimizer, rays_from_batch, bg_patch_uv, train_step) for the
# benchmark's plain reference, without the multi-rank, occupancy and
# probe-grid branches that the benchmark's configurations do not run.
"""The plain Stage-1 step: rays -> error-bound sampler -> hash encode
(plain) -> MLPs -> volume rendering (and every render_bg_iter-th step the
background patch) -> the loss stack -> backward -> Adam with the grid
factor and the exponential decay."""

from __future__ import annotations

import dataclasses

import torch

from port_bench.ref_s1.holoscene import (
    BG_PATCH,
    HoloSceneModel,
    RenderDraws,
    render_bg_patch,
    render_rays,
)
from port_bench.ref_s1.holoscene_loss import LossConfig, holoscene_loss
from port_bench.ref_s1.rays import get_camera_rays
from port_bench.ref_s1.sampler import SamplerDraws


def make_optimizer(model: HoloSceneModel, lr: float, lr_factor_for_grid: float,
                   total_iters: int):
    """Adam(0.9, 0.99, eps 1e-15), lr x lr_factor_for_grid for every
    parameter whose name ends in `grid`, decay 0.1^(1/total_iters) a step."""
    grid, net = [], []
    for name, p in model.named_parameters():
        (grid if name.endswith("grid") else net).append(p)
    opt = torch.optim.Adam(
        [{"params": grid, "lr": lr * lr_factor_for_grid},
         {"params": net, "lr": lr}], betas=(0.9, 0.99), eps=1e-15)
    decay = 0.1 ** (1.0 / max(total_iters, 1))
    return opt, torch.optim.lr_scheduler.ExponentialLR(opt, gamma=decay)


def rays_from_batch(uv, pose, intrinsics, jitter=None):
    dirs, cam_loc, depth_scale = get_camera_rays(uv, pose, intrinsics, jitter)
    return cam_loc.expand(dirs.shape), dirs, depth_scale, pose[:3, :3].T


def bg_patch_uv(intrinsics: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    span = torch.stack([intrinsics[0, 2] * 2.0 - BG_PATCH,
                        intrinsics[1, 2] * 2.0 - BG_PATCH])
    ar = torch.arange(BG_PATCH, device=u.device)
    gy, gx = torch.meshgrid(ar, ar, indexing="ij")
    grid = torch.stack([gx, gy], -1).reshape(-1, 2).to(torch.float32)
    return grid + (u * span).to(torch.float32)[None, :]


@dataclasses.dataclass
class Draws:
    """A step's random numbers, as the reference's own dataclasses."""

    jitter: torch.Tensor
    render: RenderDraws
    bg_uv: torch.Tensor | None = None
    bg_sampler: SamplerDraws | None = None

    @classmethod
    def copy_of(cls, d) -> "Draws":
        """The same numbers from any object with the program's field names
        (cloned, so later steps cannot change them)."""
        def sampler(s):
            return None if s is None else SamplerDraws(
                s.t_rand.clone(), s.u.clone(), s.perm.clone(),
                s.eik_idx.clone())

        r = d.render
        if any(f is not None for f in r.fused):
            raise NotImplementedError("a sampled H1 backward's draws")
        render = RenderDraws(sampler(r.sampler), r.eik_uniform.clone(),
                             r.nei.clone())
        return cls(d.jitter.clone(), render,
                   None if d.bg_uv is None else d.bg_uv.clone(),
                   sampler(d.bg_sampler))


def train_step(model: HoloSceneModel, optimizer, scheduler, lcfg: LossConfig,
               batch: dict, draws: Draws, step_idx: int,
               call_reg: bool = False, drop_half: bool = False):
    """One optimizer step; returns the loss (0-d tensor). drop_half leaves
    out the second half of the rays (a planted fault: the losses' means are
    then over the rest)."""
    optimizer.zero_grad(set_to_none=True)
    n = batch["uv"].shape[0]
    rows = slice(0, n // 2) if drop_half else slice(None)
    rays_o, rays_d, dscale, w2c = rays_from_batch(
        batch["uv"][rows], batch["pose"], batch["intrinsics"],
        draws.jitter[rows])
    rd = draws.render if not drop_half else draws.render.rows(rows, n)
    out = render_rays(model, rays_o, rays_d, dscale, w2c, rd)
    if draws.bg_uv is not None:
        uv = bg_patch_uv(batch["intrinsics"], draws.bg_uv)
        po, pd, pscale, pw2c = rays_from_batch(uv, batch["pose"],
                                               batch["intrinsics"])
        out.update(render_bg_patch(model, po, pd, pscale, pw2c,
                                   draws.bg_sampler))
    gt = {k: batch[k][rows] for k in ("rgb", "depth", "normal", "segs",
                                      "mask")}
    losses = holoscene_loss(out, gt, lcfg, step=step_idx, call_reg=call_reg)
    losses["loss"].backward()
    finite = torch.isfinite(losses["loss"].detach())
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            else:
                p.grad = torch.where(finite, p.grad, torch.zeros_like(p.grad))
    optimizer.step()
    if scheduler is not None:
        scheduler.step()
    return losses["loss"].detach()
