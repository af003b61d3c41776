"""Stage-4 (Gaussian-on-Mesh) data parallelism over the ranks of a mesh
(port of holoscene_tpu/parallel/stage4_dp.py).

Each data rank renders its own training frame through the whole
single-frame pipeline (the flat path's K1/K2 walks, or without a flat plan
the top-K path's K3/K4; the kernels never see a batch dimension), takes
gom_loss's gradient, and the gradients and the metrics are averaged over
the data group (one all_reduce each). Every rank then applies the same
optimizer update to its identical copy of the parameters.

A dp-B step averages the gradients of B distinct frames: the
single-process step on the mean of the B frames' gradients
(tests/test_torch_parallel.py holds it to that)."""

from __future__ import annotations

import torch

from holoscene_tpu_torch.models.gom import gom_loss, gom_scales, render_gom
from holoscene_tpu_torch.parallel.mesh import Mesh, all_reduce_sum, gather_rows

METRICS = ("main_loss", "scale_reg", "l1", "ssim_loss", "acm_loss",
           "depth_loss", "loss", "psnr")


def frame_loss(params, static: dict, cfg, flat_plan, loss_scale: float,
               width: int, height: int, pose, intr, image, acm, mesh_depth,
               bins, bg):
    """One frame's Stage-4 training loss (the trainer step's): returns
    (total, gom_loss's dict, the render)."""
    out = render_gom(params, static, cfg, pose, intr, width, height, bg,
                     flat_plan=flat_plan, flat_bins=bins, chw=True)
    batch = {
        "image": image * acm[None] + (1 - acm[None]) * bg[:, None, None],
        "acm": acm,
        "mesh_depth": mesh_depth,
        "mask": None,
    }
    losses = gom_loss(out, batch, cfg,
                      with_scale_reg=cfg.use_scale_regularization,
                      scales_linear=gom_scales(params, static, cfg), chw=True)
    return losses["main_loss"] * loss_scale + losses["scale_reg"], losses, out


def make_stage4_dp_step(mesh: Mesh, optimizer, static: dict, cfg, flat_plan,
                        loss_scale: float, width: int, height: int):
    """The dp step: step(params, pose, intr, image, acm, mesh_depth, bins,
    bg) -> (metrics, used [B, T], stale [B]) for this rank's frame (image
    channels-major [3, H, W], acm / mesh_depth [H, W], bins the frame's
    cached flat plan or None on the top-K path, bg [3] the frame's random
    background). `optimizer` holds the tensors of `params`, which the step
    updates in place, identically on every rank; metrics are the means
    over the B = n_data frames, used / stale every frame's walk telemetry
    (zeros on the top-K path)."""
    group = mesh.data_group
    n = mesh.n_data
    me = slice(mesh.data_index, mesh.data_index + 1)

    def step(params, pose, intr, image, acm, mesh_depth, bins, bg):
        optimizer.zero_grad(set_to_none=True)
        total, losses, out = frame_loss(params, static, cfg, flat_plan,
                                        loss_scale, width, height, pose, intr,
                                        image, acm, mesh_depth, bins, bg)
        total.backward()
        grads = []
        for p in params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        all_reduce_sum(grads, group)
        for g in grads:
            g.div_(n)
        optimizer.step()
        with torch.no_grad():
            psnr = -10.0 * torch.log10(
                torch.mean((out["rgb"] - image) ** 2) + 1e-12)
            vals = {**losses, "loss": total, "psnr": psnr}
            m = torch.stack([vals[k].detach().float() for k in METRICS])
            all_reduce_sum([m], group)
            metrics = dict(zip(METRICS, m / n))
            if flat_plan is not None:
                used = out["used_chunks"][None]
                stale = out["stale"].reshape(1).to(used.dtype)
            else:
                used = stale = torch.zeros(1, dtype=torch.int32,
                                           device=bg.device)
            used = gather_rows(used, me, n, group)
            stale = gather_rows(stale, me, n, group)
        return metrics, used, stale

    return step
