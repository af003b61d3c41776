# Frozen copy of holoscene_tpu_torch/training/stage4.py at commit badb067
# (GS_LRS, make_gs_optimizer, the flat plan's probe, its saturation trim,
# the per-frame bin cache with its stale evictions, the mesh raster, _step
# and _invis_step) for the benchmark's plain reference, driven by a
# recorded sequence of iterations instead of the runner's own random
# choices.
"""The plain Stage-4 trainer: the reference follows the program's checked
iterations, given each iteration's frame, background, whether a run()
call ended with it, and (with generated views) its object, view pack and
second background."""

from __future__ import annotations

import dataclasses

import torch

from port_bench.ref_s4 import as_tensor
from port_bench.ref_s4.gom import (
    GoMConfig,
    gom_flat_bins,
    gom_loss,
    gom_opacities,
    gom_project,
    gom_scales,
    render_gom,
)
from port_bench.ref_s4.rasterizer import rasterize_mesh_list
from port_bench.ref_s4.splat_flat import FlatPlan, plan_flat, plan_trimmed

GS_LRS = {
    "means_2d": 1.6e-4,
    "normal_elevates": 1.6e-4,
    "features_dc": 2.5e-3,
    "features_rest": 2.5e-3 / 20.0,
    "opacities": 5e-2,
    "scales": 5e-3,
    "quats": 1e-3,
}


def make_gs_optimizer(params: dict, total_iters: int):
    decay = 0.1 ** (1.0 / max(total_iters, 1))
    opt = torch.optim.Adam(
        [{"params": [params[k]], "lr": lr, "name": k}
         for k, lr in GS_LRS.items()],
        betas=(0.9, 0.99), eps=1e-15)
    return opt, torch.optim.lr_scheduler.ExponentialLR(opt, gamma=decay)


class RefStage4:
    """static: seed_gaussians_from_meshes' geometry of the meshes
    (ref_s4.mesh.Mesh list, rasterised for the depth and coverage terms),
    init: init_gom_params' tensors on it (copied here); frames: {"rgb" [F, H, W, 3] float32, "poses" [F, 4, 4] float32
    normalised OpenCV c2w, "intrinsics" [3, 3]} of the training split."""

    def __init__(self, static: dict, init: dict, meshes, frames: dict,
                 cfg: GoMConfig, loss_scale: float, total_iters: int, device):
        self.device = device
        self.cfg = cfg
        self.frames = frames
        self.loss_scale = loss_scale
        self.static = static
        self.meshes = meshes
        self.params = {k: v.detach().clone().requires_grad_(True)
                       for k, v in init.items()}
        self.h, self.w = frames["rgb"].shape[1:3]
        self._margin = 1.3
        if cfg.max_per_tile <= 0:
            self.cfg = cfg = dataclasses.replace(cfg, max_per_tile=256)
        self.bins: dict = {}
        self.age: dict = {}
        self.used: dict = {}
        self.raster: dict = {}
        self.pending = None     # (frame, stale) read at the next step
        self._init_flat_plan()
        self.optimizer, self.scheduler = make_gs_optimizer(self.params,
                                                           total_iters)

    def _pose_intr(self, f: int):
        return (as_tensor(self.frames["poses"][f], self.device),
                as_tensor(self.frames["intrinsics"], self.device))

    @torch.no_grad()
    def _init_flat_plan(self):
        cfg, h, w = self.cfg, self.h, self.w
        tiles_x, tiles_y = -(-w // cfg.tile_size), -(-h // cfg.tile_size)
        n = len(self.frames["poses"])
        opac = gom_opacities(self.params)
        best = None
        for f in sorted({0, n // 2, n - 1}):
            pose, intr = self._pose_intr(f)
            xy, _d, conic, valid = gom_project(self.params, self.static, cfg,
                                               pose, intr, w, h)
            pl = plan_flat(xy, conic, opac, valid, tiles_x, tiles_y,
                           cfg.tile_size, margin=self._margin)
            best = pl if best is None else FlatPlan(
                span_x=max(best.span_x, pl.span_x),
                span_y=max(best.span_y, pl.span_y),
                c_max=max(best.c_max, pl.c_max))
        self.plan_full = self.plan = best
        self.trim_active = False

    def _maybe_trim(self):
        """The trimmed plan, once every training frame has reported its
        walked chunks and holds bins."""
        n = len(self.frames["poses"])
        if self.trim_active or not self.cfg.trim_flat or len(self.used) < n:
            return
        if any(f not in self.bins for f in self.used):
            return
        c_max = max(plan_trimmed(self.plan_full,
                                 self.bins[f]["tile_chunk_cnt"], u,
                                 trim_slack=self.cfg.trim_slack).c_max
                    for f, u in self.used.items())
        self.trim_active = True
        if c_max < self.plan_full.c_max:
            self.plan = FlatPlan(span_x=self.plan_full.span_x,
                                 span_y=self.plan_full.span_y, c_max=c_max)
            self.bins.clear()
            self.age.clear()

    def _mesh_raster(self, f: int, max_faces: int = 150_000):
        if f not in self.raster:
            if any(len(m.faces) > max_faces for m in self.meshes):
                raise NotImplementedError(f"a mesh over {max_faces} faces "
                                          "(the program decimates it)")
            out = rasterize_mesh_list(
                [(m.vertices, m.faces) for m in self.meshes],
                self.frames["poses"][f],
                self.frames["intrinsics"], (self.h, self.w),
                device=self.device)
            depth = out["depth"]
            fill = depth[out["mask"]].max() if bool(out["mask"].any()) \
                else torch.ones((), device=self.device)
            self.raster[f] = (out["mask"].float(),
                              torch.where(out["mask"], depth, fill))
        return self.raster[f]

    def _bins_of(self, pose, intr, used):
        return gom_flat_bins(self.params, self.static, self.cfg, pose, intr,
                             self.w, self.h, self.plan, used_chunks=used)

    def _get_bins(self, f: int, pose, intr):
        age = self.age.get(f, 0)
        if f not in self.bins or age % max(self.cfg.rebin_every, 1) == 0:
            used = self.used.get(f) if self.trim_active else None
            bins = self._bins_of(pose, intr, used)
            if int(bins["overflow"]) != 0:
                self._margin *= 1.5
                self._init_flat_plan()
                self.bins.clear()
                self.age.clear()
                bins = self._bins_of(pose, intr, None)
            self.bins[f] = bins
        self.age[f] = age + 1
        return self.bins[f]

    def step(self, f: int, bg: torch.Tensor, drop_half: bool = False,
             last_in_call: bool = False):
        """One training-frame step; returns the total loss. A frame whose
        trimmed walk ran to the end of a tile's list while live (stale) has
        its bins dropped before the next step, unless the run() call ended
        with this step. drop_half leaves out the bottom half of the image
        (a planted fault: the losses' means over the rest)."""
        cfg = self.cfg
        acm, mesh_depth = self._mesh_raster(f)
        image = as_tensor(self.frames["rgb"][f].transpose(2, 0, 1),
                          self.device).contiguous()
        pose, intr = self._pose_intr(f)
        if self.pending is not None:
            sf, stale = self.pending
            self.pending = None
            if stale:
                self.bins.pop(sf, None)
                self.age.pop(sf, None)
        bins = self._get_bins(f, pose, intr)
        out = render_gom(self.params, self.static, cfg, pose, intr, self.w,
                         self.h, bg, flat_plan=self.plan, flat_bins=bins,
                         chw=True)
        batch = {"image": image * acm[None] + (1 - acm[None])
                 * bg[:, None, None], "acm": acm, "mesh_depth": mesh_depth,
                 "mask": None}
        if drop_half:
            rows = slice(0, self.h // 2)
            out = {k: (v[:, rows] if k == "rgb" else v[rows])
                   if k in ("rgb", "depth", "accumulation") else v
                   for k, v in out.items()}
            batch = {"image": batch["image"][:, rows], "acm": acm[rows],
                     "mesh_depth": mesh_depth[rows], "mask": None}
        losses = gom_loss(out, batch, cfg,
                          with_scale_reg=cfg.use_scale_regularization,
                          scales_linear=gom_scales(self.params, self.static,
                                                   cfg), chw=True)
        total = losses["main_loss"] * self.loss_scale + losses["scale_reg"]
        self.optimizer.zero_grad(set_to_none=True)
        total.backward()
        self.optimizer.step()
        self.scheduler.step()
        self.used[f] = out["used_chunks"]
        if self.trim_active and not last_in_call:
            self.pending = (f, int(out["stale"]))
        self._maybe_trim()
        return float(total.detach())

    def invis_step(self, obj: int, pack: dict, bg: torch.Tensor) -> float:
        """One generated-view step on object `obj`'s gaussians alone;
        returns its l1."""
        dev = self.device
        image = as_tensor(pack["rgb"], dev)
        mask = as_tensor(pack["mask"], dev)
        pose = as_tensor(pack["pose"], dev)
        half = float(pack["half_extent"])
        h, w = image.shape[0], image.shape[1]
        intr = torch.tensor([[w / (2 * half), 0.0, w / 2.0],
                             [0.0, h / (2 * half), h / 2.0],
                             [0.0, 0.0, 1.0]], device=dev)
        lo, hi = self.static["instance_ranges"][obj]
        idx = torch.arange(self.static["num_gaussians"], device=dev)
        visible = (idx >= lo) & (idx < hi)
        out = render_gom(self.params, self.static, self.cfg, pose, intr, w,
                         h, bg, visible_mask=visible, ortho=True)
        m = mask[..., None]
        gt = image * m + (1 - m) * bg
        l1 = torch.mean(torch.abs(out["rgb"] - gt))
        acm = torch.mean(torch.abs(out["accumulation"] - mask))
        self.optimizer.zero_grad(set_to_none=True)
        (l1 + acm).backward()
        self.optimizer.step()
        self.scheduler.step()
        return float(l1.detach())
