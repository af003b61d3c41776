"""Standalone free-Gaussian-splatting trainer (port of
holoscene_tpu/training/gs_trainer.py, the 3dgrut-core equivalent).

Fixed-capacity gaussians (models/gaussians_free.py); each step renders one
training frame (flat pipeline with cached bins, K1 forward / K2 backward,
or the top-K pipeline, K3 / K4), takes L1 + ssim_lambda * (1 - SSIM)
against a random background, and applies SelectiveAdam to the slots with a
positional gradient. Splatfacto refinement or MCMC relocation runs every
`refine_every` steps after `warmup`; eval renders PSNR / SSIM; checkpoints
resume exactly. Eval renders through the top-K compositor, as the
counterpart does.

Random draws: frames from a numpy Generator (the counterpart's), the
background, refine's eps and MCMC's targets from a torch.Generator on the
trainer's device (the counterpart draws them from a jax key). The first
two come through `draw_background` / `draw_refine_eps`, which the parity
tests replace with the counterpart's draws.
"""

from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch

from holoscene_tpu_torch import as_tensor, resolve_device
from holoscene_tpu_torch.models.gaussians_free import (
    FreeGaussianConfig,
    accumulate_positional_grads,
    free_flat_bins,
    free_project,
    init_free_gaussians,
    init_selective_adam,
    mcmc_relocate,
    refine_gaussians,
    render_free_gaussians,
    reset_moments,
    selective_adam_update,
)
from holoscene_tpu_torch.ops.splat_flat import FlatPlan, plan_flat
from holoscene_tpu_torch.ops.ssim import ssim as ssim_fn
from holoscene_tpu_torch.utils.eval_rgb import eval_rgb

GS_FREE_LRS = {
    "means": 1.6e-4,
    "log_scales": 5e-3,
    "quats": 1e-3,
    "opacity_logits": 5e-2,
    "features_dc": 2.5e-3,
    "features_rest": 2.5e-3 / 20.0,
}


class GSTrainer:
    def __init__(
        self,
        dataset,
        cfg: FreeGaussianConfig = FreeGaussianConfig(),
        seed_points: np.ndarray | None = None,
        seed_colors: np.ndarray | None = None,
        ssim_lambda: float = 0.2,
        warmup: int = 500,
        refine_every: int = 100,
        strategy: str = "splatfacto",  # or "mcmc"
        scene_extent: float = 1.0,
        seed: int = 0,
        quiet: bool = False,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.dataset = dataset
        self.cfg = cfg
        self.ssim_lambda = ssim_lambda
        self.warmup = warmup
        self.refine_every = refine_every
        self.strategy = strategy
        self.scene_extent = scene_extent
        self.quiet = quiet
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(self.device).manual_seed(seed)

        init_gen = torch.Generator().manual_seed(seed)
        self.params, self.state = init_free_gaussians(
            cfg, seed_points, seed_colors, scene_extent=scene_extent,
            generator=init_gen, device=self.device)
        self.moments = init_selective_adam(self.params)
        self.iter_step = 0
        self.history: list[dict] = []
        self.refines: list[dict] = []
        self.run_seconds = 0.0   # wall time inside run(), device synced

        self.use_flat = (cfg.use_flat if cfg.use_flat is not None
                         else self.device.type == "cuda")
        self.flat_plan = None
        self._flat_margin = 1.6  # densification grows footprints: headroom
        self._bins_cache: dict[int, dict] = {}
        self._bins_age: dict[int, int] = {}
        self._image_cache: dict[int, torch.Tensor] = {}
        if self.use_flat:
            self._init_flat_plan()

    # -- draws ---------------------------------------------------------------

    def draw_background(self) -> torch.Tensor:
        return torch.rand(3, generator=self.generator, device=self.device)

    def draw_refine_eps(self) -> torch.Tensor:
        return torch.randn(self.cfg.capacity, 3, generator=self.generator,
                           device=self.device)

    # -- flat plan / bins ----------------------------------------------------

    def _pose_intr(self, pose):
        return (as_tensor(pose, self.device),
                as_tensor(self.dataset.intrinsics[:3, :3], self.device))

    @torch.no_grad()
    def _init_flat_plan(self):
        """Probe frames 0, n/2, n-1 and keep the largest span / capacity."""
        ds, cfg = self.dataset, self.cfg
        h, w = ds.img_res
        tiles_x = -(-w // cfg.tile_size)
        tiles_y = -(-h // cfg.tile_size)
        best = None
        for f in sorted({0, ds.n_images // 2, ds.n_images - 1}):
            pose, intr = self._pose_intr(ds.pose_all[f])
            xy, _d, conic, opac, valid = free_project(
                self.params, self.state, cfg, pose, intr, w, h)
            pl = plan_flat(xy, conic, opac, valid, tiles_x, tiles_y,
                           cfg.tile_size, margin=self._flat_margin)
            best = pl if best is None else FlatPlan(
                span_x=max(best.span_x, pl.span_x),
                span_y=max(best.span_y, pl.span_y),
                c_max=max(best.c_max, pl.c_max))
        self.flat_plan = best
        if not self.quiet:
            print(f"[gs] flat plan {best} (rebin_every={cfg.rebin_every})")

    def _rebin(self, pose, intr):
        h, w = self.dataset.img_res
        return free_flat_bins(self.params, self.state, self.cfg, pose, intr,
                              w, h, self.flat_plan)

    def _get_bins(self, frame_idx: int, pose, intr):
        age = self._bins_age.get(frame_idx, 0)
        if frame_idx not in self._bins_cache or \
                age % max(self.cfg.rebin_every, 1) == 0:
            bins = self._rebin(pose, intr)
            if int(bins["overflow"]) != 0:
                if not self.quiet:
                    print("[gs] flat plan overflow; growing capacity")
                self._flat_margin *= 1.5
                self._init_flat_plan()
                self._bins_cache.clear()
                self._bins_age.clear()
                bins = self._rebin(pose, intr)
            self._bins_cache[frame_idx] = bins
        self._bins_age[frame_idx] = age + 1
        return self._bins_cache[frame_idx]

    # -- one step ------------------------------------------------------------

    def _frame_image(self, frame: int) -> torch.Tensor:
        if frame not in self._image_cache:
            h, w = self.dataset.img_res
            self._image_cache[frame] = as_tensor(
                self.dataset.rgb_images[frame].reshape(h, w, 3), self.device)
        return self._image_cache[frame]

    def step(self, pose, intr, image, bins, bg):
        """One SelectiveAdam step on one frame (image [H, W, 3], bg [3]).
        Returns (loss, psnr) as 0-dim tensors."""
        h, w = image.shape[0], image.shape[1]
        lam = self.ssim_lambda
        p = {k: v.detach().requires_grad_(True)
             for k, v in self.params.items()}
        out = render_free_gaussians(
            p, self.state, self.cfg, pose, intr, w, h, background=bg,
            flat_plan=self.flat_plan if self.use_flat else None,
            flat_bins=bins)
        rgb = out["rgb"]
        l1 = torch.mean(torch.abs(rgb - image))
        sim = 1.0 - ssim_fn(image, rgb)
        loss = (1 - lam) * l1 + lam * sim
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        with torch.no_grad():
            psnr = -10.0 * torch.log10(torch.mean((rgb - image) ** 2)
                                       + 1e-12)
            visibility = torch.linalg.vector_norm(grads["means"], dim=-1) > 0
            self.params, self.moments = selective_adam_update(
                grads, self.moments, self.params, visibility, GS_FREE_LRS)
            self.state = accumulate_positional_grads(self.state,
                                                     grads["means"])
        return loss.detach(), psnr

    def refine(self) -> dict:
        """One refinement event (splatfacto or MCMC); drops every cached
        bin (the gaussians moved too far for a stale plan)."""
        if self.strategy == "mcmc":
            self.params, self.state, stats = mcmc_relocate(
                self.params, self.state, self.cfg, generator=self.generator)
        else:
            self.params, self.state, stats = refine_gaussians(
                self.params, self.state, self.cfg, self.scene_extent,
                eps=self.draw_refine_eps())
        self.moments = reset_moments(self.moments, stats["reset_mask"])
        self._bins_cache.clear()
        self._bins_age.clear()
        return stats

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, n_iters: int = 1000, log_every: int = 50,
            eval_every: int = 0, ckpt_every: int = 0, ckpt_path: str = None):
        """Train for n_iters. eval_every > 0 runs a periodic eval of the
        test split (the train split without one); ckpt_every > 0
        checkpoints to ckpt_path."""
        start = self.iter_step
        end = start + n_iters
        self._sync()
        t0 = time.perf_counter()
        for it in range(start, end):
            frame = int(self.rng.integers(0, self.dataset.n_images))
            pose, intr = self._pose_intr(self.dataset.pose_all[frame])
            bins = (self._get_bins(frame, pose, intr)
                    if self.use_flat else None)
            loss, psnr = self.step(pose, intr, self._frame_image(frame), bins,
                                   self.draw_background())
            if it >= self.warmup and (it + 1) % self.refine_every == 0:
                before = int(self.state["alive"].sum())
                stats = self.refine()
                n_alive = int(self.state["alive"].sum())
                self.refines.append({"iter": it, "n_alive_before": before,
                                     "n_alive": n_alive,
                                     **{k: int(v) for k, v in stats.items()
                                        if k not in ("reset_mask",
                                                     "n_alive")}})
                if not self.quiet:
                    print(f"[gs] it {it} refine: alive={n_alive}")
            if it % log_every == 0 or it == end - 1:
                n_alive = int(self.state["alive"].sum())
                m = {"iter": it, "loss": float(loss), "psnr": float(psnr),
                     "n_alive": n_alive,
                     "splats_per_sec": n_alive * (it - start + 1)
                     / max(time.perf_counter() - t0, 1e-9)}
                self.history.append(m)
                if not self.quiet:
                    print(f"[gs] it {it} loss={m['loss']:.4f} "
                          f"psnr={m['psnr']:.2f}")
            if eval_every and (it + 1) % eval_every == 0:
                ev = self.eval_split("test" if self.dataset.test else "train",
                                     max_frames=4)
                self.history.append({"iter": it, **{f"eval_{k}": v
                                                    for k, v in ev.items()}})
                if not self.quiet:
                    print(f"[gs] it {it} eval psnr={ev['psnr']:.2f} "
                          f"ssim={ev['ssim']:.3f}")
            if ckpt_every and ckpt_path and (it + 1) % ckpt_every == 0:
                self.iter_step = it + 1
                self.save_checkpoint(ckpt_path)
        self._sync()
        self.run_seconds += time.perf_counter() - t0
        self.iter_step = end
        return self.history

    # -- checkpoint / resume -------------------------------------------------

    def save_checkpoint(self, path: str) -> str:
        """Pickle with the counterpart's keys; "key" holds the torch
        generator's state where the counterpart keeps its jax key."""
        def to_np(tree):
            return {k: v.detach().cpu().numpy() for k, v in tree.items()}

        blob = {
            "params": to_np(self.params), "state": to_np(self.state),
            "moments": {"m": to_np(self.moments["m"]),
                        "v": to_np(self.moments["v"]),
                        "count": np.asarray(self.moments["count"])},
            "iter_step": self.iter_step,
            "key": self.generator.get_state().numpy(),
            "history": self.history, "strategy": self.strategy,
            "rng_state": self.rng.bit_generator.state,
        }
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(blob, f)
        os.replace(tmp, path)
        return path

    def load_checkpoint(self, path: str):
        """Resume from save_checkpoint's file (this pipeline's own: unpickle
        nothing from elsewhere)."""
        with open(path, "rb") as f:
            blob = pickle.load(f)

        def to_t(tree):
            return {k: torch.as_tensor(np.asarray(v), device=self.device)
                    for k, v in tree.items()}

        self.params = to_t(blob["params"])
        self.state = to_t(blob["state"])
        self.moments = {"m": to_t(blob["moments"]["m"]),
                        "v": to_t(blob["moments"]["v"]),
                        "count": int(blob["moments"]["count"])}
        self.iter_step = int(blob["iter_step"])
        self.generator.set_state(torch.as_tensor(
            np.asarray(blob["key"], np.uint8)))
        self.history = list(blob["history"])
        if "rng_state" in blob:
            self.rng.bit_generator.state = blob["rng_state"]
        self._bins_cache.clear()
        self._bins_age.clear()
        return self

    # -- eval / export -------------------------------------------------------

    @torch.no_grad()
    def eval_split(self, split: str = "test", max_frames: int = 8) -> dict:
        """PSNR / SSIM / LPIPS of up to max_frames views on a black
        background, rendered through the top-K compositor at
        cfg.max_per_tile (K3 on the card), as the counterpart renders
        them."""
        src = self.dataset.test if split == "test" else None
        n = len(src["pose_all"]) if src is not None else self.dataset.n_images
        h, w = self.dataset.img_res
        zero = torch.zeros(3, device=self.device)
        metrics = []
        for i in range(min(n, max_frames)):
            pose = (src["pose_all"] if src else self.dataset.pose_all)[i]
            gt = (src["rgb_images"] if src else self.dataset.rgb_images)[i]
            pose, intr = self._pose_intr(pose)
            out = render_free_gaussians(self.params, self.state, self.cfg,
                                        pose, intr, w, h, background=zero)
            metrics.append(eval_rgb(out["rgb"].cpu().numpy(),
                                    gt.reshape(h, w, 3)))
        return {k: float(np.mean([m[k] for m in metrics]))
                for k in metrics[0]}

    def export(self, path: str) -> str:
        """The artifact the extension picks: .ply (3DGS), .usdz (NuRec) or
        .ingp (Instant-NGP), alive slots only."""
        from holoscene_tpu_torch.export import export_gaussian_artifact

        alive = self.state["alive"].cpu().numpy()
        g = {k: self.params[k].detach().cpu().numpy()[alive]
             for k in ("means", "quats", "log_scales", "opacity_logits",
                       "features_dc", "features_rest")}
        return export_gaussian_artifact(path, g)
