"""Stage-4 runner: Gaussian-on-Mesh appearance training (port of
holoscene_tpu/training/stage4.py).

Each step: GoM reparameterisation -> EWA projection -> compositing -> image
epilogue -> gom_loss with SSIM -> backward -> payload-gather transpose ->
Adam. Compositing is the flat pipeline by default (cached binning, K1
forward walk, K2 backward walk) and the top-K pipeline with
GoMConfig(use_flat=False) (per-tile selection, K3 forward, K4 backward; K
from the config or auto-calibrated at start). With Stage-2 generated-view
packs loaded (`load_vis_info`), every iteration adds one invisible-view
step: one object's gaussians alone, rendered orthographically through the
top-K pipeline against the pack's image and mask. The mesh mask/depth of
every training frame is rasterized once at init (the mesh is frozen in
Stage 4).

TF32 is switched off for the process when the runner is built: cuDNN would
otherwise run SSIM's float32 blur convolutions in TF32 (about three decimal
digits) and the loss would no longer be the float32 loss the reference and
the tests compute.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import time

import numpy as np
import torch

from holoscene_tpu_torch import as_tensor, resolve_device
from holoscene_tpu_torch.export.gs_usdz import export_from_gaussian_dict
from holoscene_tpu_torch.models.gom import (
    GoMConfig,
    compose_for_export,
    gom_flat_bins,
    gom_loss,
    gom_means,
    gom_opacities,
    gom_project,
    gom_quats,
    gom_scales,
    init_gom_params,
    render_gom,
    seed_gaussians_from_meshes,
    write_gaussian_ply,
)
from holoscene_tpu_torch.ops.gaussians import view_matrix
from holoscene_tpu_torch.ops.rasterizer import rasterize_mesh_list
from holoscene_tpu_torch.ops.splat import (
    auto_max_per_tile,
    calibrate_max_per_tile,
    tile_overlap_counts,
)
from holoscene_tpu_torch.ops.splat_flat import FlatPlan, plan_flat, plan_trimmed
from holoscene_tpu_torch.utils.eval_rgb import eval_rgb
from holoscene_tpu_torch.utils.mesh import Mesh

GS_LRS = {
    "means_2d": 1.6e-4,
    "normal_elevates": 1.6e-4,
    "features_dc": 2.5e-3,
    "features_rest": 2.5e-3 / 20.0,
    "opacities": 5e-2,
    "scales": 5e-3,
    "quats": 1e-3,
}


def make_gs_optimizer(params: dict, total_iters: int, lr_scale: float = 1.0):
    """Adam per parameter group (b1=0.9, b2=0.99, eps=1e-15, the optax
    scale_by_adam update) with the learning rate decayed by
    0.1 ** (t / total_iters), t = updates already applied. Returns
    (optimizer, scheduler); call scheduler.step() after every update."""
    decay = 0.1 ** (1.0 / max(total_iters, 1))
    opt = torch.optim.Adam(
        [{"params": [params[k]], "lr": lr * lr_scale, "name": k}
         for k, lr in GS_LRS.items()],
        betas=(0.9, 0.99), eps=1e-15)
    return opt, torch.optim.lr_scheduler.ExponentialLR(opt, gamma=decay)


class Stage4Runner:
    def __init__(
        self,
        meshes: list[Mesh],
        dataset,
        cfg: GoMConfig = GoMConfig(),
        area_to_subdivide: float = 1e-5,
        max_total_iters: int | None = None,
        out_dir: str = "stage4_out",
        loss_scale: float = 5.0,
        seed: int = 0,
        quiet: bool = False,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = cfg
        self.dataset = dataset
        self.out_dir = out_dir
        self.loss_scale = loss_scale
        self.quiet = quiet
        os.makedirs(out_dir, exist_ok=True)

        self.static = seed_gaussians_from_meshes(
            meshes, area_to_subdivide, cfg, device=self.device)
        self.meshes = meshes
        self.instance_ranges = self.static["instance_ranges"]
        self.params = init_gom_params(self.static, cfg)

        self.use_flat = cfg.use_flat is not False
        self.k_geom = None   # p99 overlap bound, set by the auto-K probe
        self.flat_plan = None
        self.flat_plan_full = None
        self._flat_margin = 1.3
        self._bins_cache: dict[int, dict] = {}
        self._bins_age: dict[int, int] = {}
        if self.use_flat:
            if cfg.max_per_tile <= 0:
                # the flat path has no K, but the orthographic invisible-
                # view renders still go through the top-K compositor
                self.cfg = cfg = dataclasses.replace(cfg, max_per_tile=256)
            self._init_flat_plan()
        elif cfg.max_per_tile <= 0:
            self.cfg = cfg = dataclasses.replace(
                cfg, max_per_tile=self._auto_max_per_tile())

        n_iters = max_total_iters or 200 * len(meshes)
        self.max_total_iters = n_iters
        self.optimizer, self.scheduler = make_gs_optimizer(self.params,
                                                           n_iters)
        self.rng = np.random.default_rng(seed)
        # per-step random background (the reference draws it from a jax key)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.iter_step = 0
        self._mesh_cache: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        self._chw_cache: dict[int, torch.Tensor] = {}
        self.history: list[dict] = []
        self.run_seconds = 0.0   # wall time inside run(), device synced
        self.test_metrics: dict | None = None   # set by the CLI after eval

        self._used_cache: dict[int, torch.Tensor] = {}
        self._trim_active = False
        self.stale_steps = 0
        self.rebin_count = 0
        self.vis_info_list: list[list[dict]] = [[] for _ in meshes]
        self.invis_steps = 0
        for f in range(self.dataset.n_images):
            self._frame_mesh_raster(f)

    # -- compositing depth / flat plan --------------------------------------

    @torch.no_grad()
    def _auto_max_per_tile(self) -> int:
        """Top-K depth for this scene: the p99 tile overlap of frame 0
        bounds the search, the saturation calibration (render at K vs 2K
        until the image stops changing) picks the depth; compositing cost
        is linear in K and deep tiles are mostly saturated."""
        cfg = self.cfg
        h, w = self.dataset.img_res
        pose, intr = self._pose_intr(0)
        counts = tile_overlap_counts(
            gom_means(self.params, self.static, cfg),
            gom_quats(self.params, self.static, cfg),
            gom_scales(self.params, self.static, cfg),
            view_matrix(pose, self.device), intr, int(w), int(h),
            tile_size=cfg.tile_size)
        self.k_geom = auto_max_per_tile(counts)
        bg = torch.zeros(3, device=self.device)

        def render_k(k):
            kcfg = dataclasses.replace(cfg, max_per_tile=int(k))
            return render_gom(self.params, self.static, kcfg, pose, intr,
                              int(w), int(h), bg)["rgb"]

        k = calibrate_max_per_tile(render_k, hi=self.k_geom)
        if not self.quiet:
            print(f"[stage4] auto max_per_tile={k} (saturation-calibrated "
                  f"under the p99 overlap bound {self.k_geom})")
        return k

    def _pose_intr(self, frame_idx: int, split_poses=None):
        poses = self.dataset.pose_all if split_poses is None else split_poses
        return (as_tensor(poses[frame_idx], self.device),
                as_tensor(self.dataset.intrinsics[:3, :3], self.device))

    @torch.no_grad()
    def _init_flat_plan(self):
        """Probe frames 0, n/2, n-1 and keep the largest span/capacity."""
        h, w = self.dataset.img_res
        cfg = self.cfg
        tiles_x = -(-w // cfg.tile_size)
        tiles_y = -(-h // cfg.tile_size)
        frames = sorted({0, self.dataset.n_images // 2,
                         self.dataset.n_images - 1})
        opac = gom_opacities(self.params)
        best = None
        for f in frames:
            pose, intr = self._pose_intr(f)
            xy, _depth, conic, valid = gom_project(
                self.params, self.static, cfg, pose, intr, w, h)
            pl = plan_flat(xy, conic, opac, valid, tiles_x, tiles_y,
                           cfg.tile_size, margin=self._flat_margin)
            best = pl if best is None else FlatPlan(
                span_x=max(best.span_x, pl.span_x),
                span_y=max(best.span_y, pl.span_y),
                c_max=max(best.c_max, pl.c_max))
        self.flat_plan_full = best  # eval renders + trim fallback
        self.flat_plan = best
        if not self.quiet:
            print(f"[stage4] flat plan {best} "
                  f"(rebin_every={cfg.rebin_every})")

    def _grow_flat_plan(self):
        """Overflow recovery: re-probe with a 1.5x capacity margin; any
        active trim resets."""
        self._flat_margin *= 1.5
        self._trim_active = False
        self._init_flat_plan()
        self._bins_cache.clear()
        self._bins_age.clear()

    def _maybe_trim_plan(self):
        """Swap to the saturation-trimmed plan once every training frame
        has reported walked-chunk counts."""
        if (self._trim_active or not self.cfg.trim_flat
                or len(self._used_cache) < self.dataset.n_images):
            return
        full = self.flat_plan_full
        c_max = 0
        for f, used in self._used_cache.items():
            bins = self._bins_cache.get(f)
            if bins is None:
                return  # frame's bins evicted before trim; wait for revisit
            pl = plan_trimmed(full, bins["tile_chunk_cnt"], used,
                              trim_slack=self.cfg.trim_slack)
            c_max = max(c_max, pl.c_max)
        self._trim_active = True
        if c_max >= full.c_max:
            return  # nothing to gain
        self.flat_plan = FlatPlan(span_x=full.span_x, span_y=full.span_y,
                                  c_max=c_max)
        self._bins_cache.clear()
        self._bins_age.clear()
        if not self.quiet:
            print(f"[stage4] trim active: c_max {full.c_max} -> {c_max} "
                  f"({100 * c_max / full.c_max:.0f}%)")

    def _rebin(self, pose, intr, used):
        h, w = self.dataset.img_res
        return gom_flat_bins(self.params, self.static, self.cfg, pose, intr,
                             w, h, self.flat_plan, used_chunks=used)

    def _refresh_bins(self, frame_idx: int, pose, intr):
        used = (self._used_cache.get(frame_idx)
                if self._trim_active else None)
        bins = self._rebin(pose, intr, used)
        if int(bins["overflow"]) != 0:
            if not self.quiet:
                print(f"[stage4] flat plan overflow at frame {frame_idx}; "
                      "growing capacity")
            self._grow_flat_plan()
            bins = self._rebin(pose, intr, None)
        return bins

    def _get_bins(self, frame_idx: int, pose, intr):
        age = self._bins_age.get(frame_idx, 0)
        period = max(self.cfg.rebin_every, 1) * (
            8 if self.cfg.rebin_drift_px > 0 else 1)
        if frame_idx not in self._bins_cache or age % period == 0:
            self._bins_cache[frame_idx] = self._refresh_bins(
                frame_idx, pose, intr)
            self.rebin_count += 1
        self._bins_age[frame_idx] = age + 1
        return self._bins_cache[frame_idx]

    # -- one step -----------------------------------------------------------

    def _step(self, pose, intr, image, acm, mesh_depth, bins, bg):
        """One Adam step on one frame. image arrives channels-major
        [3, H, W]; bg [3] is the random background; bins is None on the
        top-K path. Returns (metrics dict of 0-dim tensors, used_chunks
        [T], stale [], drift [])."""
        cfg = self.cfg
        h, w = image.shape[1], image.shape[2]
        out = render_gom(self.params, self.static, cfg, pose, intr, w, h, bg,
                         flat_plan=self.flat_plan, flat_bins=bins, chw=True)
        batch = {
            "image": image * acm[None] + (1 - acm[None]) * bg[:, None, None],
            "acm": acm,
            "mesh_depth": mesh_depth,
            "mask": None,
        }
        losses = gom_loss(out, batch, cfg,
                          with_scale_reg=cfg.use_scale_regularization,
                          scales_linear=gom_scales(self.params, self.static,
                                                   cfg),
                          chw=True)
        total = losses["main_loss"] * self.loss_scale + losses["scale_reg"]
        self.optimizer.zero_grad(set_to_none=True)
        total.backward()
        self.optimizer.step()
        self.scheduler.step()
        with torch.no_grad():
            psnr = -10.0 * torch.log10(
                torch.mean((out["rgb"] - image) ** 2) + 1e-12)
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = total.detach()
        metrics["psnr"] = psnr
        # used_chunks feeds the flat trim: required, never defaulted; the
        # stale flag and the drift exist on the flat path only
        zero = torch.zeros((), device=self.device)
        return (metrics, out["used_chunks"], out.get("stale", zero.int()),
                out.get("xy_drift", zero))

    def _invis_step(self, pose, half_extent: float, image, mask,
                    visible_mask, bg):
        """Invisible-view supervision: one Adam step on ONE object's
        gaussians (visible_mask) rendered from a generated orthographic
        view through the top-K compositor. image [H, W, 3], mask [H, W],
        bg [3]. Returns the l1 (0-dim tensor)."""
        h, w = image.shape[0], image.shape[1]
        intr = torch.tensor(
            [[w / (2 * half_extent), 0.0, w / 2.0],
             [0.0, h / (2 * half_extent), h / 2.0],
             [0.0, 0.0, 1.0]], device=self.device)
        out = render_gom(self.params, self.static, self.cfg, pose, intr, w,
                         h, bg, visible_mask=visible_mask, ortho=True)
        m = mask[..., None]
        gt = image * m + (1 - m) * bg
        l1 = torch.mean(torch.abs(out["rgb"] - gt))
        acm = torch.mean(torch.abs(out["accumulation"] - mask))
        self.optimizer.zero_grad(set_to_none=True)
        (l1 + acm).backward()
        self.optimizer.step()
        self.scheduler.step()
        self.invis_steps += 1
        return l1.detach()

    def _frame_mesh_raster(self, frame_idx: int, max_faces: int = 150_000):
        """Cached mesh mask + depth of a training frame (meshes above the
        face cap rasterize decimated)."""
        if frame_idx not in self._mesh_cache:
            if not hasattr(self, "_raster_meshes"):
                self._raster_meshes = [
                    m.decimate(max_faces) if len(m.faces) > max_faces else m
                    for m in self.meshes
                ]
            h, w = self.dataset.img_res
            out = rasterize_mesh_list(
                [(m.vertices, m.faces) for m in self._raster_meshes],
                self.dataset.pose_all[frame_idx],
                self.dataset.intrinsics[:3, :3], (h, w), device=self.device)
            mask = out["mask"].float()
            depth = out["depth"]
            fill = depth[out["mask"]].max() if bool(out["mask"].any()) \
                else torch.ones((), device=self.device)
            depth = torch.where(out["mask"], depth, fill)
            self._mesh_cache[frame_idx] = (mask, depth)
        return self._mesh_cache[frame_idx]

    def load_vis_info(self, plots_dir: str):
        """Attach Stage-2 generated-view packs (bg_info.pkl for mesh 0,
        vis_info_{i}.pkl for mesh i; each a pickled list of dicts with
        pose, half_extent, rgb, mask) for invisible-view supervision. The
        packs are this pipeline's own files: unpickle nothing from
        elsewhere."""
        for i in range(len(self.meshes)):
            name = "bg_info.pkl" if i == 0 else f"vis_info_{i}.pkl"
            p = os.path.join(plots_dir, name)
            if os.path.exists(p):
                with open(p, "rb") as f:
                    self.vis_info_list[i] = pickle.load(f)

    def _visible_mask(self, obj_i: int) -> torch.Tensor:
        lo, hi = self.instance_ranges[obj_i]
        idx = torch.arange(self.static["num_gaussians"], device=self.device)
        return (idx >= lo) & (idx < hi)

    def run(self, n_iters: int | None = None, log_every: int = 20):
        end = self.iter_step + (n_iters
                                or self.max_total_iters - self.iter_step)
        h, w = self.dataset.img_res
        t0 = time.perf_counter()
        vis_objs = [i for i, v in enumerate(self.vis_info_list) if v]
        invis_l1 = None
        pending_stale = None  # (frame_idx, device scalar), read next iter
        pending_drift = None
        for it in range(self.iter_step, end):
            frame_idx = int(self.rng.integers(0, self.dataset.n_images))
            acm, mesh_depth = self._frame_mesh_raster(frame_idx)
            if frame_idx not in self._chw_cache:
                self._chw_cache[frame_idx] = as_tensor(
                    self.dataset.rgb_images[frame_idx].reshape(h, w, 3)
                    .transpose(2, 0, 1), self.device).contiguous()
            image = self._chw_cache[frame_idx]
            pose, intr = self._pose_intr(frame_idx)
            if pending_stale is not None:
                # one-step-delayed readback: the producing step has retired
                sf, sv = pending_stale
                pending_stale = None
                if int(sv):
                    self.stale_steps += 1
                    self._bins_cache.pop(sf, None)
                    self._bins_age.pop(sf, None)
            if pending_drift is not None:
                df, dv = pending_drift
                pending_drift = None
                if float(dv) > self.cfg.rebin_drift_px:
                    self._bins_cache.pop(df, None)
            bins = (self._get_bins(frame_idx, pose, intr)
                    if self.use_flat else None)
            bg = torch.rand(3, generator=self.generator, device=self.device)
            metrics, used, stale, drift = self._step(
                pose, intr, image, acm, mesh_depth, bins, bg)
            if self.use_flat:
                self._used_cache[frame_idx] = used
                if self._trim_active:
                    pending_stale = (frame_idx, stale)
                if self.cfg.rebin_drift_px > 0:
                    pending_drift = (frame_idx, drift)
                self._maybe_trim_plan()
            if vis_objs:
                # one random object's generated view per iteration
                obj_i = int(self.rng.choice(vis_objs))
                packs = self.vis_info_list[obj_i]
                pack = packs[int(self.rng.integers(len(packs)))]
                if "half_extent" in pack and "rgb" in pack:
                    bg = torch.rand(3, generator=self.generator,
                                    device=self.device)
                    invis_l1 = self._invis_step(
                        as_tensor(pack["pose"], self.device),
                        float(pack["half_extent"]),
                        as_tensor(pack["rgb"], self.device),
                        as_tensor(pack["mask"], self.device),
                        self._visible_mask(obj_i), bg)
            if it % log_every == 0 or it == end - 1:
                m = {k: float(v) for k, v in metrics.items()}
                if invis_l1 is not None:
                    m["invis_l1"] = float(invis_l1)
                elapsed = time.perf_counter() - t0
                m["iter"] = it
                m["elapsed_s"] = elapsed   # since run() began, host clock
                m["stale_steps"] = self.stale_steps
                m["rebin_count"] = self.rebin_count
                m["splats_per_sec"] = (
                    self.static["num_gaussians"] * (it - self.iter_step + 1)
                    / max(elapsed, 1e-9))
                self.history.append(m)
                if not self.quiet:
                    print(f"[stage4] it {it} loss={m['loss']:.4f} "
                          f"psnr={m['psnr']:.2f} l1={m['l1']:.4f}")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.run_seconds += time.perf_counter() - t0
        self.iter_step = end
        return self.history

    @torch.no_grad()
    def render_eval(self, pose, intr, h: int, w: int) -> dict:
        """Render on a zero background. At the dataset's resolution on the
        flat path the render bins fresh (exact, no staleness) under the FULL
        plan: a trimmed capacity without per-frame used counts would
        overflow. Any other resolution, and the top-K trainer, go through
        the top-K compositor."""
        at_ds = (h, w) == tuple(self.dataset.img_res)
        return render_gom(
            self.params, self.static, self.cfg, pose, intr, w, h,
            torch.zeros(3, device=self.device),
            flat_plan=self.flat_plan_full if at_ds else None)

    def eval_split(self, split: str = "test", max_frames: int = 8):
        """PSNR/SSIM/LPIPS over a split (LPIPS is NaN, with a warning)."""
        src = self.dataset.test if split == "test" else None
        poses = src["pose_all"] if src else self.dataset.pose_all
        gts = src["rgb_images"] if src else self.dataset.rgb_images
        h, w = self.dataset.img_res
        metrics = []
        for i in range(min(len(poses), max_frames)):
            out = self.render_eval(*self._pose_intr(i, poses), h, w)
            metrics.append(eval_rgb(out["rgb"].cpu().numpy(),
                                    gts[i].reshape(h, w, 3), self.device))
        return {k: float(np.mean([m[k] for m in metrics]))
                for k in metrics[0]}

    def export(self):
        """gauss_obj_{i}.ply/.npz per instance + gauss_scene.ply + USDZ."""
        paths = []
        for i, (lo, hi) in enumerate(self.instance_ranges):
            g = compose_for_export(self.params, self.static, self.cfg,
                                   select=slice(lo, hi))
            p = os.path.join(self.out_dir, f"gauss_obj_{i}.ply")
            write_gaussian_ply(p, g)
            np.savez(os.path.join(self.out_dir, f"gauss_obj_{i}.npz"), **g)
            paths.append(p)
        g_all = compose_for_export(self.params, self.static, self.cfg)
        p_all = os.path.join(self.out_dir, "gauss_scene.ply")
        write_gaussian_ply(p_all, g_all)
        usdz = os.path.join(self.out_dir, "gauss_scene.usdz")
        export_from_gaussian_dict(usdz, g_all, sh_degree=self.cfg.sh_degree)
        return paths + [p_all, usdz]
