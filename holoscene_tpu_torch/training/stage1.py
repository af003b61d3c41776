"""Stage-1 runner: object-compositional neural-SDF scene reconstruction
(port of holoscene_tpu/training/stage1.py: make_optimizer,
rays_from_batch, the train step, make_eval_render, Stage1Runner).

One training step: jittered rays -> error-bound sampling (placement from
the baked probe grid) -> top-M pruning and tiered fine levels -> H1 encode
with jacobian -> SDF / colour MLPs -> volume rendering (every
render_bg_iter-th step also the background patch of the bg regulariser)
-> the loss stack -> backward (H1-bwd) -> Adam. PyTorch runs it eagerly;
every random number of the step is drawn up front from the runner's
torch.Generator on the device (`StepDraws`), so a test can hand the step
JAX's draws instead. Float32 matmuls stay full float32 (TF32 off), set
where the runner starts.

On the plot cadence (`run(plot_freq=...)`) the runner eval-renders a
frame and, with extract_meshes_on_plot, extracts the per-object meshes
(`extract_meshes`: grid evaluation through H2 on the device, marching
tetrahedra on the host, visibility pruning, surface_{it}_{k}.ply and
bbox/bbox_{k}.json).

A resume (`is_continue`, `ft_folder`) loads a run's checkpoint whichever
package wrote it: the port's .pth or the JAX package's .msgpack (its
params, Adam moments and step; training/checkpoints.py).

With model.use_occupancy the runner keeps the occupancy grid
(ops/occupancy.py): every train.occ_update_every-th step samples the full
interval and refreshes the grid from the sampler's probes, the others
sample each ray's occupied span. The grid is not checkpointed.

Several ranks (torch.distributed initialised with a world size above 1,
e.g. under torchrun): every rank draws the same global batch and the same
StepDraws from the shared seed and renders its rows of them (the data
axis, parallel/mesh.py); the loss is computed on every rank from the
gathered rows, so a step's loss and gradients are those of the
single-process step on the global batch (the batch-wide depth
scale-and-shift solve and masked means included). With n_model > 1 the
hash tables (and the MLP rows JAX's rules shard) are stored and updated
as row shards, reassembled after every update. Only rank 0 writes
checkpoints, plots, meshes and logs."""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from datetime import datetime

import numpy as np
import torch
import torch.distributed as dist

from holoscene_tpu_torch import as_tensor, resolve_device
from holoscene_tpu_torch.config import Config
from holoscene_tpu_torch.datasets.ns_dataset import NSDataset
from holoscene_tpu_torch.losses.holoscene_loss import LossConfig, holoscene_loss
from holoscene_tpu_torch.models.fields import implicit_sdf_raw_grid
from holoscene_tpu_torch.models.holoscene import (
    BG_PATCH,
    HoloSceneConfig,
    HoloSceneModel,
    RenderDraws,
    init_holoscene,
    make_probe_bake,
    render_bg_patch,
    render_rays,
)
from holoscene_tpu_torch.ops.occupancy import init_occ_grid
from holoscene_tpu_torch.ops.rays import get_camera_rays
from holoscene_tpu_torch.ops.sampler import SamplerDraws
from holoscene_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_min,
    batch_sharding,
    full_optimizer_state,
    gather_params,
    gather_rows,
    make_mesh,
    reduce_grads,
    shard_optimizer,
    shard_params,
)
from holoscene_tpu_torch.training import checkpoints as ckpt_lib
from holoscene_tpu_torch.training.pruning import instance_meshes_post_pruning
from holoscene_tpu_torch.utils.logging import MetricsLogger
from holoscene_tpu_torch.utils.plots import (
    extract_object_meshes,
    generate_bbox,
    save_object_meshes,
)


def make_optimizer(model: HoloSceneModel, lr: float, lr_factor_for_grid: float,
                   total_iters: int):
    """Adam(0.9, 0.99, eps 1e-15) with lr x lr_factor_for_grid for every
    parameter whose name ends in `grid` (grid, color_grid), and the
    per-step exponential decay 0.1^(1/total_iters): optax's scale_by_adam +
    exponential_decay(transition_steps=1) of the JAX package. Returns
    (optimizer, scheduler); step the scheduler after each optimizer step."""
    grid, net = [], []
    for name, p in model.named_parameters():
        (grid if name.endswith("grid") else net).append(p)
    opt = torch.optim.Adam(
        [{"params": grid, "lr": lr * lr_factor_for_grid},
         {"params": net, "lr": lr}], betas=(0.9, 0.99), eps=1e-15)
    decay = 0.1 ** (1.0 / max(total_iters, 1))
    return opt, torch.optim.lr_scheduler.ExponentialLR(opt, gamma=decay)


def rays_from_batch(uv, pose, intrinsics, jitter=None):
    """Pixel batch -> world rays (rays_o, rays_d, depth_scale, w2c_rot);
    jitter [R, 2] in [-0.5, 0.5) pixels (training)."""
    dirs, cam_loc, depth_scale = get_camera_rays(uv, pose, intrinsics, jitter)
    return cam_loc.expand(dirs.shape), dirs, depth_scale, pose[:3, :3].T


@dataclasses.dataclass
class StepDraws:
    """Every random number of one train step: the ray jitter, the render's
    draws and, on a background step, the patch origin's two uniforms bg_uv
    [2] and the patch sampler's draws (BG_PATCH^2 rays)."""

    jitter: torch.Tensor
    render: RenderDraws
    bg_uv: torch.Tensor | None = None
    bg_sampler: SamplerDraws | None = None

    @classmethod
    def make(cls, cfg: HoloSceneConfig, n_rays: int, gen: torch.Generator,
             device, with_bg: bool = False) -> "StepDraws":
        jitter = torch.rand(n_rays, 2, generator=gen, device=device) - 0.5
        render = RenderDraws.make(cfg, n_rays, gen, device)
        if not with_bg:
            return cls(jitter, render)
        return cls(jitter, render,
                   torch.rand(2, generator=gen, device=device),
                   SamplerDraws.make(cfg.sampler, BG_PATCH * BG_PATCH, gen,
                                     device))

    def rows(self, sl: slice, n_rays: int, patch: slice) -> "StepDraws":
        """The draws of rays sl of the n_rays batch and of the patch's
        pixels `patch` (bg_uv is shared)."""
        return StepDraws(
            self.jitter[sl], self.render.rows(sl, n_rays), self.bg_uv,
            None if self.bg_sampler is None else self.bg_sampler.rows(patch))


def bg_patch_uv(intrinsics: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The BG_PATCH x BG_PATCH pixel grid [BG_PATCH^2, 2] (x fastest) at
    origin u * (2 cx - BG_PATCH, 2 cy - BG_PATCH), u [2] in [0, 1)."""
    span = torch.stack([intrinsics[0, 2] * 2.0 - BG_PATCH,
                        intrinsics[1, 2] * 2.0 - BG_PATCH])
    ar = torch.arange(BG_PATCH, device=u.device)
    gy, gx = torch.meshgrid(ar, ar, indexing="ij")
    grid = torch.stack([gx, gy], -1).reshape(-1, 2).to(torch.float32)
    return grid + (u * span).to(torch.float32)[None, :]


# the render outputs the loss reads: one row a ray, one an eikonal point
# (the uniform half, then the near half), one a background-patch pixel
_RAY_KEYS = ("rgb_values", "semantic_values", "object_opacity",
             "depth_values", "normal_map", "sdf")
_EIK_KEYS = ("grad_theta", "grad_theta_nei", "sample_sdf", "sample_minsdf")
_PATCH_KEYS = ("bg_depth_values", "bg_normal_map", "bg_mask")


def _gather_outputs(out: dict, mesh: Mesh, rows: slice, n: int,
                    patch: slice) -> dict:
    """Every rank's rows of the outputs the loss reads, in the global
    batch's order (the eikonal points as the single-process render lays
    them out: all uniform points, then all near points)."""
    g = mesh.data_group
    full = {k: gather_rows(out[k], rows, n, g) for k in _RAY_KEYS if k in out}
    for k in _EIK_KEYS:
        if k in out:
            m = out[k].shape[0] // 2
            full[k] = torch.cat([gather_rows(out[k][:m], rows, n, g),
                                 gather_rows(out[k][m:], rows, n, g)])
    for k in _PATCH_KEYS:
        if k in out:
            full[k] = gather_rows(out[k], patch, BG_PATCH * BG_PATCH, g)
    return full


def train_step(model: HoloSceneModel, optimizer, scheduler, lcfg: LossConfig,
               batch: dict, draws: StepDraws, step_idx: int,
               call_reg: bool = False, probe=None, occ=None,
               update_occ: bool = False, mesh: Mesh | None = None,
               shards: dict | None = None):
    """One optimizer step; returns the metrics as 0-d tensors (no host
    sync), and with an occupancy grid `occ` (metrics, the grid after the
    step): restricted sampling, or with update_occ the full interval and
    the grid refreshed from the sampler's probes. Draws made with with_bg
    (draws.bg_uv set) also render the background patch for the bg
    regulariser. A non-finite loss zeroes every gradient and still steps
    the optimizer (as the JAX step does), so every parameter gets a
    gradient, zeros if unused, and Adam treats each as optax does.

    mesh: this rank renders its rows of the global batch and of the
    background patch; the loss is computed from every rank's rows on each
    rank, the gradients are summed over the data ranks, and the occupancy
    update takes the minima of every rank's probes. `shards` (from
    parallel/mesh.py::shard_params) are the parameters the optimizer holds
    as row shards; their full values are reassembled after the update."""
    optimizer.zero_grad(set_to_none=True)
    model.zero_grad(set_to_none=True)
    n = batch["uv"].shape[0]
    rows = patch = slice(None)
    if mesh is not None:
        rows = batch_sharding(mesh, n)
        patch = batch_sharding(mesh, BG_PATCH * BG_PATCH)
        draws = draws.rows(rows, n, patch)
    rays_o, rays_d, dscale, w2c = rays_from_batch(
        batch["uv"][rows], batch["pose"], batch["intrinsics"], draws.jitter)
    out = render_rays(model, rays_o, rays_d, dscale, w2c, draws.render,
                      training=True, probe=probe, occ=occ,
                      update_occ=update_occ,
                      occ_reduce=None if mesh is None else all_reduce_min(mesh))
    occ_new = out.pop("occ", None)
    if draws.bg_uv is not None:
        uv = bg_patch_uv(batch["intrinsics"], draws.bg_uv)[patch]
        po, pd, pscale, pw2c = rays_from_batch(uv, batch["pose"],
                                               batch["intrinsics"])
        out.update(render_bg_patch(model, po, pd, pscale, pw2c,
                                   draws.bg_sampler, training=True))
    if mesh is not None:
        out = _gather_outputs(out, mesh, rows, n, patch)
    gt = {k: batch[k] for k in ("rgb", "depth", "normal", "segs", "mask")}
    losses = holoscene_loss(out, gt, lcfg, step=step_idx, call_reg=call_reg)
    losses["loss"].backward()
    if mesh is not None:
        reduce_grads(mesh, model, shards or {})
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
    if mesh is not None:
        gather_params(mesh, model, shards or {})
    with torch.no_grad():
        psnr = -10.0 * torch.log10(
            ((out["rgb_values"] - gt["rgb"].reshape(-1, 3)) ** 2).mean())
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics.update(psnr=psnr, nonfinite=1.0 - finite.float(),
                       beta=model.density["beta"].abs() + model.cfg.beta_min)
    if occ is None:
        return metrics
    return metrics, occ_new


def make_eval_render(cfg: HoloSceneConfig):
    """Chunked full-frame eval renderer: render_frame(model, sample,
    chunk) -> dict of numpy arrays (rgb, depth, normal, semantic,
    object opacity)."""
    keys = ("rgb_values", "depth_values", "normal_map", "semantic_values",
            "object_opacity")

    def render_frame(model: HoloSceneModel, sample: dict, chunk: int = 1024):
        dev = model.density["beta"].device
        uv = as_tensor(sample["uv"], dev)
        pose = as_tensor(sample["pose"], dev)
        intr = as_tensor(sample["intrinsics"], dev)
        outs = {k: [] for k in keys}
        with torch.no_grad():
            for i in range(0, uv.shape[0], chunk):
                ro, rd, ds, w2c = rays_from_batch(uv[i:i + chunk], pose, intr)
                out = render_rays(model, ro, rd, ds, w2c, training=False,
                                  compute_eikonal=False)
                for k in keys:
                    outs[k].append(out[k])
        return {k: torch.cat(v).cpu().numpy() for k, v in outs.items()}

    return render_frame


def batch_to_device(sample: dict, gt: dict, device) -> dict:
    batch = {k: as_tensor(sample[k], device)
             for k in ("uv", "pose", "intrinsics")}
    batch.update({k: as_tensor(gt[k], device)
                  for k in ("rgb", "depth", "normal", "mask")})
    batch["segs"] = torch.as_tensor(np.asarray(gt["segs"]), dtype=torch.int64,
                                    device=device)
    return batch


OCC_WARNING = ("WARNING: model.use_occupancy is an experimental "
               "sampling-policy knob; its duty-cycle mitigation is "
               "validated at <=256^2 gate scale only (see PERF.md "
               "occupancy flagship-collapse post-mortem)")


class Stage1Runner:
    """Conf-driven Stage-1 training on `device` (default cuda; there is no
    CPU fallback: device='cpu' runs the kernels' plain versions).

    use_mesh: with torch.distributed initialised at a world size above 1,
    train over a (world / n_model, n_model) mesh of ranks (module
    docstring); each rank runs on its own `device`."""

    def __init__(self, conf: Config, exps_folder: str = "exps",
                 data_root_override: str | None = None,
                 is_continue: bool = False, timestamp: str = "latest",
                 checkpoint: str = "latest",
                 max_total_iters: int | None = None, seed: int = 0,
                 quiet: bool = False, expname_suffix: str = "",
                 ft_folder: str | None = None, device: str = "cuda",
                 use_mesh: bool = True, n_model: int = 1):
        self.device = resolve_device(device)
        distributed = (use_mesh and dist.is_available()
                       and dist.is_initialized()
                       and dist.get_world_size() > 1)
        self.is_main = not distributed or dist.get_rank() == 0
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.conf = conf
        self.quiet = quiet
        self.expname = conf.get_string("train.expname", "holoscene") \
            + expname_suffix
        dataset_conf = conf.get_config("dataset").as_plain_dict()
        if data_root_override:
            dataset_conf["data_root_dir"] = data_root_override
        dataset_conf.pop("depth_type", None)
        self.dataset = NSDataset(**dataset_conf, seed=seed)
        conf.put("model.implicit_network.d_out",
                 len(self.dataset.label_mapping))
        self.model_cfg = HoloSceneConfig.from_conf(conf.get_config("model"))
        self.loss_cfg = LossConfig.from_conf(conf.get_config("loss"))
        self.num_pixels = conf.get_int("train.num_pixels", 1024)
        self.max_total_iters = (max_total_iters if max_total_iters is not None
                                else conf.get_int("train.max_total_iters",
                                                  200000))
        self.stop_iter = min(conf.get_int("train.stop_iter",
                                          self.max_total_iters),
                             self.max_total_iters)
        self.checkpoint_freq = conf.get_int("train.checkpoint_freq", 100)
        self.exact_bwd_from_iter = conf.get_int("train.exact_bwd_from_iter",
                                                -1)
        self.split_n_pixels = conf.get_int("train.split_n_pixels", 1024)
        self.add_objectvio_iter = conf.get_int("train.add_objectvio_iter",
                                               100000)
        lr = conf.get_float("train.learning_rate", 5e-4)
        lr_grid = conf.get_float("train.lr_factor_for_grid", 1.0)

        self.expdir = os.path.join(exps_folder, self.expname)
        if is_continue and timestamp == "latest":
            timestamp = (ckpt_lib.latest_timestamp(self.expdir)
                         or datetime.now().strftime("%Y_%m_%d_%H_%M_%S"))
        elif not is_continue:
            timestamp = datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
        self.timestamp = timestamp
        self.rundir = os.path.join(self.expdir, timestamp)
        self.checkpoints_path = os.path.join(self.rundir, "checkpoints")
        self.plots_dir = os.path.join(self.rundir, "plots")
        if self.is_main:
            os.makedirs(self.checkpoints_path, exist_ok=True)
            os.makedirs(self.plots_dir, exist_ok=True)

        self.model = init_holoscene(self.model_cfg, seed, self.device)
        self.optimizer, self.scheduler = make_optimizer(
            self.model, lr, lr_grid, self.max_total_iters)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.start_iter = 0
        if is_continue or ft_folder is not None:
            load_dir = (os.path.join(ft_folder, "checkpoints")
                        if ft_folder is not None else self.checkpoints_path)
            try:
                meta, gen_state = ckpt_lib.load_checkpoint(
                    load_dir, self.model, self.optimizer, self.scheduler,
                    checkpoint)
                self.start_iter = int(meta.get("step", 0))
                if gen_state is not None:
                    self.generator.set_state(gen_state)
            except FileNotFoundError:
                if ft_folder is not None or checkpoint != "latest":
                    raise
                if not quiet:
                    print(f"[stage1] no checkpoint under {load_dir}; "
                          "starting fresh", flush=True)
        self.mesh: Mesh | None = None
        self.shards: dict = {}
        if distributed:
            # rank 0's parameters on every rank (each drew the same init)
            with torch.no_grad():
                for p in self.model.parameters():
                    dist.broadcast(p, 0)
            self.mesh = make_mesh(n_model=n_model)
            self.shards = shard_params(self.mesh, self.model)
            shard_optimizer(self.mesh, self.optimizer, self.model,
                            self.shards)
        self.render_frame = make_eval_render(self.model_cfg)
        # occupancy-grid sampling restriction: rebuilt from probe evidence
        # within about one update cycle, so it is not checkpointed (a
        # resume starts occupied everywhere)
        self.occ = None
        self.occ_update_every = conf.get_int("train.occ_update_every", 8)
        if self.model_cfg.use_occupancy:
            if self.is_main:
                print(OCC_WARNING, flush=True)
            self.occ = init_occ_grid(self.model_cfg.occupancy, self.device)
        # the probe grid is re-baked on its cadence and at a resume's first
        # step; it is not checkpointed
        self.probe = None
        self._probe_bake = (make_probe_bake(self.model_cfg)
                            if self.model_cfg.probe_grid_res > 0 else None)
        self.probe_bakes: list[int] = []
        self.history: list[dict] = []
        self.run_seconds = 0.0
        self.extract_seconds: dict = {}
        self.extract_fine_res: list[int] = []
        self.logger = MetricsLogger(self.rundir) if self.is_main else None

    def save_checkpoint(self, it: int) -> None:
        """Checkpoint after step `it`, written by rank 0; with sharded
        tables the Adam moments are reassembled first (every rank takes
        part), so the file is the single-process runner's."""
        opt_state = (full_optimizer_state(self.mesh, self.optimizer,
                                          self.model, self.shards)
                     if self.mesh is not None else None)
        if self.is_main:
            ckpt_lib.save_checkpoint(
                self.checkpoints_path, epoch=it, model=self.model,
                optimizer=self.optimizer, scheduler=self.scheduler,
                extra={"step": it + 1},
                generator_state=self.generator.get_state(),
                optimizer_state=opt_state)

    def switch_to_exact_bwd(self):
        """Exact table gradients from here on (the sampled one-corner
        backward buys speed while features move fast)."""
        if not self.model_cfg.implicit.color_bwd_sample:
            return
        self.model_cfg = dataclasses.replace(
            self.model_cfg, implicit=dataclasses.replace(
                self.model_cfg.implicit, color_bwd_sample=False,
                sdf_bwd_sample=False))
        self.model.cfg = self.model_cfg
        self.model.implicit.cfg = self.model_cfg.implicit
        if not self.quiet:
            print(f"[{self.expname}] exact table backward from iter "
                  f"{self.exact_bwd_from_iter}", flush=True)

    def extract_meshes(self, resolution: int | None = None,
                       prune: bool = True, epoch: int | None = None,
                       save: bool = True):
        """Per-object mesh extraction + visibility pruning + bbox artifacts
        (reference holoscene_train.py:326-327, :523-641): the K object
        SDFs on the plot.grid_boundary cube at plot.resolution (256 when
        the conf has none), evaluated on the runner's device in chunks
        through H2 (implicit_sdf_raw_grid), triangulated on the host, then
        pruned against the training views' instance masks and written as
        surface_{epoch}_{k}.ply and bbox/bbox_{k}.json. Returns the meshes
        (None for an empty object) and leaves the wall time of each part
        in self.extract_seconds (grid_eval, marching_tetrahedra, pruning,
        writing, total) and each object's fine-grid resolution in
        self.extract_fine_res."""
        t_all = time.perf_counter()
        res = resolution or self.conf.get_int("plot.resolution", 256)
        bound = self.conf.get_list("plot.grid_boundary", [-1.0, 1.0])
        net = self.model.implicit
        seconds: dict = {}
        self.extract_fine_res = []
        meshes = extract_object_meshes(
            lambda pts: implicit_sdf_raw_grid(net, pts),
            self.model_cfg.implicit.d_out, resolution=res,
            grid_boundary=tuple(bound), device=self.device, seconds=seconds,
            fine_resolutions=self.extract_fine_res)
        if prune:
            t0 = time.perf_counter()
            meshes = instance_meshes_post_pruning(meshes, self.dataset,
                                                  device=self.device)
            seconds["pruning"] = time.perf_counter() - t0
        if save:
            t0 = time.perf_counter()
            epoch = self.start_iter if epoch is None else epoch
            save_object_meshes(meshes, self.plots_dir, epoch)
            generate_bbox(meshes, self.plots_dir)
            seconds["writing"] = time.perf_counter() - t0
        seconds["total"] = time.perf_counter() - t_all
        self.extract_seconds = seconds
        return meshes

    def plot(self, it: int, frame_idx: int = 0, extract_meshes: bool = False,
             split: str = "train"):
        """Plot-cadence artifacts (reference holoscene_train.py:283-353):
        eval-render a frame to PNGs (rgb, normal, depth, instance) and,
        with extract_meshes, extract + prune the meshes and write them with
        their bboxes; returns {"psnr": ...}. split="test" renders a
        held-out frame (dataset.test_split)."""
        from PIL import Image

        sample, gt = self.dataset.full_frame(frame_idx, split=split)
        out = self.render_frame(self.model, sample, chunk=self.split_n_pixels)
        h, w = self.dataset.img_res
        tag = "" if split == "train" else f"_{split}{frame_idx}"

        def save(name, arr):
            Image.fromarray(np.clip(arr * 255, 0, 255).astype(np.uint8)).save(
                os.path.join(self.plots_dir, f"{name}{tag}_{it}.png"))

        save("rendering", out["rgb_values"].reshape(h, w, 3))
        save("normal", (out["normal_map"].reshape(h, w, 3) + 1) / 2)
        d = out["depth_values"].reshape(h, w)
        save("depth", (d - d.min()) / max(d.max() - d.min(), 1e-9))
        inst = np.argmax(out["object_opacity"], -1).reshape(h, w)
        save("instance", inst / max(self.model_cfg.num_semantic - 1, 1))
        psnr = -10 * np.log10(np.mean(
            (out["rgb_values"] - gt["rgb"].reshape(-1, 3)) ** 2) + 1e-12)
        if not self.quiet:
            print(f"[{self.expname}] plot it={it} {split}-frame={frame_idx} "
                  f"psnr={psnr:.2f}")
        if extract_meshes:
            self.extract_meshes(epoch=it)
        return {"psnr": float(psnr)}

    def run(self, n_iters: int | None = None, log_every: int = 20,
            plot_freq: int | None = None,
            extract_meshes_on_plot: bool = False):
        """Train to n_iters more steps (default: to train.stop_iter),
        recording the metrics every log_every steps; every plot_freq-th
        step also plots (and extracts meshes with extract_meshes_on_plot)."""
        end = self.start_iter + (n_iters if n_iters is not None
                                 else self.stop_iter - self.start_iter)
        n_steps = end - self.start_iter
        batch_q: queue.Queue = queue.Queue(maxsize=4)

        def producer():
            try:
                for _ in range(n_steps):
                    batch_q.put(self.dataset.sample_rays(self.num_pixels))
            except BaseException as exc:  # surfaced in the consumer
                batch_q.put(exc)

        if n_steps > 0:
            threading.Thread(target=producer, daemon=True).start()
        t0 = time.time()
        rays_done = 0
        for it in range(self.start_iter, end):
            item = batch_q.get()
            if isinstance(item, BaseException):
                raise RuntimeError("ray-batch producer thread died") from item
            _, sample, gt = item
            if 0 <= self.exact_bwd_from_iter <= it:
                self.switch_to_exact_bwd()
            batch = batch_to_device(sample, gt, self.device)
            with_bg = (self.model_cfg.use_bg_reg
                       and it % self.model_cfg.render_bg_iter == 0)
            draws = StepDraws.make(self.model_cfg, self.num_pixels,
                                   self.generator, self.device, with_bg)
            if self._probe_bake is not None and (
                    self.probe is None
                    or it % self.model_cfg.probe_update_every == 0):
                self.probe = self._probe_bake(self.model)
                self.probe_bakes.append(it)
            metrics = train_step(
                self.model, self.optimizer, self.scheduler, self.loss_cfg,
                batch, draws, it, call_reg=it >= self.add_objectvio_iter,
                probe=self.probe, occ=self.occ,
                update_occ=it % self.occ_update_every == 0, mesh=self.mesh,
                shards=self.shards)
            if self.occ is not None:
                metrics, self.occ = metrics
            rays_done += self.num_pixels
            if it % log_every == 0 or it == end - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["elapsed_s"] = time.time() - t0
                m["rays_per_sec"] = rays_done / max(m["elapsed_s"], 1e-9)
                m["iter"] = it
                self.history.append(m)
                if self.is_main:
                    self.logger.log(m, step=it)
                if self.is_main and not self.quiet:
                    print(f"[{self.expname}] it {it} loss={m['loss']:.4f} "
                          f"rgb={m['rgb_loss']:.4f} psnr={m['psnr']:.2f} "
                          f"beta={m['beta']:.4f} "
                          f"rays/s={m['rays_per_sec']:.0f}", flush=True)
            if plot_freq and (it + 1) % plot_freq == 0 and self.is_main:
                self.plot(it, extract_meshes=extract_meshes_on_plot)
            if (it + 1) % self.checkpoint_freq == 0 or it == end - 1:
                self.save_checkpoint(it)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.run_seconds = time.time() - t0
        self.start_iter = end
        return self.history
