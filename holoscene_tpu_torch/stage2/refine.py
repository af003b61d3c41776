"""Per-object SDF refinement under generated-view + collision constraints
(port of holoscene_tpu/stage2/refine.py).

Reference semantics: training/holoscene_train_post.py —
  * `foreground_object_reconstruction` (:3394): clone the Stage-1 model,
    ~500 iterations of (Stage-1 losses on class-targeted rays) +
    `calculate_invisible_loss` (:458: orthographic renders of the object in
    isolation vs generated rgb/normal/mask) + grid-sampled parent-SDF
    collision losses (:3620-3700) + eikonal;
  * `background_reconstruction` (:3245): the same for object 0 with
    background smoothness;
  * SDF constraint losses get_pts_sdf_contraints_loss / maintain /
    additional (model/network.py:973-1013).

One step (`finetune_step`) runs eagerly on the model's device in the idiom
of training/stage1.py::train_step: every random number is an argument
(`FinetuneDraws`: the ray jitter, the render's draws, the invisible
render's sampler draws), so a test can hand it the draws of JAX's step. On
the card a step launches H2 in every sampler round, H1-fwd / H1-bwd (exact)
for the class-targeted render, the eikonal points, the invisible render and
the collision points.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from holoscene_tpu_torch import as_tensor
from holoscene_tpu_torch.losses.holoscene_loss import (
    LossConfig,
    holoscene_loss,
    safe_normalize,
)
from holoscene_tpu_torch.models.fields import (
    implicit_all_gradients,
    implicit_sdf_raw_grid,
)
from holoscene_tpu_torch.models.holoscene import (
    HoloSceneModel,
    RenderDraws,
    render_rays,
    render_rays_only_multi_obj,
)
from holoscene_tpu_torch.ops.rays import get_orthographic_rays
from holoscene_tpu_torch.ops.sampler import SamplerDraws
from holoscene_tpu_torch.training.stage1 import make_optimizer, rays_from_batch

COLL_MODES = ("contain", "maintain", "match")


def sdf_constraint_loss(model: HoloSceneModel, obj_i: int, pts, target_sdf,
                        mode: str = "contain"):
    """SDF point constraints (model/network.py:973-1013).

    contain: object must stay OUT of the region where target (parent) is
             solid: penalize -sdf_obj(x) > sdf_target(x) (x5 + eikonal x0.1)
    maintain: object must not grow past its recorded sdf:
             penalize sdf_obj(x) > target (x3 + eikonal x0.1)
    match:   |sdf_obj - target| (x10 + eikonal x0.1)

    The object SDFs and their jacobians come from one H1 evaluation
    (implicit_all_gradients returns both); JAX evaluates implicit_sdf_raw
    and implicit_all_gradients separately on the same points, which is the
    same function."""
    if mode not in COLL_MODES:
        raise ValueError(f"coll_mode must be one of {COLL_MODES}, got "
                         f"{mode!r}")
    jac, raw = implicit_all_gradients(model.implicit, pts)
    s = raw[:, obj_i]
    t = target_sdf.reshape(-1)
    if mode == "contain":
        delta, w = -s - t, 5.0
    elif mode == "maintain":
        delta, w = s - t, 3.0
    else:
        delta, w = torch.abs(t - s), 10.0
    if mode == "match":
        loss_sdf = delta.mean()
    else:
        viol = delta > 0
        cnt = viol.sum()
        loss_sdf = torch.where(viol, delta, torch.zeros_like(delta)).sum() \
            / torch.clamp(cnt, min=1)
    loss_eik = ((torch.linalg.norm(jac[:, obj_i, :], dim=-1) - 1.0) ** 2
                ).mean()
    return w * loss_sdf + 0.1 * loss_eik


def invisible_view_loss(
    model: HoloSceneModel,
    draws: SamplerDraws,
    obj_idxs: tuple[int, ...],
    pose_c2w,
    half_extent,
    gen_rgb,
    gen_normal,
    gen_mask,
    uv_unit,
    gen_nm_mask=None,
    rgb_weight: float = 1.0,
    normal_weight: float = 0.5,
    mask_weight: float = 0.5,
    nm_l1_weight: float = 0.0,
    inp_mask=None,
    lama_rgb_weight: float | None = None,
    lama_nm_weight: float | None = None,
    lama_nm_l1_weight: float | None = None,
    gen_depth=None,
    gen_depth_mask=None,
    depth_weight: float = 0.0,
    mask_boost=None,
):
    """Supervise the object's isolated orthographic render against one
    generated view (calculate_invisible_loss, holoscene_train_post.py:458).
    `gen_nm_mask` restricts the normal term to pixels whose inpainted
    normals passed the consistency gate; defaults to gen_mask. Visible
    pixels use the base weights, LaMa-inpainted ones (`inp_mask`) the
    lama_* weights when set. Shapes: gen_rgb / gen_normal / uv_unit [M, 3]
    / [M, 3] / [M, 2], the masks and gen_depth [M]; `draws` the render's
    sampler draws for M rays."""
    rays_o, rays_d = get_orthographic_rays(uv_unit, pose_c2w, half_extent)
    depth_scale = torch.ones(rays_o.shape[0], 1, device=rays_o.device)
    out = render_rays_only_multi_obj(
        model, rays_o, rays_d, depth_scale, pose_c2w[:3, :3].T, obj_idxs,
        draws, training=True, detach_rgb_geometry=True)
    m = gen_mask.reshape(-1, 1)
    mn = m if gen_nm_mask is None else gen_nm_mask.reshape(-1, 1)
    inp = torch.zeros_like(m) if inp_mask is None else inp_mask.reshape(-1, 1)

    def blend(base, lama):
        if lama is None:
            return base * torch.ones_like(m)
        return base * (1.0 - inp) + lama * inp

    w_rgb = blend(rgb_weight, lama_rgb_weight)
    w_nm = blend(normal_weight, lama_nm_weight)
    w_nl1 = blend(nm_l1_weight, lama_nm_l1_weight)
    rgb_l = (torch.abs(out["rgb_values"] - gen_rgb) * m * w_rgb).sum() \
        / torch.clamp(m.sum() * 3, min=1.0)
    n_pred = safe_normalize(out["normal_map"])
    n_gt = safe_normalize(gen_normal)
    normal_l = ((1.0 - (n_pred * n_gt).sum(-1, keepdim=True)) * mn * w_nm
                ).sum() / torch.clamp(mn.sum(), min=1.0)
    nm_l1_l = (torch.abs(n_pred - n_gt) * mn * w_nl1).sum() \
        / torch.clamp(mn.sum() * 3, min=1.0)
    # opacity supervision is MSE like the reference (:584/:604), not BCE —
    # the conf lambdas are tuned for it
    mask_l = ((out["acc"].reshape(-1) - m[:, 0]) ** 2).mean()
    if mask_boost is not None:
        mask_l = mask_l * mask_boost
    total = rgb_l + normal_l + nm_l1_l + mask_weight * mask_l
    if gen_depth is not None:
        md = m if gen_depth_mask is None else gen_depth_mask.reshape(-1, 1)
        depth_l = (torch.abs(out["depth_values"].reshape(-1, 1)
                             - gen_depth.reshape(-1, 1)) * md).sum() \
            / torch.clamp(md.sum(), min=1.0)
        total = total + depth_weight * depth_l
    return total


@dataclasses.dataclass(frozen=True)
class FinetuneConfig:
    iters: int = 500
    lr: float = 5e-4
    lr_factor_for_grid: float = 20.0
    rays_per_step: int = 512
    invis_pixels: int = 512
    collision_pts: int = 1024
    invis_weight: float = 1.0
    collision_weight: float = 1.0
    # invisible-view per-term weights; the reference carries these in the
    # post confs' invis_loss{} section (lambda_rgb/nm_l1/nm_cos/mask +
    # lambda_lama_* variants for inpainted pixels, num_rays)
    rgb_weight: float = 1.0
    nm_cos_weight: float = 0.5
    nm_l1_weight: float = 0.0
    mask_weight: float = 0.5
    depth_weight: float = 0.0
    lama_rgb_weight: float | None = None
    lama_nm_cos_weight: float | None = None
    lama_nm_l1_weight: float | None = None
    # background-reconstruction normal/depth weights (reference bg_nm_l1 /
    # bg_nm_cos / bg_depth in invis_loss{}); None keeps the stage-1 ones
    bg_nm_l1: float | None = None
    bg_nm_cos: float | None = None
    bg_depth: float | None = None
    # lambda_smooth: the smoothness weight of the finetune steps (replaces
    # the stage-1 loss{} smooth_weight when set)
    smooth_weight: float | None = None

    @classmethod
    def from_conf(cls, conf, **overrides):
        """Build from a post conf's invis_loss{} section (reference key
        names). Absent section/keys keep the dataclass defaults."""
        kw = dict(overrides)
        if "invis_loss" in conf:
            s = conf.get_config("invis_loss")
            remap = {
                "lambda_rgb": "rgb_weight",
                "lambda_nm_cos": "nm_cos_weight",
                "lambda_nm_l1": "nm_l1_weight",
                "lambda_mask": "mask_weight",
                "lambda_depth": "depth_weight",
                "lambda_lama_rgb": "lama_rgb_weight",
                "lambda_lama_nm_cos": "lama_nm_cos_weight",
                "lambda_lama_nm_l1": "lama_nm_l1_weight",
                "bg_nm_l1": "bg_nm_l1",
                "bg_nm_cos": "bg_nm_cos",
                "bg_depth": "bg_depth",
                "lambda_smooth": "smooth_weight",
            }
            for src, dst in remap.items():
                if src in s and dst not in kw:
                    kw[dst] = s.get_float(src)
            if "num_rays" in s and "invis_pixels" not in kw:
                kw["invis_pixels"] = s.get_int("num_rays")
        return cls(**kw)


@dataclasses.dataclass
class FinetuneDraws:
    """Every random number of one finetune step, in the order JAX's step
    splits its key: the ray jitter [R, 2] in [-0.5, 0.5), the render's
    draws, and the invisible render's sampler draws (None on a step
    without the invisible view)."""

    jitter: torch.Tensor
    render: RenderDraws
    invis: SamplerDraws | None = None

    @classmethod
    def make(cls, model: HoloSceneModel, n_rays: int, n_invis: int,
             gen: torch.Generator, device,
             use_invis: bool = True) -> "FinetuneDraws":
        cfg = model.cfg
        jitter = torch.rand(n_rays, 2, generator=gen, device=device) - 0.5
        render = RenderDraws.make(cfg, n_rays, gen, device)
        invis = (SamplerDraws.make(cfg.sampler, n_invis, gen, device)
                 if use_invis else None)
        return cls(jitter, render, invis)


def make_finetune_optimizer(model: HoloSceneModel, fcfg: FinetuneConfig):
    """(optimizer, scheduler) of one refinement: Stage 1's Adam with the
    grid factor and the per-step decay over fcfg.iters."""
    return make_optimizer(model, fcfg.lr, fcfg.lr_factor_for_grid, fcfg.iters)


def finetune_step(model: HoloSceneModel, optimizer, scheduler,
                  lcfg: LossConfig, fcfg: FinetuneConfig, obj_i: int,
                  batch: dict, gen_view: dict | None, invis_on, coll_pts,
                  coll_sdf, draws: FinetuneDraws,
                  coll_mode: str = "contain") -> dict:
    """One refinement step of object obj_i (JAX make_object_finetune_step's
    step): the Stage-1 loss on the class-targeted ray batch (stage-1
    layout), plus, when gen_view is given (dict of tensors: pose [4, 4],
    half_extent, rgb / normal [M, 3], mask / nm_mask / inp_mask / depth /
    depth_mask [M], uv [M, 2], mask_boost), invis_on x the invisible-view
    loss, plus the collision loss at coll_pts [P, 3] against coll_sdf [P];
    then Adam. Returns the metrics as 0-d tensors: holoscene_loss's terms,
    invis_loss (with gen_view), collision_loss and the total `loss`."""
    optimizer.zero_grad(set_to_none=True)
    if fcfg.smooth_weight is not None:      # invis_loss{} lambda_smooth
        lcfg = dataclasses.replace(lcfg, smooth_weight=fcfg.smooth_weight)
    rays_o, rays_d, dscale, w2c = rays_from_batch(
        batch["uv"], batch["pose"], batch["intrinsics"], draws.jitter)
    out = render_rays(model, rays_o, rays_d, dscale, w2c, draws.render,
                      training=True)
    gt = {k: batch[k] for k in ("rgb", "depth", "normal", "segs", "mask")}
    losses = holoscene_loss(out, gt, lcfg, step=0, call_reg=False)
    total = losses["loss"]
    if gen_view is not None:
        inv = invisible_view_loss(
            model, draws.invis, (obj_i,), gen_view["pose"],
            gen_view["half_extent"], gen_view["rgb"], gen_view["normal"],
            gen_view["mask"], gen_view["uv"],
            gen_nm_mask=gen_view.get("nm_mask"),
            rgb_weight=fcfg.rgb_weight, normal_weight=fcfg.nm_cos_weight,
            mask_weight=fcfg.mask_weight, nm_l1_weight=fcfg.nm_l1_weight,
            inp_mask=gen_view.get("inp_mask"),
            lama_rgb_weight=fcfg.lama_rgb_weight,
            lama_nm_weight=fcfg.lama_nm_cos_weight,
            lama_nm_l1_weight=fcfg.lama_nm_l1_weight,
            gen_depth=gen_view.get("depth"),
            gen_depth_mask=gen_view.get("depth_mask"),
            depth_weight=fcfg.depth_weight,
            mask_boost=gen_view.get("mask_boost"))
        total = total + fcfg.invis_weight * invis_on * inv
        losses["invis_loss"] = inv
    coll = sdf_constraint_loss(model, obj_i, coll_pts, coll_sdf, coll_mode)
    total = total + fcfg.collision_weight * coll
    total.backward()
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    optimizer.step()
    if scheduler is not None:
        scheduler.step()
    metrics = {k: v.detach() for k, v in losses.items()}
    metrics.update(collision_loss=coll.detach(), loss=total.detach())
    return metrics


def sample_collision_points(model: HoloSceneModel, bbox_center, bbox_scale,
                            parent_ids: tuple[int, ...], n_pts: int,
                            rng: np.random.Generator):
    """Uniform samples in the object's bbox (numpy rng, as JAX draws them)
    with the PARENT SDF frozen as the constraint target
    (holoscene_train_post.py:3620-3700): (pts [P, 3], target [P]) on the
    model's device, the target from the grid evaluator (H2, packed; JAX's
    packed implicit_sdf_raw), without gradient."""
    dev = model.density["beta"].device
    pts = rng.uniform(-1, 1, (n_pts, 3)) * np.asarray(bbox_scale)[None] \
        + np.asarray(bbox_center)[None]
    pts_t = as_tensor(pts.astype(np.float32), dev)
    raw = implicit_sdf_raw_grid(model.implicit, pts_t)
    return pts_t, torch.amin(raw[:, list(parent_ids)], -1)
