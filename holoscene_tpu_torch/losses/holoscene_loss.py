"""Stage-1/2 loss stack (port of holoscene_tpu/losses/holoscene_loss.py):
MonoSDF terms + the object-compositional terms. Reductions are masked sums
and counts, as in the JAX package."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class LossConfig:
    rgb_loss: str = "l1"
    eikonal_weight: float = 0.1
    smooth_weight: float = 0.005
    depth_weight: float = 0.1
    normal_l1_weight: float = 0.05
    normal_cos_weight: float = 0.05
    semantic_weight: float = 0.04
    use_obj_opacity: bool = True
    reg_vio_weight: float = 0.1
    bg_reg_weight: float = 0.1
    end_step: int = -1

    @classmethod
    def from_conf(cls, conf) -> "LossConfig":
        rgb = conf.get_string("rgb_loss", "torch.nn.L1Loss")
        return cls(
            rgb_loss="mse" if "MSE" in rgb else "l1",
            eikonal_weight=conf.get_float("eikonal_weight", 0.1),
            smooth_weight=conf.get_float("smooth_weight", 0.005),
            depth_weight=conf.get_float("depth_weight", 0.1),
            normal_l1_weight=conf.get_float("normal_l1_weight", 0.05),
            normal_cos_weight=conf.get_float("normal_cos_weight", 0.05),
            semantic_weight=conf.get_float("semantic_weight", 0.04),
            use_obj_opacity=conf.get_bool("use_obj_opacity", True),
            reg_vio_weight=conf.get_float("reg_vio_weight", 0.1),
            bg_reg_weight=conf.get_float("bg_reg_weight", 0.1),
            end_step=conf.get_int("end_step", -1),
        )


def safe_normalize(v, eps: float = 1e-6):
    return v / torch.sqrt((v * v).sum(-1, keepdim=True) + eps * eps)


def _masked_mean(x, mask):
    cnt = mask.sum()
    total = torch.where(mask, x, torch.zeros_like(x)).sum()
    return torch.where(cnt > 0, total / torch.clamp(cnt, min=1),
                       torch.zeros_like(total))


def rgb_loss(pred, gt, kind: str = "l1"):
    if kind == "mse":
        return ((pred - gt) ** 2).mean()
    return (pred - gt).abs().mean()


def eikonal_loss(grad_theta):
    return ((torch.linalg.norm(grad_theta, dim=-1) - 1.0) ** 2).mean()


def smooth_loss(g1, g2):
    n1, n2 = safe_normalize(g1, 1e-5), safe_normalize(g2, 1e-5)
    return torch.sqrt(((n1 - n2) ** 2).sum(-1) + 1e-12).mean()


def scale_shift_solve(pred, gt):
    """argmin_{w,q} ||w pred + q - gt||^2 over the whole batch."""
    pred, gt = pred.reshape(-1), gt.reshape(-1)
    n = pred.shape[0]
    sx, sxx = pred.sum(), (pred * pred).sum()
    sy, sxy = gt.sum(), (pred * gt).sum()
    det = sxx * n - sx * sx
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    return (n * sxy - sx * sy) / det, (sxx * sy - sx * sxy) / det


def depth_loss(depth_pred, depth_gt):
    w, q = scale_shift_solve(depth_pred, depth_gt)
    diff = ((w * depth_pred.reshape(-1) + q) - depth_gt.reshape(-1)) ** 2
    return torch.clamp(diff, max=1.0).mean()


def normal_loss(normal_pred, normal_gt):
    ng, np_ = safe_normalize(normal_gt), safe_normalize(normal_pred)
    l1 = (np_ - ng).abs().sum(-1).mean()
    cos = (1.0 - (np_ * ng).sum(-1)).mean()
    return l1, cos


def object_opacity_loss(predict_opacity, gt_seg):
    k = predict_opacity.shape[1]
    target = F.one_hot(gt_seg.reshape(-1).long(), k).to(predict_opacity.dtype)
    p = torch.clamp(predict_opacity, 1e-4, 1.0 - 1e-4)
    bce = -(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))
    return bce.mean(-1).mean()


def object_distinct_loss(sample_sdf, min_sdf):
    """Penalise -sdf_j above -min_sdf for every non-argmin object."""
    k = sample_sdf.shape[1]
    min_idx = torch.argmin(sample_sdf, 1)
    viol = torch.relu(-sample_sdf - min_sdf.detach()[:, None])
    not_min = torch.arange(k, device=sample_sdf.device)[None] \
        != min_idx[:, None]
    return _masked_mean(viol, not_min & (viol > 0))


def object_distinct_graph_loss(sample_sdf, obj_i: int, parent_id: int,
                               desc_ids: tuple, bother_groups: tuple):
    """Scene-graph-aware collision regulariser: (parent, desc, bother)."""
    zero = sample_sdf.new_zeros(())
    parent_loss = desc_loss = bother_loss = zero
    if parent_id >= 0:
        sel = sample_sdf[:, [parent_id, obj_i, *desc_ids]]
        viol = -sel[:, 1:] - sel[:, 0:1].detach()
        parent_loss = _masked_mean(viol, (sel[:, 0] < 0)[:, None] & (viol > 0))
    if len(desc_ids) > 0:
        sel = sample_sdf[:, [obj_i, *desc_ids]]
        viol = -sel[:, 1:] - sel[:, 0:1].detach()
        desc_loss = _masked_mean(viol, (sel[:, 0] < 0)[:, None] & (viol > 0))
    if len(bother_groups) > 0:
        groups = [[obj_i, *desc_ids]] + [list(g) for g in bother_groups]
        mins = torch.stack([sample_sdf[:, g].amin(1) for g in groups], 1)
        min_val = mins.amin(1, keepdim=True)
        min_idx = torch.argmin(mins, 1)
        viol = torch.relu(-mins - min_val.detach())
        not_min = torch.arange(mins.shape[1], device=mins.device)[None] \
            != min_idx[:, None]
        bother_loss = _masked_mean(
            viol, (min_val[:, 0] < 0)[:, None] & not_min & (viol > 0))
    return parent_loss, desc_loss, bother_loss


def multiscale_grad_error(x, mask, scales: int = 4):
    """Multi-scale masked gradient smoothness; x, mask [C, H, W]."""
    total = x.new_zeros(())
    for i in range(scales):
        step = 2 ** i
        xs, ms = x[:, ::step, ::step], mask[:, ::step, ::step]
        m_cnt = ms[:1].sum()
        diff = ms * xs
        gx = (diff[:, :, 1:] - diff[:, :, :-1]).abs() * (ms[:, :, 1:]
                                                         * ms[:, :, :-1])
        gy = (diff[:, 1:, :] - diff[:, :-1, :]).abs() * (ms[:, 1:, :]
                                                         * ms[:, :-1, :])
        total = total + torch.where(
            m_cnt > 0, (gx.sum() + gy.sum()) / torch.clamp(m_cnt, min=1.0),
            torch.zeros_like(m_cnt))
    return total


def bg_render_loss(bg_depth, bg_normal, mask, patch: int = 32):
    d = bg_depth.reshape(1, patch, patch)
    n = bg_normal.reshape(patch, patch, 3).permute(2, 0, 1)
    m = mask.reshape(1, patch, patch).to(d.dtype)
    return multiscale_grad_error(d, m) + multiscale_grad_error(
        n, m.expand(n.shape))


def holoscene_loss(out: dict, gt: dict, cfg: LossConfig, step=0,
                   call_reg: bool = False,
                   graph_relations: dict | None = None) -> dict:
    """The full Stage-1 loss. gt: rgb [R,3], depth [R,1], normal [R,3],
    segs [R] int, mask [R,1]."""
    res: dict = {}
    zero = out["rgb_values"].new_zeros(())
    res["rgb_loss"] = rgb_loss(out["rgb_values"], gt["rgb"].reshape(-1, 3),
                               cfg.rgb_loss)
    if "grad_theta" in out:
        res["eikonal_loss"] = eikonal_loss(out["grad_theta"])
        res["smooth_loss"] = smooth_loss(out["grad_theta"],
                                         out["grad_theta_nei"])
    else:
        res["eikonal_loss"] = res["smooth_loss"] = zero
    sdf = out["sdf"]
    sign_change = (sdf > 0).any(-1) & (sdf < 0).any(-1)
    mask = (gt["mask"].reshape(-1) > 0.5) & sign_change
    res["depth_loss"] = (depth_loss(out["depth_values"], gt["depth"])
                         if cfg.depth_weight > 0 else zero)
    normal_pred = out["normal_map"] * mask[:, None]
    res["normal_l1"], res["normal_cos"] = normal_loss(normal_pred,
                                                      gt["normal"])
    decay = (torch.exp(-torch.as_tensor(step, dtype=torch.float32)
                       / cfg.end_step * 10.0)
             if cfg.end_step > 0 else 1.0)
    loss = (res["rgb_loss"] + cfg.eikonal_weight * res["eikonal_loss"]
            + cfg.smooth_weight * res["smooth_loss"]
            + decay * cfg.depth_weight * res["depth_loss"]
            + decay * cfg.normal_l1_weight * res["normal_l1"]
            + decay * cfg.normal_cos_weight * res["normal_cos"])
    if cfg.use_obj_opacity and "object_opacity" in out:
        res["semantic_loss"] = object_opacity_loss(out["object_opacity"],
                                                   gt["segs"])
    elif "semantic_values" in out:
        logp = torch.log_softmax(out["semantic_values"], -1)
        res["semantic_loss"] = -torch.gather(
            logp, -1, gt["segs"].reshape(-1, 1).long()).mean()
    else:
        res["semantic_loss"] = zero
    if call_reg and "sample_sdf" in out:
        if graph_relations is not None:
            p, d, b = object_distinct_graph_loss(
                out["sample_sdf"], graph_relations["obj_i"],
                graph_relations["parent"], tuple(graph_relations["desc"]),
                tuple(tuple(g) for g in graph_relations["bother"]))
            res["collision_reg_loss"] = p + d + b
        else:
            res["collision_reg_loss"] = object_distinct_loss(
                out["sample_sdf"], out["sample_minsdf"])
    else:
        res["collision_reg_loss"] = zero
    if "bg_depth_values" in out:
        bg_mask = (out["bg_mask"] != 0 if "bg_mask" in out
                   else gt["segs"].reshape(-1, 1) != 0)
        res["background_reg_loss"] = bg_render_loss(
            out["bg_depth_values"], out["bg_normal_map"], bg_mask)
    else:
        res["background_reg_loss"] = zero
    res["loss"] = (loss + cfg.semantic_weight * res["semantic_loss"]
                   + cfg.reg_vio_weight * res["collision_reg_loss"]
                   + cfg.bg_reg_weight * res["background_reg_loss"])
    return res
