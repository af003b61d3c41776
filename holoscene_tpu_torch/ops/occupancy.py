"""Persistent occupancy grid for Stage-1 sample-range restriction (port of
holoscene_tpu/ops/occupancy.py).

A res^3 grid holds an estimate of min |scene SDF| per cell, refreshed from
the error-bound sampler's probe buffer (the refined (z, sdf) pairs it
already computes), and each ray's sampling interval is tightened to the
span of taps that fall in cells that can hold surface.

Safety invariants (the JAX module's):
  * the grid starts at 0, "occupied everywhere": restriction is a no-op
    until probe evidence arrives;
  * a cell is skippable only when its estimate exceeds
    max(margin_cells x cell diagonal, beta_margin x beta);
  * unprobed cells decay toward occupied (x decay per update);
  * rays whose taps see no occupied cell keep their full interval.

The grid is a flat float32 tensor [res^3] and is never differentiated.
Bitwise as JAX: the taps come from ops/sampler.py::linspace (jnp.linspace's
rounding; torch.linspace differs in the last bit of about half the taps),
the cell of a point is floor((p + bound) * (res / (2 bound))), and the
first / last occupied tap are torch.argmax's first maximum of the mask and
of its reverse."""

from __future__ import annotations

import dataclasses

import torch

from holoscene_tpu_torch.ops.sampler import linspace


@dataclasses.dataclass(frozen=True)
class OccGridConfig:
    resolution: int = 64
    bound: float = 1.0          # grid spans [-bound, bound]^3
    taps: int = 64              # coarse taps per ray for range finding
    margin_cells: float = 1.5   # occupied if est < margin_cells * cell_diag
    beta_margin: float = 4.0    # ... or est < beta_margin * beta
    decay: float = 0.95         # unprobed-cell relaxation toward occupied
    pad_taps: float = 1.0       # interval padding in tap spacings

    @property
    def cell_diag(self) -> float:
        return 2.0 * self.bound * (3.0 ** 0.5) / self.resolution


def init_occ_grid(cfg: OccGridConfig, device="cpu") -> torch.Tensor:
    """All zero: occupied everywhere."""
    return torch.zeros(cfg.resolution ** 3, dtype=torch.float32,
                       device=device)


def _cell_index(pts: torch.Tensor, cfg: OccGridConfig):
    """[M, 3] world points -> (flat cell index [M], inside mask [M])."""
    g = cfg.resolution
    x = (pts + cfg.bound) * (g / (2.0 * cfg.bound))
    idx = torch.floor(x).to(torch.int64)
    inside = ((idx >= 0) & (idx < g)).all(-1)
    idx = torch.clamp(idx, 0, g - 1)
    return (idx[:, 0] * g + idx[:, 1]) * g + idx[:, 2], inside


def occ_batch_min(occ: torch.Tensor, pts: torch.Tensor, sdf: torch.Tensor,
                  cfg: OccGridConfig) -> torch.Tensor:
    """Per-cell min |sdf| of a probe batch (pts [..., 3], sdf [...]), +inf
    where no probe fell; points outside the grid are dropped."""
    idx, inside = _cell_index(pts.detach().reshape(-1, 3), cfg)
    a = sdf.detach().reshape(-1).abs()
    inf = torch.full_like(a, float("inf"))
    return torch.full_like(occ, float("inf")).scatter_reduce(
        0, torch.where(inside, idx, torch.zeros_like(idx)),
        torch.where(inside, a, inf), "amin", include_self=True)


def update_occ_grid(occ: torch.Tensor, pts: torch.Tensor, sdf: torch.Tensor,
                    cfg: OccGridConfig, reduce_min=None) -> torch.Tensor:
    """Fold a probe batch into the grid: probed cells take the batch min
    |sdf|, unprobed cells decay toward occupied. reduce_min, when given,
    combines the per-cell minima of every rank's rows first (an all-reduce
    MIN), so every rank applies the same update."""
    batch_min = occ_batch_min(occ, pts, sdf, cfg)
    if reduce_min is not None:
        batch_min = reduce_min(batch_min)
    probed = batch_min < float("inf")
    return torch.where(probed, batch_min, occ.detach() * cfg.decay)


def _margin(beta, cfg: OccGridConfig, device) -> torch.Tensor:
    b = torch.as_tensor(beta, dtype=torch.float32, device=device)
    return torch.clamp(cfg.beta_margin * b,
                       min=cfg.margin_cells * cfg.cell_diag)


def occupied_mask(occ: torch.Tensor, beta, cfg: OccGridConfig) -> torch.Tensor:
    """Boolean per-cell occupancy at the current annealing state."""
    return occ < _margin(beta, cfg, occ.device)


def ray_range(occ: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor,
              near: torch.Tensor, far: torch.Tensor, beta,
              cfg: OccGridConfig):
    """Tighten each ray's [near, far] ([R, 1]) to its occupied span; taps
    outside the grid count as unoccupied, and a ray with no occupied tap
    keeps its full interval. Returns (near' [R, 1], far' [R, 1]) with
    near <= near' <= far' <= far."""
    occ = occ.detach()
    t = linspace(0.0, 1.0, cfg.taps, rays_o.device)[None, :]
    z = near * (1.0 - t) + far * t                               # [R, T]
    pts = rays_o[:, None, :] + z[..., None] * rays_d[:, None, :]
    idx, inside = _cell_index(pts.reshape(-1, 3), cfg)
    hot = ((occ[idx] < _margin(beta, cfg, occ.device)) & inside) \
        .reshape(z.shape)
    any_hot = hot.any(-1, keepdim=True)
    first = torch.argmax(hot.to(torch.int32), -1, keepdim=True)
    last = (cfg.taps - 1) - torch.argmax(hot.flip(-1).to(torch.int32), -1,
                                         keepdim=True)
    spacing = (far - near) / (cfg.taps - 1)
    pad = cfg.pad_taps * spacing
    t0 = torch.gather(z, -1, first) - pad
    t1 = torch.gather(z, -1, last) + pad
    t0 = torch.minimum(torch.maximum(t0, near), far)
    t1 = torch.minimum(torch.maximum(t1, near), far)
    near_r = torch.where(any_hot, t0, near)
    far_r = torch.where(any_hot, torch.maximum(t1, t0 + spacing), far)
    return near_r, far_r
