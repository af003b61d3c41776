"""VolSDF error-bound ray sampling (port of holoscene_tpu/ops/sampler.py:
error_bound_sample, estimate_weights_from_buffer, the sign-change surface
search ray_marching_surface and the stratified uniform_sample).

The JAX version's fixed unroll is kept: a constant-width buffer of T*E
samples padded with the far sample, T-1 upsampling rounds, a final draw
from the compositing-weight PDF. A round whose every ray has converged is
skipped, as JAX's lax.cond skips it (one host sync a round). Every random
draw is an argument (`SamplerDraws`), so the same draws give JAX's
placements."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from holoscene_tpu_torch.ops.density import laplace_density
from holoscene_tpu_torch.ops.rays import near_far_from_cube


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    scene_bounding_sphere: float = 1.0
    near: float = 0.0
    N_samples: int = 64
    N_samples_eval: int = 128
    N_samples_extra: int = 32
    eps: float = 0.1
    beta_iters: int = 10
    max_total_iters: int = 5

    @property
    def far(self) -> float:
        return 2.0 * self.scene_bounding_sphere * 1.75

    @property
    def n_final(self) -> int:
        return self.N_samples + 2 + self.N_samples_extra

    @property
    def buffer_width(self) -> int:
        return self.max_total_iters * self.N_samples_eval

    @classmethod
    def from_conf(cls, conf, scene_bounding_sphere: float):
        return cls(
            scene_bounding_sphere=scene_bounding_sphere,
            near=conf.get_float("near", 0.0),
            N_samples=conf.get_int("N_samples", 64),
            N_samples_eval=conf.get_int("N_samples_eval", 128),
            N_samples_extra=conf.get_int("N_samples_extra", 32),
            eps=conf.get_float("eps", 0.1),
            beta_iters=conf.get_int("beta_iters", 10),
            max_total_iters=conf.get_int("max_total_iters", 5),
        )


@dataclasses.dataclass
class SamplerDraws:
    """The training sampler's random numbers: stratified jitter t_rand
    [R, E], final uniforms u [R, N_samples], the extra-sample indices perm
    [N_samples_extra] (a permutation's head of range(T*E)) and the eikonal
    sample index eik_idx [R, 1] in [0, n_final)."""

    t_rand: torch.Tensor
    u: torch.Tensor
    perm: torch.Tensor
    eik_idx: torch.Tensor

    @classmethod
    def make(cls, cfg: SamplerConfig, n_rays: int, gen: torch.Generator,
             device) -> "SamplerDraws":
        kw = dict(generator=gen, device=device)
        return cls(
            torch.rand(n_rays, cfg.N_samples_eval, **kw),
            torch.rand(n_rays, cfg.N_samples, **kw),
            torch.randperm(cfg.buffer_width, **kw)[:cfg.N_samples_extra],
            torch.randint(0, cfg.n_final, (n_rays, 1), **kw))

    def rows(self, sl: slice) -> "SamplerDraws":
        """The draws of rays sl (perm is shared by every ray)."""
        return SamplerDraws(self.t_rand[sl], self.u[sl], self.perm,
                            self.eik_idx[sl])


def linspace(start: float, stop: float, n: int, device) -> torch.Tensor:
    """n float32 points from start to stop as jnp.linspace rounds them
    (torch.linspace rounds its upper half differently; a sample placement
    can amplify one ulp)."""
    return start + torch.arange(n, dtype=torch.float32, device=device) \
        * ((stop - start) / (n - 1))


def _searchsorted_batched(cdf, u, side: str = "right"):
    """Per-row searchsorted(cdf[i], u[i])."""
    return torch.searchsorted(cdf.contiguous(), u.contiguous(),
                              right=side == "right")


def _sample_pdf(bins, cdf, u):
    """Invert a per-ray CDF: bins [R, S], cdf [R, S], u [R, N]."""
    inds = _searchsorted_batched(cdf, u)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_lo = torch.gather(cdf, -1, below)
    cdf_hi = torch.gather(cdf, -1, above)
    bin_lo = torch.gather(bins, -1, below)
    bin_hi = torch.gather(bins, -1, above)
    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_lo) / denom
    return bin_lo + t * (bin_hi - bin_lo)


def _merge_sorted(z_a, s_a, z_b, s_b):
    """Merge two per-row ascending (z, sdf) pairs: a[i] lands at
    i + #{b < a[i]}, b[j] at j + #{a <= b[j]}."""
    R, W = z_a.shape
    E = z_b.shape[1]
    dev = z_a.device
    pos_a = torch.arange(W, device=dev)[None] + _searchsorted_batched(
        z_b, z_a, "left")
    pos_b = torch.arange(E, device=dev)[None] + _searchsorted_batched(
        z_a, z_b, "right")
    z_m = torch.zeros(R, W + E, dtype=z_a.dtype, device=dev)
    s_m = torch.zeros(R, W + E, dtype=s_a.dtype, device=dev)
    z_m.scatter_(1, pos_a, z_a).scatter_(1, pos_b, z_b)
    s_m.scatter_(1, pos_a, s_a).scatter_(1, pos_b, s_b)
    return z_m, s_m


def _d_star(z_vals, sdf):
    """Theorem-1 minimum-distance bound per section [R, S-1]."""
    a = z_vals[:, 1:] - z_vals[:, :-1]
    b = sdf[:, :-1].abs()
    c = sdf[:, 1:].abs()
    first = a ** 2 + b ** 2 <= c ** 2
    second = a ** 2 + c ** 2 <= b ** 2
    s = (a + b + c) / 2.0
    area_sq = torch.clamp(s * (s - a) * (s - b) * (s - c), min=0.0)
    h = 2.0 * torch.sqrt(area_sq) / (a + 1e-12)
    zero = torch.zeros_like(h)
    d = torch.where(first, b, torch.where(second, c,
                                          torch.where(b + c - a > 0, h, zero)))
    same_sign = torch.sign(sdf[:, 1:]) * torch.sign(sdf[:, :-1]) == 1
    return torch.where(same_sign, d, zero)


def _error_bound(beta, sdf, z_vals, dists, d_star):
    """Max per-ray opacity error bound [R]."""
    density = laplace_density(sdf, beta)
    shifted = torch.cat([torch.zeros_like(z_vals[:, :1]),
                         dists * density[:, :-1]], -1)
    integral = torch.cumsum(shifted, -1)
    err_sec = torch.exp(-d_star / beta) * dists ** 2 / (4.0 * beta ** 2)
    err_int = torch.cumsum(err_sec, -1)
    bound = (torch.clamp(torch.exp(err_int), max=1e6) - 1.0) \
        * torch.exp(-integral[:, :-1])
    return bound.amax(-1)


def _near_far(rays_o, rays_d, cfg: SamplerConfig, near, far):
    """The caller's (near, far) [R, 1], or cfg.near and the scene cube's
    far when either is None."""
    if near is not None and far is not None:
        return near, far
    _, far = near_far_from_cube(rays_o, rays_d, bound=cfg.scene_bounding_sphere,
                                min_near=cfg.near, max_far=cfg.far)
    return torch.full((rays_o.shape[0], 1), cfg.near,
                      device=rays_o.device), far


def error_bound_sample(rays_o, rays_d, sdf_fn: Callable, beta0, cfg:
                       SamplerConfig, draws: SamplerDraws | None = None,
                       training: bool = True, return_aux: bool = False,
                       near=None, far=None):
    """z_vals [R, n_final] sorted and z_eik [R, 1] (+ (z_buf, sdf_buf,
    beta) with return_aux). training=True needs `draws`; eval uses
    linspace placements and no draws. sdf_fn: [M, 3] -> [M] scene SDF
    evaluated without gradient. near / far [R, 1] bound the initial
    samples (default cfg.near and the scene cube's far)."""
    R = rays_o.shape[0]
    E, T = cfg.N_samples_eval, cfg.max_total_iters
    dev = rays_o.device
    beta0 = torch.as_tensor(beta0, dtype=torch.float32, device=dev)
    near, far = _near_far(rays_o, rays_d, cfg, near, far)
    t_vals = linspace(0.0, 1.0, E, dev)[None]
    z_vals = near * (1.0 - t_vals) + far * t_vals
    if training:
        mids = 0.5 * (z_vals[:, 1:] + z_vals[:, :-1])
        upper = torch.cat([mids, z_vals[:, -1:]], -1)
        lower = torch.cat([z_vals[:, :1], mids], -1)
        z_vals = lower + (upper - lower) * draws.t_rand

    def probe(z):
        pts = rays_o[:, None, :] + z[..., None] * rays_d[:, None, :]
        return sdf_fn(pts.reshape(-1, 3)).reshape(R, -1)

    W = T * E
    far_pts = rays_o + far * rays_d
    sdf_all = sdf_fn(torch.cat([
        (rays_o[:, None, :] + z_vals[..., None] * rays_d[:, None, :])
        .reshape(-1, 3), far_pts]))
    sdf0 = sdf_all[:R * E].reshape(R, E)
    sdf_far = sdf_all[R * E:].reshape(R, 1)
    z_buf = torch.cat([z_vals, far.expand(R, W - E)], -1)
    sdf_buf = torch.cat([sdf0, sdf_far.expand(R, W - E)], -1)

    dists0 = z_buf[:, 1:] - z_buf[:, :-1]
    eps1 = torch.tensor(cfg.eps + 1.0, device=dev)
    bound = (1.0 / (4.0 * torch.log(eps1))) * (dists0 ** 2).sum(-1)
    beta = torch.sqrt(bound)

    def refine_beta(z_vals, sdf, beta):
        dists = z_vals[:, 1:] - z_vals[:, :-1]
        d_star = _d_star(z_vals, sdf)
        err_b0 = _error_bound(beta0, sdf, z_vals, dists, d_star)
        beta = torch.where(err_b0 <= cfg.eps, beta0, beta)
        beta_min, beta_max = beta0.expand(R), beta
        for _ in range(cfg.beta_iters):
            beta_mid = 0.5 * (beta_min + beta_max)
            err = _error_bound(beta_mid[:, None], sdf, z_vals, dists, d_star)
            beta_max = torch.where(err <= cfg.eps, beta_mid, beta_max)
            beta_min = torch.where(err > cfg.eps, beta_mid, beta_min)
        return beta_max, dists, d_star

    def weights_of(sdf, beta, dists):
        density = laplace_density(sdf, beta[:, None])
        dists_pad = torch.cat([dists, torch.full_like(dists[:, :1], 1e10)],
                              -1)
        free_energy = dists_pad * density
        shifted = torch.cat([torch.zeros_like(free_energy[:, :1]),
                             free_energy[:, :-1]], -1)
        alpha = 1.0 - torch.exp(-free_energy)
        transmittance = torch.exp(-torch.cumsum(shifted, -1))
        return alpha * transmittance, transmittance

    z_vals, sdf = z_buf, sdf_buf
    for _ in range(T - 1):
        beta, dists, d_star = refine_beta(z_vals, sdf, beta)
        if not bool((beta > beta0 * (1.0 + 1e-6)).any()):
            continue     # every ray converged: JAX's lax.cond skip
        _, transmittance = weights_of(sdf, beta, dists)
        err_sec = (torch.exp(-d_star / beta[:, None]) * dists ** 2
                   / (4.0 * beta[:, None] ** 2))
        err_int = torch.cumsum(err_sec, -1)
        bound_op = (torch.clamp(torch.exp(err_int), max=1e6) - 1.0) \
            * transmittance[:, :-1]
        pdf = bound_op + 1e-6
        pdf = pdf / pdf.sum(-1, keepdim=True)
        cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)],
                        -1)
        u = linspace(0.0, 1.0, E, dev)[None].expand(R, E)
        new_samples = _sample_pdf(z_vals, cdf, u)
        z_m, s_m = _merge_sorted(z_vals, sdf, new_samples, probe(new_samples))
        z_vals, sdf = z_m[:, :W], s_m[:, :W]

    beta, dists, _ = refine_beta(z_vals, sdf, beta)
    weights, _ = weights_of(sdf, beta, dists)
    pdf = weights[:, :-1] + 1e-5
    pdf = pdf / pdf.sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)], -1)
    if training:
        u = draws.u
    else:
        u = linspace(0.0, 1.0, cfg.N_samples, dev)[None].expand(
            R, cfg.N_samples)
    final_samples = _sample_pdf(z_vals, cdf, u)

    near_col = torch.full((R, 1), cfg.near, device=dev)
    far_col = torch.full((R, 1), cfg.far, device=dev)
    extra = [near_col, far_col]
    if cfg.N_samples_extra > 0:
        if training:
            idx = draws.perm
        else:
            idx = linspace(0, z_vals.shape[1] - 1, cfg.N_samples_extra,
                           dev).to(torch.int64)
        extra.append(z_vals[:, idx])
    z_final = torch.sort(torch.cat([final_samples] + extra, -1), -1).values
    if training:
        z_eik = torch.gather(z_final, -1, draws.eik_idx)
    else:
        z_eik = z_final[:, :1]
    if return_aux:
        return z_final, z_eik, (z_vals, sdf, beta)
    return z_final, z_eik


def estimate_weights_from_buffer(z_query, z_buf, sdf_buf, beta):
    """Compositing weights at z_query [R, S] estimated from the sampler's
    probe buffer (no SDF evaluation): for ranking samples only."""
    inds = _searchsorted_batched(z_buf, z_query)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=z_buf.shape[-1] - 1)
    z_lo = torch.gather(z_buf, -1, below)
    z_hi = torch.gather(z_buf, -1, above)
    s_lo = torch.gather(sdf_buf, -1, below)
    s_hi = torch.gather(sdf_buf, -1, above)
    span = z_hi - z_lo
    t = (z_query - z_lo) / torch.where(span < 1e-9, torch.ones_like(span),
                                       span)
    sdf_est = s_lo + torch.clamp(t, 0.0, 1.0) * (s_hi - s_lo)
    density = laplace_density(sdf_est, beta[:, None])
    dists = z_query[:, 1:] - z_query[:, :-1]
    free_energy = torch.cat([dists * density[:, :-1],
                             torch.full_like(dists[:, :1], 1e10)], -1)
    shifted = torch.cat([torch.zeros_like(free_energy[:, :1]),
                         free_energy[:, :-1]], -1)
    alpha = 1.0 - torch.exp(-free_energy)
    return alpha * torch.exp(-torch.cumsum(shifted, -1))


def ray_marching_surface(rays_o, rays_d, sdf_fn: Callable, cfg: SamplerConfig,
                         n_steps: int = 128, n_secant_steps: int = 8,
                         near=None, far=None):
    """Surface depth by sign-change search and secant refinement (JAX
    ray_marching_surface; reference ray_marching_surface + secant,
    ray_sampler.py:474-608): n_steps uniform samples in [near, far], the
    first + -> - transition of a ray that starts outside, then
    n_secant_steps secant steps. Returns (depth [R, 1], hit_mask [R]);
    rays without a transition get depth = far."""
    R = rays_o.shape[0]
    near, far = _near_far(rays_o, rays_d, cfg, near, far)
    t_vals = linspace(0.0, 1.0, n_steps, rays_o.device)[None]
    z = near * (1.0 - t_vals) + far * t_vals                   # [R, S]
    pts = rays_o[:, None, :] + z[..., None] * rays_d[:, None, :]
    val = sdf_fn(pts.reshape(-1, 3)).reshape(R, n_steps)

    sign_change = (val[:, :-1] > 0) & (val[:, 1:] < 0)
    any_hit = sign_change.any(-1) & (val[:, 0] > 0)
    first = torch.argmax(sign_change.to(torch.int8), -1)[:, None]
    hi = torch.clamp(first + 1, max=n_steps - 1)
    d_low, f_low = z.gather(1, first)[:, 0], val.gather(1, first)[:, 0]
    d_high, f_high = z.gather(1, hi)[:, 0], val.gather(1, hi)[:, 0]
    for _ in range(n_secant_steps):
        d_pred = -f_low * (d_high - d_low) / (f_high - f_low + 1e-12) + d_low
        f_mid = sdf_fn(rays_o + d_pred[:, None] * rays_d)
        same_side = f_mid * f_low > 0
        d_low = torch.where(same_side, d_pred, d_low)
        f_low = torch.where(same_side, f_mid, f_low)
        d_high = torch.where(same_side, d_high, d_pred)
        f_high = torch.where(same_side, f_high, f_mid)
    d_pred = -f_low * (d_high - d_low) / (f_high - f_low + 1e-12) + d_low
    depth = torch.where(any_hit, d_pred, far[:, 0])
    return depth[:, None], any_hit


def uniform_sample(near, far, n_samples: int, t_rand=None):
    """Stratified uniform sampling (JAX uniform_sample; UniformSampler,
    ray_sampler.py:63-83): n_samples evenly in [near, far] ([R, 1] each),
    each moved within its stratum by t_rand [R, n_samples] uniforms in [0,
    1) when given (training), left at the bin edges when None (eval).
    JAX's rays arguments only gave the batch; near / far give it here."""
    t_vals = linspace(0.0, 1.0, n_samples, near.device)[None]
    z_vals = near * (1.0 - t_vals) + far * t_vals
    if t_rand is not None:
        mids = 0.5 * (z_vals[:, 1:] + z_vals[:, :-1])
        upper = torch.cat([mids, z_vals[:, -1:]], -1)
        lower = torch.cat([z_vals[:, :1], mids], -1)
        z_vals = lower + (upper - lower) * t_rand
    return z_vals
