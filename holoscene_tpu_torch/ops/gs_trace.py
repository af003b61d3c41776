"""Ray-traced 3D gaussians (port of holoscene_tpu/ops/gs_trace.py, the
analog of the 3DGRT tracer).

The counterpart's `trace_gaussians` has two halves, and so does this one:

  * hit selection: for each ray the K nearest accepted particles, front to
    back (processHit's acceptance: response > min_kernel, alpha >
    min_alpha, t_proj > near). `select_hits` launches kernel T1
    (csrc/gs_trace_select.cu) for a CUDA tensor and runs its plain version
    `select_hits_plain` (the counterpart's block-streamed top-K, with a
    stable sort) for a CPU tensor. Not differentiable, in either package.
  * recompute and composite: the response, alpha, cumprod transmittance,
    SH radiance, depth (and the ellipsoid normal) of the selected [R, K]
    hits in plain PyTorch, with autograd.

The squared distance of a ray to a particle's centre in its unit frame is
|grd x gro|^2, processHit's form. The counterpart writes |gro|^2 -
t_proj^2, equal in exact arithmetic, but for a flat particle (scale 1e-4,
as Gaussian-on-Mesh exports have) a few units away both terms are ~1e9 and
their float32 difference is noise of +-100: its hit test and response are
wrong there. On well-conditioned particles the two agree to rounding
(tests/test_torch_gs_trace.py).

Selection is exact, ties to the smaller gaussian index. The counterpart
selects with jax.lax.approx_max_k, which is exact on the CPU and has a
recall of ~0.95 on a TPU; the port keeps the CPU's set, as ops/splat.py's
select_topk does (tests/test_torch_gs_trace.py pins it there). Indices past
a ray's count are 0, as the counterpart's are.

`pinhole_rays` / `fisheye_rays` generate a camera's rays and `trace_image`
renders a gaussian dict (read_gaussian_ply layout): one selection (a T1
launch on the card) for every SELECT_RAYS rays, then the composite a ray
chunk at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from holoscene_tpu_torch import as_tensor, resolve_device
from holoscene_tpu_torch.ops.gaussians import eval_sh, quat_to_rotmat

# generalized gaussian response exp(s_n * grayDist^(n/2)), s_n = -4.5/3^n
# (processHit's particle response; degree 2 is the standard gaussian)
KERNEL_SCALES = {1: -1.5, 2: -0.5, 4: -1.0 / 18.0, 8: -4.5 / 6561.0}
MAX_HITS = 256        # the largest K kernel T1's per-ray buffer holds
# rays a T1 launch in trace_image on the card: 512 blocks of 128 rays fill
# the H100's 132 SMs (a 4096-ray chunk is 32 blocks, a quarter of them)
SELECT_RAYS = 65536
PACK = 13             # floats a gaussian: mean, A = diag(1/s) R^T, opacity


def _response(gd, kernel_degree: int):
    s = KERNEL_SCALES[kernel_degree]
    if kernel_degree == 2:
        return torch.exp(s * gd)
    if kernel_degree == 4:
        return torch.exp(s * gd * gd)
    if kernel_degree == 8:
        gd2 = gd * gd
        return torch.exp(s * gd2 * gd2)
    return torch.exp(s * torch.sqrt(torch.clamp(gd, min=1e-20)))


@torch.no_grad()
def pack_gaussians(means, quats, scales, opacities) -> torch.Tensor:
    """[N, 13] float32 rows (mean, A row-major, opacity), A = diag(1/s) R^T
    the particle's canonical transform: T1's and the plain selection's
    input."""
    rot = quat_to_rotmat(quats)
    inv = 1.0 / torch.clamp(scales, min=1e-12)
    a = inv[:, :, None] * rot.transpose(-1, -2)
    return torch.cat([means, a.reshape(-1, 9), opacities[:, None]],
                     dim=1).float().contiguous()


def _pair_hits(g13, rays_o, rays_d, min_kernel: float, min_alpha: float,
               near: float, kernel_degree: int):
    """(accept, t) [R, B] of every (ray, packed gaussian) pair, each float
    operation the one T1 does, in its order."""
    ox, oy, oz = rays_o[:, 0:1], rays_o[:, 1:2], rays_o[:, 2:3]
    dx, dy, dz = rays_d[:, 0:1], rays_d[:, 1:2], rays_d[:, 2:3]
    g = [g13[None, :, c] for c in range(PACK)]
    ocx, ocy, ocz = ox - g[0], oy - g[1], oz - g[2]
    gx = (g[3] * ocx + g[4] * ocy) + g[5] * ocz
    gy = (g[6] * ocx + g[7] * ocy) + g[8] * ocz
    gz = (g[9] * ocx + g[10] * ocy) + g[11] * ocz
    ux = (g[3] * dx + g[4] * dy) + g[5] * dz
    uy = (g[6] * dx + g[7] * dy) + g[8] * dz
    uz = (g[9] * dx + g[10] * dy) + g[11] * dz
    n = torch.clamp(torch.sqrt((ux * ux + uy * uy) + uz * uz), min=1e-12)
    rx, ry, rz = ux / n, uy / n, uz / n
    tp = -((rx * gx + ry * gy) + rz * gz)
    cx = ry * gz - rz * gy
    cy = rz * gx - rx * gz
    cz = rx * gy - ry * gx
    gd = (cx * cx + cy * cy) + cz * cz
    resp = _response(gd, kernel_degree)
    alpha = torch.clamp(resp * g[12], max=0.99)
    accept = (resp > min_kernel) & (alpha > min_alpha) & (tp > near)
    return accept, tp / n


@torch.no_grad()
def select_hits_plain(g13, rays_o, rays_d, k: int, min_kernel: float,
                      min_alpha: float, near: float, kernel_degree: int = 2,
                      block: int = 2048, ray_chunk: int = 4096):
    """Plain PyTorch T1 (the CPU path and the card's reference): the
    counterpart's streaming top-K over blocks of `block` gaussians, merged
    with a stable sort so equal distances keep the smaller index, for
    `ray_chunk` rays at a time (its [rays, block] temporaries). Returns
    (idx int32 [R, k], count int32 [R])."""
    if rays_o.shape[0] > ray_chunk:
        parts = [select_hits_plain(g13, rays_o[i:i + ray_chunk],
                                   rays_d[i:i + ray_chunk], k, min_kernel,
                                   min_alpha, near, kernel_degree, block,
                                   ray_chunk)
                 for i in range(0, rays_o.shape[0], ray_chunk)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))
    r = rays_o.shape[0]
    dev = rays_o.device
    best_t = torch.full((r, k), float("inf"), device=dev)
    best_i = torch.zeros((r, k), dtype=torch.int64, device=dev)
    for b0 in range(0, g13.shape[0], block):
        g = g13[b0:b0 + block]
        accept, t = _pair_hits(g, rays_o, rays_d, min_kernel, min_alpha,
                               near, kernel_degree)
        t = torch.where(accept, t, torch.full_like(t, float("inf")))
        ids = torch.arange(b0, b0 + g.shape[0], device=dev)
        cand_t = torch.cat([best_t, t], dim=1)
        cand_i = torch.cat([best_i, ids[None, :].expand(r, -1)], dim=1)
        srt, pos = torch.sort(cand_t, dim=1, stable=True)
        best_t = srt[:, :k]
        best_i = torch.gather(cand_i, 1, pos[:, :k])
    hit = torch.isfinite(best_t)
    idx = torch.where(hit, best_i, torch.zeros_like(best_i))
    return idx.to(torch.int32), hit.sum(dim=1).to(torch.int32)


@torch.no_grad()
def select_hits(g13, rays_o, rays_d, k: int, min_kernel: float,
                min_alpha: float, near: float, kernel_degree: int = 2,
                block: int = 2048):
    """T1 wrapper. CUDA tensor: launches `gs_trace_select` of
    csrc/gs_trace_select.cu (a ray a thread, the gaussians streamed through
    shared memory, a sorted K-buffer a ray) and counts the launch in
    `select_hits.launches`; CPU tensor: select_hits_plain. Returns (idx
    int32 [R, k], count int32 [R]). `block` sizes the plain version's
    gaussian blocks (the kernel streams 128 at a time)."""
    if kernel_degree not in KERNEL_SCALES:
        raise ValueError(f"kernel_degree {kernel_degree} not in 1, 2, 4, 8")
    if not 1 <= k <= MAX_HITS:
        raise ValueError(f"k = {k} hits a ray: T1 holds 1..{MAX_HITS}")
    for x in (g13, rays_o, rays_d):
        if x.device != rays_o.device or x.dtype != torch.float32 \
                or not x.is_contiguous():
            raise ValueError("select_hits: float32 contiguous tensors on "
                             "one device")
    if not rays_o.is_cuda:
        return select_hits_plain(g13, rays_o, rays_d, k, min_kernel,
                                 min_alpha, near, kernel_degree, block)
    from holoscene_tpu_torch import kernels

    r = rays_o.shape[0]
    idx = torch.empty((r, k), dtype=torch.int32, device=rays_o.device)
    count = torch.empty((r,), dtype=torch.int32, device=rays_o.device)
    if r:
        st = kernels.library().gs_trace_select(
            rays_o.data_ptr(), rays_d.data_ptr(), g13.data_ptr(), r,
            g13.shape[0], k, min_kernel, min_alpha, near, kernel_degree,
            idx.data_ptr(), count.data_ptr(),
            torch.cuda.current_stream(rays_o.device).cuda_stream)
        kernels.check(st, "gs_trace_select")
        select_hits.launches += 1
    return idx, count


select_hits.launches = 0


def composite_hits(means, quats, scales, opacities, sh_coeffs, rays_o,
                   rays_d, idx, count, sh_degree: int = 3,
                   kernel_degree: int = 2, with_normal: bool = False):
    """Recompute the selected hits' responses and composite them front to
    back (the counterpart's second half, plain PyTorch with autograd).
    idx [R, K] / count [R] from select_hits. Returns rgb [R,3], depth [R],
    alpha [R] (+ normal [R,3])."""
    r, k = idx.shape
    valid = torch.arange(k, device=idx.device)[None, :] < count[:, None]
    flat = idx.reshape(-1).long()
    rot = quat_to_rotmat(quats)
    inv_scales = 1.0 / torch.clamp(scales, min=1e-12)
    m_k = means[flat].reshape(r, k, 3)
    is_k = inv_scales[flat].reshape(r, k, 3)
    rot_k = rot[flat].reshape(r, k, 3, 3)
    op_k = opacities[flat].reshape(r, k)

    rot_t = rot_k.transpose(-1, -2)
    oc = rays_o[:, None, :] - m_k
    gro = torch.einsum("rkij,rkj->rki", rot_t, oc) * is_k
    dl = torch.einsum("rkij,rj->rki", rot_t, rays_d)
    grdu = dl * is_k
    grd = grdu / torch.clamp(
        torch.linalg.vector_norm(grdu, dim=-1, keepdim=True), min=1e-12)
    t_proj = -torch.sum(grd * gro, dim=-1)
    gray = torch.sum(torch.linalg.cross(grd, gro) ** 2, dim=-1)
    resp = _response(gray, kernel_degree)
    alpha = torch.where(valid, torch.clamp(resp * op_k, max=0.99),
                        torch.zeros_like(resp))
    hit_t = torch.linalg.vector_norm((grd * t_proj[..., None]) / is_k,
                                     dim=-1)

    trans = torch.cumprod(1.0 - alpha + 1e-12, dim=1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=1)
    weight = alpha * trans

    dirs = rays_d[:, None, :].expand(r, k, 3).reshape(-1, 3)
    rgb_k = torch.clamp(eval_sh(sh_coeffs[flat], dirs, sh_degree),
                        min=0.0).reshape(r, k, 3)
    out = {"rgb": torch.einsum("rk,rkc->rc", weight, rgb_k),
           "depth": torch.sum(weight * hit_t, dim=1),
           "alpha": weight.sum(dim=1)}
    if with_normal:
        # ellipsoid surface normal at the response point, scaled back to
        # world (processHit, ellipsoidSqRadius = 9)
        root = torch.sqrt(torch.clamp(9.0 - gray, min=0.0))
        p_surf = gro + grd * (t_proj - root)[..., None]
        nrm_c = p_surf / torch.clamp(
            torch.linalg.vector_norm(p_surf, dim=-1, keepdim=True),
            min=1e-12)
        nrm_w = torch.einsum("rkij,rkj->rki", rot_k, nrm_c / is_k)
        nrm_w = nrm_w / torch.clamp(
            torch.linalg.vector_norm(nrm_w, dim=-1, keepdim=True), min=1e-12)
        out["normal"] = torch.einsum("rk,rki->ri", weight, nrm_w)
    return out


def trace_gaussians(
    means: torch.Tensor,          # [N, 3]
    quats: torch.Tensor,          # [N, 4]
    scales: torch.Tensor,         # [N, 3] linear scales
    opacities: torch.Tensor,      # [N]
    sh_coeffs: torch.Tensor,      # [N, B, 3]
    rays_o: torch.Tensor,         # [R, 3]
    rays_d: torch.Tensor,         # [R, 3] unit
    sh_degree: int = 3,
    max_hits: int = 128,
    min_alpha: float = 1.0 / 255.0,
    min_kernel: float = 0.0113,
    near: float = 1e-4,
    block: int = 2048,
    kernel_degree: int = 2,
    with_normal: bool = False,
):
    """Trace rays through a gaussian mixture: rgb [R,3], depth [R], alpha
    [R] (+ normal [R,3] with with_normal). Hit selection through T1 (not
    differentiable), compositing with autograd."""
    k = min(max_hits, means.shape[0])
    g13 = pack_gaussians(means.detach(), quats.detach(), scales.detach(),
                         opacities.detach())
    idx, count = select_hits(g13, rays_o.detach().float().contiguous(),
                             rays_d.detach().float().contiguous(), k,
                             min_kernel, min_alpha, near, kernel_degree,
                             block)
    return composite_hits(means, quats, scales, opacities, sh_coeffs, rays_o,
                          rays_d, idx, count, sh_degree, kernel_degree,
                          with_normal)


# ---------------------------------------------------------------------------
# ray generators: the tracer's reason to exist, exact distorted cameras
# ---------------------------------------------------------------------------


def _pixel_grid(intrinsics, width: int, height: int, dev):
    y, x = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev) + 0.5,
        torch.arange(width, dtype=torch.float32, device=dev) + 0.5,
        indexing="ij")
    return ((x - intrinsics[0, 2]) / intrinsics[0, 0],
            (y - intrinsics[1, 2]) / intrinsics[1, 1])


def pinhole_rays(pose_c2w, intrinsics, width: int, height: int,
                 device: str | torch.device = "cpu"):
    """[H*W, 3] origins and unit directions (world), OpenCV convention."""
    dev = torch.device(device)
    pose = as_tensor(pose_c2w, dev)
    u, v = _pixel_grid(as_tensor(intrinsics, dev), width, height, dev)
    d = torch.stack([u, v, torch.ones_like(u)], dim=-1).reshape(-1, 3)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    dirs = d @ pose[:3, :3].T
    return pose[:3, 3].expand(dirs.shape).contiguous(), dirs.contiguous()


def fisheye_rays(pose_c2w, intrinsics, width: int, height: int,
                 device: str | torch.device = "cpu"):
    """Equidistant fisheye (r_px = f * theta): [H*W, 3] origins and unit
    directions; pixels past theta = pi/2 get rays pointing sideways or
    backwards."""
    dev = torch.device(device)
    pose = as_tensor(pose_c2w, dev)
    u, v = _pixel_grid(as_tensor(intrinsics, dev), width, height, dev)
    r = torch.sqrt(u * u + v * v)
    sin_t = torch.sin(r)
    safe_r = torch.clamp(r, min=1e-9)
    d = torch.stack([sin_t * u / safe_r, sin_t * v / safe_r, torch.cos(r)],
                    dim=-1).reshape(-1, 3)
    dirs = d @ pose[:3, :3].T
    return pose[:3, 3].expand(dirs.shape).contiguous(), dirs.contiguous()


@torch.no_grad()
def trace_image(g: dict, pose_c2w, intrinsics, width: int, height: int,
                sh_degree: int = 3, camera: str = "pinhole",
                chunk: int = 4096, device: str | torch.device = "cuda",
                max_hits: int = 128, min_alpha: float = 1.0 / 255.0,
                min_kernel: float = 0.0113, near: float = 1e-4,
                block: int = 2048, kernel_degree: int = 2) -> dict:
    """Render a gaussian dict (read_gaussian_ply layout: means, quats,
    log_scales, opacity_logits, features_dc, features_rest) with the ray
    tracer: the hits of SELECT_RAYS rays a selection (one T1 launch on
    the card), composited `chunk` rays at a time. Returns rgb [H,W,3],
    depth [H,W], alpha [H,W] as numpy."""
    dev = resolve_device(device)
    rays = pinhole_rays if camera == "pinhole" else fisheye_rays
    rays_o, rays_d = rays(pose_c2w, intrinsics, width, height, dev)
    means = as_tensor(g["means"], dev)
    quats = as_tensor(g["quats"], dev)
    quats = quats / torch.clamp(
        torch.linalg.vector_norm(quats, dim=-1, keepdim=True), min=1e-12)
    scales = torch.exp(as_tensor(g["log_scales"], dev))
    opac = torch.sigmoid(as_tensor(g["opacity_logits"], dev).reshape(-1))
    sh = torch.cat([as_tensor(g["features_dc"], dev)[:, None, :],
                    as_tensor(g["features_rest"], dev)], dim=1)
    g13 = pack_gaussians(means, quats, scales, opac)
    k = min(max_hits, means.shape[0])
    span = -(-SELECT_RAYS // chunk) * chunk
    outs = {"rgb": [], "depth": [], "alpha": []}
    for s0 in range(0, rays_o.shape[0], span):
        idx, cnt = select_hits(g13, rays_o[s0:s0 + span],
                               rays_d[s0:s0 + span], k, min_kernel,
                               min_alpha, near, kernel_degree, block)
        for c0 in range(0, idx.shape[0], chunk):
            sl = slice(s0 + c0, s0 + c0 + chunk)
            o = composite_hits(means, quats, scales, opac, sh, rays_o[sl],
                               rays_d[sl], idx[c0:c0 + chunk],
                               cnt[c0:c0 + chunk], sh_degree, kernel_degree)
            for key in outs:
                outs[key].append(o[key].cpu().numpy())
    return {
        "rgb": np.concatenate(outs["rgb"]).reshape(height, width, 3),
        "depth": np.concatenate(outs["depth"]).reshape(height, width),
        "alpha": np.concatenate(outs["alpha"]).reshape(height, width),
    }
