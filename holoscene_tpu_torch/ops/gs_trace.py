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

T1 culls before it tests: a block of CULL_RAYS rays bounds its rays by a
cone and tests every gaussian's bounding sphere (`cull_spheres`, made by
the wrapper) against it, then runs the exact test on the survivors only.
`ray_bundles` / `bundle_survivors` are the cull's plain mirror, the same
float32 operations (the tests hold it to `_pair_hits`: no accepted pair is
culled); `ray_sphere_pairs` counts the pairs whose ray meets a sphere.

`pinhole_rays` / `fisheye_rays` generate a camera's rays and `trace_image`
renders a gaussian dict (read_gaussian_ply layout): the rays in tile order
(`tile_order`: TILE_W x TILE_H pixels, a compact bundle for each T1 block),
one selection (a T1 launch on the card) for every SELECT_RAYS of them, then
the composite in pixel order a ray chunk at a time.
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
CULL_RAYS = 128       # rays a T1 block, bounded by one cone
TILE_W, TILE_H = 16, 8    # trace_image's pixel tile: one T1 block's rays
# the cull's margins and slacks (csrc/gs_trace_select.cu derives them)
_LOG_SLACK = 2.0 ** -20   # expf, resp * op and the test, in -ln(resp)
_REL, _REL_KAPPA, _ABS = 2.0 ** -10, 2.0 ** -19, 2.0 ** -16
_COS_SLACK = 2.0 ** -20   # the bundle's cos T, below its least ray's
_MIN_COS = 2.0 ** -4      # a wider cone does not cull
_TOL = 2.0 ** -18         # the cone test's own rounding
_HUGE = 1e18              # a radius that culls nothing


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
def cull_spheres(g13, rays_o, min_kernel: float, min_alpha: float,
                 kernel_degree: int = 2, exact: bool = False):
    """[N, 4] float32 (mean, radius): the sphere around each packed gaussian
    outside which no ray of `rays_o`'s origins is accepted, radius -1 where
    none can be (opacity <= min_alpha). T1's cull input, computed in
    float64 and rounded up: the unit-frame threshold sqrt(gd_max) of the
    acceptance test times ||A^-1||, with the margins for float32 rounding
    derived in csrc/gs_trace_select.cu. exact=True: the sphere of the exact
    threshold, no slack and no margin (the bound's pair count)."""
    n = g13.shape[0]
    a = g13[:, 3:12].double().reshape(n, 3, 3)
    op = g13[:, 12].double()
    mk, ma = float(np.float32(min_kernel)), float(np.float32(min_alpha))
    dead = ~(op > ma) | (ma >= float(np.float32(0.99))) | (mk >= 1.0)
    slack = 0.0 if exact else _LOG_SLACK
    gd_max = ((slack - torch.log(torch.clamp(ma / op, min=mk)))
              * ((1.0 + slack) / abs(KERNEL_SCALES[kernel_degree]))) \
        ** (2.0 / kernel_degree)
    # ||A^-1|| and ||A|| <= sqrt of the largest Gershgorin row sum of the
    # Gram matrix; A^-1 = adj(A) / det, adj(A)^T's rows the rows' crosses
    cols = torch.linalg.cross(a[:, [1, 2, 0]], a[:, [2, 0, 1]])
    det = (a[:, 0] * cols[:, 0]).sum(-1)
    grams = torch.stack([cols, a], 1)                      # [N, 2, 3, 3]
    grams = (grams[:, :, :, None] * grams[:, :, None]).sum(-1)
    norms = torch.sqrt(grams.abs().sum(-1).amax(-1))       # [N, 2]
    s_max = norms[:, 0] / det.abs()
    radius = s_max * torch.sqrt(gd_max)
    if not exact:
        o_scale = torch.linalg.vector_norm(rays_o, dim=-1).amax().double() \
            if rays_o.shape[0] else 0.0
        radius = radius * (1.0 + _REL + _REL_KAPPA * s_max * norms[:, 1]) \
            + _ABS * (torch.linalg.vector_norm(g13[:, :3], dim=-1).double()
                      + o_scale)
    inf = float("inf")
    radius = torch.nan_to_num(radius, nan=inf, posinf=inf)
    r32 = radius.float()
    r32 = torch.where(r32.double() < radius,
                      torch.nextafter(r32, torch.full_like(r32, inf)), r32)
    r32 = torch.where(dead, torch.full_like(r32, -1.0), r32)
    return torch.cat([g13[:, :3], r32[:, None]], dim=1).contiguous()


def _blocks(x, n_blocks: int):
    """[R, 3] -> [n_blocks, CULL_RAYS, 3], zero rows past R."""
    pad = n_blocks * CULL_RAYS - x.shape[0]
    return torch.cat([x, x.new_zeros(pad, 3)]).reshape(n_blocks, CULL_RAYS,
                                                        3)


def _norm3(x, y, z):
    return torch.sqrt((x * x + y * y) + z * z)


@torch.no_grad()
def ray_bundles(rays_o, rays_d, near: float) -> dict:
    """Plain mirror of T1's pass (a): for each block of CULL_RAYS rays the
    bundle the kernel reduces in shared memory, in its float32 operations
    and order. Returns {"c": [B, 3] first origin, "ro": [B] origin radius,
    "a": [B, 3] axis, "cos_t": [B], "inv_sin": [B], "cull": [B] bool}; no
    block culls at near < 0, where hits behind the origin count."""
    r = rays_o.shape[0]
    nb = -(-r // CULL_RAYS)
    active = (torch.arange(nb * CULL_RAYS, device=rays_o.device)
              < r).reshape(nb, CULL_RAYS)
    o, d = _blocks(rays_o, nb), _blocks(rays_d, nb)
    dx, dy, dz = d.unbind(-1)
    d2n = (dx * dx + dy * dy) + dz * dz
    ok = torch.isfinite(o).all(-1) & torch.isfinite(d2n) & (d2n > 0)
    all_ok = (ok | ~active).all(1)
    c = o[:, 0]
    e = torch.where(active, _norm3(*(o - c[:, None]).unbind(-1)),
                    torch.zeros_like(d2n))
    ro = e.amax(1)
    s = torch.where(active[..., None], d, torch.zeros_like(d))
    while s.shape[1] > 1:                     # the kernel's tree
        h = s.shape[1] // 2
        s = s[:, :h] + s[:, h:]
    s = s[:, 0]
    sn = _norm3(*s.unbind(-1))
    a = s / sn[:, None]
    ax, ay, az = (x[:, None] for x in a.unbind(-1))
    cos = ((dx * ax + dy * ay) + dz * az) / torch.sqrt(d2n)
    cos = torch.where(active, cos, torch.full_like(cos, 2.0))
    cos_t = torch.clamp(cos.amin(1) - _COS_SLACK, max=1.0 - _COS_SLACK)
    return {"c": c, "ro": ro + ro * _COS_SLACK, "a": a, "cos_t": cos_t,
            "inv_sin": 1.0 / torch.sqrt((1.0 - cos_t) * (1.0 + cos_t)),
            "cull": all_ok & (sn > 0) & (cos_t >= _MIN_COS)
            & bool(np.float32(near) >= 0)}


@torch.no_grad()
def bundle_survivors(spheres, bundles: dict, chunk: int = 16):
    """Plain mirror of T1's pass (b): [B, N] bool, the spheres that block b
    keeps for the exact test (every live one where it does not cull)."""
    out = []
    mx, my, mz, rad = (x[None] for x in spheres.unbind(-1))
    for b0 in range(0, bundles["cull"].shape[0], chunk):
        sl = slice(b0, b0 + chunk)
        cx, cy, cz = (x[:, None] for x in bundles["c"][sl].unbind(-1))
        ax, ay, az = (x[:, None] for x in bundles["a"][sl].unbind(-1))
        ro, cos_t, inv_sin = (bundles[k][sl][:, None]
                              for k in ("ro", "cos_t", "inv_sin"))
        rr = rad + ro
        vx, vy, vz = mx - cx, my - cy, mz - cz
        s = rr * inv_sin
        wx, wy, wz = vx + s * ax, vy + s * ay, vz + s * az
        wa = (wx * ax + wy * ay) + wz * az
        wn = _norm3(wx, wy, wz)
        va = (vx * ax + vy * ay) + vz * az
        tol = _TOL * (wn + 2.0 * s)
        meets = ((va + rr) + tol >= 0) & (wa + tol >= cos_t * wn)
        out.append((rad >= 0) & (~bundles["cull"][sl][:, None]
                                 | ~(rr < _HUGE) | meets))
    return torch.cat(out)


@torch.no_grad()
def ray_sphere_pairs(spheres, rays_o, rays_d, survivors,
                     chunk: int = 8192) -> int:
    """How many (ray, gaussian) pairs have the ray (t >= 0) meet the
    gaussian's sphere, counted among each block's `survivors`: all of them
    when these spheres lie inside the ones the survivors were culled with
    (the exact spheres inside the cull spheres)."""
    r = rays_o.shape[0]
    b_idx, g_idx = survivors.nonzero(as_tuple=True)
    lanes = torch.arange(CULL_RAYS, device=rays_o.device)
    total = 0
    for p0 in range(0, b_idx.numel(), chunk):
        rid = b_idx[p0:p0 + chunk, None] * CULL_RAYS + lanes
        valid = rid < r
        rid = rid.clamp(max=r - 1)
        sp = spheres[g_idx[p0:p0 + chunk]]
        o, d = rays_o[rid], rays_d[rid]
        v = sp[:, None, :3] - o
        t = torch.clamp((v * d).sum(-1), min=0.0)
        q = v - t[..., None] * d
        hit = (q * q).sum(-1) <= sp[:, None, 3] ** 2
        total += int((hit & valid).sum())
    return total


@torch.no_grad()
def select_hits(g13, rays_o, rays_d, k: int, min_kernel: float,
                min_alpha: float, near: float, kernel_degree: int = 2,
                block: int = 2048):
    """T1 wrapper. CUDA tensor: makes the cull spheres (`cull_spheres`),
    launches `gs_trace_select` of csrc/gs_trace_select.cu (a ray a thread,
    each block of 128 rays culls the spheres against its bundle and runs the
    exact test on the survivors, a sorted K-buffer a ray) and counts the
    launch in `select_hits.launches`; CPU tensor: select_hits_plain. Returns
    (idx int32 [R, k], count int32 [R]), the same bits either way. `block`
    sizes the plain version's gaussian blocks."""
    return _select_hits(g13, rays_o, rays_d, k, min_kernel, min_alpha, near,
                        kernel_degree, block, None)


def _select_hits(g13, rays_o, rays_d, k, min_kernel, min_alpha, near,
                 kernel_degree, block, spheres):
    """select_hits with the cull spheres given (trace_image makes them once
    a view, from all its origins); None: made from these rays."""
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
        if spheres is None:
            spheres = cull_spheres(g13, rays_o, min_kernel, min_alpha,
                                   kernel_degree)
        st = kernels.library().gs_trace_select(
            rays_o.data_ptr(), rays_d.data_ptr(), g13.data_ptr(),
            spheres.data_ptr(), r, g13.shape[0], k, min_kernel, min_alpha,
            near, kernel_degree, idx.data_ptr(), count.data_ptr(),
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


def tile_order(width: int, height: int, device="cpu") -> torch.Tensor:
    """[H*W] int64: the row-major pixel indices in tile order (tiles of
    TILE_W x TILE_H pixels, row-major over the tiles and within each), so
    that each T1 block of 128 consecutive rays is one compact tile."""
    y = torch.arange(height, device=device)[:, None]
    x = torch.arange(width, device=device)[None, :]
    tiles_x = -(-width // TILE_W)
    key = ((y // TILE_H) * tiles_x + x // TILE_W) * (TILE_W * TILE_H) \
        + (y % TILE_H) * TILE_W + x % TILE_W
    return torch.argsort(key.reshape(-1))


@torch.no_grad()
def trace_image(g: dict, pose_c2w, intrinsics, width: int, height: int,
                sh_degree: int = 3, camera: str = "pinhole",
                chunk: int = 4096, device: str | torch.device = "cuda",
                max_hits: int = 128, min_alpha: float = 1.0 / 255.0,
                min_kernel: float = 0.0113, near: float = 1e-4,
                block: int = 2048, kernel_degree: int = 2) -> dict:
    """Render a gaussian dict (read_gaussian_ply layout: means, quats,
    log_scales, opacity_logits, features_dc, features_rest) with the ray
    tracer: the hits of SELECT_RAYS rays in tile order a selection (one T1
    launch on the card), composited in pixel order `chunk` rays at a time.
    Each ray's hits do not depend on the other rays, so the image is the
    same bits as a row-major selection's. Returns rgb [H,W,3], depth
    [H,W], alpha [H,W] as numpy."""
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
    n = rays_o.shape[0]
    order = tile_order(width, height, dev)
    tiled_o, tiled_d = rays_o[order], rays_d[order]
    idx = torch.empty((n, k), dtype=torch.int32, device=dev)
    cnt = torch.empty((n,), dtype=torch.int32, device=dev)
    spheres = cull_spheres(g13, rays_o, min_kernel, min_alpha,
                           kernel_degree) if rays_o.is_cuda else None
    for s0 in range(0, n, SELECT_RAYS):
        sl = slice(s0, s0 + SELECT_RAYS)
        idx[order[sl]], cnt[order[sl]] = _select_hits(
            g13, tiled_o[sl], tiled_d[sl], k, min_kernel, min_alpha, near,
            kernel_degree, block, spheres)
    outs = {"rgb": [], "depth": [], "alpha": []}
    for c0 in range(0, n, chunk):
        sl = slice(c0, c0 + chunk)
        o = composite_hits(means, quats, scales, opac, sh, rays_o[sl],
                           rays_d[sl], idx[sl], cnt[sl], sh_degree,
                           kernel_degree)
        for key in outs:
            outs[key].append(o[key].cpu().numpy())
    return {
        "rgb": np.concatenate(outs["rgb"]).reshape(height, width, 3),
        "depth": np.concatenate(outs["depth"]).reshape(height, width),
        "alpha": np.concatenate(outs["alpha"]).reshape(height, width),
    }
