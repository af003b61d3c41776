"""T1's cull (csrc/gs_trace_select.cu) through its plain mirror in
ops/gs_trace.py: the cull spheres (`cull_spheres`), the block bundles
(`ray_bundles`) and the cone test (`bundle_survivors`), the same float32
operations as the kernel.

  * No false negatives: every (ray, gaussian) pair that `_pair_hits` (the
    exact test, T1's operations) accepts survives its block's cull, for
    kernel degrees 1 / 2 / 4 / 8 on seeded scenes of round, flat (1e-4
    across), needle, tiny (1e-6) and huge particles, opacities at and
    beside min_alpha, pinhole and fisheye tiles (rays past theta = pi/2
    included) and blocks of scattered origins. Each scene also places
    gaussians at the acceptance threshold: the ray passes at the unit-frame
    distance of the threshold (to a relative 2e-6) along the particle's
    longest axis, on the side away from the block's axis, from the block's
    widest ray and from its farthest origin, so the sphere's world radius
    and the cone's edge are both met.
  * The cull is not a no-op: on a pinhole tile of a random cloud of small
    particles the blocks keep a small share of the gaussians.
  * No block culls at near < 0, where the exact test accepts gaussians
    just behind the origin that the forward cone cannot meet.
  * Tiling changes nothing: trace_image (rays in 16 x 8 tiles) gives the
    arrays of a row-major selection bit for bit.
The kernel itself is held against select_hits_plain on the card in
tests/test_torch_cuda_kernels.py.
"""

import numpy as np
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401

from holoscene_tpu_torch.ops import gs_trace as tt

MIN_KERNEL, MIN_ALPHA, NEAR = 0.0113, 1.0 / 255.0, 1e-4
MA32 = np.float32(MIN_ALPHA)


def _pack(mu, rot, scales, op):
    """g13 rows from world means, rotations (columns the axes), scales."""
    a = (1.0 / scales)[:, :, None] * np.transpose(rot, (0, 2, 1))
    return torch.tensor(np.concatenate(
        [mu, a.reshape(-1, 9), op[:, None]], 1), dtype=torch.float32)


def _rho(op, degree):
    """Unit-frame distance of the exact acceptance threshold."""
    thr = np.maximum(np.float32(MIN_KERNEL), MA32 / op.astype(np.float64))
    big_l = np.maximum(-np.log(thr), 0.0)      # 0: never accepted
    return (big_l / abs(tt.KERNEL_SCALES[degree])) ** (1.0 / degree)


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _rays(kind, rng):
    """Rays in blocks of 128 (tile order for the cameras)."""
    if kind == "scattered":
        n_blocks = 8
        centre = rng.normal(size=(n_blocks, 1, 3)) * 0.5
        axis = _unit(rng.normal(size=(n_blocks, 1, 3)))
        ro = centre + rng.normal(size=(n_blocks, 128, 3)) * 0.2
        rd = _unit(axis + rng.normal(size=(n_blocks, 128, 3)) * 0.08)
        return (torch.tensor(ro.reshape(-1, 3), dtype=torch.float32),
                torch.tensor(rd.reshape(-1, 3), dtype=torch.float32))
    pose = np.eye(4, dtype=np.float32)
    c, s = np.cos(0.3), np.sin(0.3)
    pose[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    pose[:3, 3] = [0.4, -0.3, 0.2]
    w, h = 64, 32
    if kind == "pinhole":
        intr = np.array([[60.0, 0, 32], [0, 60.0, 16], [0, 0, 1]], np.float32)
        ro, rd = tt.pinhole_rays(pose, intr, w, h)
    else:   # r up to 2.55 rad: the outer tiles look backwards
        intr = np.array([[14.0, 0, 32], [0, 14.0, 16], [0, 0, 1]], np.float32)
        ro, rd = tt.fisheye_rays(pose, intr, w, h)
    order = tt.tile_order(w, h)
    return ro[order].contiguous(), rd[order].contiguous()


def _frame(rng, n, long_dir=None, d=None):
    """n rotations; with long_dir, column 0 is it and column 2 is d."""
    if long_dir is None:
        q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
        return q
    side = _unit(np.cross(d, long_dir))
    return np.stack([long_dir, side, np.cross(long_dir, side)], -1)


def _scales(rng, kind, n):
    if kind == "round":
        return np.repeat(rng.uniform(0.02, 0.3, (n, 1)), 3, 1)
    if kind == "flat":   # long axis, then a shorter one, 1e-4 across
        big = rng.uniform(0.02, 0.3, n)
        return np.stack([big, big * rng.uniform(0.3, 1.0, n),
                         np.full(n, 1e-4)], 1)
    if kind == "edge":   # flat, seen edge-on (the thin axis across the ray)
        big = rng.uniform(0.02, 0.3, n)
        return np.stack([big, np.full(n, 1e-4), big * 0.5], 1)
    if kind == "needle":
        return np.stack([rng.uniform(0.1, 0.5, n), np.full(n, 1e-3),
                         np.full(n, 2e-3)], 1)
    if kind == "tiny":
        return np.full((n, 3), 1e-6)
    return np.repeat(rng.uniform(5.0, 20.0, (n, 1)), 3, 1)   # huge


KINDS = ("round", "flat", "edge", "needle", "tiny", "huge")


def _opacities(rng, n):
    op = rng.uniform(0.02, 1.0, n)
    near_min = [MA32, np.nextafter(MA32, np.float32(0)),
                np.nextafter(MA32, np.float32(1))] + [
        np.float32(MA32 * (1 + k * 2.0 ** -22)) for k in range(1, 9)]
    fill = np.resize(near_min, min(n // 2, 3 * len(near_min)))
    op[: fill.size] = fill
    return rng.permutation(op).astype(np.float32)


def _scene(kind, degree, seed):
    """(g13, rays_o, rays_d): a cloud along the rays and the gaussians at
    the threshold of chosen rays."""
    rng = np.random.default_rng(seed)
    ro, rd = _rays(kind, rng)
    o, d = ro.double().numpy(), rd.double().numpy()
    n_rays = o.shape[0]
    parts = []
    # a cloud along random rays (some centred on the ray)
    n = 600
    pick = rng.integers(0, n_rays, n)
    t = rng.uniform(0.5, 5.0, n)
    off = rng.normal(size=(n, 3)) * 0.3
    off[::7] = 0.0
    mu = o[pick] + t[:, None] * d[pick] + off
    sc = np.concatenate([_scales(rng, k, n // len(KINDS)) for k in KINDS])
    parts.append((mu, _frame(rng, n), sc, _opacities(rng, n)))
    # at the threshold of each block's widest ray, farthest origin and two
    # others, off to the side away from the block's axis
    bundles = tt.ray_bundles(ro, rd, NEAR)
    cos = (rd * bundles["a"].repeat_interleave(128, 0)).sum(-1).reshape(
        -1, 128)
    far = (ro - bundles["c"].repeat_interleave(128, 0)).norm(dim=-1)
    rows = [cos.argmin(1), far.reshape(-1, 128).argmax(1),
            torch.tensor(rng.integers(0, 128, (2, cos.shape[0])))]
    base = torch.arange(cos.shape[0]) * 128
    chosen = torch.cat([(base + r).reshape(-1) for r in
                        [rows[0], rows[1], *rows[2]]]).numpy()
    chosen = chosen[chosen < n_rays]
    for kind_s in KINDS:
        m = chosen.size
        p = o[chosen] + rng.uniform(0.5, 4.0, m)[:, None] * d[chosen]
        axis = bundles["a"].double().numpy()[chosen // 128]
        out = p - o[chosen // 128 * 128]
        out = out - (out * axis).sum(-1, keepdims=True) * axis
        out = out + rng.normal(size=out.shape) * 1e-3
        out = _unit(out - (out * d[chosen]).sum(-1, keepdims=True)
                    * d[chosen])
        sc = _scales(rng, kind_s, m)
        op = _opacities(rng, m)
        rho = _rho(op, degree) * (1.0 + rng.uniform(-2e-6, 2e-6, m))
        mu = p + (sc[:, 0] * rho)[:, None] * out
        parts.append((mu, _frame(rng, m, out, d[chosen]), sc, op))
    g13 = _pack(*(np.concatenate(x) for x in zip(*parts)))
    return g13, ro, rd


def _world_distance(g13, ro, rd):
    """[R, N] float64 distance of each ray (t >= 0) to each mean."""
    v = g13[None, :, :3].double() - ro[:, None].double()
    d = rd[:, None].double()
    t = torch.clamp((v * d).sum(-1), min=0.0)
    return (v - t[..., None] * d).norm(dim=-1)


@pytest.mark.parametrize("kind", ["pinhole", "fisheye", "scattered"])
@pytest.mark.parametrize("degree", [1, 2, 4, 8])
def test_no_accepted_pair_is_culled(kind, degree):
    g13, ro, rd = _scene(kind, degree, seed=degree * 10 + len(kind))
    spheres = tt.cull_spheres(g13, ro, MIN_KERNEL, MIN_ALPHA, degree)
    bundles = tt.ray_bundles(ro, rd, NEAR)
    keep = tt.bundle_survivors(spheres, bundles)
    accept, _t = tt._pair_hits(g13, ro, rd, MIN_KERNEL, MIN_ALPHA, NEAR,
                               degree)
    block = torch.arange(ro.shape[0]) // tt.CULL_RAYS
    culled = accept & ~keep[block]
    assert int(culled.sum()) == 0, culled.nonzero()[:10]
    # the scene reaches the boundary: accepted pairs at the exact radius
    exact = tt.cull_spheres(g13, ro, MIN_KERNEL, MIN_ALPHA, degree,
                            exact=True)[:, 3].double()
    ratio = _world_distance(g13, ro, rd) / exact[None]
    assert float(ratio[accept].max()) > 0.999
    assert int(accept.sum()) > 1000
    # every block culls, and a fisheye block culls looking backwards
    assert bool(bundles["cull"].all())
    if kind == "fisheye":
        fwd = torch.tensor([np.sin(0.3), 0.0, np.cos(0.3)],
                           dtype=torch.float32)
        assert bool(((bundles["a"] @ fwd) < -0.2).any())
    if kind == "scattered":
        assert float(bundles["ro"].min()) > 0.2
    else:
        assert float(bundles["ro"].max()) == 0.0   # one camera
    # opacity at or below min_alpha: never accepted, radius -1
    dead = ~(g13[:, 12] > MA32)
    assert bool(dead.any()) and not bool(accept[:, dead].any())
    assert bool((spheres[dead, 3] == -1).all())
    assert not bool(keep[:, dead].any())


def test_the_cull_is_not_a_no_op():
    """Small particles filling a 128 x 64 pinhole view: each block keeps a
    few percent of them, and every accepted pair among those."""
    rng = np.random.default_rng(5)
    n = 1200
    z = rng.uniform(2.0, 4.0, n)
    mu = np.stack([rng.uniform(-0.32, 0.32, n) * z,
                   rng.uniform(-0.16, 0.16, n) * z, z], 1)
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    scales = rng.uniform(0.004, 0.015, (n, 3))
    scales[::4, 2] = 1e-4
    g13 = _pack(mu, q, scales, rng.uniform(0.05, 1.0, n))
    intr = np.array([[200.0, 0, 64], [0, 200.0, 32], [0, 0, 1]], np.float32)
    ro, rd = tt.pinhole_rays(np.eye(4, dtype=np.float32), intr, 128, 64)
    order = tt.tile_order(128, 64)
    ro, rd = ro[order].contiguous(), rd[order].contiguous()
    keep = tt.bundle_survivors(
        tt.cull_spheres(g13, ro, MIN_KERNEL, MIN_ALPHA, 2),
        tt.ray_bundles(ro, rd, NEAR))
    per_block = keep.sum(1).double()
    assert float(per_block.max()) < 0.1 * n
    assert float(per_block.mean()) > 0
    accept, _t = tt._pair_hits(g13, ro, rd, MIN_KERNEL, MIN_ALPHA, NEAR, 2)
    assert int(accept.sum()) > 0
    assert not bool((accept & ~keep[torch.arange(ro.shape[0]) // 128]).any())
    exact = tt.cull_spheres(g13, ro, MIN_KERNEL, MIN_ALPHA, 2, exact=True)
    met = tt.ray_sphere_pairs(exact, ro, rd, keep)
    assert int(accept.sum()) <= met <= int(per_block.sum()) * 128


def test_bundles_that_do_not_cull():
    """A non-finite ray, a zero direction or a cone wider than ~86 degrees
    turns the block's cull off: it keeps every live sphere."""
    rng = np.random.default_rng(3)
    rd = torch.tensor(_unit(rng.normal(size=(4 * 128, 3))),
                      dtype=torch.float32)
    rd[:128] = torch.tensor([0.0, 0.0, 1.0])
    rd[128:256] = rd[:128]
    rd[128 + 5] = float("nan")
    rd[256:384] = rd[:128]
    rd[256 + 7] = 0.0
    ro = torch.zeros(4 * 128, 3)
    bundles = tt.ray_bundles(ro, rd, NEAR)
    assert bundles["cull"].tolist() == [True, False, False, False]
    g13 = _pack(rng.normal(size=(50, 3)), _frame(rng, 50),
                np.full((50, 3), 0.1), np.linspace(0.0, 1.0, 50))
    keep = tt.bundle_survivors(tt.cull_spheres(g13, ro, MIN_KERNEL,
                                               MIN_ALPHA, 2), bundles)
    live = g13[:, 12] > MA32
    assert torch.equal(keep[1:], live[None].expand(3, -1))


def test_negative_near_turns_the_cull_off():
    """near < 0 accepts gaussians just behind the origin, which the forward
    cone cannot meet: no block culls then, and the forward cull of the same
    rays would drop some of those accepted pairs."""
    rng = np.random.default_rng(11)
    n = 600
    scales = rng.uniform(0.02, 0.3, (n, 3))
    scales[::5, 2] = 1e-4
    g13 = _pack(rng.uniform(-1, 1, (n, 3)), _frame(rng, n), scales,
                rng.uniform(0.05, 1.0, n))
    intr = np.array([[60.0, 0, 32], [0, 60.0, 16], [0, 0, 1]], np.float32)
    ro, rd = tt.pinhole_rays(np.eye(4, dtype=np.float32), intr, 64, 32)
    order = tt.tile_order(64, 32)
    ro, rd = ro[order].contiguous(), rd[order].contiguous()
    near = -5.0
    bundles = tt.ray_bundles(ro, rd, near)
    assert not bool(bundles["cull"].any())
    spheres = tt.cull_spheres(g13, ro, MIN_KERNEL, MIN_ALPHA, 2)
    keep = tt.bundle_survivors(spheres, bundles)
    accept, _t = tt._pair_hits(g13, ro, rd, MIN_KERNEL, MIN_ALPHA, near, 2)
    block = torch.arange(ro.shape[0]) // tt.CULL_RAYS
    assert not bool((accept & ~keep[block]).any())
    forward = tt.bundle_survivors(spheres, tt.ray_bundles(ro, rd, NEAR))
    assert bool((accept & ~forward[block]).any())


@pytest.mark.parametrize("camera", ["pinhole", "fisheye"])
def test_tiling_changes_nothing(camera):
    """trace_image selects on the rays in tile order and composites in
    pixel order: the same arrays as selecting row-major, bit for bit."""
    rng = np.random.default_rng(7)
    n, w, h = 150, 40, 24
    means = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    means[:, 2] += 3.0
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    scales = rng.uniform(0.05, 0.3, (n, 3)).astype(np.float32)
    opac = rng.uniform(0.1, 0.9, n).astype(np.float32)
    sh = (rng.normal(size=(n, 4, 3)) * 0.5).astype(np.float32)
    g = {"means": means, "quats": quats, "log_scales": np.log(scales),
         "opacity_logits": np.log(opac / (1 - opac)),
         "features_dc": sh[:, 0], "features_rest": sh[:, 1:]}
    intr = np.array([[30.0, 0, 20], [0, 30.0, 12], [0, 0, 1]], np.float32)
    pose = np.eye(4, dtype=np.float32)
    got = tt.trace_image(g, pose, intr, w, h, sh_degree=1, camera=camera,
                         chunk=256, max_hits=24, device="cpu")

    order = tt.tile_order(w, h)
    assert torch.equal(torch.sort(order).values, torch.arange(w * h))
    first = order[:128]      # one 16 x 8 tile: a block's rays
    assert int((first // w).max() - (first // w).min()) == 7
    assert int((first % w).max() - (first % w).min()) == 15

    rays = tt.pinhole_rays if camera == "pinhole" else tt.fisheye_rays
    ro, rd = rays(pose, intr, w, h)
    t = {k: torch.tensor(g[k]) for k in g}
    q = t["quats"] / torch.linalg.vector_norm(t["quats"], dim=-1,
                                              keepdim=True)
    sc, op = torch.exp(t["log_scales"]), torch.sigmoid(t["opacity_logits"])
    shc = torch.cat([t["features_dc"][:, None], t["features_rest"]], 1)
    idx, cnt = tt.select_hits(tt.pack_gaussians(t["means"], q, sc, op), ro,
                              rd, 24, MIN_KERNEL, MIN_ALPHA, NEAR)
    want = {"rgb": [], "depth": [], "alpha": []}
    for c0 in range(0, w * h, 256):
        sl = slice(c0, c0 + 256)
        o = tt.composite_hits(t["means"], q, sc, op, shc, ro[sl], rd[sl],
                              idx[sl], cnt[sl], 1)
        for key in want:
            want[key].append(o[key].numpy())
    for key in want:
        ref = np.concatenate(want[key]).reshape(got[key].shape)
        np.testing.assert_array_equal(got[key], ref, err_msg=key)
    assert got["alpha"].max() > 0.5
