"""The hand-written CUDA kernels K1/K2 (holoscene_tpu_torch/csrc) against
their plain PyTorch versions, on the card. CUDA kernels have no CPU mode, so
every test here needs an NVIDIA GPU with nvcc and skips without one; run
them on the card with

    python -m pytest tests/test_torch_cuda_kernels.py -q
"""

import numpy as np
import pytest
import torch

from holoscene_tpu_torch.ops import gaussians as tg
from holoscene_tpu_torch.ops import splat_flat as tflat

pytestmark = pytest.mark.cuda

FWD_ATOL = 2e-4
BWD_ATOL, BWD_RTOL = 5e-4, 5e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _projected(n, res, seed, wall=False):
    """Projected gaussians (CPU tensors) of a random scene; wall=True puts
    an opaque layer in front so tiles saturate."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(1.0, 1.1, n) if wall else rng.uniform(1.2, 3.0, n)
    means = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.6, 0.6, n),
                      z], -1)
    q = rng.normal(size=(n, 4))
    scales = rng.uniform(0.02, 0.12 if wall else 0.08, (n, 3))
    f = res * 0.8
    intr = torch.tensor([[f, 0, res / 2], [0, f, res / 2], [0, 0, 1.0]])
    xy, depth, conic, _, valid = tg.project_gaussians_fused(
        *(torch.as_tensor(x, dtype=torch.float32) for x in (means, q, scales)),
        torch.eye(4), intr, res, res)
    opac = torch.as_tensor(rng.uniform(0.9 if wall else 0.2, 0.97, n),
                           dtype=torch.float32)
    rgb = torch.as_tensor(rng.uniform(0, 1, (n, 3)), dtype=torch.float32)
    return xy, depth, conic, opac, valid, rgb


def _walk_inputs(xy, depth, conic, opac, valid, rgb, res):
    tiles = -(-res // 16)
    plan = tflat.plan_flat(xy, conic, opac, valid, tiles, tiles, 16)
    bins = tflat.build_flat_bins(xy, depth, conic, opac, valid, tiles_x=tiles,
                                 tiles_y=tiles, tile_size=16, plan=plan)
    n = xy.shape[0]
    pay = torch.cat([xy, conic, opac[:, None], rgb, depth[:, None],
                     torch.ones(n, 1), torch.zeros(n, 5)], -1)
    pay = torch.cat([pay, torch.zeros(1, 16)], 0)
    return (pay[bins["gidx"]].contiguous(), bins["tile_chunk_start"],
            bins["tile_chunk_cnt"], tiles)


@pytest.mark.parametrize("case", ["random64", "random40", "saturated"])
def test_kernels_match_plain(cuda, case):
    res, n, seed, wall = {"random64": (64, 800, 0, False),
                          "random40": (40, 400, 1, False),
                          "saturated": (48, 900, 2, True)}[case]
    cand, cs, cc, tiles = _walk_inputs(*_projected(n, res, seed, wall), res)
    ref = tflat.flat_fwd(cand, cs, cc, tiles, 16, res, res)
    n_fwd = tflat.flat_fwd.launches
    out = tflat.flat_fwd(cand.to(cuda), cs.to(cuda), cc.to(cuda), tiles, 16,
                         res, res)
    torch.cuda.synchronize()
    assert tflat.flat_fwd.launches == n_fwd + 1
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), atol=FWD_ATOL)
    if wall:
        assert (ref[:, 0, 5] < cc).any()

    v = torch.as_tensor(np.random.default_rng(seed).normal(size=ref.shape),
                        dtype=torch.float32)
    v[..., 5:] = 0.0
    dref = tflat.flat_bwd(cand, cs, ref, v, tiles, 16, res, res)
    n_bwd = tflat.flat_bwd.launches
    dker = tflat.flat_bwd(cand.to(cuda), cs.to(cuda), ref.to(cuda),
                          v.to(cuda), tiles, 16, res, res)
    torch.cuda.synchronize()
    assert tflat.flat_bwd.launches == n_bwd + 1
    np.testing.assert_allclose(dker.cpu().numpy(), dref.numpy(),
                               atol=BWD_ATOL, rtol=BWD_RTOL)


def test_composite_autograd_on_card_matches_cpu(cuda):
    res = 48
    args = _projected(500, res, 5)
    tiles = -(-res // 16)
    plan = tflat.plan_flat(args[0], args[2], args[3], args[4], tiles, tiles,
                           16)
    grads = []
    for dev in ("cpu", cuda):
        xs = [a.detach().to(dev, copy=True).requires_grad_(
            a.is_floating_point()) for a in args]
        r, d, a, _ = tflat.composite_tiles_flat(
            xs[0], xs[1], xs[2], xs[3], xs[5], xs[4], res, res, 16, plan)
        (r.square().mean() + a.mean() + 0.01 * d.mean()).backward()
        grads.append([x.grad.cpu().numpy() for x in xs if x.requires_grad])
    for gc, gk in zip(*grads):
        np.testing.assert_allclose(gk, gc, atol=BWD_ATOL, rtol=BWD_RTOL)
