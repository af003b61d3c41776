"""HoloScene on PyTorch and CUDA: the port of `holoscene_tpu` to one NVIDIA
H100 (Hopper, sm_90a).

The JAX package `holoscene_tpu/` stays the reference; every module here keeps
its counterpart's path and names (`holoscene_tpu_torch/ops/splat_flat.py` <->
`holoscene_tpu/ops/splat_flat.py`) and is parity-tested against it on the CPU
(tests/test_torch_*.py). This package imports torch, never jax, and nothing
of `holoscene_tpu`: it keeps its own copy of the host-side modules it needs
(config, datasets, utils/{mesh,mc,eval_rgb}, export/gs_usdz; numpy / PIL /
scipy only).

Layer map (the Stage-1 neural-SDF slice, the Stage-4 Gaussian-on-Mesh
slice and the free-Gaussian / ray-tracing stack):
  ops/        Stage 1: rays, positional encoding, Laplace density, volume
              rendering, the hash grid with the H1 / H2 kernels (hashgrid),
              the error-bound sampler, the baked probe grid and the
              occupancy grid; the physics dense grid (phygrid).
              Stage 4: projection + SH (gaussians), SSIM, flat tile binning
              and the K1/K2 tile-walk kernels (splat_flat), the K3/K4 top-K
              walks (splat_topk), the renderer entry with per-tile
              selection and the image epilogue (splat), the mesh
              mask/depth rasterizer; the unscented-transform camera
              projection (gaussians), the gaussian ray tracer with its
              T1 hit-selection kernel (gs_trace)
  csrc/       hand-written CUDA for sm_90a (built by kernels.py on first use)
  models/     the SDF and rendering networks (fields), the Stage-1 renderer
              (holoscene), camera-pose refinement (cam_opt);
              Gaussian-on-Mesh seeding, reparameterisations,
              render, loss (gom) and its fixed-capacity densification
              (gom_adaptive); free gaussians with splatfacto / MCMC and
              SelectiveAdam (gaussians_free)
  losses/     the Stage-1 loss stack
  stage0/     monocular depth / normal priors (TorchScript providers, CLI)
  stage2/     per-object refinement (Stage2Runner and its parts), the
              generative-model providers, the mv_predict CLI
  physics/    the stability and settle providers of Stage 2
  training/   Stage1Runner and its exp_runner CLI; Stage3Runner (colour
              field, UV bake) and its exp_runner_texture CLI;
              Stage4Runner, the exp_runner_gaussian CLI, the gs_render
              CLI (raster and trace); GSTrainer and the gs_train CLI;
              checkpoints (the port's .pth and the JAX package's msgpack)
  datasets/   the synthetic scene with analytic meshes and packs, loaders
  utils/      mesh I/O, marching tetrahedra, the chart UV atlas, PSNR/SSIM
              (host, numpy), LPIPS (lpips), the JSONL metrics log
  parallel/   the (data, model) grid of ranks over torch.distributed and
              the Stage-1 sharding policy (mesh), the data-parallel
              Stage-4 step (stage4_dp)
  export/     gaussian USDZ / INGP / PLY, GLB, USD with PhysX schemas, the
              export CLI and its read-back (load_scene)
  viewer.py   the orbit viewer (HTTP server; gaussians or meshes)
  config.py   HOCON-subset config parser
  convert.py  JAX params/static (as numpy) <-> torch tensors (Stage 4's,
              Stage 1's, the free-Gaussian trainer's); the flax msgpack
              reader
"""

from __future__ import annotations

import numpy as np
import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device) -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and absent.

    There is no silent CPU fallback: a run that asked for the card and got
    the CPU would report CPU numbers under a device's name."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    return dev


def as_tensor(x, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """numpy / python / tensor -> tensor of `dtype` on `device` (a copy for
    host input, so read-only numpy buffers are never aliased)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)
