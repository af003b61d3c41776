"""Shared inputs of the Stage-2 port's parity tests: the tiny Stage-1
configuration of tests/torch_stage1_cases.py in the vjp gradient mode (the
post confs' route: untiered, H1 exact), a generated view and collision
points from numpy, each finetune step's draws made with jax.random in the
order JAX's step splits its key, and small meshes."""

from __future__ import annotations

import jax
import numpy as np
import torch
from torch_stage1_cases import R, _t, cfgs, sampler_draws

from holoscene_tpu_torch.models import holoscene as ths
from holoscene_tpu_torch.stage2.refine import FinetuneDraws

M = 12        # invisible-view pixels of the tiny step
P = 20        # collision points


def vjp_cfgs():
    """(JAX, port) HoloSceneConfig of the tiny width in the vjp mode."""
    return cfgs("exact", False, "vjp")


def gen_view(seed: int = 0, n: int = M) -> dict:
    """A generated view's sampled pixels (numpy): an orthographic camera
    looking along +z from z = -0.6, random targets and masks."""
    rng = np.random.default_rng(seed)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.05, 0.0, -0.6]

    def mask(p):
        return (rng.uniform(size=n) > p).astype(np.float32)

    return {
        "pose": pose, "half_extent": np.float32(0.6),
        "rgb": rng.uniform(0, 1, (n, 3)).astype(np.float32),
        "normal": rng.normal(size=(n, 3)).astype(np.float32),
        "mask": mask(0.3), "nm_mask": mask(0.3), "inp_mask": mask(0.5),
        "depth": rng.uniform(0.5, 1.5, n).astype(np.float32),
        "depth_mask": mask(0.3),
        "uv": rng.uniform(-1, 1, (n, 2)).astype(np.float32),
        "mask_boost": np.float32(25.0),
    }


def collision(seed: int = 1, n: int = P):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32),
            rng.uniform(-0.2, 0.2, n).astype(np.float32))


def finetune_draws(key, jc, n_rays: int = R, n_invis: int = M,
                   use_invis: bool = True) -> FinetuneDraws:
    """The draws of JAX make_object_finetune_step's step(key): k1 the ray
    jitter, k2 render_rays' (sampler, eikonal, neighbour), k3 the
    invisible render's sampler."""
    k1, k2, k3 = jax.random.split(key, 3)
    k_sampler, k_eik, k_nei = jax.random.split(k2, 3)
    sbs = jc.scene_bounding_sphere
    render = ths.RenderDraws(
        sampler_draws(k_sampler, jc.sampler, n_rays),
        _t(jax.random.uniform(k_eik, (n_rays, 3), minval=-sbs, maxval=sbs)),
        _t(jax.random.uniform(k_nei, (2 * n_rays, 3))), [None])
    return FinetuneDraws(
        _t(jax.random.uniform(k1, (n_rays, 2)) - 0.5), render,
        sampler_draws(k3, jc.sampler, n_invis) if use_invis else None)


def to_torch(d: dict) -> dict:
    return {k: torch.tensor(np.asarray(v)) for k, v in d.items()}


def box(center, half):
    """An axis-aligned box mesh (12 faces, outward winding) as (vertices,
    faces) numpy arrays."""
    c, h = np.asarray(center, float), np.asarray(half, float)
    sgn = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                    for sz in (-1, 1)])
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5],
                  [0, 5, 1], [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4],
                  [1, 5, 7], [1, 7, 3]])
    return c + sgn * h, f
