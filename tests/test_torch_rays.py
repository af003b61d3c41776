"""The port's camera rays (holoscene_tpu_torch/ops/rays.py) against the JAX
package's on the CPU: the orthographic rays of Stage 2's object views and
the ray-sphere intersections (hits, a grazing ray and misses), on the same
numpy inputs. Tolerance: atol 1e-6 (the same float32 operations)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401

from holoscene_tpu.ops import rays as jrays
from holoscene_tpu_torch.ops import rays as trays

ATOL = 1e-6


def _pose(seed):
    """A random rotation (c2w columns) and camera centre."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = q * np.sign(np.linalg.det(q))
    pose[:3, 3] = rng.uniform(-1.5, 1.5, 3)
    return pose


@pytest.mark.parametrize("half_extent", [0.35, 1.7])
def test_orthographic_rays_match_jax(half_extent):
    rng = np.random.default_rng(1)
    uv = rng.uniform(-1, 1, (200, 2)).astype(np.float32)
    pose = _pose(2)
    jo, jd = jrays.get_orthographic_rays(jnp.asarray(uv), jnp.asarray(pose),
                                         half_extent)
    to, td = trays.get_orthographic_rays(torch.tensor(uv), torch.tensor(pose),
                                         half_extent)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL)
    # origins on the image plane: the camera axis sees them at depth 0
    np.testing.assert_allclose((to.numpy() - pose[:3, 3]) @ pose[:3, 2], 0,
                               atol=1e-5)


def test_orthographic_rays_take_a_tensor_half_extent():
    """Stage 2's invisible-view step passes the half extent as a tensor."""
    uv = torch.tensor([[1.0, -1.0], [0.0, 0.5]])
    pose = torch.tensor(_pose(3))
    a, _ = trays.get_orthographic_rays(uv, pose, 0.8)
    b, _ = trays.get_orthographic_rays(uv, pose, torch.tensor(0.8))
    assert torch.equal(a, b)


@pytest.mark.parametrize("r", [0.5, 1.0, 3.0])
def test_sphere_intersections_match_jax(r):
    rng = np.random.default_rng(4)
    cam = np.array([0.2, -1.9, 0.7], np.float32)
    d = rng.normal(size=(300, 3)).astype(np.float32)
    d[:100] = -cam + rng.normal(scale=0.2, size=(100, 3))   # towards centre
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ref = np.asarray(jrays.get_sphere_intersections(
        jnp.asarray(cam), jnp.asarray(d), r))
    got = trays.get_sphere_intersections(torch.tensor(cam), torch.tensor(d),
                                         r).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=1e-6)
    assert got.shape == (300, 2) and (got >= 0).all()
    hit = got[:, 1] > got[:, 0]
    if r > np.linalg.norm(cam):      # the camera inside: every ray exits
        assert hit.all() and (got[:, 0] == 0).all()
    else:
        assert hit[:100].any() and (~hit).any()
