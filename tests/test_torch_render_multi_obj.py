"""The port's object-subset render inside the scene
(holoscene_tpu_torch/models/holoscene.py::render_rays_multi_obj) and the
field's colours at surface points (query_point_colors) against the JAX
package's on the CPU, from identical parameters (the tiny vjp
configuration of tests/torch_stage2_cases.py) and JAX's sampler draws.

Tolerances, those of the Stage-2 render test
(tests/test_torch_stage2_refine.py): outputs within 1e-5 absolute + 1e-4
relative; the gradient of a random functional of the outputs, per
parameter tensor, within 1e-3 of its largest |JAX| value. The normal map
within 1e-4 absolute: with the caller's near / far the two samplers place
a sample up to 1.8e-6 apart (inside the sampler's stated margin,
tests/test_torch_sampler.py), and the random hash tables turn the unit
normal fast where the SDF gradient is short (|grad| 0.10 at the worst
sample, 4e-5 on the composited normal)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401
from torch_stage1_cases import R, jax_params, port_model, sampler_draws
from torch_stage2_cases import gen_view, vjp_cfgs

from holoscene_tpu.models import holoscene as jhs
from holoscene_tpu_torch.convert import stage1_params_from_jax
from holoscene_tpu_torch.models import holoscene as ths

OUT_ATOL, OUT_RTOL = 1e-5, 1e-4
NORMAL_ATOL = 1e-4
PARAM_REL = 1e-3
KEYS = ("rgb_values", "semantic_values", "object_opacity", "depth_values",
        "normal_map", "weights", "bg_weights", "subset_weight_sum", "z_vals",
        "sdf")
CASES = ((True, False), (False, False), (False, True))   # training, bounded


def _rays():
    """An orthographic camera's rays through the scene (numpy), its w2c
    rotation, and per-ray near / far."""
    gv = gen_view(seed=6, n=R)
    pose = gv["pose"]
    o = pose[:3, 3][None] + gv["uv"][:, :1] * 0.6 * pose[:3, 0][None] \
        + gv["uv"][:, 1:] * 0.6 * pose[:3, 1][None]
    d = np.broadcast_to(pose[:3, 2][None], o.shape).copy()
    near = np.full((R, 1), 0.2, np.float32)
    return o.astype(np.float32), d, pose[:3, :3].T.copy(), near, near + 1.1


def _grad_cmp(model, jgrads):
    ref = stage1_params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    for k, p in model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        err = float((g - ref[k]).abs().max())
        assert err <= PARAM_REL * float(ref[k].abs().max()) + 1e-9, (k, err)


@functools.lru_cache(maxsize=1)
def _jax_multi_obj():
    """JAX's render_rays_multi_obj of objects (1, 2) in every case of
    CASES, the training case with the gradient of a random functional of
    its outputs."""
    jc, _ = vjp_cfgs()
    params = jax_params(jc)
    o, d, w2c, near, far = _rays()
    key = jax.random.PRNGKey(12)
    rng = np.random.default_rng(3)
    coef = {"rgb_values": (R, 3), "semantic_values": (R, 3),
            "object_opacity": (R, 3), "depth_values": (R, 1),
            "normal_map": (R, 3), "subset_weight_sum": (R,)}
    coef = {k: rng.normal(size=s).astype(np.float32) for k, s in coef.items()}

    def fun(p, training, bounded):
        out = jhs.render_rays_multi_obj(
            p, jc, key, jnp.asarray(o), jnp.asarray(d), jnp.ones((R, 1)),
            jnp.asarray(w2c), (1, 2), training=training,
            near=jnp.asarray(near) if bounded else None,
            far=jnp.asarray(far) if bounded else None)
        return sum(jnp.sum(out[k] * c) for k, c in coef.items()), out

    @jax.jit
    def all_cases(p):
        return {case: jax.value_and_grad(fun, has_aux=True)(p, *case)
                if case[0] else (fun(p, *case), None) for case in CASES}

    res = {case: (out, g) for case, ((_, out), g)
           in all_cases(params).items()}
    return key, coef, res


@pytest.mark.parametrize("training,bounded", CASES)
def test_render_rays_multi_obj_matches_jax(training, bounded):
    """Objects (1, 2) inside the scene: every output; training (with
    JAX's sampler draws) also every parameter gradient of a random
    functional of them (an eval render, as the port's other eval renders,
    builds no graph of the normals' gradients); bounded: the caller's near
    / far."""
    jc, tc = vjp_cfgs()
    model = port_model(tc, jax_params(jc))
    o, d, w2c, near, far = _rays()
    key, coef, res = _jax_multi_obj()
    jout, jgrads = res[(training, bounded)]
    draws = sampler_draws(key, jc.sampler, R) if training else None
    out = ths.render_rays_multi_obj(
        model, torch.tensor(o), torch.tensor(d), torch.ones(R, 1),
        torch.tensor(w2c), (1, 2), draws, training=training,
        near=torch.tensor(near) if bounded else None,
        far=torch.tensor(far) if bounded else None)
    assert set(out) == set(KEYS) == set(jout)
    for k in KEYS:
        np.testing.assert_allclose(
            out[k].detach().numpy(), np.asarray(jout[k]),
            atol=NORMAL_ATOL if k == "normal_map" else OUT_ATOL,
            rtol=OUT_RTOL, err_msg=k)
    if bounded:
        z = out["z_vals"].detach().numpy()
        assert (z[:, 2:-2] >= near - 1e-6).all()
    if not training:
        return
    sum((out[k] * torch.tensor(c)).sum() for k, c in coef.items()).backward()
    _grad_cmp(model, jgrads)


def test_query_point_colors_matches_jax():
    """Colours and unit normals at points along view directions, and the
    gradient of a random functional of both."""
    jc, tc = vjp_cfgs()
    params = jax_params(jc)
    model = port_model(tc, params)
    rng = np.random.default_rng(4)
    x = rng.uniform(-0.8, 0.8, (70, 3)).astype(np.float32)
    v = rng.normal(size=(70, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    c_rgb, c_n = (rng.normal(size=(70, 3)).astype(np.float32)
                  for _ in range(2))

    def fun(p):
        rgb, n = jhs.query_point_colors(p, jc, jnp.asarray(x), jnp.asarray(v))
        return jnp.sum(rgb * c_rgb) + jnp.sum(n * c_n), (rgb, n)

    (_, (jrgb, jn)), jgrads = jax.value_and_grad(fun, has_aux=True)(params)
    rgb, n = ths.query_point_colors(model, torch.tensor(x), torch.tensor(v))
    for got, ref in ((rgb, jrgb), (n, jn)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   atol=OUT_ATOL, rtol=OUT_RTOL)
    np.testing.assert_allclose(np.linalg.norm(n.detach().numpy(), axis=-1),
                               1.0, atol=1e-5)
    ((rgb * torch.tensor(c_rgb)).sum() + (n * torch.tensor(c_n)).sum()
     ).backward()
    _grad_cmp(model, jgrads)
