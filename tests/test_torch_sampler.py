"""The port's error-bound sampler and probe grid
(holoscene_tpu_torch/ops/{sampler,probe_grid}.py), its sign-change surface
search and its stratified uniform sampler against the JAX package's on the
CPU, on an analytic SDF written in both frameworks, with the JAX draws
handed to the port (tests/torch_stage1_cases.py::sampler_draws).

Tolerances. beta atol 1e-5. Samples and the probe buffer: 90% within atol
1e-5 and every one within 5e-3 (a fifth of a buffer section). The
reason: alpha = 1 - exp(-free energy) at free energies ~1e-7 is quantised
to float32 steps of 6e-8, and the two frameworks' exp differ in the last
bit; on a ray whose weights are all ~0 the padded PDF's normaliser then
differs by ~1e-4 relative, and its inverse-CDF samples move by ~1e-4 of
the ray (the port keeps JAX's 1 - exp). Weights from the buffer at the
JAX samples atol 1e-5; probe tables and proxy SDFs atol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401
from torch_stage1_cases import sampler_draws

from holoscene_tpu.ops import probe_grid as jpg
from holoscene_tpu.ops import sampler as js
from holoscene_tpu_torch.ops import probe_grid as tpg
from holoscene_tpu_torch.ops import sampler as ts

ATOL = 1e-5
SECTION_ATOL = 5e-3
CENTER, RADIUS = (0.1, -0.05, 0.2), 0.45


def _sdf_j(p):
    return jnp.linalg.norm(p - jnp.asarray(CENTER), axis=-1) - RADIUS


def _sdf_t(p):
    return torch.linalg.norm(p - torch.tensor(CENTER), dim=-1) - RADIUS


def _rays(n=24, seed=0):
    rng = np.random.default_rng(seed)
    o = np.tile(np.array([[0.0, 0.1, -0.8]], np.float32), (n, 1))
    d = rng.normal(size=(n, 3)).astype(np.float32) * 0.3
    d[:, 2] = 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


CFG = dict(N_samples=16, N_samples_eval=32, N_samples_extra=8,
           max_total_iters=4, beta_iters=6)


def _near_far(o, bounded):
    """None, or per-ray (near, far) [R, 1] inside the scene cube."""
    if not bounded:
        return None, None
    rng = np.random.default_rng(7)
    near = rng.uniform(0.05, 0.2, (o.shape[0], 1)).astype(np.float32)
    return near, near + rng.uniform(0.9, 1.4, near.shape).astype(np.float32)


@pytest.mark.parametrize("beta0", [0.01, 2.0])
@pytest.mark.parametrize("training", [True, False])
def test_error_bound_sample_matches_jax(training, beta0):
    """Placements, the refined probe buffer and per-ray beta, and
    estimate_weights_from_buffer on them. beta0 = 2.0: every ray has
    converged, so the upsampling rounds are skipped on both sides."""
    _check_error_bound_sample(training, beta0, bounded=False)


@pytest.mark.parametrize("beta0", [0.01, 2.0])
@pytest.mark.parametrize("training", [True, False])
def test_error_bound_sample_with_near_far_matches_jax(training, beta0):
    """As above with the caller's per-ray near / far instead of the scene
    cube's (render_rays_multi_obj passes them)."""
    _check_error_bound_sample(training, beta0, bounded=True)


def _check_error_bound_sample(training, beta0, bounded):
    jc, tc = js.SamplerConfig(**CFG), ts.SamplerConfig(**CFG)
    o, d = _rays()
    near, far = _near_far(o, bounded)
    key = jax.random.PRNGKey(3)
    z, z_eik, (zb, sb, beta) = js.error_bound_sample(
        key, jnp.asarray(o), jnp.asarray(d), _sdf_j, jnp.float32(beta0), jc,
        training=training, return_aux=True,
        near=None if near is None else jnp.asarray(near),
        far=None if far is None else jnp.asarray(far))
    draws = sampler_draws(key, jc, o.shape[0]) if training else None
    tz, tz_eik, (tzb, tsb, tbeta) = ts.error_bound_sample(
        torch.tensor(o), torch.tensor(d), _sdf_t, torch.tensor(beta0), tc,
        draws, training=training, return_aux=True,
        near=None if near is None else torch.tensor(near),
        far=None if far is None else torch.tensor(far))
    np.testing.assert_allclose(tbeta.numpy(), np.asarray(beta), atol=ATOL)
    pairs = [(z, tz), (zb, tzb), (sb, tsb)] + ([(z_eik, tz_eik)]
                                              if training else [])
    for r, g in pairs:
        err = np.abs(g.numpy() - np.asarray(r))
        assert (err > ATOL).mean() <= 0.1 and err.max() <= SECTION_ATOL, (
            (err > ATOL).mean(), err.max())
    assert tz.shape == (o.shape[0], tc.n_final)
    assert bool((tz[:, 1:] >= tz[:, :-1]).all())
    w = js.estimate_weights_from_buffer(z, zb, sb, beta)
    tw = ts.estimate_weights_from_buffer(torch.tensor(np.asarray(z)), tzb,
                                         tsb, tbeta)
    np.testing.assert_allclose(tw.numpy(), np.asarray(w), atol=ATOL)


def test_merge_and_searchsorted_tie_rules():
    """_merge_sorted keeps a before b on ties; _sample_pdf searches right."""
    za = np.array([[0.0, 1.0, 2.0, 2.0, 3.0]], np.float32)
    zb = np.array([[1.0, 2.0, 2.5]], np.float32)
    sa, sb_ = za * 10, zb * 10 + 1
    ref = js._merge_sorted(*(jnp.asarray(a) for a in (za, sa, zb, sb_)))
    got = ts._merge_sorted(*(torch.tensor(a) for a in (za, sa, zb, sb_)))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    cdf = np.array([[0.0, 0.25, 0.25, 0.5, 1.0]], np.float32)
    u = np.array([[0.0, 0.25, 0.3, 0.5, 0.99]], np.float32)
    np.testing.assert_allclose(
        ts._sample_pdf(torch.tensor(za), torch.tensor(cdf),
                       torch.tensor(u)).numpy(),
        np.asarray(js._sample_pdf(jnp.asarray(za), jnp.asarray(cdf),
                                  jnp.asarray(u))), atol=1e-7)


def test_probe_grid_bake_and_lookup_match_jax():
    res, bound = 12, 1.0
    ref = jpg.bake_probe_grid(_sdf_j, res, bound, chunk=500)
    got = tpg.bake_probe_grid(_sdf_t, res, bound, chunk=500)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    pts = np.random.default_rng(1).uniform(-1.3, 1.3, (400, 3)).astype(
        np.float32)
    r = jpg.probe_sdf_fn(ref, res, bound)(jnp.asarray(pts))
    g = tpg.probe_sdf_fn(got, res, bound)(torch.tensor(pts))
    np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)


@pytest.mark.parametrize("bounded", [False, True])
def test_ray_marching_surface_matches_jax(bounded):
    """Depths and hits of the sign-change search with secant refinement on
    the analytic sphere, rays that hit and rays that miss, with the cube's
    bounds or the caller's near / far: hits equal, depths atol 1e-5 (the
    secant divides by SDF differences the two norms round differently)."""
    jc, tc = js.SamplerConfig(**CFG), ts.SamplerConfig(**CFG)
    o, d = _rays(40, seed=3)
    d[:8] = [0.0, 0.0, -1.0]                     # away from the sphere
    near, far = _near_far(o, bounded)
    jd, jh = js.ray_marching_surface(
        jax.random.PRNGKey(0), jnp.asarray(o), jnp.asarray(d), _sdf_j, jc,
        n_steps=64, near=None if near is None else jnp.asarray(near),
        far=None if far is None else jnp.asarray(far))
    td, th = ts.ray_marching_surface(
        torch.tensor(o), torch.tensor(d), _sdf_t, tc, n_steps=64,
        near=None if near is None else torch.tensor(near),
        far=None if far is None else torch.tensor(far))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL)
    assert 0 < th.sum() < len(th)
    hit = th.numpy()
    pts = o[hit] + td.numpy()[hit] * d[hit]
    np.testing.assert_allclose(np.linalg.norm(pts - CENTER, axis=-1),
                               RADIUS, atol=1e-4)


@pytest.mark.parametrize("training", [True, False])
def test_uniform_sample_matches_jax(training):
    """Stratified samples from JAX's uniforms (training) or the bin edges
    (eval), per-ray near / far: atol 1e-6; each training sample lies in
    its stratum."""
    o, d = _rays(30, seed=5)
    near, far = _near_far(o, True)
    key = jax.random.PRNGKey(11)
    ref = np.asarray(js.uniform_sample(key, jnp.asarray(o), jnp.asarray(d),
                                       16, jnp.asarray(near),
                                       jnp.asarray(far), training=training))
    t_rand = (torch.tensor(np.asarray(jax.random.uniform(key, (30, 16))))
              if training else None)
    got = ts.uniform_sample(torch.tensor(near), torch.tensor(far), 16,
                            t_rand).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    edges = near + (far - near) * np.linspace(0, 1, 16, dtype=np.float32)
    if training:
        mids = 0.5 * (edges[:, 1:] + edges[:, :-1])
        lo = np.concatenate([edges[:, :1], mids], -1)
        hi = np.concatenate([mids, edges[:, -1:]], -1)
        assert ((got >= lo - 1e-6) & (got <= hi + 1e-6)).all()
    else:
        np.testing.assert_allclose(got, edges, atol=1e-6)
