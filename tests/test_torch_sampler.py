"""The port's error-bound sampler and probe grid
(holoscene_tpu_torch/ops/{sampler,probe_grid}.py) against the JAX package's
on the CPU, on an analytic SDF written in both frameworks, with the JAX
draws handed to the port (tests/torch_stage1_cases.py::sampler_draws).

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


@pytest.mark.parametrize("beta0", [0.01, 2.0])
@pytest.mark.parametrize("training", [True, False])
def test_error_bound_sample_matches_jax(training, beta0):
    """Placements, the refined probe buffer and per-ray beta, and
    estimate_weights_from_buffer on them. beta0 = 2.0: every ray has
    converged, so the upsampling rounds are skipped on both sides."""
    jc, tc = js.SamplerConfig(**CFG), ts.SamplerConfig(**CFG)
    o, d = _rays()
    key = jax.random.PRNGKey(3)
    z, z_eik, (zb, sb, beta) = js.error_bound_sample(
        key, jnp.asarray(o), jnp.asarray(d), _sdf_j, jnp.float32(beta0), jc,
        training=training, return_aux=True)
    draws = sampler_draws(key, jc, o.shape[0]) if training else None
    tz, tz_eik, (tzb, tsb, tbeta) = ts.error_bound_sample(
        torch.tensor(o), torch.tensor(d), _sdf_t, torch.tensor(beta0), tc,
        draws, training=training, return_aux=True)
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
