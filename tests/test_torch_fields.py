"""The port's Stage-1 fields (holoscene_tpu_torch/models/fields.py) against
the JAX package's on the CPU, from the same parameters (convert.py):
implicit_get_outputs_fused (sdf, feature vectors, scene-SDF gradients,
semantic, raw SDFs; all levels and coarse_levels), the vjp mode
implicit_get_outputs (also at x01 = 1, where JAX's packed encode wraps
the dense index and H1 clamps the cell), implicit_forward /
implicit_sdf_raw, the scene / object / multi-object SDF wrappers,
implicit_all_gradients, the rendering network, and the backward of each
with respect to every parameter, second order through the hash grid
included; and hash_encode_world (the packed encode of world points, H2's
plain version) with its table gradient.

Tolerances: outputs atol 1e-5 + rtol 1e-5 (float32 sums in another order);
parameter gradients per tensor max |port - JAX| <= 1e-4 max |JAX| (the
same, through the second-order path of softplus-100)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401
from torch_stage1_cases import cfgs, implicit_cfgs, jax_params

from holoscene_tpu.models import fields as jf
from holoscene_tpu.ops import hashgrid as jhash
from holoscene_tpu.ops.hashgrid import build_dense_block_tables
from holoscene_tpu_torch.convert import stage1_params_from_jax
from holoscene_tpu_torch.models import fields as tf
from holoscene_tpu_torch.ops import hashgrid as thash

OUT_ATOL = OUT_RTOL = 1e-5
GRAD_REL = 1e-4


def _implicit(seed=1):
    jc, tc = cfgs("exact")
    params = jax_params(jc, seed)["implicit"]
    net = tf.ImplicitNetwork(tc.implicit)
    net.load_state_dict(stage1_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jc.implicit, params, net


def _points(n, seed=0):
    return np.random.default_rng(seed).uniform(
        -0.98, 0.98, (n, 3)).astype(np.float32)


def _check_grads(jgrads, net):
    ref = stage1_params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    names = dict(net.named_parameters())
    assert set(ref) == set(names)
    for k, r in ref.items():
        g = names[k].grad
        assert g is not None, k
        scale = float(r.abs().max())
        assert scale > 0, k
        err = float((g - r).abs().max())
        assert err <= GRAD_REL * scale, (k, err, scale)


@pytest.mark.parametrize("coarse", [None, 3])
def test_get_outputs_fused_and_its_backward_match_jax(coarse):
    jic, params, net = _implicit()
    x = _points(97)
    ref = jf.implicit_get_outputs_fused(params, jic, jnp.asarray(x),
                                        coarse_levels=coarse)
    got = tf.implicit_get_outputs_fused(net, torch.tensor(x),
                                        coarse_levels=coarse)
    for name, r, g in zip(("sdf", "features", "gradients", "semantic",
                           "sdf_raw"), ref, got):
        assert tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   atol=OUT_ATOL, rtol=OUT_RTOL, err_msg=name)
    rng = np.random.default_rng(1)
    cs = [rng.normal(size=np.asarray(r).shape).astype(np.float32)
          for r in ref]

    def loss(p):
        o = jf.implicit_get_outputs_fused(p, jic, jnp.asarray(x),
                                          coarse_levels=coarse)
        return sum(jnp.sum(a * c) for a, c in zip(o, cs))

    jgrads = jax.grad(loss)(params)
    sum((a * torch.tensor(c)).sum() for a, c in zip(got, cs)).backward()
    _check_grads(jgrads, net)


def _outputs_and_backward_vs_jax(jfn, tfn, x, seed=1):
    """Outputs of jfn / tfn (the JAX and port field functions of points
    x) and the parameter gradients of a random weighting of all of them."""
    jic, params, net = _implicit(seed)
    ref = jfn(params, jic, jnp.asarray(x))
    got = tfn(net, torch.tensor(x))
    for i, (r, g) in enumerate(zip(ref, got)):
        assert tuple(g.shape) == r.shape, i
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   atol=OUT_ATOL, rtol=OUT_RTOL, err_msg=i)
    rng = np.random.default_rng(seed)
    cs = [rng.normal(size=np.asarray(r).shape).astype(np.float32)
          for r in ref]
    jgrads = jax.grad(lambda p: sum(jnp.sum(a * c) for a, c in zip(
        jfn(p, jic, jnp.asarray(x)), cs)))(params)
    sum((a * torch.tensor(c)).sum() for a, c in zip(got, cs)).backward()
    return jgrads, net


def test_get_outputs_vjp_and_its_backward_match_jax():
    """The vjp gradient mode: JAX's pullback through one packed forward
    against the port's H1 route (exact backward), outputs and the
    backward through all five, the gradients' second order included."""
    jgrads, net = _outputs_and_backward_vs_jax(
        jf.implicit_get_outputs, tf.implicit_get_outputs, _points(97, 7))
    _check_grads(jgrads, net)


def test_vjp_route_and_packed_wrap_differ_only_at_x01_one():
    """The packed encode wraps a dense row index where H1 clamps the dense
    cell: the corner rows differ exactly at the points with a coordinate
    at x01 = 1 (level 0 has scale 3, an integer, so 1 lands on the last
    grid line), and there the differing corners carry zero weight, so the
    vjp outputs and their backward still match JAX at every point."""
    jic, _, net = _implicit()
    x = _points(40, 8)
    x[:6, 0] = 1.0                  # x01 = 1 in one coordinate
    x[6:9] = 1.0                    # in all three
    x[9, 1] = -1.0                  # x01 = 0: both rules agree
    edge = np.zeros(len(x), bool)
    edge[:9] = True
    lt = thash.level_tables(jic.grid_meta)
    x01 = torch.tensor((x / jic.divide_factor + 1.0) * 0.5)
    clamped, _ = thash._fused_rows_frac(x01, lt)
    ld = lt.n_dense
    res, sizes, offs = (torch.as_tensor(a[:ld])
                        for a in (lt.res, lt.sizes, lt.offsets))
    pos = torch.as_tensor(lt.scales[:ld])[:, None, None] * x01.T[None]
    wrapped = (thash._dense_rows(torch.floor(pos).long(), res,
                                 torch.zeros_like(offs))
               % sizes[:, None, None] + offs[:, None, None])
    differs = (wrapped != clamped[:ld]).any(1).any(0).numpy()
    np.testing.assert_array_equal(differs, edge)
    jgrads, net = _outputs_and_backward_vs_jax(
        jf.implicit_get_outputs, tf.implicit_get_outputs, x)
    _check_grads(jgrads, net)


@pytest.mark.parametrize("with_features", [True, False])
def test_implicit_forward_and_sdf_raw_match_jax(with_features):
    """implicit_forward (both tables, or the SDF table alone as
    implicit_sdf_raw) through H1 against JAX's packed forward, outputs and
    parameter gradients."""
    def jfn(p, c, x):
        raw, fv = jf.implicit_forward(p, c, x, with_features=with_features)
        return (raw, fv) if with_features else (raw,)

    def tfn(net, x):
        raw, fv = tf.implicit_forward(net, x, with_features=with_features)
        return (raw, fv) if with_features else (tf.implicit_sdf_raw(net, x),)

    jgrads, net = _outputs_and_backward_vs_jax(jfn, tfn, _points(53, 9))
    ref = stage1_params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    for k, p in net.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        err = float((g - ref[k]).abs().max())
        assert err <= GRAD_REL * float(ref[k].abs().max()), (k, err)
    assert dict(net.named_parameters())["grid"].grad.any()


@pytest.mark.parametrize("which", ["scene", "object", "multi_object"])
def test_scene_and_object_sdf_wrappers_match_jax(which):
    """implicit_scene_sdf (the min over the objects), implicit_object_sdf
    (object 1) and implicit_multi_object_sdf (objects 0 and 2) through H1
    against JAX's, outputs and parameter gradients."""
    args = {"scene": (), "object": (1,), "multi_object": ((0, 2),)}[which]
    jfn = getattr(jf, f"implicit_{which}_sdf")
    tfn = getattr(tf, f"implicit_{which}_sdf")
    jgrads, net = _outputs_and_backward_vs_jax(
        lambda p, c, x: (jfn(p, c, x, *args),),
        lambda net, x: (tfn(net, x, *args),), _points(59, 3))
    ref = stage1_params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    for k, p in net.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        err = float((g - ref[k]).abs().max())
        assert err <= GRAD_REL * float(ref[k].abs().max()), (k, err)
    assert dict(net.named_parameters())["grid"].grad.any()


@pytest.mark.parametrize("size", [1.0, 2.5])
def test_hash_encode_world_matches_jax(size):
    """hash_encode_world of world points in [-size, size] (some on the
    boundary, some outside) against JAX's: features atol 1e-6, the table
    gradient of a random functional within 1e-5 of its largest entry."""
    jic, params, _ = _implicit()
    rng = np.random.default_rng(8)
    x = rng.uniform(-size, size, (300, 3)).astype(np.float32)
    x[:20, 0] = size
    x[20:40] *= 1.2
    emb = np.asarray(params["grid"])
    ref = jax.jit(lambda e: jhash.hash_encode_world(
        jnp.asarray(x), e, jic.grid_meta, size))(jnp.asarray(emb))
    ct = rng.normal(size=ref.shape).astype(np.float32)
    jg = jax.grad(lambda e: jnp.sum(jhash.hash_encode_world(
        jnp.asarray(x), e, jic.grid_meta, size) * ct))(jnp.asarray(emb))
    t_emb = torch.tensor(emb, requires_grad=True)
    got = thash.hash_encode_world(torch.tensor(x), t_emb,
                                  implicit_cfgs()[1].grid_meta, size)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-6)
    (got * torch.tensor(ct)).sum().backward()
    jg = np.asarray(jg)
    assert np.abs(t_emb.grad.numpy() - jg).max() <= 1e-5 * np.abs(jg).max()
    assert np.count_nonzero(jg) > 100


def test_all_gradients_and_their_backward_match_jax():
    """[N, K+1, 3] jacobians from the single-table encode and three
    hand-pushed tangents against JAX's three JVPs of the packed forward."""
    jic, params, net = _implicit(seed=4)
    x = _points(61, seed=2)
    ref = jf.implicit_all_gradients(params, jic, jnp.asarray(x))
    got, raw = tf.implicit_all_gradients(net, torch.tensor(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=OUT_ATOL, rtol=OUT_RTOL)
    np.testing.assert_allclose(
        raw.detach().numpy(),
        np.asarray(jf.implicit_sdf_raw(params, jic, jnp.asarray(x))),
        atol=OUT_ATOL, rtol=OUT_RTOL)
    c = np.random.default_rng(3).normal(size=ref.shape).astype(np.float32)
    jgrads = jax.grad(lambda p: jnp.sum(
        jf.implicit_all_gradients(p, jic, jnp.asarray(x)) * c))(params)
    (got * torch.tensor(c)).sum().backward()
    ref_g = stage1_params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    for k, p in net.named_parameters():
        # the colour grid, its MLP and the head's bias do not reach the
        # jacobians: JAX's gradient is zeros, the port's None
        g = torch.zeros_like(p) if p.grad is None else p.grad
        r = ref_g[k]
        err = float((g - r).abs().max())
        assert err <= GRAD_REL * float(r.abs().max()), (k, err)
    assert dict(net.named_parameters())["grid"].grad.any()


def test_rendering_network_matches_jax():
    jc, tc = cfgs("exact")
    params = jax_params(jc)["rendering"]
    net = tf.RenderingNetwork(tc.rendering)
    net.load_state_dict(stage1_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.default_rng(5)
    ins = [rng.normal(size=(40, d)).astype(np.float32) for d in (3, 3, 3, 16)]
    ref = jf.rendering_forward(params, jc.rendering,
                               *(jnp.asarray(a) for a in ins))
    got = net(*(torch.tensor(a) for a in ins))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=OUT_ATOL, rtol=OUT_RTOL)


def test_sampler_sdf_matches_jax():
    """implicit_sdf_raw_sampler (H2 plain + the trunk) at 4 of 6 levels."""
    jic, params, net = _implicit()
    x = _points(80, seed=6)
    blocks = build_dense_block_tables(params["grid"], jic.grid_meta,
                                      max_levels=4)
    ref = jf.implicit_sdf_raw_sampler(params, jic, jnp.asarray(x), blocks,
                                      grid_levels=4)
    got = tf.implicit_sdf_raw_sampler(net, torch.tensor(x), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=OUT_ATOL,
                               rtol=OUT_RTOL)


def test_config_rejects_what_is_not_ported():
    """level_dim other than 2 is refused with its reason (no JAX Stage-1
    render runs it); an unknown gradient mode, tiers outside the fused
    mode and tiers on a network the fused encode does not take raise, as
    JAX's config does."""
    with pytest.raises(NotImplementedError, match="build_dense_block_tables"):
        tf.ImplicitNetwork(implicit_cfgs(level_dim=4)[1])
    with pytest.raises(ValueError, match="sdf_bwd_sample"):
        tf.ImplicitNetworkConfig(color_bwd_sample=False, sdf_bwd_sample=True)
    _, tc = cfgs("exact")
    with pytest.raises(ValueError, match="forward_grad_mode"):
        dataclasses.replace(tc, forward_grad_mode="reverse",
                            render_fine_top_f=0)
    with pytest.raises(ValueError, match="fused"):
        dataclasses.replace(tc, forward_grad_mode="vjp")
    with pytest.raises(ValueError, match="trilinear"):
        dataclasses.replace(tc, implicit=dataclasses.replace(
            tc.implicit, grid_interp="tetrahedral"))
