"""The port reads the JAX package's Stage-1 checkpoints: the flax msgpack
files decoded with msgpack and numpy alone (convert.py::read_flax_msgpack),
the params through stage1_params_from_jax, the optax Adam state as the
port's Adam moments, step and schedule. The JAX package writes a tiny
checkpoint of the micro conf of tests/test_cli_chain.py with its own
save_checkpoint; the port's field agrees with JAX's on the same points
(atol 1e-5: the same float32 function, evaluated by two libraries), the
moments are the file's bits, and exp_runner_post (--device cpu) and the
Stage-1 resume start from it."""

import argparse
import os
import shutil

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_cli_chain import workdir  # noqa: F401  (the micro conf + scene)
from test_torch_threads import few_torch_threads  # noqa: F401

from holoscene_tpu.config import ConfigFactory as JConfigFactory
from holoscene_tpu.datasets.ns_dataset import NSDataset as JNSDataset
from holoscene_tpu.models import fields as jf
from holoscene_tpu.models import holoscene as jhs
from holoscene_tpu.training import checkpoints as jck
from holoscene_tpu.training.stage1 import make_optimizer as jmake_optimizer
from holoscene_tpu_torch.config import ConfigFactory
from holoscene_tpu_torch.convert import read_flax_msgpack
from holoscene_tpu_torch.models import fields as tf
from holoscene_tpu_torch.models import holoscene as ths
from holoscene_tpu_torch.training import checkpoints as tck
from holoscene_tpu_torch.training.stage1 import make_optimizer

STAMP = "2026_01_01_00_00_00"
STEP = 3
LR, LR_GRID, ITERS = 5.0e-4, 20.0, 12     # the micro conf's train values


@pytest.fixture(scope="module")
def jax_run(workdir):  # noqa: F811
    """The micro conf's model, initialised and stepped 3 times by JAX's
    optimizer, saved as exps/cli_micro/STAMP/checkpoints by JAX's
    save_checkpoint. Returns (conf path, exps dir, JAX config, params,
    opt state, the optimizer's jitted update)."""
    conf = JConfigFactory.parse_file(str(workdir / "micro.conf"))
    ds = JNSDataset(str(workdir / "data"), "scene_0", img_res=(24, 24))
    conf.put("model.implicit_network.d_out", len(ds.label_mapping))
    jc = jhs.HoloSceneConfig.from_conf(conf.get_config("model"))
    params = jhs.init_holoscene(jax.random.PRNGKey(3), jc)
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(
        lambda x: x + jnp.asarray(rng.normal(0, 0.05, x.shape)
                                  .astype(np.float32)), params)
    opt = jmake_optimizer(LR, LR_GRID, ITERS)
    state = opt.init(params)
    # one compiled update (the eager one dispatches leaf by leaf)
    update = jax.jit(opt.update)
    for i in range(STEP):
        grads = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.normal(0, 1, x.shape)
                                  .astype(np.float32)), params)
        updates, state = update(grads, state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    exps = workdir / "exps_jax"
    path = exps / "cli_micro" / STAMP / "checkpoints"
    jck.save_checkpoint(str(path), STEP, params, state,
                        extra={"step": STEP})
    return workdir / "micro.conf", exps, jc, params, state, update


def _points(n=257, seed=5):
    return np.random.default_rng(seed).uniform(-0.9, 0.9, (n, 3)).astype(
        np.float32)


def _port_model(conf_path, d_out):
    conf = ConfigFactory.parse_file(str(conf_path))
    conf.put("model.implicit_network.d_out", d_out)
    cfg = ths.HoloSceneConfig.from_conf(conf.get_config("model"))
    return ths.init_holoscene(cfg, 0, "cpu")


def test_msgpack_reader_matches_flax():
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": (np.int32(7), np.zeros((0, 4), np.float32)),
            "c": {"d": np.float64(2.5), "e": np.ones(3, np.int64),
                  "f": {}}}
    data = flax.serialization.to_bytes(tree)
    got = read_flax_msgpack(data)
    ref = flax.serialization.msgpack_restore(data)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_ref]
    for (_, a), (_, b) in zip(flat_got, flat_ref):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    assert got["b"]["0"] == 7 and got["c"]["f"] == {}


def test_field_and_adam_state_from_a_jax_checkpoint(jax_run):
    conf_path, exps, jc, params, state, update = jax_run
    ck = str(exps / "cli_micro" / STAMP / "checkpoints")
    assert tck.checkpoint_format(ck) == "msgpack"
    model = _port_model(conf_path, jc.implicit.d_out)
    opt, sched = make_optimizer(model, LR, LR_GRID, ITERS)
    meta, gen = tck.load_checkpoint(ck, model, opt, sched)
    assert meta == {"epoch": STEP, "step": STEP} and gen is None
    x = _points()
    ref = np.asarray(jf.implicit_sdf_raw(params["implicit"], jc.implicit,
                                         jnp.asarray(x)))
    with torch.no_grad():
        got = tf.implicit_sdf_raw(model.implicit, torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    # the optax moments, bit for bit, and the step / schedule
    names = dict(model.named_parameters())
    for label, group in zip(("grid", "net"), opt.param_groups):
        adam = state.inner_states[label].inner_state[0]
        assert int(adam.count) == STEP
        for p in group["params"]:
            name = next(n for n, q in names.items() if q is p)
            node_m, node_v = adam.mu, adam.nu
            for part in name.split("."):
                node_m, node_v = node_m[part], node_v[part]
            st = opt.state[p]
            assert float(st["step"]) == STEP
            np.testing.assert_array_equal(st["exp_avg"].numpy(),
                                          np.asarray(node_m))
            np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                          np.asarray(node_v))
    decay = 0.1 ** (1.0 / ITERS)
    assert sched.last_epoch == STEP
    np.testing.assert_allclose([g["lr"] for g in opt.param_groups],
                               [LR * LR_GRID * decay ** STEP,
                                LR * decay ** STEP], rtol=1e-12)
    # one more step moves the params as JAX's optimizer would
    rng = np.random.default_rng(9)
    grads = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.normal(0, 1, x.shape).astype(np.float32)),
        params)
    upd, _ = update(grads, state, params)
    want = jax.tree_util.tree_map(lambda p, u: np.asarray(p + u), params, upd)
    for name, p in names.items():
        node = grads
        for part in name.split("."):
            node = node[part]
        p.grad = torch.tensor(np.asarray(node)).reshape(p.shape)
    opt.step()
    for name, p in names.items():
        node = want
        for part in name.split("."):
            node = node[part]
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(node).reshape(p.shape),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


def test_both_formats_refused_and_groups_checked(jax_run, tmp_path):
    conf_path, exps, jc, _params, _state, _update = jax_run
    ck = tmp_path / "checkpoints"
    shutil.copytree(exps / "cli_micro" / STAMP / "checkpoints", ck)
    model = _port_model(conf_path, jc.implicit.d_out)
    # a one-group optimizer does not hold the JAX state's two groups
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    with pytest.raises(ValueError, match="groups"):
        tck.load_checkpoint(str(ck), model, opt)
    # groups of the same count that hold other parameters
    params = list(model.parameters())
    swapped = torch.optim.Adam([{"params": params[1:]},
                                {"params": params[:1]}])
    with pytest.raises(ValueError, match="optimizer group 'grid'"):
        tck.load_checkpoint(str(ck), model, swapped)
    torch.save(model.state_dict(), ck / "ModelParameters" / "latest.pth")
    with pytest.raises(ValueError, match="latest.pth.*latest.msgpack"):
        tck.load_checkpoint(str(ck), model)


def test_exp_runner_post_and_resume_start_from_it(jax_run, monkeypatch):
    conf_path, exps, jc, params, _state, _update = jax_run
    monkeypatch.chdir(conf_path.parent)
    from holoscene_tpu_torch.training import exp_runner_post

    ap = argparse.ArgumentParser()
    exp_runner_post.add_run_args(ap, mesh_resolution=32)
    args = ap.parse_args(["--conf", str(conf_path), "--exps_folder",
                          str(exps), "--quiet", "--device", "cpu"])
    runner, rundir = exp_runner_post.build_stage2_runner(args)
    assert rundir.endswith(STAMP)
    x = _points(64, 6)
    ref = np.asarray(jf.implicit_sdf_raw(params["implicit"], jc.implicit,
                                         jnp.asarray(x)))
    with torch.no_grad():
        got = tf.implicit_sdf_raw(runner.model.implicit,
                                  torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)

    from holoscene_tpu_torch.training.stage1 import Stage1Runner

    conf = ConfigFactory.parse_file(str(conf_path))
    s1 = Stage1Runner(conf, exps_folder=str(exps), is_continue=True,
                      quiet=True, device="cpu")
    assert s1.timestamp == STAMP and s1.start_iter == STEP
    assert all(float(s1.optimizer.state[p]["step"]) == STEP
               for p in s1.model.parameters())
    assert os.path.isdir(s1.checkpoints_path)
