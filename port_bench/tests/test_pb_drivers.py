"""The drivers at tiny sizes on the CPU, through the port's plain kernels:
a run without a card prints no result; a sound run's check passes; each
fault a training cell can have, planted underneath the timed path, makes
the check fail."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from port_bench.drivers import stage1, stage4
from port_bench.tests import cases

ROOT = cases.ROOT


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload", ["s1_room0_4k", "gom_room_views"])
def test_a_run_without_a_card_prints_no_result(workload, tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", TMPDIR=str(tmp_path))
    done = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", workload,
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert done.returncode != 0
    for line in done.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def _correct(driver) -> bool:
    driver.release()
    return all(v <= lim for _, v, lim in driver.check())


def _unchanged(module, attr, params_of):
    """module.attr wrapped so that every step leaves the state as it was."""
    orig = getattr(module, attr)

    def step(*a, **k):
        params = params_of(a)
        before = [p.detach().clone() for p in params]
        out = orig(*a, **k)
        with torch.no_grad():
            for p, b in zip(params, before):
                p.copy_(b)
        return out
    return step


def _s1(tmp_path, fault=None, monkeypatch=None):
    config, traffic = cases.tiny_s1(tmp_path)
    from holoscene_tpu_torch.training import stage1 as prog

    if fault == "unchanged":
        monkeypatch.setattr(prog, "train_step", _unchanged(
            prog, "train_step", lambda a: list(a[0].parameters())))
    elif fault == "half_batch":
        orig = prog.train_step

        def half(model, opt, sched, lcfg, batch, draws, *a, **k):
            n = batch["uv"].shape[0]
            rows = slice(0, n // 2)
            batch = {key: (v[rows] if key in ("uv", "rgb", "depth", "normal",
                                              "segs", "mask") else v)
                     for key, v in batch.items()}
            return orig(model, opt, sched, lcfg, batch,
                        draws.rows(rows, n, slice(None)), *a, **k)
        monkeypatch.setattr(prog, "train_step", half)
    d = stage1.Driver(config, traffic, 2 ** 31 + 11, ROOT, tmp_path, "cpu")
    d.setup()
    d.window(0.2, None)
    return d


def test_stage1_sound_run_is_correct(tmp_path):
    assert _correct(_s1(tmp_path))


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_stage1_fault_is_not_correct(fault, tmp_path, monkeypatch):
    assert not _correct(_s1(tmp_path, fault, monkeypatch))


def _s4(tmp_path, name, fault=None, monkeypatch=None):
    config, traffic = cases.tiny_s4(name)
    from holoscene_tpu_torch.training import stage4 as prog

    if fault == "unchanged":
        orig = prog.Stage4Runner._step

        def step(self, *a, **k):
            before = {n: p.detach().clone() for n, p in self.params.items()}
            out = orig(self, *a, **k)
            with torch.no_grad():
                for n, p in self.params.items():
                    p.copy_(before[n])
            return out
        monkeypatch.setattr(prog.Stage4Runner, "_step", step)
    elif fault == "half_batch":
        orig_loss = prog.gom_loss

        def half(out, batch, cfg, **k):
            h = batch["acm"].shape[0] // 2
            out = dict(out, rgb=out["rgb"][:, :h], depth=out["depth"][:h],
                       accumulation=out["accumulation"][:h])
            batch = dict(batch, image=batch["image"][:, :h],
                         acm=batch["acm"][:h],
                         mesh_depth=batch["mesh_depth"][:h])
            return orig_loss(out, batch, cfg, **k)
        monkeypatch.setattr(prog, "gom_loss", half)
    elif fault == "trim_drops":
        # the trimmed plan's bins keep one chunk a tile, live or not
        orig_bins = prog.gom_flat_bins

        def dropping(*a, used_chunks=None, **k):
            if used_chunks is not None:
                used_chunks = torch.full_like(used_chunks, -1)
            return orig_bins(*a, used_chunks=used_chunks, **k)
        monkeypatch.setattr(prog, "gom_flat_bins", dropping)
    d = stage4.Driver(config, traffic, 2 ** 31 + 13, ROOT, tmp_path, "cpu")
    d.setup()
    d.window(0.2, None)
    return d


def test_stage4_sound_run_is_correct(tmp_path):
    assert _correct(_s4(tmp_path, "gom_room_views"))


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "trim_drops"])
def test_stage4_fault_is_not_correct(fault, tmp_path, monkeypatch):
    assert not _correct(_s4(tmp_path, "gom_room_views", fault, monkeypatch))
