"""BENCHMARK.json against the benchmark's contract: names, units, keys and
limits, and every file the cells, configurations and metrics name."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and ".." not in p and not p.startswith("/")
        assert (ROOT / p).is_dir()
    assert 1 <= len(bench["command"]) <= 32
    assert all(_one_line(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    cells = len(bench["workloads"])
    assert 1 <= cells <= 24
    # a full check of 24 cells fits the driver's budget
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert len(json.dumps(bench)) <= 64 * 1024


def test_configs(bench):
    names = [c["name"] for c in bench["configs"]]
    assert len(names) == len(set(names))
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert c["source"].startswith("https://") and _one_line(c["source"])
        assert _one_line(c["why"])
        assert c["file"].startswith("port_bench/")
        config = json.loads((ROOT / c["file"]).read_text())
        assert (ROOT / "port_bench" / "drivers"
                / f"{config['driver']}.py").is_file()
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_workloads(bench):
    names = [w["name"] for w in bench["workloads"]]
    assert len(names) == len(set(names))
    pairs = {(w["config"], w["traffic"]) for w in bench["workloads"]}
    assert len(pairs) == len(names)
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(names) // 4)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _one_line(w["why"])
        assert (ROOT / "port_bench" / "workloads"
                / f"{w['traffic']}.json").is_file()
        limits = json.loads((ROOT / "port_bench" / "limits"
                             / f"{w['name']}.json").read_text())["limits"]
        # an exact comparison (a count that has to agree) has the limit 0
        assert limits and all(v >= 0 for v in limits.values())


def _applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    per = bench["per_layer"]
    names = list(e2e) + [m["name"] for m in per]
    assert len(names) == len(set(names))
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers: dict = {}
    for m in per:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _one_line(m["layer"]) and m["moves"] in e2e
        for c in m.get("workloads", cells):
            assert c in cells and _applies(e2e[m["moves"]], c)
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in bench["end_to_end"] + per:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "port_bench" / "metrics" / f"{m['name']}.py").is_file()
    for c in cells:
        have = [m["name"] for m in bench["end_to_end"] if _applies(m, c)]
        assert "setup_s" in have and len(have) >= 2
        assert any(_applies(m, c) for m in per)
