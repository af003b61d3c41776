"""Tiny configurations of the benchmark's cells for the CPU tests (the
port's plain kernels) and a small one for the card."""

from __future__ import annotations

import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TINY_S1 = {r"dims = \[256, 256\]": "dims = [32, 32]",
           "feature_vector_size = 256": "feature_vector_size = 16",
           "num_levels = 16": "num_levels = 4", "end_size = 2048":
           "end_size = 64", "logmap = 19": "logmap = 10",
           "N_samples = 64": "N_samples = 16",
           "N_samples_eval = 128": "N_samples_eval = 32",
           "N_samples_extra = 32": "N_samples_extra = 8",
           "max_total_iters = 5": "max_total_iters = 2",
           r"img_res = \[512, 512\]": "img_res = [64, 64]"}


def cell(name: str) -> tuple[dict, dict, dict]:
    """(config, traffic, limits) of a cell as BENCHMARK.json names them."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    w = next(w for w in bench["workloads"] if w["name"] == name)
    c = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((ROOT / c["file"]).read_text())
    traffic = json.loads((ROOT / "port_bench" / "workloads"
                          / f"{w['traffic']}.json").read_text())
    limits = json.loads((ROOT / "port_bench" / "limits"
                         / f"{name}.json").read_text())["limits"]
    return config, traffic, limits


def tiny_s1(tmp: Path, res: int = 64, subs=TINY_S1) -> tuple[dict, dict]:
    config, traffic, limits = cell("s1_room0_4k")
    text = (ROOT / config["conf"]).read_text()
    for a, b in subs.items():
        text = re.sub(a, b, text)
    text = text.replace("img_res = [512, 512]", f"img_res = [{res}, {res}]")
    text = re.sub(r"img_res = \[64, 64\]", f"img_res = [{res}, {res}]", text)
    path = tmp / "tiny.conf"
    path.write_text(text)
    config = dict(config, conf=str(path),
                  scene=dict(config["scene"], res=res))
    traffic = dict(traffic, rays_per_step=64, warmup_steps=2, chunk_steps=2,
                   trace_steps=2, limits=limits)
    return config, traffic


def tiny_s4(name: str, res: int = 64, area: float = 2e-3):
    config, traffic, limits = cell(name)
    config = dict(config, scene=dict(config["scene"], res=res),
                  gom=dict(config["gom"], area_to_subdivide=area))
    traffic = dict(traffic, warmup_min=2, warmup_max=24, chunk_steps=2,
                   trace_steps=2, view_res=32, limits=limits)
    return config, traffic
