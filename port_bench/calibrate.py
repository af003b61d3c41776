"""Readings behind a training cell's limits: for each seed, the program's
gaps to the plain reference over the cell's checked first steps, and the
same gaps of each control put in the program's place.

    python3 -m port_bench.calibrate --workload s1_room0_4k \
        --seeds 11 12 13 --controls tf32 drop_half --out chiprun_out/cal.jsonl

Controls: tf32, the reference with TF32 matmuls and convolutions (the
nearest precision below the configuration's float32 with TF32 off);
drop_half, the reference with half of each batch left out (the mean taken
over the rest). With --control_steps K each control and the reference it
is held to follow the first K checked steps only: the worst step's loss gap
and the first step's gradient gap over a prefix are at most those over
every step, so the prefix's readings bound the control from below. A step
that leaves the state unchanged reads 1 on the change gap by definition
and needs no run. One process reads every seed,
on the card; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path.cwd()


def readings(workload: str, seeds, controls, out=None, config_patch=None,
             traffic_patch=None, device=None, control_steps=None):
    """One dict a seed: {seed, program: numbers, <control>: numbers,
    worst: the program's worst leaves}; appended to `out` as JSON lines."""
    import torch

    from port_bench import harness
    from port_bench.drivers import common

    cell = harness.load_cell(ROOT, workload)
    config = dict(cell["config"], **(config_patch or {}))
    traffic = dict(cell["traffic"], **(traffic_patch or {}))
    mod = importlib.import_module(f"port_bench.drivers.{config['driver']}")
    device = torch.device(device or "cuda")
    rows = []
    for seed in seeds:
        with tempfile.TemporaryDirectory(prefix="port_bench_cal_") as work:
            d = mod.Driver(config, traffic, seed, ROOT, Path(work), device)
            d.setup(warm=False)
            d.release()
            ref = d.reference()
            row = {"seed": seed,
                   "program": d.numbers(d.program, ref),
                   "loss": {"program": d.program["loss"],
                            "reference": ref["loss"]}}
            gaps = common.leaf_gaps(d.program["grad"], ref["grad"])
            row["worst_grad_leaves"] = sorted(
                gaps.items(), key=lambda kv: -kv[1])[:3]
            base = ref if control_steps is None else d.reference(
                steps=control_steps)
            for c in controls:
                ctl = d.reference(tf32=(c == "tf32"),
                                  drop_half=(c == "drop_half"),
                                  steps=control_steps)
                row[c] = d.numbers(ctl, base)
            del d
            if device.type == "cuda":
                torch.cuda.empty_cache()
        rows.append(row)
        print(json.dumps(row), flush=True)
        if out:
            with open(out, "a") as fh:
                fh.write(json.dumps(row) + "\n")
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", nargs="*", default=["tf32", "drop_half"])
    p.add_argument("--control_steps", type=int, default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    readings(args.workload, args.seeds, args.controls, args.out,
             control_steps=args.control_steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
