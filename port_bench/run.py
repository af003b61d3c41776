"""Run one cell of the port's benchmark once.

    python3 -m port_bench.run --workload s1_room0_4k --seed 7 --seconds 10 \
        --trace 0

from the root of a checkout. The cell, its configuration, its traffic and
its metrics are found by name (BENCHMARK.json, port_bench/configs/,
port_bench/workloads/, port_bench/metrics/); the configuration names its
driver (port_bench/drivers/). A run builds the kernels (kept in the
checkout), makes its scene and weights from --seed, warms up (set-up),
measures for --seconds, checks what the timed path produced against the
plain reference, and prints one JSON line last. --trace 0 reports the
end-to-end metrics; --trace 1 the per-layer ones, from the harness's spans
over a window of --seconds and a torch.profiler trace of a steady window
after it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import shutil  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()
CACHE = ROOT / ".bench_cache"


def _environment() -> None:
    """Fixed cache directories inside the checkout (the port keeps its
    kernel library in holoscene_tpu_torch/build/ itself), and one CPU
    thread for torch's and the BLAS's pools: the steps are dispatched by
    one host thread, and idle pool threads spinning beside it made Stage-1
    runs spread wider (7.6% against 4.1% between quartiles, four 30 s runs
    each, an H100 at 700 W)."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    os.environ["USE_FLAX"] = "0"
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"
    os.environ["OPENBLAS_NUM_THREADS"] = "1"


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def read_metrics(entries, rec: dict) -> dict:
    """Each metric's reader port_bench/metrics/<name>.py on the run's
    record; a reader that finds nothing returns None and the metric is
    left out."""
    out = {}
    for m in entries:
        path = ROOT / "port_bench" / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location(
            "port_bench.metrics._reader_" + m["name"].replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    _environment()
    from port_bench import harness

    try:
        cell = harness.load_cell(ROOT, args.workload)
    except (harness.CellError, OSError, KeyError, ValueError) as exc:
        print(f"port_bench: {exc}", file=sys.stderr)
        return 2
    import torch

    chips = int(cell["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, "
              f"count {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    driver_mod = importlib.import_module(
        f"port_bench.drivers.{cell['config']['driver']}")
    work = Path(tempfile.mkdtemp(prefix="port_bench_"))
    try:
        return _run(args, cell, driver_mod, work, chips, torch)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run(args, cell, driver_mod, work, chips, torch) -> int:
    from port_bench import harness

    device = torch.device("cuda", 0)
    traffic = dict(cell["traffic"])
    traffic["limits"] = harness.load_limits(ROOT, args.workload)
    driver = driver_mod.Driver(cell["config"], traffic, args.seed,
                               ROOT, work, device)
    driver.setup()
    torch.cuda.synchronize(device)
    rec: dict = {"setup_s": time.perf_counter() - T_START}
    spans = harness.Spans()
    rec["spans"] = spans
    rec["window"] = driver.window(args.seconds, spans if args.trace else None)
    if args.trace:
        rec["trace"] = driver.traced(spans)
    torch.cuda.synchronize(device)
    rec["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    entries = cell["per_layer"] if args.trace else cell["end_to_end"]
    metrics = read_metrics(entries, rec)
    device_info = {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(device),
                   "count": chips,
                   "memory_peak_bytes": int(rec["peak_bytes"])}
    if args.trace:
        device_info["busy_s"] = rec["trace"]["busy_s"]
        device_info["window_s"] = rec["trace"]["window_s"]
    driver.release()
    t_check = time.perf_counter()
    checks = driver.check()
    print(f"port_bench: check took {time.perf_counter() - t_check:.1f} s",
          file=sys.stderr)
    correct = all(v <= lim for _, v, lim in checks)
    found = harness.forbidden_loaded()
    if found:
        print(f"port_bench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 4
    result = {"correct": bool(correct),
              "attempted": int(rec["window"]["steps"]),
              "failed": int(rec["window"]["failed"]),
              "metrics": metrics, "device": device_info}
    if args.trace:
        result["breakdown"] = rec["trace"]["breakdown"]
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
