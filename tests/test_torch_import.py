"""The port imports torch and never jax: importing every module of
holoscene_tpu_torch in a fresh interpreter leaves jax out of sys.modules
(checked in a subprocess, since the test session's conftest imports jax)."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import holoscene_tpu_torch

REPO = Path(__file__).resolve().parents[1]


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(
            holoscene_tpu_torch.__path__, prefix="holoscene_tpu_torch."))


def test_port_lists_its_slice_modules():
    mods = set(_port_modules())
    for name in ("convert", "kernels", "ops.gaussians", "ops.ssim",
                 "ops.splat_flat", "ops.splat", "ops.rasterizer",
                 "models.gom", "training.stage4", "training.checkpoints",
                 "training.exp_runner_gaussian"):
        assert f"holoscene_tpu_torch.{name}" in mods, name


def test_kernel_signatures_match_sources():
    """ctypes passes exactly the arguments each extern "C" entry of csrc/
    declares, pointers (and the stream) as void*, ints as int: a mismatch
    is a crash on the card that no CPU test would otherwise see."""
    import ctypes
    import re

    from holoscene_tpu_torch import kernels

    src = "".join(p.read_text() for p in sorted(kernels.CSRC.glob("*.cu")))
    decls = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src))
    assert set(decls) == set(kernels._SIGNATURES)
    for name, params in decls.items():
        kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int
                 for p in params.split(",")]
        assert kinds == list(kernels._SIGNATURES[name]), name


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"mods = {_port_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith(('jax.', 'jaxlib', 'flax', 'optax')))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(_port_modules())
