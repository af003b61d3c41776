"""The port imports torch, never jax and nothing of the JAX package:
importing every module of holoscene_tpu_torch in a fresh interpreter leaves
jax and holoscene_tpu out of sys.modules (checked in a subprocess, since the
test run's conftest imports jax), and no source line of the port or of
chip_smoke.py imports either."""

import pkgutil
import re
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
    for name in ("convert", "kernels", "config", "ops.gaussians", "ops.ssim",
                 "ops.splat_flat", "ops.splat_topk", "ops.splat",
                 "ops.rasterizer", "models.gom", "training.stage4",
                 "training.checkpoints", "training.exp_runner_gaussian",
                 "training.gs_render", "datasets.synthetic",
                 "datasets.ns_dataset", "datasets.gs_datasets", "utils.mesh",
                 "utils.mc", "utils.eval_rgb", "export.gs_usdz",
                 "ops.embedder", "ops.density", "ops.volrend", "ops.rays",
                 "ops.hashgrid", "ops.probe_grid", "ops.sampler",
                 "models.fields", "models.holoscene",
                 "losses.holoscene_loss", "training.stage1",
                 "training.exp_runner", "utils.logging", "native",
                 "utils.plots", "utils.eval_geometry", "training.pruning",
                 "training.quality_gate", "physics", "physics.sim",
                 "stage2", "stage2.scene_graph", "stage2.views",
                 "stage2.inpaint_views", "stage2.providers",
                 "stage2.refine", "stage2.remesh", "stage2.runner",
                 "training.exp_runner_post", "training.stage3",
                 "training.exp_runner_texture", "utils.uv_atlas",
                 "export.glb", "export.usd", "export.load_scene",
                 "export.cli", "stage0", "stage0.priors",
                 "stage2.mv_predict", "models.gaussians_free",
                 "models.gom_adaptive", "training.gs_trainer",
                 "training.gs_train", "ops.gs_trace", "export.gs_ingp",
                 "viewer"):
        assert f"holoscene_tpu_torch.{name}" in mods, name


def test_kernel_signatures_match_sources():
    """ctypes passes exactly the arguments each extern "C" entry of csrc/
    declares, pointers (and the stream) as void*, ints as int, floats as
    float: a mismatch is a crash on the card that no CPU test would
    otherwise see."""
    import ctypes

    from holoscene_tpu_torch import kernels

    src = "".join(p.read_text() for p in sorted(kernels.CSRC.glob("*.cu")))
    decls = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src))
    assert set(decls) == set(kernels._SIGNATURES)
    for name, params in decls.items():
        kinds = [ctypes.c_void_p if "*" in p
                 else ctypes.c_float if p.split()[0] == "float"
                 else ctypes.c_int for p in params.split(",")]
        assert kinds == list(kernels._SIGNATURES[name]), name


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"mods = {_port_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'holoscene_tpu')"
        " or k.startswith(('jax.', 'jaxlib', 'flax', 'optax', "
        "'holoscene_tpu.')))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(_port_modules())


def test_no_source_line_imports_jax_or_the_jax_package():
    """Also the imports inside functions, which importing a module does not
    run."""
    pat = re.compile(
        r"^\s*(from|import)\s+(holoscene_tpu|jax|jaxlib|flax|optax)([.\s]|$)")
    files = sorted((REPO / "holoscene_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    bad = [f"{f.relative_to(REPO)}:{i}: {line.strip()}"
           for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if pat.match(line)]
    assert not bad, bad
