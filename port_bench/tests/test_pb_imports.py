"""No module of the benchmark imports JAX or the JAX package: each
import's top-level name is compared whole, so the port
(holoscene_tpu_torch) passes and holoscene_tpu does not."""

from __future__ import annotations

import ast
from pathlib import Path

from port_bench import harness

BENCH = Path(__file__).resolve().parents[1]


def _top_names(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    found = {}
    for path in BENCH.rglob("*.py"):
        bad = _top_names(path) & set(harness.FORBIDDEN)
        if bad:
            found[str(path.relative_to(BENCH))] = sorted(bad)
    assert not found, found


def test_names_are_compared_whole():
    assert harness.forbidden_loaded(["holoscene_tpu_torch.ops.hashgrid",
                                     "holoscene_tpu_torchx", "jaxtyping",
                                     "torch"]) == []
    assert harness.forbidden_loaded(["holoscene_tpu.ops", "jax.numpy",
                                     "flax", "jaxlib.xla"]) \
        == ["flax", "holoscene_tpu", "jax", "jaxlib"]


def test_the_references_import_nothing_of_the_program():
    for sub in ("ref_s1", "ref_s4"):
        for path in (BENCH / sub).glob("*.py"):
            assert "holoscene_tpu_torch" not in _top_names(path), path
