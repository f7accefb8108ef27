"""What the benchmark's modules import: no module under ``perfbench/`` names
JAX or the JAX package at any level, and the references, inputs and counts
import nothing of the port (top-level names compared whole: the port
``repro_torch`` begins with the JAX package's ``repro``)."""

import ast

import pytest

from _cells import ROOT

BENCH = ROOT / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
PORT_FREE = ("reference", "inputs", "counts")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


SOURCES = sorted(p for p in BENCH.rglob("*.py") if ".cache" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not FORBIDDEN.intersection(_imports(path)), path


@pytest.mark.parametrize("path", [p for p in SOURCES if p.relative_to(BENCH).parts[0] in PORT_FREE],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_references_inputs_counts_import_nothing_of_the_port(path):
    assert "repro_torch" not in set(_imports(path)), path


def test_the_run_refuses_jax_once_loaded():
    from perfbench.harness import device

    assert device.forbidden_modules_loaded(["torch", "repro.api.update", "numpy"]) == ["repro"]
    assert device.forbidden_modules_loaded(["jax.numpy", "jaxlib", "flax.linen"]) == \
        ["flax", "jax", "jaxlib"]
    assert device.forbidden_modules_loaded(["repro_torch.api", "reprocess", "jaxtyping"]) == []
