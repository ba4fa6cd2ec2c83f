"""The import rule: no module of the benchmark imports JAX, its libraries or
the JAX package (top-level names compared whole: `rift_tpu_torch` is not
`rift_tpu`), and the reference imports nothing of the program."""
from __future__ import annotations

import ast
import os

import pytest

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "rift_tpu"}
SOURCES = sorted(os.path.relpath(os.path.join(d, f), harness.BENCH_DIR)
                 for d, _, files in os.walk(harness.BENCH_DIR) for f in files
                 if f.endswith(".py"))


def imported_top_levels(path: str) -> set[str]:
    """Top-level names of the absolute imports of a source file."""
    tree = ast.parse(open(path).read(), filename=path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("source", SOURCES)
def test_no_jax_and_a_plain_reference(source):
    names = imported_top_levels(os.path.join(harness.BENCH_DIR, source))
    assert not names & FORBIDDEN, (source, names & FORBIDDEN)
    if source.startswith("reference" + os.sep):
        assert "rift_tpu_torch" not in names and "benchmark" not in names, source


def test_the_check_compares_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "rift_tpu_torch_like", types.ModuleType("x"))
    assert "rift_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "rift_tpu.models", types.ModuleType("x"))
    assert "rift_tpu" in harness.forbidden_modules()
