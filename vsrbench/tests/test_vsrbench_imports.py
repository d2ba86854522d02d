"""No module of the benchmark imports JAX, jaxlib, flax or the JAX package
`vsrcic_tpu`, comparing each import's top-level name (the part before the
first dot) whole, so `vsrcic_tpu_torch` is not `vsrcic_tpu`; the reference
imports nothing of the program either."""
from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from vsrbench import harness
from vsrbench.tests.tiny import REPO

BENCH = REPO / "vsrbench"
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_names(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not top_names(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = top_names(path)
    assert "vsrcic_tpu_torch" not in names
    assert names <= {"__future__", "math", "typing", "numpy", "torch",
                     "scipy"}


def test_whole_name_comparison():
    assert "vsrcic_tpu_torch".split(".")[0] not in harness.FORBIDDEN
    assert "vsrcic_tpu.models".split(".")[0] in harness.FORBIDDEN


def test_reference_loads_no_program_module():
    code = ("import sys; import vsrbench.reference.captioner, "
            "vsrbench.reference.planner, vsrbench.reference.plan; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True).stdout
    loaded = set(ast.literal_eval(out.strip()))
    assert not loaded & {"vsrcic_tpu_torch", *harness.FORBIDDEN}
