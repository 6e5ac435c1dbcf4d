"""What the benchmark may import: never JAX or the JAX package (top-level
names compared whole: ``pydreamer_tpu_torch`` is not ``pydreamer_tpu``), and
in the reference nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "pydreamer_tpu", "__graft_entry__", "tests"}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


FILES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert set(_imports(path)) <= {"__future__", "math", "typing", "torch"}


def test_a_run_loads_no_jax():
    """A tiny run in a fresh process leaves no JAX module behind."""
    code = ("import torch; from benchmark import run; from benchmark.tests.tiny import tiny_spec;"
            "run.run_cell(tiny_spec('atari-train'), 1, 0.1, True, torch.device('cpu'),"
            " log=lambda *a, **k: None); print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
