"""Nothing the harness runs imports JAX or the JAX package, and the
reference imports nothing of the program; top-level names are compared
whole (``repro_torch`` begins with ``repro``)."""

import ast
import subprocess
import sys

import pytest

from conftest import ROOT

BANNED = {"jax", "jaxlib", "flax", "repro"}
HARNESS = sorted(p for p in (ROOT / "perfbench").rglob("*.py")
                 if "tests" not in p.parts)
REFERENCE = [ROOT / "perfbench" / "reference.py",
             *sorted((ROOT / "perfbench" / "models").glob("*.py"))]


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", HARNESS, ids=lambda p: p.name)
def test_no_jax_in_the_harness(path):
    assert not _top_level_imports(path) & BANNED


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_program(path):
    assert "repro_torch" not in _top_level_imports(path)
    assert "repro_torch" not in path.read_text().replace(
        "repro_torch.sparse.graphs", "")


def test_whole_names_are_compared():
    from perfbench import harness
    assert harness.forbidden_modules(["repro_torch", "repro_torch.core",
                                      "reproduce", "jaxtyping"]) == []
    assert harness.forbidden_modules(["repro.core", "jax.numpy", "jaxlib",
                                      "flax.linen", "torch"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_a_run_loads_no_jax(tiny_root):
    """A whole tiny run in a fresh process (on the CPU, past the look for
    a card), then the modules it loaded."""
    code = f"""
import sys, time, pathlib
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
import torch
from perfbench import harness
cell = harness.load_cell(pathlib.Path({str(tiny_root)!r}), "gcn-tiny")
r = harness.run_cell(cell, 5, 0.2, False, [torch.device("cpu")],
                     time.perf_counter(), log=lambda s: None)
assert r["correct"], r
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and not loaded & BANNED


def test_run_exits_without_a_card_and_prints_no_result():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(ROOT / "perfbench/run.py"),
                          "--workload", "gcn-amazon-replica-f32", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr
