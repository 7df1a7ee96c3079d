"""Nothing a run loads has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``semanticsearch_tpu`` (compared whole: the program,
``semanticsearch_tpu_torch``, begins with the last), and the reference
imports nothing of the program."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench.harness import FORBIDDEN_MODULES, forbidden_loaded
from perfbench.tests import tiny

HERE = Path(__file__).resolve().parents[1]


def test_names_compared_whole():
    assert forbidden_loaded(["semanticsearch_tpu_torch.index.engine",
                             "jaxtyping", "flaxen"]) == []
    assert forbidden_loaded(["semanticsearch_tpu.index", "jax.numpy",
                             "flax"]) == ["flax", "jax.numpy",
                                          "semanticsearch_tpu.index"]
    assert set(FORBIDDEN_MODULES) == {"jax", "jaxlib", "flax",
                                      "semanticsearch_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    p for p in HERE.rglob("*.py") if "tests" not in p.parts),
    ids=lambda p: str(p.relative_to(HERE)))
def test_no_forbidden_import_in_sources(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & set(FORBIDDEN_MODULES)
    if "reference" in path.parts:
        assert "semanticsearch_tpu_torch" not in tops


_RUN = """
import json, sys, tempfile
sys.path.insert(0, {repo!r})
from perfbench.tests import tiny
with tempfile.TemporaryDirectory() as tmp:
    root = tiny.make_root(tmp)
    for cell in {cells!r}:
        rc, _ = tiny.run_cell(root, cell)
        assert rc == 0, (cell, rc)
from perfbench.harness import forbidden_loaded
print(json.dumps(sorted(m for m in sys.modules if "." not in m)))
print(json.dumps(forbidden_loaded()))
"""


def test_a_run_loads_no_forbidden_module():
    cells = tiny.cells()
    out = subprocess.run(
        [sys.executable, "-c", _RUN.format(repo=str(tiny.REPO),
                                           cells=cells)],
        capture_output=True, text=True, timeout=900, cwd=tiny.REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    tops, bad = (json.loads(x) for x in out.stdout.strip().splitlines()[-2:])
    assert "semanticsearch_tpu_torch" in tops
    assert bad == []


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import perfbench.reference.encoder, perfbench.reference.search,"
            " perfbench.reference.train, perfbench.reference.tokenizer\n"
            "print(sorted(m for m in sys.modules"
            " if m.split('.')[0].startswith('semanticsearch')))"
            % str(tiny.REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_result_without_the_program_or_a_card(tmp_path):
    """In a directory holding only ``BENCHMARK.json`` and ``perfbench/``,
    and on a machine without a card, a run exits non-zero and prints no
    result."""
    import shutil

    shutil.copytree(tiny.REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(tiny.REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "minilm-l6-bf16.search_b8k", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
