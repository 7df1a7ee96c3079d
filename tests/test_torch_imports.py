"""semanticsearch_tpu_torch imports neither JAX nor the JAX package.

Every module of the port is imported in a fresh interpreter in which
``import jax`` and ``import semanticsearch_tpu`` fail, so a stray import
anywhere in the port is an error here."""
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import semanticsearch_tpu_torch

_ROOT = Path(__file__).resolve().parent.parent


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        semanticsearch_tpu_torch.__path__, "semanticsearch_tpu_torch."))


def test_port_has_the_slice_modules():
    mods = set(_port_modules())
    for name in ("core.config", "core.logging", "data.tsv", "data.synth",
                 "models.tokenizer", "models.encoder", "models.convert",
                 "ops._build", "ops.topk", "ops.flash_attention",
                 "index.engine", "index.bm25", "index.rrf", "index.builder",
                 "index.query_engine", "index.delta", "train.metrics",
                 "train.fusion", "ops.similarity", "chunking.cleaning",
                 "chunking.segmenter", "chunking.naive", "chunking.dp_segment",
                 "chunking.splitter", "chunking.grouping",
                 "chunking.pipeline"):
        assert f"semanticsearch_tpu_torch.{name}" in mods


@pytest.mark.parametrize("blocked", [("jax",), ("semanticsearch_tpu",),
                                     ("jax", "semanticsearch_tpu")])
def test_port_imports_without(blocked):
    code = "\n".join([
        "import sys",
        *(f"sys.modules[{b!r}] = None" for b in blocked),
        "import importlib",
        *(f"importlib.import_module({m!r})" for m in _port_modules()),
        "assert not any(m == 'jax' or m.startswith(('jax.', 'flax', "
        "'semanticsearch_tpu.')) for m in sys.modules if sys.modules[m])",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
