"""What every cell shares: finding a cell's files by the names in
``BENCHMARK.json``, the per-layer readers, the import guard and the result
line.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by name:

- ``perfbench/configs/<config>.json`` (the path is the configuration's
  ``file`` in ``BENCHMARK.json``): the sizes as run;
- ``perfbench/traffic/<traffic>.json``: a mix's parameters; its ``kind``
  names the module, ``perfbench/kinds/<kind>.py``, that runs it;
- ``perfbench/limits/<cell>.json``: the limits of the numbers that decide
  the cell's ``correct``;
- ``perfbench/metrics/<metric>.py``: a per-layer metric's reader, a
  function ``read(run)`` that returns a number, or None when the run has
  nothing for it to read.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that may not be loaded in a run's process
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "semanticsearch_tpu")


class Benchmark:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: Path = ROOT) -> None:
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.bench_dir = self.root / "perfbench"

    def cell(self, name: str) -> dict:
        for cell in self.spec["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads(
            (self.bench_dir / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        return json.loads(
            (self.bench_dir / "limits" / f"{cell}.json").read_text())

    def runner(self, kind: str):
        return load_module(self.bench_dir / "kinds" / f"{kind}.py",
                           f"perfbench.kinds.{kind}")

    def end_to_end(self, cell: str) -> List[dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.spec["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str) -> List[dict]:
        """The per-layer metrics this cell reports: those that list it, and
        those with no list whose end-to-end metric the cell reports."""
        moved = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in moved)]

    def reader(self, metric: str):
        return load_module(self.bench_dir / "metrics" / f"{metric}.py",
                           f"perfbench.metrics.{metric}").read


def load_module(path: Path, name: str):
    """A module by file path (metric files carry dots in their names)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_loaded(modules=None) -> List[str]:
    """Loaded modules whose top-level name, compared whole, is one that a
    run may not load."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names
                   if m.split(".", 1)[0] in FORBIDDEN_MODULES})


def read_per_layer(bench: Benchmark, cell: str, run: dict) -> Dict[str, dict]:
    """Every per-layer metric of the cell that its reader finds."""
    out = {}
    for m in bench.per_layer(cell):
        value = bench.reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def checks_line(compared: List[tuple]) -> str:
    return "; ".join(f"{n} {v!r} limit {lim!r}" for n, v, lim in compared)


def result(correct: bool, attempted: int, failed: int, metrics: dict,
           device: dict, compared: List[tuple],
           breakdown: Optional[dict] = None) -> dict:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in compared}
    return out
