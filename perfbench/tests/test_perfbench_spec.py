"""``BENCHMARK.json`` keeps to its contract: names, units and fields, and
every file it names is there."""
import json
import re

import pytest

from perfbench.harness import Benchmark, load_module
from perfbench.tests import tiny

SPEC = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "perfbench/run.py"]
    assert SPEC["paths"] == ["perfbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            yield group, entry


@pytest.mark.parametrize("group,entry", list(_names()),
                         ids=lambda x: x if isinstance(x, str) else x["name"])
def test_names_and_units(group, entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer") + (("source",) if group == "configs"
                                   else ()):
        if key in entry:
            assert LINE.match(entry[key])
    if group == "configs":
        assert set(entry) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in entry["reduced"])
        assert len(entry["reduced"]) <= 16
        assert (tiny.REPO / entry["file"]).exists()
        assert entry["file"].startswith("perfbench/")
    if group == "workloads":
        assert set(entry) == {"name", "config", "traffic", "chips", "why"}
        assert entry["name"] == f"{entry['config']}.{entry['traffic']}"
        assert entry["chips"] in (1, 4)
    if group == "end_to_end":
        assert set(entry) - {"workloads"} == {"name", "unit", "better",
                                              "bound", "source"}
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    if group == "per_layer":
        assert set(entry) - {"workloads"} == {
            "name", "unit", "better", "source", "layer", "moves"}
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")


def test_names_are_unique():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_reports_what_it_must():
    bench = Benchmark(tiny.REPO)
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        e2e = {m["name"] for m in bench.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = bench.per_layer(w["name"])
        assert layer
        for m in layer:
            assert m["moves"] in e2e
        assert bench.limits(w["name"])
        assert bench.traffic(w["traffic"])["kind"]
        assert bench.config(w["config"])
    for m in SPEC["per_layer"]:
        mod = load_module(tiny.REPO / "perfbench" / "metrics"
                          / f"{m['name']}.py", f"perfbench.metrics.{m['name']}")
        assert mod.LAYER == m["layer"] and mod.MOVES == m["moves"]
        for cell in m.get("workloads", []):
            assert cell in {w["name"] for w in SPEC["workloads"]}
    setup = [m for m in SPEC["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] == 0.25 and "workloads" not in setup[0]


def test_a_share_is_in_percent():
    for m in SPEC["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"] \
                or "roofline" in m["name"]:
            assert m["unit"] == "%"


def test_check_time_fits():
    runs = 2 + 14 * 24
    total = runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
