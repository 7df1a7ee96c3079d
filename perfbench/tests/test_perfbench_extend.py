"""A later change adds a configuration, a traffic mix, a cell and a
per-layer metric with new files and new entries only: the harness finds
them by name, and no file already there is edited."""
import hashlib
import json

from perfbench.tests import tiny


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "perfbench").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_are_found(tmp_path, capsys):
    root = tiny.make_root(tmp_path)
    before = _digests(root)
    bench = root / "perfbench"
    # a new configuration: the same model with two heads
    cfg = json.loads((bench / "configs" / "minilm-l6-bf16.json").read_text())
    cfg["num_attention_heads"] = 2
    (bench / "configs" / "narrow-heads.json").write_text(json.dumps(cfg))
    # a new mix of an existing kind: smaller batches
    mix = json.loads((bench / "traffic" / "search_b8k.json").read_text())
    mix.update(batch=32, rows_per_forward=16)
    (bench / "traffic" / "search_b32.json").write_text(json.dumps(mix))
    (bench / "limits" / "narrow-heads.search_b32.json").write_text(
        (bench / "limits" / "minilm-l6-bf16.search_b8k.json").read_text())
    # a new per-layer metric and its reader
    (bench / "metrics" / "traced_queries.py").write_text(
        'LAYER = "search step"\nMOVES = "search_qps"\n\n\n'
        'def read(run):\n    return run.get("queries")\n')
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "narrow-heads", "source": "x",
                            "file": "perfbench/configs/narrow-heads.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "narrow-heads.search_b32",
                              "config": "narrow-heads",
                              "traffic": "search_b32", "chips": 1,
                              "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "search_qps" or m["name"] == "search_p95_ms":
            m["workloads"].append("narrow-heads.search_b32")
    spec["per_layer"].append({"name": "traced_queries", "unit": "queries",
                              "better": "higher", "source": "program_counter",
                              "layer": "search step", "moves": "search_qps",
                              "workloads": ["narrow-heads.search_b32"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    # long enough for the traced batches on a loaded machine
    rc, line = tiny.run_cell(root, "narrow-heads.search_b32", trace=1,
                             seconds=5.0, capsys=capsys)
    assert rc == 0 and line["correct"]
    assert line["metrics"]["traced_queries"]["value"] == 2 * 32
    rc, line = tiny.run_cell(root, "narrow-heads.search_b32", trace=0,
                             capsys=capsys)
    assert rc == 0 and set(line["metrics"]) == {"setup_s", "search_qps",
                                                "search_p95_ms"}
    after = _digests(root)
    assert all(after[p] == d for p, d in before.items())
