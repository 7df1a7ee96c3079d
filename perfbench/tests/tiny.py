"""A checkout of the benchmark at a small size, for runs on the CPU: the
real files under ``perfbench/`` and ``BENCHMARK.json`` copied into a
temporary root, each configuration cut to a few narrow layers and a small
corpus and each mix to small batches. The program is the repository's."""
from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

CONFIG = dict(vocab_size=1000, hidden_size=32, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=64,
              max_position_embeddings=64)
INDEX = dict(rows=5000, block_rows=1024, seg_split=4)
# eight of a batch's 64 queries sampled, so that a fault in half of a
# batch shows even when a loaded machine completes a single batch
MIX = dict(batch=64, rows_per_forward=32, pool_batches=3, max_batches=64,
           trace_from_batch=1, trace_batches=2, vocab=2000,
           control_batches=20, sample_per_batch=8)
TRAIN_MIX = dict(batch=8, chunk_words=[4, 40], pool_steps=4, min_steps=2,
                 trace_steps=2, vocab=2000)
TRAINER = dict(max_len_query=16, max_len_chunk=48)
# training's gaps at this size, between the program's readings (loss
# 2.5e-3 to 4.2e-3, first gradient 3.8e-3 to 1.4e-2, change 3.8e-3 to
# 1.1e-2 over four seeds) and the fp8 control's (2.4e-2, 3.8e-2 and
# 2.2e-2 and up over three): a narrow model in bf16 reads higher than the
# full width does, so the cell's own limits are not for this size
TINY_LIMITS = {"minilm-l6-bf16.train_b256": {
    "loss_gap": 0.012, "grad_gap": 0.025, "update_gap": 0.016}}


def cells():
    """Every cell of ``BENCHMARK.json``."""
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    return [w["name"] for w in spec["workloads"]]


def make_root(tmp) -> Path:
    root = Path(tmp)
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        p = root / c["file"]
        cfg = json.loads(p.read_text())
        cfg.update(CONFIG)
        cfg["index"].update(INDEX)
        p.write_text(json.dumps(cfg))
    for p in (root / "perfbench" / "traffic").glob("*.json"):
        mix = json.loads(p.read_text())
        if mix["kind"] == "train":
            mix.update(TRAIN_MIX)
            mix["trainer"].update(TRAINER)
        else:
            mix.update({k: v for k, v in MIX.items() if k in mix})
        p.write_text(json.dumps(mix))
    for cell, lim in TINY_LIMITS.items():
        (root / "perfbench" / "limits" / f"{cell}.json").write_text(
            json.dumps(lim))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def run_cell(root, workload: str, seed: int = 123, seconds: float = 1.0,
             trace: int = 0, capsys=None):
    """Runs one cell on the CPU; returns (exit code, result line or
    None)."""
    from perfbench import run

    rc = run.main(["--workload", workload, "--seed", str(seed),
                   "--seconds", str(seconds), "--trace", str(trace)],
                  device="cpu", t_start=time.perf_counter(), root=root)
    line = None
    if capsys is not None:
        out = capsys.readouterr().out.strip().splitlines()
        line = json.loads(out[-1]) if out and rc == 0 else None
    return rc, line
