"""Where pass A's two consumer warpgroups are in their tiles, on one CUDA card.

    python -m semanticsearch_tpu_torch.tools.pass_a_phase [--reps N] [--out FILE.jsonl]

Pass A's wgmma kernel (``csrc/segtopk.cu``) runs two consumer warpgroups
over the same corpus tiles; at the end of every tile each drains its
multiplies and selects (its epilogue). The overlap schedule (mode 1) exists
so that one warpgroup's epilogue falls under the other's multiplies. This
runner shows whether it does.

It builds ``csrc/segtopk.cu`` once more with ``-DQC_PHASE_PROBE``, which
makes the first CTA's two consumer warpgroups record the SM clock at which
each starts and ends its epilogue, at every tile, and the global nanosecond
timer at each start (``csrc/qc_mainloop.cuh``). Then, at the shard shape of
``chip_smoke.py`` phase 4 (32,768 queries x 1,250,000 rows x 384 bf16,
32-row segments, k_sel 11), it runs pass A on rings of 4 (mode 0's plan)
to 7 stages (the overlap schedule's). For each it prints one JSON line: the
time by CUDA events of the ordinary build (``ms``, two readings, the rings
timed in one order and then the reverse), whether the result equals mode
0's bit for bit, and from the probe build: the tile period in cycles and
in ns, the SM clock they imply, each warpgroup's epilogue as a share of a
tile, how many tiles warpgroup 1 starts its epilogues after warpgroup 0
(10th, 50th and 90th percentile), and the share of warpgroup 0's epilogue
time that warpgroup 1 spends in its own epilogue too; and the card's SM
clock and power draw as ``nvidia-smi`` samples them every 50 ms while the
ordinary build runs back to back for about two seconds (medians).
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

PROBE_TILES = 4096  # qc::PROBE_TILES


def _build_probe():
    """The probe build of csrc/segtopk.cu, loaded."""
    from semanticsearch_tpu_torch.ops import _build

    src = _build._CSRC / "segtopk.cu"
    flags = [*_build.NVCC_FLAGS, "-DQC_PHASE_PROBE"]
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(_build._CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(flags).encode())
    out = _build.BUILD_DIR / f"libsegtopk-probe-{digest.hexdigest()[:12]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *flags, "-I", str(_build._CSRC), "-o",
                        str(out), str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(out))


def _overlap(a0, a1, b0, b1) -> float:
    """Total length shared by two sorted lists of intervals [a0, a1) and
    [b0, b1)."""
    i = j = 0
    total = 0.0
    while i < len(a0) and j < len(b0):
        total += max(0.0, min(a1[i], b1[j]) - max(a0[i], b0[j]))
        if a1[i] < b1[j]:
            i += 1
        else:
            j += 1
    return total


def phase_stats(clk: np.ndarray) -> dict:
    """Epilogue timing of the two warpgroups from the probe's records,
    shaped (warpgroup, start cycle / end cycle / start ns, tile)."""
    n = int((clk[0, 0] != 0).sum())
    s0, e0, s1, e1 = (clk[w, edge, :n].astype(np.float64)
                      for w in (0, 1) for edge in (0, 1))
    ns0 = clk[0, 2, :n].astype(np.float64)
    period = float(np.median(np.diff(s0)))
    lag = (s1 - s0) / period
    return {
        "tiles": n,
        "tile_cycles": period,
        "tile_ns": float(np.median(np.diff(ns0))),
        "sm_ghz": float((s0[-1] - s0[0]) / (ns0[-1] - ns0[0])),
        "epilogue_share": [float(np.median(e0 - s0)) / period,
                           float(np.median(e1 - s1)) / period],
        "wg1_behind_tiles": [float(np.percentile(lag, p)) for p in (10, 50, 90)],
        "both_in_epilogue_share": _overlap(s0, e0, s1, e1) / float((e0 - s0).sum()),
    }


def _sampled(fn, seconds: float = 2.0) -> dict:
    """Median SM clock (MHz) and power draw (W) that nvidia-smi reads while
    fn() runs back to back for about ``seconds``."""
    import time

    import torch

    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, text=True)
    try:
        end = time.monotonic() + seconds
        while time.monotonic() < end:
            fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate()[0]
    rows = [[float(x) for x in line.split(",")]
            for line in out.splitlines()[2:] if line.count(",") == 1]
    mhz, watts = np.median(np.asarray(rows), axis=0) if rows else (0.0, 0.0)
    return {"smi_sm_mhz": float(mhz), "smi_power_w": float(watts),
            "smi_samples": len(rows)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("pass_a_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from chip_smoke import time_ms
    from semanticsearch_tpu_torch.data import synth
    from semanticsearch_tpu_torch.ops import _build, topk

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    n, d, seg_rows, k_sel = 1_250_000, 384, 32, 11
    corpus = synth.corpus(n, d, torch.bfloat16, "cuda")
    queries = synth.corpus(32768, d, torch.bfloat16, "cuda", start=20_000_000)
    n_segs = -(-n // seg_rows)
    base = topk.pass_a_plan(32768, d, k_sel, n_segs, seg_rows)
    rings = list(range(base["stages"], topk.OVERLAP_MAX_STAGES + 1))

    regular = _build.load("segtopk")
    probe = _build_probe()
    probe.segtopk_phase_probe.restype = ctypes.c_int
    probe.segtopk_phase_probe.argtypes = [ctypes.c_void_p]
    want = topk.segtopk_pass_a(queries, corpus, n, seg_rows, k_sel)
    planner = topk.overlap_plan

    def run(stages):
        topk.overlap_plan = lambda *a, **k: {**base, "stages": stages}
        try:
            return topk.segtopk_pass_a_overlap(queries, corpus, n, seg_rows,
                                               k_sel)
        finally:
            topk.overlap_plan = planner

    rows = {s: {"stages": s, "ms": [], "card": smi} for s in rings}
    for order in (rings, rings[::-1]):
        for s in order:
            rows[s]["ms"].append(time_ms(lambda: run(s), reps=args.reps))
    clk = np.zeros((2, 3, PROBE_TILES), np.int64)
    for s in rings:
        got = run(s)
        rows[s]["bit_identical"] = bool(torch.equal(got[0], want[0])
                                        and torch.equal(got[1], want[1]))
        _build._LIBS["segtopk"] = probe
        try:
            _build.check(probe.segtopk_phase_probe(clk.ctypes.data), "probe")
            run(s)
            torch.cuda.synchronize()
            _build.check(probe.segtopk_phase_probe(clk.ctypes.data), "probe")
        finally:
            _build._LIBS["segtopk"] = regular
        rows[s].update(phase_stats(clk))
        rows[s].update(_sampled(lambda: run(s)))
    for row in rows.values():
        print(json.dumps(row), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
