"""Time the f32 top-k schedules' 3xTF32 main loop against variants of it,
in turns, on one CUDA card: what holds the loop, by taking its parts away.

    python -m semanticsearch_tpu_torch.tools.tf32_variants [--rounds N]

Each variant is ``csrc/tf32_mainloop.cuh`` changed by one text
replacement, built with ``segtopk.cu`` and ``topk_fused.cu`` under
``build/tf32_variants/<name>/`` (one nvcc per library, all at once) and
timed at the f32 shard shape of ``chip_smoke.py`` phase 7 (pass A at
32,768 x 1,250,000 x 384, k_sel 11; the fused top-200 at 16,384 queries),
the variants in turns, the order reversed every round:

* ``kept``: the main loop as it is (the corpus box raw, its lo plane
  written beside it by ``tf32x3::split_stage_lo``);
* ``hi_in_place``: the corpus box split in place as well
  (``tf32x3::split_stage``, hi rounded, as the similarity kernel does);
* ``no_split``: no split at all (the lo plane never written: wrong
  values), the split's cost;
* ``one_product``: only the hi x hi product of each step (wrong values;
  the same loads, split and L2 traffic), the products' cost.

Each row also gives pass A's largest error on unit rows (300 queries over
20,000 rows, k_sel 41) against the plain f32 version. Prints one JSON
object with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

LIBS = ("segtopk", "topk_fused")
SPLIT_LO = ("    tf32x3::split_stage_lo(b, b + qc::STAGE_BYTES, qc::STAGE_BYTES / 4, "
            "tid, THREADS);\n")
STEP = "      tf32x3::mma_step(big, small, hi, lo, bh, bl, false);"
VARIANTS = {
    "kept": None,
    "hi_in_place": (SPLIT_LO, SPLIT_LO.replace("split_stage_lo", "split_stage")),
    "no_split": (SPLIT_LO, ""),
    "one_product": (STEP, "      tf32x3::wgmma_m64n128k8_rs(big, hi, bh, 1);"),
}


def build(csrc: Path, out_dir: Path) -> dict:
    """{(variant, library): loaded library}, every variant built at once."""
    from semanticsearch_tpu_torch.ops import _build

    header = (csrc / "tf32_mainloop.cuh").read_text()
    procs = {}
    for name, change in VARIANTS.items():
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        for f in list(csrc.glob("*.cuh")) + [csrc / f"{lib}.cu" for lib in LIBS]:
            (d / f.name).write_text(f.read_text())
        if change is not None:
            old, new = change
            if old not in header:
                raise SystemExit(f"tf32_variants: {name}: the main loop changed; "
                                 f"its replacement no longer applies")
            (d / "tf32_mainloop.cuh").write_text(header.replace(old, new))
        for lib in LIBS:
            so = d / f"lib{lib}.so"
            procs[(name, lib)] = (so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(d / f"{lib}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"tf32_variants: nvcc failed for {key}:\n{log}")
        libs[key] = ctypes.CDLL(str(so))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("tf32_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from chip_smoke import F32_SHARD, time_ms
    from semanticsearch_tpu_torch.data import synth
    from semanticsearch_tpu_torch.ops import _build, topk

    libs = build(_build._CSRC, _build.BUILD_DIR.parent / "tf32_variants")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    n, d, q, qf = F32_SHARD
    corpus = synth.corpus(n, d, torch.float32, "cuda")
    queries = synth.corpus(q, d, torch.float32, "cuda", start=20_000_000)
    g = torch.Generator(device="cuda").manual_seed(5)
    uq, uc = (torch.randn(s, generator=g, device="cuda") for s in ((300, d), (20000, d)))
    uq, uc = uq / uq.norm(dim=1, keepdim=True), uc / uc.norm(dim=1, keepdim=True)
    pv, _ = topk.segtopk_pass_a_plain(uq, uc, 20000, 32, 41)
    res = {"card": smi, "variants": {name: [] for name in VARIANTS}}
    order = list(VARIANTS)
    for rnd in range(args.rounds):
        for name in (order if rnd % 2 == 0 else order[::-1]):
            for lib in LIBS:
                _build._LIBS[lib] = libs[(name, lib)]
            row = {
                "pass_a_ms": time_ms(lambda: topk.segtopk_pass_a(
                    queries, corpus, n, 32, 11), reps=3),
                "fused_ms": time_ms(lambda: topk.topk_scores_fused(
                    queries[:qf], corpus, 200), reps=3),
                "unit_err": float((topk.segtopk_pass_a(uq, uc, 20000, 32, 41)[0]
                                   - pv).abs().max()),
            }
            res["variants"][name].append(row)
            print(name, row, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
