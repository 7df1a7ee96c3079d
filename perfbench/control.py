"""The control of a cell's check: the plain reference put in the
program's place, computed one precision step below the configuration's
(the configuration's ``control_precision``: fp8 for bf16, TF32 for f32),
and judged as a run judges the program. Its readings set the upper end of
each limit; they must fail the cell's check.

    python3 perfbench/control.py --workload <cell> --seeds 1 2 3

Runs on the card (or, in the tests, on the CPU at a small size) at the
cell's own sizes: the same corpus, weights and traffic as a run of that
seed, and as many answers as a run keeps. It prints one JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None, device=None, root=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", default="",
                    help="a training cell: plant 'unchanged' or "
                    "'half_batch' in the reference put in the program's "
                    "place")
    args = ap.parse_args(argv)
    import torch

    from perfbench.harness import Benchmark
    from perfbench.run import Context
    from perfbench.trace import Tracer

    bench = Benchmark(ROOT if root is None else root)
    cell = bench.cell(args.workload)
    if device is None:
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 3
        device = "cuda"
    failed_all = True
    for seed in args.seeds:
        ns = argparse.Namespace(seed=seed, seconds=0.0, trace=0)
        ctx = Context(bench, cell, ns, torch.device(device), Tracer(False),
                      0.0)
        # a planted fault is read on the float64 reference
        prec = "f64" if args.fault else ctx.config["control_precision"]
        runner = bench.runner(ctx.mix["kind"])
        compared = (runner.control(ctx, prec, args.fault) if args.fault
                    else runner.control(ctx, prec))
        passed = all(v <= lim for _, v, lim in compared)
        failed_all &= not passed
        print(json.dumps({"workload": cell["name"], "seed": seed,
                          "precision": prec, "fault": args.fault,
                          "passes": passed,
                          "checks": {n: {"value": v, "limit": lim}
                                     for n, v, lim in compared}}),
              flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
