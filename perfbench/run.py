"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The run makes its inputs and weights from
``--seed``, warms up the shapes its traffic uses (set-up, timed from the
start of this process), measures for ``--seconds``, checks what the timed
path produced against the plain reference, and prints one JSON object as
the last line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``, each compared number beside its limit (also the last lines of
standard error). It exits non-zero and prints no result without the CUDA
cards the cell asks for, or when a forbidden module was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _environment() -> None:
    """Caches inside the checkout, at fixed paths; no library may pull in
    JAX or Flax by itself."""
    cache = ROOT / "build" / "perfbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device=None, t_start=None, root=None) -> int:
    """``device`` None runs on the cards (and refuses without them); the
    tests pass "cpu" to drive a run at a small size, and ``root`` a
    checkout of their own."""
    args = parse(argv)
    _environment()
    from perfbench.harness import (Benchmark, checks_line, forbidden_loaded,
                                   read_per_layer, result)
    from perfbench.trace import Tracer

    bench = Benchmark(ROOT if root is None else root)
    cell = bench.cell(args.workload)
    import torch

    if device is None:
        if not torch.cuda.is_available():
            print("no CUDA device: this benchmark measures the card",
                  file=sys.stderr)
            return 3
        if torch.cuda.device_count() < cell["chips"]:
            print(f"{cell['name']} needs {cell['chips']} CUDA devices, "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return 3
        device = "cuda"
    ctx = Context(bench, cell, args, torch.device(device),
                  Tracer(bool(args.trace)),
                  T_START if t_start is None else t_start)
    mix = ctx.mix
    out = bench.runner(mix["kind"]).run(ctx)

    bad = forbidden_loaded()
    if bad:
        print("forbidden modules loaded in this process: " + ", ".join(bad),
              file=sys.stderr)
        return 4
    compared = out["compared"]
    correct = (out["failed"] == 0 and
               all(v <= lim for _, v, lim in compared))
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(ctx.device)
                    if ctx.device.type == "cuda" else "cpu"),
           "count": cell["chips"],
           "memory_peak_bytes": int(out["memory_peak_bytes"])}
    breakdown = None
    if args.trace:
        s = ctx.tracer.summary
        if s is not None:
            dev["busy_s"] = s.busy_s
            dev["window_s"] = s.window_s
            breakdown = {"device_ops": s.device_ops,
                         "idle_gaps": s.idle_gaps}
        run = dict(out["layer"], trace=s, config=ctx.config, mix=mix)
        metrics = read_per_layer(bench, cell["name"], run)
    else:
        values = dict(out["e2e"], setup_s=out["setup_s"])
        metrics = {m["name"]: {"value": float(values[m["name"]]),
                               "unit": m["unit"]}
                   for m in bench.end_to_end(cell["name"])}
    line = result(correct, out["attempted"], out["failed"], metrics, dev,
                  compared, breakdown)
    sys.stderr.write(f"set-up {out['setup_s']:.1f} s, whole run "
                     f"{time.perf_counter() - ctx.t_start:.1f} s\n")
    sys.stderr.write(f"correct {correct}: {checks_line(compared)}\n")
    for name, value, limit in compared:
        sys.stderr.write(f"{name} {value!r} limit {limit!r}\n")
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


class Context:
    """What a kind's run gets: the cell, its configuration, mix and limits,
    the run's arguments, the device, the tracer and the process's start."""

    def __init__(self, bench, cell, args, device, tracer, t_start) -> None:
        self.bench = bench
        self.cell = cell
        self.config = bench.config(cell["config"])
        self.mix = bench.traffic(cell["traffic"])
        self.limits = bench.limits(cell["name"])
        self.seed = args.seed
        self.seconds = args.seconds
        self.trace = bool(args.trace)
        self.device = device
        self.tracer = tracer
        self.t_start = t_start


if __name__ == "__main__":
    sys.exit(main())
