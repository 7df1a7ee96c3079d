"""Time the top-k, flash-attention and similarity kernels of a source tree
on one CUDA card.

    python -m semanticsearch_tpu_torch.tools.kernel_profile \
        [--tree DIR] [--profiler] [--only PREFIX,...] [--label NAME] \
        [--out FILE.jsonl]

``chip_smoke.py`` is the record of the kernels' times; this runner adds the
two things it does not do. ``--tree`` names the root of another checkout
(default: the one this file lies in), whose package, kernels and
``chip_smoke.time_ms`` are then the ones used, so two versions can be timed
in turns on one card: run the script once per tree, all in one shell
command; every kernel of the tree is built first, one nvcc per source.
``--profiler`` also runs each shape once (the similarity shapes five
times, reported per call) under ``torch.profiler`` and reports the device
time by kernel name (selection and merge kernels apart, and free of the
host's launch path, which CUDA events include).

Shapes, those of ``chip_smoke.py`` phase 4: pass A at the shard size
(32,768 queries x 1,250,000 x 384 bf16, 32-row segments, k_sel 11), in
the default schedule and in the overlap schedule, and at the serve shape
(64 queries x 20,000 rows, k_sel 41); the fused top-k at
16,384 queries (k = 200) over the shard and at the live-search shape
(10,000 queries x 22,000 rows, k = 200); flash attention on the
encoder's transposed (B, T, H, Dh) views, in bf16 (``flash_*``) and f32
(``flash_f32_*``), at the serve shape (B 256, H 12, T 256, Dh 32, 40-256
real keys), at T = 1024 (B 2, 600-1000 real), at the chunking batch (B
2,048, T 64, 3-12 real) and at head widths 256 and 320 (the wide path; B
64, H 8, T 256, 40-256 real), and for these also the host's time per call
(``*_host_ms``: 50 calls queued without a wait), which CUDA events include
whenever it is the longer; the similarity kernel at
``chip_smoke.SIM_SHAPES`` on unit f32 rows (the long document's 4096
bucket with 3,939 real rows, and 256
documents of 64 rows); and the two f32 schedules (the shapes of
``chip_smoke.py`` phase 7) on the f32 shard (1,250,000 x 384): pass A at
32,768 queries (k_sel 11) and at the serve shape (64 x 20,000, k_sel 41),
the fused top-k at 16,384 queries (k = 200) and at the f32 live round's
shape (10,000 queries over 20,000 rows, k = 712). Pass B runs on pass A's
own segments: ``pass_b_shard`` (32,768 queries, k_sel 11, k 10),
``pass_b_serve`` (64 x 20,000, k_sel 41, k 40; also ``*_queued_ms``, 50
calls queued between two events over 50, the device's time a call apart
from the host's), ``pass_b_hot`` (64 distinct queries repeated to 32,768:
every query picks the same segments) and ``f32_pass_b_shard``. ``--only``
keeps the shapes whose names start with one of the given prefixes
(``pass_a``, ``pass_b``, ``overlap``, ``fused``, ``flash``, ``sim``,
``f32``); a shard is built only when a shape needs it.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


# flash attention's shapes (name, B, H, T, Dh, real keys a row), in bf16
# (flash_<name>) and f32 (flash_f32_<name>)
FLASH_SHAPES = [("serve", 256, 12, 256, 32, (40, 256)),
                ("t1024", 2, 12, 1024, 32, (600, 1000)),
                ("chunk", 2048, 12, 64, 32, (3, 12)),
                ("dh256", 64, 8, 256, 256, (40, 256)),
                ("dh320", 64, 8, 256, 320, (40, 256))]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--profiler", action="store_true")
    ap.add_argument("--only", default="")
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    for mod in [m for m in sys.modules if m.startswith("semanticsearch_tpu_torch")]:
        del sys.modules[mod]
    import torch

    if not torch.cuda.is_available():
        print("kernel_profile: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import LONG_DOC_SENTENCES, SIM_SHAPES, time_ms
    from semanticsearch_tpu_torch.data import synth
    from semanticsearch_tpu_torch.ops import _build, topk
    from semanticsearch_tpu_torch.ops import flash_attention as fa
    from semanticsearch_tpu_torch.ops import similarity as sim

    assert Path(topk.__file__).resolve().is_relative_to(tree), topk.__file__
    _build.build_all()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    res = {"tree": str(tree), "label": args.label or tree.name, "card": smi}
    only = tuple(p for p in args.only.split(",") if p)

    def wanted(name):
        return not only or name.startswith(only)

    runs = {}
    if any(wanted(name) for name in ("pass_a_shard", "overlap_shard",
                                     "pass_a_serve", "fused_shard",
                                     "fused_live", "pass_b_shard",
                                     "pass_b_serve", "pass_b_hot")):
        n, d = 1_250_000, 384
        corpus = synth.corpus(n, d, torch.bfloat16, "cuda")
        queries = synth.corpus(32768, d, torch.bfloat16, "cuda",
                               start=20_000_000)
        small = corpus[:20000].contiguous()
        live = corpus[:22000].contiguous()
        runs.update({
            "pass_a_shard": lambda: topk.segtopk_pass_a(queries, corpus, n,
                                                        32, 11),
            "overlap_shard": lambda: topk.segtopk_pass_a_overlap(
                queries, corpus, n, 32, 11),
            "pass_a_serve": lambda: topk.segtopk_pass_a(queries[:64], small,
                                                        20000, 32, 41),
            "fused_shard": lambda: topk.topk_scores_fused(queries[:16384],
                                                          corpus, 200),
            "fused_live": lambda: topk.topk_scores_fused(queries[:10000],
                                                         live, 200),
        })
        if any(wanted(name) for name in ("pass_b_shard", "pass_b_serve",
                                         "pass_b_hot")):
            seg = topk.segtopk_pass_a(queries, corpus, n, 32, 11)[1]
            serve_seg = topk.segtopk_pass_a(queries[:64], small, 20000, 32,
                                            41)[1]
            hot_q = queries[:64].repeat(512, 1)
            hot_seg = topk.segtopk_pass_a(hot_q, corpus, n, 32, 11)[1]
            runs.update({
                "pass_b_shard": lambda: topk.pass_b_rescore(
                    queries, corpus, seg, n, 32, 10),
                "pass_b_serve": lambda: topk.pass_b_rescore(
                    queries[:64], small, serve_seg, 20000, 32, 40),
                "pass_b_hot": lambda: topk.pass_b_rescore(
                    hot_q, corpus, hot_seg, n, 32, 10),
            })
    if any(wanted(name) for name in ("f32_pass_a_shard", "f32_pass_a_serve",
                                     "f32_fused_shard", "f32_fused_live",
                                     "f32_pass_b_shard")):
        n, d = 1_250_000, 384
        corpus32 = synth.corpus(n, d, torch.float32, "cuda")
        queries32 = synth.corpus(32768, d, torch.float32, "cuda",
                                 start=20_000_000)
        small32 = corpus32[:20000].contiguous()
        runs.update({
            "f32_pass_a_shard": lambda: topk.segtopk_pass_a(
                queries32, corpus32, n, 32, 11),
            "f32_pass_a_serve": lambda: topk.segtopk_pass_a(
                queries32[:64], small32, 20000, 32, 41),
            "f32_fused_shard": lambda: topk.topk_scores_fused(
                queries32[:16384], corpus32, 200),
            "f32_fused_live": lambda: topk.topk_scores_fused(
                queries32[:10000], small32, 712),
        })
        if wanted("f32_pass_b_shard"):
            seg32 = topk.segtopk_pass_a(queries32, corpus32, n, 32, 11)[1]
            runs["f32_pass_b_shard"] = lambda: topk.pass_b_rescore(
                queries32, corpus32, seg32, n, 32, 10)
    gen = torch.Generator().manual_seed(3)
    for prefix, dtype in (("flash_", torch.bfloat16),
                          ("flash_f32_", torch.float32)):
        for name, b, h, t, dh, (lo, hi) in FLASH_SHAPES:
            if not wanted(prefix + name):
                continue
            qkv = [torch.randn((b, t, h, dh), generator=gen)
                   .to("cuda", dtype).transpose(1, 2) for _ in range(3)]
            lengths = torch.randint(lo, hi + 1, (b,), generator=gen)
            mask = (torch.arange(t)[None, :]
                    < lengths[:, None]).float().to("cuda")
            runs[prefix + name] = (lambda qkv=qkv, mask=mask:
                                   fa.flash_attention(*qkv, mask))
    for name, (b, n_rows, width) in zip(("sim_long", "sim_batched"),
                                        SIM_SHAPES):
        E = sim.l2_normalize(torch.randn((b, n_rows, width), generator=gen)
                             .to("cuda"))
        if b == 1:
            E[:, LONG_DOC_SENTENCES:] = 0.0  # the bucket's zero rows
        runs[name] = lambda E=E: sim.similarity_matrix(E)
    runs = {name: fn for name, fn in runs.items() if wanted(name)}
    reps = {"pass_a_serve": 50, "fused_live": 5, "f32_pass_a_serve": 50,
            "pass_b_serve": 50, "pass_b_shard": 10, "pass_b_hot": 10,
            "f32_pass_b_shard": 10,
            "f32_fused_live": 5, "sim_long": 20, "sim_batched": 20,
            **{prefix + name: 20 for prefix in ("flash_", "flash_f32_")
               for name, *_ in FLASH_SHAPES}}
    for name, fn in runs.items():
        res[name + "_ms"] = time_ms(fn, reps=reps.get(name, 3))
        if name == "pass_b_serve":
            # the device's time a call: 50 calls queued between two events
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(50):
                fn()
            b.record()
            b.synchronize()
            res[name + "_queued_ms"] = a.elapsed_time(b) / 50
        if name.startswith(("flash", "pass_b_serve")):
            # the host's side of a call: 50 calls queued without a wait
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                fn()
            res[name + "_host_ms"] = (time.perf_counter() - t0) * 1e3 / 50
            torch.cuda.synchronize()
    if args.profiler:
        from torch.profiler import ProfilerActivity, profile

        rows = {}
        for name, fn in runs.items():
            calls = 5 if name.startswith(("sim", "pass_b_serve")) else 1
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            for ev in prof.key_averages():
                dev_us = getattr(ev, "device_time_total",
                                 getattr(ev, "cuda_time_total", 0.0))
                if dev_us > 0 and any(w in ev.key for w in
                                      ("topk", "merge", "flash", "gram",
                                       "split", "pass_b", "emset")):
                    kernel = ev.key.replace("(anonymous namespace)::", "")
                    rows[f"{name}: {kernel[:40]}"] = dev_us / 1e3 / calls
        res["profiler_device_ms_by_kernel"] = rows
        if not rows:
            print("torch.profiler showed no device time for the kernels")
    print(json.dumps(res), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(res) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
