"""Time flash attention's tensor-core schedules against variants of them, in
turns, on one CUDA card: what holds each schedule, by taking its parts away
or changing one thing.

    python -m semanticsearch_tpu_torch.tools.flash_variants [--rounds N] \
        [--only NAME,...]

Each variant is ``csrc/flash_attention.cu`` (or ``csrc/tf32x3.cuh``)
changed by text replacements, built under ``build/flash_variants/<name>/``
(one nvcc per variant, all at once) and timed by CUDA events at the f32
serve shape (B 256, H 12, T 256, Dh 32, 40-256 real keys, the f32 path),
at Dh 256 in f32, and at Dh 320 in bf16 and f32 (the wide path; B 64, H 8,
T 256), the variants in turns, the order reversed every round; beside
each, the device time under ``torch.profiler`` (``*_device_ms``). Each row
also gives the largest error against the plain version at those shapes,
as a multiple of the kernel's tolerance (f32: 2e-5 + 2e-5 |o|; bf16:
2e-2 max(|o|, 0.5)): the diagnostic variants compute wrong values on
purpose. Prints one JSON object with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

F32_PV = ("        tf32x3::mma3_m16n8k8(o[d], o[d], ph, pl, __float_as_uint(v0[8 * d]),\n"
          "                             __float_as_uint(v0[4 * LDV + 8 * d]));\n")
F32_S = ("        tf32x3::mma3_m16n8k8(s[2 * np], sl[2 * np], qh, ql, bb[0], bb[1]);\n"
         "        tf32x3::mma3_m16n8k8(s[2 * np + 1], sl[2 * np + 1], qh, ql, bb[2], bb[3]);\n")
F32_S_FOLD = F32_S.replace("sl[2 * np]", "s[2 * np]").replace("sl[2 * np + 1]",
                                                            "s[2 * np + 1]")
MMA3 = ("  mma_m16n8k8(small, a_lo, b0, b1);\n"
        "  mma_m16n8k8(small, a, lo_of_raw(b0), lo_of_raw(b1));\n")
PV_LOOP = ("    const float* vs = t_s + ((2 * blk + 1) % NST) * BKV * LDV;\n")
CU, CUH = "flash_attention.cu", "tf32x3.cuh"

# name: [(file, old, new), ...]
VARIANTS = {
    "kept": [],
    # diagnostics (wrong values): the f32 path without its P V products,
    # without its S products, or without both; every f32 product one TF32
    # product
    "no_pv": [(CU, F32_PV, "        ;\n")],
    "no_s": [(CU, F32_S, "")],
    "one_product": [(CUH, MMA3, "")],
    "no_products": [(CU, F32_PV, "        ;\n"), (CU, F32_S, "")],
    # the f32 path without the exponentials (wrong values), and with lo = 0
    # (wrong values; the products still run): the softmax's and the split's
    # cost
    "no_exp": [(CU, "      s[jj][%d] = exp2f(s[jj][%d] - mn%d);\n" % (e, e, e // 2),
                "      s[jj][%d] = s[jj][%d] - mn%d;\n" % (e, e, e // 2)) for e in range(4)],
    "no_split": [(CUH, "  return __float_as_uint(__uint_as_float(x) - __uint_as_float(x & ~0x1FFFu));",
                  "  return 0u;")],
    # candidates: O's small terms in an accumulator of their own a block
    # (shorter dependent chains in P V); Q from shared memory at Dh 32; S's
    # small terms folded into S (32 registers fewer); a fourth ring stage (a
    # block and a half in flight) with a third Q tile at Dh <= 32
    "o_small": [
        (CU, F32_PV + "    }\n", F32_PV.replace("o[d], o[d]", "o[d], os[d]") + "    }\n"
         "#pragma unroll\n    for (int d = 0; d < DH / 8; ++d)\n"
         "#pragma unroll\n      for (int e = 0; e < 4; ++e) o[d][e] += os[d][e];\n"),
        (CU, PV_LOOP, PV_LOOP + "    float os[DH / 8][4] = {};\n")],
    "q_smem": [(CU, "constexpr bool Q_IN_REGS = DH <= 32;", "constexpr bool Q_IN_REGS = false;")],
    "s_fold": [(CU, F32_S, F32_S_FOLD)],
    "nst4": [(CU, "constexpr int tf_stages(int dh) { return dh <= 128 ? 3 : 2; }",
              "constexpr int tf_stages(int dh) { return dh <= 32 ? 4 : dh <= 128 ? 3 : 2; }"),
             (CU, "constexpr int tf_q_tiles(int dh) { return dh <= 128 ? 2 : 1; }",
              "constexpr int tf_q_tiles(int dh) { return dh <= 32 ? 3 : dh <= 128 ? 2 : 1; }")],
    # the kept choice undone: the wide path's 16-bit CTAs one an SM
    "wide_one_cta": [(CU, "sizeof(T) == 2 && NCH <= 5 ? 2 : 1", "1")],
    # the wide path: a fourth ring stage
    "wide_nst4": [(CU, "constexpr int W_NST = 3;", "constexpr int W_NST = 4;")],
}


def build(csrc: Path, out_dir: Path, variants: dict) -> dict:
    """{variant: loaded library}, every variant built at once."""
    from semanticsearch_tpu_torch.ops import _build

    procs = {}
    for name, changes in variants.items():
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        files = {f.name: f.read_text() for f in csrc.glob("*.cuh")}
        files[CU] = (csrc / CU).read_text()
        for fname, old, new in changes:
            if old not in files[fname]:
                raise SystemExit(f"flash_variants: {name}: {fname} changed; its "
                                 f"replacement no longer applies")
            files[fname] = files[fname].replace(old, new)
        for fname, text in files.items():
            (d / fname).write_text(text)
        so = d / "libflash_attention.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(d / CU)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            for _, other in procs.values():
                other.kill()
            raise SystemExit(f"flash_variants: nvcc failed for {name}:\n{log}")
        spills = sorted({line.strip() for line in log.splitlines()
                         if "spill" in line and not line.strip().startswith("0 bytes")})
        if spills:
            print(f"{name}: {spills}", flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def device_ms(fn, calls: int = 5) -> float:
    """Mean device time of the flash kernels one call of fn() launches,
    under torch.profiler (free of the host's launch path)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(getattr(ev, "device_time_total", 0.0)
               for ev in prof.key_averages() if "flash" in ev.key) / 1e3 / calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", default="", help="variants to build and time, "
                    "comma-separated (default: all); kept is always timed")
    args = ap.parse_args()
    keep = {"kept", *args.only.split(",")} if args.only else set(VARIANTS)
    variants = {name: ch for name, ch in VARIANTS.items() if name in keep}
    import torch

    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from chip_smoke import time_ms
    from semanticsearch_tpu_torch.ops import _build
    from semanticsearch_tpu_torch.ops import flash_attention as fa

    libs = build(_build._CSRC, _build.BUILD_DIR.parent / "flash_variants",
                 variants)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator().manual_seed(3)
    shapes = {}
    for name, b, h, dh, dtype in (("f32_serve", 256, 12, 32, torch.float32),
                                  ("f32_dh256", 64, 8, 256, torch.float32),
                                  ("bf16_dh320", 64, 8, 320, torch.bfloat16),
                                  ("f32_dh320", 64, 8, 320, torch.float32)):
        qkv = [torch.randn((b, 256, h, dh), generator=gen).to("cuda", dtype)
               .transpose(1, 2) for _ in range(3)]
        lengths = torch.randint(40, 257, (b,), generator=gen)
        mask = (torch.arange(256)[None, :] < lengths[:, None]).float().to("cuda")
        want = fa.flash_attention_plain(*qkv, mask).float()
        tol = (2e-5 + 2e-5 * want.abs() if dtype == torch.float32
               else 2e-2 * want.abs().clamp(min=0.5))
        shapes[name] = (qkv, mask, want, tol)
    res = {"card": smi, "variants": {name: [] for name in variants}}
    order = list(variants)
    for rnd in range(args.rounds):
        for name in (order if rnd % 2 == 0 else order[::-1]):
            _build._LIBS["flash_attention"] = libs[name]
            row = {}
            for shape, (qkv, mask, want, tol) in shapes.items():
                row[shape + "_ms"] = time_ms(
                    lambda: fa.flash_attention(*qkv, mask), reps=10, warmup=2)
                row[shape + "_device_ms"] = device_ms(
                    lambda: fa.flash_attention(*qkv, mask))
                got = fa.flash_attention(*qkv, mask).float()
                row[shape + "_err"] = float(((got - want).abs() / tol).max())
            res["variants"][name].append(row)
            print(name, json.dumps(row), flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
