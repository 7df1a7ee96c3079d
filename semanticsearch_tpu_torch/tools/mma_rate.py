"""Measure the rate of the tensor cores' register form (``mma.sync``) on one
CUDA card, for the types the flash kernel multiplies in.

    python -m semanticsearch_tpu_torch.tools.mma_rate

Builds a small kernel of its own (``nvcc``, sm_90a, under
``build/mma_rate/``) that issues ``mma.sync`` back to back on eight
independent accumulators a warp, sixteen warps an SM, every SM busy, and
times it by CUDA events: TF32 ``m16n8k8`` (the f32 flash's products, three
a 3xTF32 step) and bf16 ``m16n8k16`` (the bf16 flash's). Prints one JSON
object: the rate of each in TFLOP/s (two operations a multiply-add) beside
the card's dense peak for the type (the same tensor cores driven by
``wgmma``), and the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

SOURCE = r"""
#include <stdint.h>
#include <cuda_runtime.h>

template <bool TF32>
__global__ void __launch_bounds__(256) mma_loop(float* out, int iters) {
  float d[8][4];
  for (int j = 0; j < 8; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.0f;
  const uint32_t a0 = threadIdx.x * 0x3f800001u, a1 = a0 ^ 0x10u, a2 = a0 ^ 0x20u,
                 a3 = a0 ^ 0x30u, b0 = a0 ^ 0x40u, b1 = a0 ^ 0x50u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (TF32)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
            "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
            "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  float s = 0.0f;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int mma_rate(float* out, int blocks, int iters, int tf32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tf32)
    mma_loop<true><<<blocks, 256, 0, st>>>(out, iters);
  else
    mma_loop<false><<<blocks, 256, 0, st>>>(out, iters);
  return (int)cudaGetLastError();
}
"""

BLOCKS_PER_SM = 2  # sixteen warps an SM
ITERS = 4096
PEAKS = {"tf32_m16n8k8": 495e12, "bf16_m16n8k16": 989e12}  # dense, H100 SXM


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mma_rate: no CUDA device", file=sys.stderr)
        return 2
    from semanticsearch_tpu_torch.ops import _build
    from chip_smoke import time_ms

    out_dir = Path(_build.BUILD_DIR).parent / "mma_rate"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib_path = out_dir / "mma_rate.cu", out_dir / "libmma_rate.so"
    src.write_text(SOURCE)
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
                    str(lib_path), str(src)], check=True)
    fn = ctypes.CDLL(str(lib_path)).mma_rate
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = sms * BLOCKS_PER_SM
    out = torch.empty(blocks * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    res = {"card": smi, "sms": sms, "warps_per_sm": 8 * BLOCKS_PER_SM,
           "chains_per_warp": 8}
    for name, tf32, flops in (("tf32_m16n8k8", 1, 2 * 16 * 8 * 8),
                              ("bf16_m16n8k16", 0, 2 * 16 * 8 * 16)):
        def run():
            status = fn(out.data_ptr(), blocks, ITERS, tf32, stream)
            if status:
                raise RuntimeError(f"mma_rate: cudaError {status}")

        ms = time_ms(run, reps=5, warmup=2)
        total = blocks * 8 * ITERS * 8 * flops  # warps x iters x chains
        res[name + "_ms"] = ms
        res[name + "_tflops"] = total / ms / 1e9
        res[name + "_peak_tflops"] = PEAKS[name] / 1e12
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
