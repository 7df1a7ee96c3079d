"""How the reference rounds the operands of its products.

``f64`` computes in float64 (the reference). The controls compute in the
precision one step below the configuration's: ``tf32`` rounds each product
operand to TF32 (10 stored mantissa bits, to nearest) and accumulates in
float32, as the tensor cores do with TF32 on; ``fp8`` scales each operand
tensor by its largest magnitude onto float8 e4m3's range (448), rounds, and
accumulates in float32, as an fp8 GEMM with per-tensor scales does.
"""
from __future__ import annotations

import torch


def compute_dtype(precision: str) -> torch.dtype:
    return torch.float64 if precision == "f64" else torch.float32


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to nearest (ties away) at 10 mantissa bits."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """A per-tensor scaled float8 e4m3 round trip."""
    x = x.float()
    amax = x.abs().max().clamp(min=1e-30)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """A product operand in ``precision`` (a rounded operand passes its
    gradient through unchanged)."""
    if precision == "f64":
        return x.double()
    if precision in ("tf32", "fp8"):
        x = x.float()
        r = round_tf32(x.detach()) if precision == "tf32" else round_fp8(
            x.detach())
        return x + (r - x.detach())
    raise ValueError(f"unknown precision {precision!r}")


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b with both operands in ``precision``; f32 products with TF32
    off, whatever the process's setting."""
    a, b = operand(a, precision), operand(b, precision)
    if a.is_cuda and a.dtype == torch.float32:
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return a @ b
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    return a @ b
