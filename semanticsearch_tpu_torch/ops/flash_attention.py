"""Flash attention (forward kernel) for the sentence encoder.

Counterpart of ``semanticsearch_tpu/ops/flash_attention.py``: masked,
non-causal attention over (B, H, T, Dh) with a (B, T) key-padding mask
(1 = real key). On a CUDA tensor :func:`flash_attention` launches the
hand-written Hopper kernel ``csrc/flash_attention.cu``; on a CPU tensor it
computes :func:`flash_attention_plain`. The backward pass recomputes
attention with the plain math, as the JAX package's ``_flash_bwd`` does.
The kernel reads q, k and v through their strides and writes an output
with q's strides, so the encoder's transposed (B, T, H, Dh) views cost no
copy either way.

The kernel takes bf16, fp16 and f32 (an f32 encoder; the f32 path computes
both products on the TF32 tensor cores by the 3xTF32 split, within 2e-5 of
the plain version), any T up to 128 and every multiple of 64 above it (a
superset of the JAX kernel's T <= 128 or multiples of 128), and every head
width, as the JAX kernel does: 16, 32, 64, 128 and 256 as they are, any
other up to 256 padded with zero columns to the next of those, and past 256
(the kernel's wide path, S once per 64 query rows over the whole width)
padded to a multiple of 8 (:func:`_padded_heads`,
one copy of q, k and v; the scale stays that of the real width), the output
sliced back. The CPU path takes the same route, so the tests here reach
it.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30
# launches of the flash kernel (csrc/flash_attention.cu) in this process:
# bf16/fp16 and f32 q, k, v at head widths up to 256, and the wide path past
# 256 (every dtype)
FLASH_LAUNCHES = 0
FLASH_F32_LAUNCHES = 0
FLASH_WIDE_LAUNCHES = 0
_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
_KERNEL_HEAD_DIMS = (16, 32, 64, 128, 256)
_KERNEL_WIDE_STEP = 8  # past 256: 16-byte rows in every dtype
_KERNEL_BLOCK = 64  # the kernel's key block rows
_KERNEL_MAX_TAIL_T = 128  # up to here T need not be a multiple of the block


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: torch.Tensor,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention in f32: masked keys score the finite NEG_INF, so a
    query with every key masked averages V. Returns q's dtype. ``scale``
    defaults to 1/sqrt(Dh)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    s = torch.where(mask[:, None, None, :] > 0, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _kernel_operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when the kernel can read it through its strides (head
    dimension contiguous, 16-byte aligned rows), else a contiguous copy."""
    vec = 16 // x.element_size()
    if (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(s % vec == 0 for n, s in zip(x.shape[:3], x.stride()[:3])
                    if n > 1)):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _kernel_head_dim(dh: int) -> int:
    """The kernel's head width that holds ``dh``: the next of 16, 32, 64,
    128, 256; past 256, ``dh`` rounded up to a multiple of 8."""
    for width in _KERNEL_HEAD_DIMS:
        if dh <= width:
            return width
    return -(-dh // _KERNEL_WIDE_STEP) * _KERNEL_WIDE_STEP


def _padded_heads(attend, q, k, v, mask):
    """``attend(q, k, v, mask, scale)`` at a head width the kernel takes:
    q, k and v padded with zero columns to :func:`_kernel_head_dim` (a zero
    column adds nothing to q.k, and V's zero columns give output columns
    that are sliced away), the scale that of the real width."""
    dh = q.shape[-1]
    width = _kernel_head_dim(dh)
    scale = 1.0 / math.sqrt(dh)
    if width == dh:
        return attend(q, k, v, mask, scale)
    q, k, v = (torch.nn.functional.pad(x, (0, width - dh)) for x in (q, k, v))
    return attend(q, k, v, mask, scale)[..., :dh]


def _strides(x: torch.Tensor):
    """(b, h, t) element strides, 0 for a dimension of size 1."""
    return [s if n > 1 else 0 for n, s in zip(x.shape[:3], x.stride()[:3])]


def _flash_forward(q, k, v, mask):
    if q.device.type == "cpu":
        return _padded_heads(flash_attention_plain, q, k, v, mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: tensors on {q.device}")
    b, h, t, dh = q.shape
    if q.dtype not in _KERNEL_DTYPES or not (k.dtype == v.dtype == q.dtype):
        raise NotImplementedError(
            f"the flash kernel takes bfloat16, float16 or float32 q, k, v; "
            f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if t > _KERNEL_MAX_TAIL_T and t % _KERNEL_BLOCK:
        raise ValueError(
            f"flash kernel: T={t} must be at most {_KERNEL_MAX_TAIL_T} or a "
            f"multiple of {_KERNEL_BLOCK}")
    return _padded_heads(_launch, q, k, v, mask)


def _launch(q, k, v, mask, scale):
    """Launch csrc/flash_attention.cu on CUDA tensors of a head width it
    takes, or raise."""
    global FLASH_LAUNCHES, FLASH_F32_LAUNCHES, FLASH_WIDE_LAUNCHES
    b, h, t, dh = q.shape
    if k.shape != q.shape or v.shape != q.shape or mask.shape != (b, t):
        raise ValueError(f"flash kernel: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"mask {tuple(mask.shape)}")
    if not all(x.device == q.device for x in (k, v, mask)):
        raise ValueError("flash kernel: q, k, v and mask on different devices")
    # strided views (the encoder's transposed heads) go in as they are
    q, k, v = (_kernel_operand(x) for x in (q, k, v))
    mask = mask.to(torch.float32).contiguous()
    if mask.data_ptr() % 16:
        mask = mask.clone()
    out = torch.empty_like(q)  # q's strides where q is dense, else contiguous
    strides = (ctypes.c_longlong * 12)(
        *_strides(q), *_strides(k), *_strides(v), *_strides(out))
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                out.data_ptr(), b, h, t, dh, strides, scale,
                _KERNEL_DTYPES[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "flash_attention")
    if dh > _KERNEL_HEAD_DIMS[-1]:
        FLASH_WIDE_LAUNCHES += 1
    elif q.dtype == torch.float32:
        FLASH_F32_LAUNCHES += 1
    else:
        FLASH_LAUNCHES += 1
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask):
        ctx.save_for_backward(q, k, v, mask)
        return _flash_forward(q, k, v, mask)

    @staticmethod
    def backward(ctx, g):
        # exact gradients by recomputing the (small) attention matrix with
        # the plain math: no backward kernel to keep in step
        q, k, v, mask = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [x.detach().requires_grad_(True) for x in (q, k, v)]
            out = flash_attention_plain(*qkv, mask)
            dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Masked non-causal attention: q, k, v (B, H, T, Dh); mask (B, T) with
    1 = real key. Returns (B, H, T, Dh) in q's dtype."""
    return _FlashAttention.apply(q, k, v, mask)
