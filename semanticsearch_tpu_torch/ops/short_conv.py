"""LFM2's gated short convolution, between the conv layer's projections.

``bcx`` (N, 3h) is the in-projection's output over packed texts (the real
tokens of a batch's texts end to end), B, C and X in that order of its
last dimension; ``weight`` the depthwise conv's (h, 1, taps) or (h, taps),
its last tap the current token's; ``pos`` (N,) each token's place in its
text. With u = B * X, the result is C * v, where v_t sums w_{taps-1-j}
u_{t-j} over the taps j whose token t - j lies in t's own text
(``pos_t >= j``): (N, h) in bcx's dtype.

On a CUDA tensor :func:`gated_short_conv` launches the hand-written kernel
``csrc/short_conv.cu``: one read of B, C and X and one write of the result,
bit-equal to the plain version on the card (its roundings in the plain
version's order); it has no backward, so a CUDA input that wants a gradient
raises. On a CPU tensor it computes :func:`gated_short_conv_plain`: u in
float32, the taps summed in float32 one at a time, v rounded to the dtype
before the C gate.
"""
from __future__ import annotations

import ctypes
import torch
from torch.nn import functional as F

from . import _build

# launches of the fused short-conv kernel (csrc/short_conv.cu) in this
# process
SHORT_CONV_LAUNCHES = 0
_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
MAX_TAPS = 4  # the kernel's instantiations: 1 to 4 taps


def gated_short_conv_plain(bcx: torch.Tensor, weight: torch.Tensor,
                           pos: torch.Tensor) -> torch.Tensor:
    """The gated short convolution in plain torch ops (the module
    docstring)."""
    n = bcx.shape[0]
    b, c, xx = bcx.chunk(3, dim=-1)
    u = (b * xx).float()
    w = weight.reshape(weight.shape[0], -1).float()  # (hidden, taps)
    taps = w.shape[1]
    v = u * w[:, taps - 1]
    for back in range(1, taps):
        # u_{t-back}, 0 where the text has no token that far back
        keep = (pos >= back).float()[:, None]
        prev = F.pad(u[:n - back], (0, 0, min(back, n), 0)) * keep
        v = v + prev * w[:, taps - 1 - back]
    return c * v.to(c.dtype)


def short_conv_vec(h: int, itemsize: int, ptr: int) -> int:
    """Channels a kernel thread takes: the widest of 16 bytes' worth, then
    halves, down to one, that divides ``h`` and to whose bytes ``ptr`` is
    aligned (rows of 3h elements then keep every vector aligned)."""
    vec = 16 // itemsize
    while vec > 1 and (h % vec or ptr % (vec * itemsize)):
        vec //= 2
    return vec


def gated_short_conv(bcx: torch.Tensor, weight: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
    """The gated short convolution (the module docstring): the kernel on
    CUDA tensors, the plain version on CPU tensors. A CUDA input the kernel
    does not take, or one that wants a gradient, raises."""
    global SHORT_CONV_LAUNCHES
    if bcx.device.type == "cpu":
        return gated_short_conv_plain(bcx, weight, pos)
    if bcx.device.type != "cuda":
        raise ValueError(f"gated_short_conv: tensors on {bcx.device}")
    if torch.is_grad_enabled() and (bcx.requires_grad
                                    or weight.requires_grad):
        raise NotImplementedError("gated_short_conv has no backward")
    if bcx.dim() != 2 or bcx.shape[1] % 3:
        raise ValueError(f"gated_short_conv: bcx of shape {tuple(bcx.shape)}"
                         ", not (N, 3 * hidden)")
    n, h = bcx.shape[0], bcx.shape[1] // 3
    w = weight.reshape(weight.shape[0], -1)
    if (weight.dim() not in (2, 3) or weight.dim() == 3 and weight.shape[1] != 1
            or w.shape[0] != h or not 1 <= w.shape[1] <= MAX_TAPS):
        raise ValueError(f"gated_short_conv: weight of shape "
                         f"{tuple(weight.shape)} for hidden {h}: (hidden, 1, "
                         f"taps) or (hidden, taps), at most {MAX_TAPS} taps")
    if bcx.dtype not in _KERNEL_DTYPES or w.dtype != bcx.dtype:
        raise NotImplementedError(
            f"the short-conv kernel takes bfloat16, float16 or float32 bcx "
            f"and a weight of the same dtype; got {bcx.dtype}, {w.dtype}")
    if (pos.dtype != torch.int32 or pos.shape != (n,)
            or not pos.is_contiguous()):
        raise ValueError("gated_short_conv: pos must be contiguous (N,) "
                         "int32")
    if not (w.device == pos.device == bcx.device):
        raise ValueError("gated_short_conv: bcx, weight and pos on "
                         "different devices")
    out = torch.empty((n, h), dtype=bcx.dtype, device=bcx.device)
    if n == 0 or h == 0:
        return out
    bcx, w = bcx.contiguous(), w.contiguous()
    vec = short_conv_vec(h, bcx.element_size(), bcx.data_ptr())
    fn = _build.load("short_conv").gated_short_conv
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4
                   + [ctypes.c_longlong] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    status = fn(bcx.data_ptr(), w.data_ptr(), pos.data_ptr(), out.data_ptr(),
                n, h, w.shape[1], _KERNEL_DTYPES[bcx.dtype], vec,
                torch.cuda.current_stream(bcx.device).cuda_stream)
    _build.check(status, "gated_short_conv")
    SHORT_CONV_LAUNCHES += 1
    return out
