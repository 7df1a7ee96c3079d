"""RMSNorm over the last dimension, with or without the residual add before
it: LFM2's norms and the adds that feed them.

``add_rms_norm(x, d, weight, eps)`` returns ``(s, out)``: the new residual
``s = x + d`` and ``out = RMSNorm(s) * weight``; ``rms_norm(x, weight,
eps)`` returns ``RMSNorm(x) * weight``. Rows are the last dimension, of any
width, in bfloat16, float16 or float32, the weight of that width and dtype.
RMSNorm(s) is s / sqrt(mean(s^2) + eps) in float32, rounded to the dtype,
before the weight's product (rounded again).

On a CUDA tensor both launch the hand-written kernel ``csrc/rms_norm.cu``:
one read of x (and d) and one write of s (and out). Its roundings are the
plain chain's, in its order: s is the plain add's bits, and out differs
from the plain chain's only where the order of the sum of squares moves
the float32 statistic across a rounding. It has no backward, so a CUDA
input that wants a gradient raises. On a CPU tensor they compute
:func:`add_rms_norm_plain` / :func:`rms_norm_plain`, the chain the model
held inline, bit for bit.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build

# launches of the RMSNorm kernel (csrc/rms_norm.cu) in this process
RMS_NORM_LAUNCHES = 0
_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
# vectors a lane holds on the kernel's register path past one a lane; the
# kernel takes 0 (the loop path), 1 and this alone
MAX_VECTORS = 8


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """x / rms(x) in float32, rounded to x's dtype, times the weight."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return y.to(x.dtype) * weight


def add_rms_norm_plain(x: torch.Tensor, d: torch.Tensor, weight: torch.Tensor,
                       eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x + d, :func:`rms_norm_plain` of it)."""
    s = x + d
    return s, rms_norm_plain(s, weight, eps)


def rms_norm_plan(h: int, itemsize: int, ptrs) -> Tuple[int, int, int]:
    """The kernel's (elements a vector, lanes a row, vectors a lane) for rows
    of ``h`` elements of ``itemsize`` bytes at the addresses ``ptrs``: the
    widest vector of 16 bytes, then halves, down to one element, that
    divides ``h`` and to whose bytes every pointer is aligned; the fewest
    lanes, a power of two up to 32, that leave a lane at most one vector,
    else 32; and one vector a lane where that holds the row, else
    ``MAX_VECTORS`` (the vectors past the row's end left out), else 0: the
    loop path, a warp a row."""
    vec = 16 // itemsize
    while vec > 1 and (h % vec or any(p % (vec * itemsize) for p in ptrs)):
        vec //= 2
    per_row = h // vec
    lanes = min(32, 1 << (per_row - 1).bit_length())
    if per_row <= lanes:
        return vec, lanes, 1
    return vec, lanes, MAX_VECTORS if per_row <= lanes * MAX_VECTORS else 0


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view({2: torch.int16, 4: torch.int32}[x.element_size()])


def rms_norm_agrees(got: torch.Tensor, s: torch.Tensor, w: torch.Tensor,
                    eps: float, shifts: int = 2) -> Tuple[bool, bool, float]:
    """How the kernel's output ``got`` stands to the plain chain over the
    residual ``s`` (the kernel sums the squares in another order, so its
    float32 1/rms may sit a few units in the last place off): (every row,
    bit for bit, the plain chain's output with its 1/rms moved by at most
    ``shifts`` units in the last place; every normalized value within one
    unit in the last place of the dtype of the plain one before the
    weight's product; the share of elements bit-equal to the plain
    output)."""
    h = s.shape[-1]
    sf, g = s.reshape(-1, h).float(), _bits(got.reshape(-1, h))
    r = torch.rsqrt(sf.pow(2).mean(-1, keepdim=True) + eps)
    rows = torch.zeros(sf.shape[0], dtype=torch.bool, device=s.device)
    for toward in (float("inf"), float("-inf")):
        rk = r
        for _ in range(shifts + 1):
            rows |= (_bits((sf * rk).to(s.dtype) * w) == g).all(-1)
            rk = torch.nextafter(rk, torch.full_like(rk, toward))
    y = _bits((sf * r).to(s.dtype))
    near = torch.zeros_like(g, dtype=torch.bool)
    for step in (-1, 0, 1):
        near |= _bits((y + step).view(s.dtype) * w) == g
    same = _bits((sf * r).to(s.dtype) * w) == g
    return bool(rows.all()), bool(near.all()), float(same.double().mean())


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("rms_norm").rms_norm
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_float]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    return fn


def _launch(x: torch.Tensor, d: Optional[torch.Tensor], weight: torch.Tensor,
            eps: float, what: str):
    """The kernel on CUDA tensors: (s or None, out)."""
    global RMS_NORM_LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"{what}: tensors on {x.device}")
    inputs = (x, weight) if d is None else (x, d, weight)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise NotImplementedError(f"{what} has no backward")
    if x.dtype not in _KERNEL_DTYPES or any(t.dtype != x.dtype
                                            for t in inputs):
        raise NotImplementedError(
            f"the RMSNorm kernel takes bfloat16, float16 or float32 tensors "
            f"of one dtype; got {[t.dtype for t in inputs]}")
    if any(t.device != x.device for t in inputs):
        raise ValueError(f"{what}: tensors on different devices")
    if x.dim() == 0 or weight.shape != x.shape[-1:]:
        raise ValueError(f"{what}: weight of shape {tuple(weight.shape)} "
                         f"for rows of shape {tuple(x.shape)}")
    if d is not None and d.shape != x.shape:
        raise ValueError(f"{what}: x of shape {tuple(x.shape)} and d of "
                         f"shape {tuple(d.shape)}")
    if not all(t.is_contiguous() for t in inputs):
        raise ValueError(f"{what}: the kernel takes contiguous tensors")
    out = torch.empty_like(x)
    s = None if d is None else torch.empty_like(x)
    h = x.shape[-1]
    if x.numel() == 0:
        return s, out
    outputs = (out,) if s is None else (s, out)
    vec, lanes, nv = rms_norm_plan(
        h, x.element_size(), [t.data_ptr() for t in inputs + outputs])
    status = _kernel()(x.data_ptr(), None if d is None else d.data_ptr(),
                weight.data_ptr(), None if s is None else s.data_ptr(),
                out.data_ptr(), x.numel() // h, h, eps,
                _KERNEL_DTYPES[x.dtype], vec, lanes, nv,
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, what)
    RMS_NORM_LAUNCHES += 1
    return s, out


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> torch.Tensor:
    """RMSNorm(x) * weight (the module docstring): the kernel on CUDA
    tensors, the plain chain on CPU tensors. A CUDA input the kernel does
    not take, or one that wants a gradient, raises."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, eps)
    return _launch(x, None, weight, eps, "rms_norm")[1]


def add_rms_norm(x: torch.Tensor, d: torch.Tensor, weight: torch.Tensor,
                 eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x + d, RMSNorm(x + d) * weight) (the module docstring): the kernel
    on CUDA tensors, the plain chain on CPU tensors. A CUDA input the
    kernel does not take, or one that wants a gradient, raises."""
    if x.device.type == "cpu":
        return add_rms_norm_plain(x, d, weight, eps)
    return _launch(x, d, weight, eps, "add_rms_norm")
