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

Packed texts (:func:`flash_attention_varlen`, the encoder's inference
forward): q, k, v (N, H, Dh) hold the real tokens of a batch's texts end to
end, and a token attends to the keys of its own text alone. The kernel's
packed entry takes 64-token tiles of the stream from :func:`varlen_tiles`
and reads only real tokens; its plain version,
:func:`flash_attention_varlen_plain`, scatters the texts into a padded
batch for :func:`flash_attention_plain` and gathers the tokens back.

Packed texts of a causal language model (``causal=True``, the LFM2-MoE
encoder's attention): a token attends to the keys of its own text up to
itself, and K and V may hold fewer heads than Q (grouped-query attention:
query head h reads K/V head h // (H / H_kv)). The kernel's LM entry
(``flash_attention_varlen_lm_fwd``) takes bf16 and fp16 at head widths 32,
64 and 128; the plain version repeats each K/V head over its group and
masks the keys past each row.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from . import _build

NEG_INF = -1e30
# launches of the flash kernel (csrc/flash_attention.cu) in this process:
# bf16/fp16 and f32 q, k, v at head widths up to 256, and the wide path past
# 256 (every dtype)
FLASH_LAUNCHES = 0
FLASH_F32_LAUNCHES = 0
FLASH_WIDE_LAUNCHES = 0
# the packed entry's causal grouped-K/V instantiation (LM)
FLASH_CAUSAL_LAUNCHES = 0
_LM_HEAD_DIMS = (32, 64, 128)
_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
_KERNEL_HEAD_DIMS = (16, 32, 64, 128, 256)
_KERNEL_WIDE_STEP = 8  # past 256: 16-byte rows in every dtype
_KERNEL_BLOCK = 64  # the kernel's key block rows
_KERNEL_MAX_TAIL_T = 128  # up to here T need not be a multiple of the block


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: torch.Tensor,
                          scale: Optional[float] = None,
                          causal: bool = False) -> torch.Tensor:
    """Plain attention in f32: masked keys score the finite NEG_INF, so a
    query with every key masked averages V. Returns q's dtype. ``scale``
    defaults to 1/sqrt(Dh). ``causal`` masks the keys past each query's
    own place as well."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    keep = mask[:, None, None, :] > 0
    if causal:
        t = s.shape[-1]
        keep = keep & torch.ones(t, t, dtype=torch.bool,
                                 device=s.device).tril()
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _kernel_operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when the kernel can read it through its strides (head
    dimension contiguous, 16-byte aligned rows), else a contiguous copy."""
    vec = 16 // x.element_size()
    if (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(s % vec == 0 for n, s in zip(x.shape[:-1],
                                                 x.stride()[:-1])
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


# the packed kernel's tile: consecutive tokens a CTA takes as its query rows
VARLEN_TILE = 64


@dataclasses.dataclass
class Varlen:
    """A batch of texts packed end to end, one token a row, on the tokens'
    device: ``cu_seqlens`` (rows + 1,) int32 offsets of the texts,
    ``tiles`` (n_tiles, 4) int32 from :func:`varlen_tiles`, and per token
    ``seg``, its text, and ``pos``, its place in the text; ``width``
    exceeds every ``pos`` (the plain version's padded length)."""

    cu_seqlens: torch.Tensor
    tiles: torch.Tensor
    seg: torch.Tensor
    pos: torch.Tensor
    width: int

    @property
    def rows(self) -> int:
        return self.cu_seqlens.shape[0] - 1


def varlen_tiles(cu_seqlens: np.ndarray) -> np.ndarray:
    """The packed kernel's tiles over texts at offsets ``cu_seqlens``: up to
    ``VARLEN_TILE`` consecutive tokens each, which may span several texts,
    except that a text longer than a tile starts a tile and ends one, so
    its tiles hold its tokens alone (as the padded kernel's do). Returns
    (n_tiles, 4) int32: a tile's first token, its end, the text of its
    first token and one past the text of its last; its keys are those
    texts' tokens."""
    tile = VARLEN_TILE
    cu = np.asarray(cu_seqlens, np.int64)
    n = int(cu[-1])
    if n == 0:
        return np.zeros((0, 4), np.int32)
    long = np.diff(cu) > tile
    cuts = np.unique(np.concatenate([[0, n], cu[:-1][long], cu[1:][long]]))
    per = -(-np.diff(cuts) // tile)  # tiles of each stretch between cuts
    first = np.repeat(np.cumsum(per) - per, per)
    q0 = np.repeat(cuts[:-1], per) + tile * (np.arange(per.sum()) - first)
    q1 = np.minimum(q0 + tile, np.repeat(cuts[1:], per))
    return np.stack([q0, q1, np.searchsorted(cu, q0, "right") - 1,
                     np.searchsorted(cu, q1 - 1, "right")],
                    axis=1).astype(np.int32)


def varlen_layout(lens, device="cpu") -> Varlen:
    """The ``Varlen`` layout of texts of ``lens`` tokens each, a text's
    tokens at its first places, on ``device``."""
    lens = np.asarray(lens, np.int64)
    cu = np.concatenate([[0], np.cumsum(lens)])
    seg = np.repeat(np.arange(lens.size), lens)
    pos = np.arange(cu[-1]) - cu[:-1][seg]
    return Varlen(*(torch.from_numpy(np.ascontiguousarray(x, np.int32))
                    .to(device) for x in (cu, varlen_tiles(cu), seg, pos)),
                  int(lens.max(initial=0)))


def flash_attention_varlen_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, layout: Varlen,
                                 causal: bool = False) -> torch.Tensor:
    """:func:`flash_attention_varlen` in plain math: the tokens scattered
    into a (rows, width) batch whose mask holds each text's own tokens,
    each K/V head repeated over its group of query heads,
    :func:`flash_attention_plain`, and the tokens gathered back."""
    h, dh = q.shape[1:]
    _kv_group(q, k, v)
    idx = (layout.seg.long(), layout.pos.long())

    def padded(x):
        x = x.repeat_interleave(h // x.shape[1], dim=1)
        out = x.new_zeros((layout.rows, layout.width, h, dh))
        out[idx] = x
        return out.transpose(1, 2)

    mask = torch.zeros((layout.rows, layout.width), device=q.device)
    mask[idx] = 1.0
    out = flash_attention_plain(padded(q), padded(k), padded(v), mask,
                                causal=causal)
    return out.transpose(1, 2)[idx]


def _kv_group(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """Query heads a K/V head serves: k and v (N, H_kv, Dh) beside q (N,
    H, Dh), H a multiple of H_kv; raises on other shapes."""
    n, h, dh = q.shape
    hk = k.shape[1]
    if (k.shape != v.shape or k.shape[0] != n or k.shape[2] != dh
            or hk < 1 or h % hk):
        raise ValueError(f"flash kernel: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    return h // hk


def flash_attention_varlen(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, layout: Varlen,
                           causal: bool = False) -> torch.Tensor:
    """Attention of packed texts (no gradient): q, k, v (N, H, Dh), the
    tokens of ``layout``'s texts end to end; each token attends to the keys
    of its own text. Returns (N, H, Dh) in q's dtype. On a CUDA tensor the
    kernel's packed entry, at head widths up to 256 (padded as
    :func:`flash_attention` pads them); on a CPU tensor the plain
    version. ``causal`` (a token attends to its text's keys up to itself),
    or k and v of (N, H_kv, Dh) with H a multiple of H_kv, take the
    kernel's LM entry (:func:`_launch_varlen_lm`)."""
    if q.device.type == "cpu":
        return flash_attention_varlen_plain(q, k, v, layout, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_varlen: tensors on {q.device}")
    if q.dtype not in _KERNEL_DTYPES or not (k.dtype == v.dtype == q.dtype):
        raise NotImplementedError(
            f"the flash kernel takes bfloat16, float16 or float32 q, k, v; "
            f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[-1] > _KERNEL_HEAD_DIMS[-1]:
        raise ValueError(f"flash kernel: packed texts at head width "
                         f"{q.shape[-1]} (at most {_KERNEL_HEAD_DIMS[-1]})")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError("flash_attention_varlen has no backward")
    if causal or k.shape[1] != q.shape[1]:
        return _launch_varlen_lm(q, k, v, layout, causal)
    return _padded_heads(_launch_varlen, q, k, v, layout)


def _layout_args(q, layout: Varlen, tensors):
    """The packed entries' shared checks: the layout's int32 arrays on
    q's device."""
    cu, tiles = layout.cu_seqlens, layout.tiles
    if not all(x.device == q.device for x in tuple(tensors) + (cu, tiles)):
        raise ValueError("flash kernel: q, k, v and the layout on different "
                         "devices")
    if cu.dtype != torch.int32 or tiles.dtype != torch.int32 or not (
            cu.is_contiguous() and tiles.is_contiguous()):
        raise ValueError("flash kernel: cu_seqlens and tiles must be "
                         "contiguous int32")
    return cu, tiles


def _launch_varlen_lm(q, k, v, layout: Varlen, causal: bool):
    """Launch the kernel's LM entry (causal, grouped K/V) on CUDA tensors,
    or raise."""
    global FLASH_CAUSAL_LAUNCHES
    n, h, dh = q.shape
    group = _kv_group(q, k, v)
    if not causal:
        raise NotImplementedError("the flash kernel's grouped K/V heads run "
                                  "causal only")
    if q.dtype == torch.float32 or dh not in _LM_HEAD_DIMS:
        raise NotImplementedError(
            f"the causal flash kernel takes bfloat16 or float16 at head "
            f"widths {_LM_HEAD_DIMS}, got {q.dtype} at {dh}")
    cu, tiles = _layout_args(q, layout, (k, v))
    if n == 0:
        return torch.empty_like(q)
    q, k, v = (_kernel_operand(x) for x in (q, k, v))
    out = torch.empty_like(q)
    strides = (ctypes.c_longlong * 8)(*(
        s for x in (q, k, v, out)
        for s in (x.stride(1) if x.shape[1] > 1 else 0, x.stride(0))))
    fn = _build.load("flash_attention").flash_attention_varlen_lm_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                cu.data_ptr(), tiles.data_ptr(), tiles.shape[0], h, group,
                dh, strides, 1.0 / math.sqrt(dh), _KERNEL_DTYPES[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "flash_attention_varlen_lm")
    FLASH_CAUSAL_LAUNCHES += 1
    return out


def _launch_varlen(q, k, v, layout: Varlen, scale):
    """Launch the kernel's packed entry on CUDA tensors of a head width it
    takes, or raise."""
    global FLASH_LAUNCHES, FLASH_F32_LAUNCHES
    n, h, dh = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash kernel: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    cu, tiles = _layout_args(q, layout, (k, v))
    if n == 0:
        return torch.empty_like(q)
    q, k, v = (_kernel_operand(x) for x in (q, k, v))
    out = torch.empty_like(q)
    strides = (ctypes.c_longlong * 8)(*(
        s for x in (q, k, v, out)
        for s in (x.stride(1) if h > 1 else 0, x.stride(0))))
    fn = _build.load("flash_attention").flash_attention_varlen_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                cu.data_ptr(), tiles.data_ptr(), tiles.shape[0], h, dh,
                strides, scale, _KERNEL_DTYPES[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "flash_attention_varlen")
    if q.dtype == torch.float32:
        FLASH_F32_LAUNCHES += 1
    else:
        FLASH_LAUNCHES += 1
    return out
