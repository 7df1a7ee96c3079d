"""Transformer sentence encoder in PyTorch.

Counterpart of ``semanticsearch_tpu/models/encoder.py``: token + position
embeddings, LayerNorm, pre-LN transformer blocks, a final LayerNorm, masked
mean pooling and L2 normalisation. The numerics follow the flax model:
LayerNorm eps 1e-6, tanh-approximate GELU, queries scaled by 1/sqrt(Dh)
before the score product, masked scores at the dtype's most negative value,
and an rsqrt of the clamped squared norm. ``models/convert.py`` loads the
flax parameter tree, so both packages embed with the same weights.

Attention: "stock" is plain torch math, "flash" the hand-written kernel
(``ops/flash_attention.py``), and "auto" picks flash on a CUDA device when
dropout is 0 and ``max_len >= 1024``, where the (T, T) score matrix starts
to dominate.

Parameters: as flax keeps float32 parameters and computes in ``dtype``,
``SentenceEncoder`` keeps float32 master parameters (``master``) beside the
serving module (``model``, in ``cfg.dtype``; the same module when that is
float32). Training (``train/encoder_train.py``, ``train/mlm_pretrain.py``)
runs the serving module's forward on the masters cast to ``cfg.dtype``
(:meth:`SentenceEncoder.train_forward`), so the gradient reaches the
float32 masters, and :meth:`SentenceEncoder.sync` copies them into the
serving module after a step.
"""
from __future__ import annotations

import copy
import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..core.config import EncoderConfig
from ..ops.flash_attention import flash_attention
from .tokenizer import HashingTokenizer

_LN_EPS = 1e-6  # flax LayerNorm's epsilon (torch's default is 1e-5)
_BUCKETS = (64, 128, 256)


def use_flash(cfg: EncoderConfig, device: torch.device) -> bool:
    """The attention rule: "flash" forces the kernel, "stock" the plain
    math, "auto" takes the kernel on CUDA for dropout 0 and max_len >=
    1024."""
    attention = cfg.attention
    return attention == "flash" or (
        attention == "auto"
        and torch.device(device).type == "cuda"
        and cfg.dropout_rate == 0.0
        and cfg.max_len >= 1024
    )


class Dropout(nn.Dropout):
    """flax ``nn.Dropout``: in training, each element kept with probability
    1 - p and scaled by 1 / (1 - p). The mask is drawn from ``generator``
    when a training step sets one (a seeded step replays exactly), else
    from the default generator."""

    generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


def dropout_generator(device, *seeds: int) -> torch.Generator:
    """The dropout generator of one training step on ``device``, seeded
    from the run's seed and the step's place (epoch, step in epoch), so a
    rerun or a resumed run draws the same masks."""
    seed = int(np.random.SeedSequence(list(seeds)).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)


def set_dropout_generator(module: nn.Module,
                          generator: Optional[torch.Generator]) -> None:
    """Draw every :class:`Dropout` mask in ``module`` from ``generator``."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (self-attention, key-padding
    mask): query/key/value/out projections over (H, Dh) heads. In training
    the stock path drops attention weights at ``dropout_rate``, as flax's
    does; the flash path has no attention dropout, as the JAX kernel's
    adapter takes none."""

    def __init__(self, hidden_dim: int, num_heads: int,
                 dropout_rate: float = 0.0) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(hidden_dim, hidden_dim)
        self.key = nn.Linear(hidden_dim, hidden_dim)
        self.value = nn.Linear(hidden_dim, hidden_dim)
        self.out = nn.Linear(hidden_dim, hidden_dim)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, flash: bool
                ) -> torch.Tensor:
        b, t, d = x.shape
        h = self.num_heads
        q = self.query(x).view(b, t, h, d // h)
        k = self.key(x).view(b, t, h, d // h)
        v = self.value(x).view(b, t, h, d // h)
        if flash:
            o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), mask.to(torch.float32))
            o = o.transpose(1, 2)
        else:
            q = q / torch.tensor(math.sqrt(d // h), dtype=q.dtype)
            s = torch.einsum("bqhd,bkhd->bhqk", q, k)
            s = s.masked_fill(~mask.bool()[:, None, None, :],
                              torch.finfo(s.dtype).min)
            w = self.dropout(torch.softmax(s.float(), dim=-1).to(v.dtype))
            o = torch.einsum("bhqk,bkhd->bqhd", w, v)
        return self.out(o.reshape(b, t, d))


class TransformerBlock(nn.Module):
    def __init__(self, cfg: EncoderConfig) -> None:
        super().__init__()
        self.ln_attn = nn.LayerNorm(cfg.hidden_dim, eps=_LN_EPS)
        self.attn = MultiHeadAttention(cfg.hidden_dim, cfg.num_heads,
                                       cfg.dropout_rate)
        self.ln_mlp = nn.LayerNorm(cfg.hidden_dim, eps=_LN_EPS)
        self.mlp_in = nn.Linear(cfg.hidden_dim, cfg.mlp_dim)
        self.mlp_out = nn.Linear(cfg.mlp_dim, cfg.hidden_dim)
        self.dropout = Dropout(cfg.dropout_rate)

    def forward(self, x, mask, flash: bool):
        x = x + self.attn(self.ln_attn(x), mask, flash)
        h = F.gelu(self.mlp_in(self.ln_mlp(x)), approximate="tanh")
        return x + self.dropout(self.mlp_out(h))


class SentenceTransformerModel(nn.Module):
    """Token+position embed -> N pre-LN blocks -> masked mean pool -> L2.

    ``forward(ids, mask)`` returns (B, hidden_dim) float32 embeddings;
    ``return_tokens=True`` returns the final (B, T, hidden_dim) token states
    in float32 instead. Parameters follow the module's dtype."""

    def __init__(self, cfg: EncoderConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.token_embed = nn.Embedding(cfg.vocab_size, cfg.hidden_dim)
        self.pos_embed = nn.Embedding(cfg.max_len, cfg.hidden_dim)
        self.ln_embed = nn.LayerNorm(cfg.hidden_dim, eps=_LN_EPS)
        self.layers = nn.ModuleList(
            TransformerBlock(cfg) for _ in range(cfg.num_layers))
        self.ln_final = nn.LayerNorm(cfg.hidden_dim, eps=_LN_EPS)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init in the spirit of flax's defaults: embeddings
        N(0, 1/hidden), dense kernels N(0, 1/fan_in), zero biases, unit
        LayerNorm scales."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("bias"):
                    p.zero_()
                elif p.ndim == 1:
                    p.fill_(1.0)
                else:
                    fan_in = p.shape[1]
                    p.copy_(torch.randn(p.shape, generator=generator)
                            / math.sqrt(fan_in))

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                return_tokens: bool = False) -> torch.Tensor:
        c = self.cfg
        flash = use_flash(c, ids.device)
        pos = torch.arange(ids.shape[1], device=ids.device)
        x = self.token_embed(ids) + self.pos_embed(pos)[None]
        x = self.ln_embed(x)
        for layer in self.layers:
            x = layer(x, mask, flash)
        x = self.ln_final(x)
        if return_tokens:
            return x.float()
        if c.pooling == "cls":
            pooled = x[:, 0, :]
        else:
            m = mask[..., None].to(x.dtype)
            pooled = (x * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
        pooled = pooled.float()
        if c.normalize:
            sq = (pooled * pooled).sum(dim=-1, keepdim=True)
            pooled = pooled * torch.rsqrt(torch.clamp(sq, min=1e-18))
        return pooled


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU")
    return device


class SentenceEncoder:
    """Batched sentence encoding on one device.

    Texts are tokenized on the host, padded into the smallest length bucket
    (64/128/256, capped at ``max_len``), run through the model per bucket
    and batch, and reassembled in input order. ``master`` holds the float32
    parameters (what training updates and ``save_encoder`` writes),
    ``model`` serves in ``cfg.dtype``.
    """

    def __init__(
        self,
        cfg: EncoderConfig = EncoderConfig(),
        device="cuda",
        seed: int = 0,
        tokenizer=None,
        state_dict: Optional[dict] = None,
    ) -> None:
        self.cfg = cfg
        self.device = _resolve_device(device)
        self.tokenizer = tokenizer or HashingTokenizer(
            vocab_size=cfg.vocab_size, max_len=cfg.max_len)
        master = SentenceTransformerModel(cfg)
        if state_dict is None:
            master.reset_parameters(torch.Generator().manual_seed(seed))
        else:
            master.load_state_dict(state_dict)
        self.master = master.to(device=self.device,
                                dtype=torch.float32).eval()
        dtype = getattr(torch, cfg.dtype)
        self.model = (self.master if dtype == torch.float32 else
                      copy.deepcopy(self.master).to(dtype=dtype))

    def sync(self) -> None:
        """Copy the float32 masters into the serving module (cast to
        ``cfg.dtype``)."""
        if self.model is self.master:
            return
        with torch.no_grad():
            for p, m in zip(self.model.parameters(),
                            self.master.parameters()):
                p.copy_(m)

    def train_forward(self, ids: torch.Tensor, mask: torch.Tensor,
                      params: dict, return_tokens: bool = False,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
        """The serving module's forward in training mode on ``params`` (the
        float32 masters by name) cast to ``cfg.dtype``: the casts carry the
        gradient back to float32, as flax's ``dtype`` does. Dropout masks
        come from ``generator``."""
        dtype = getattr(torch, self.cfg.dtype)
        cast = {k: v.to(dtype) for k, v in params.items()}
        set_dropout_generator(self.model, generator)
        self.model.train()
        try:
            return torch.func.functional_call(
                self.model, cast, (ids, mask),
                {"return_tokens": return_tokens})
        finally:
            self.model.eval()
            set_dropout_generator(self.model, None)

    def _bucket_for(self, n_tokens: int) -> int:
        for b in _BUCKETS:
            if n_tokens <= b and b <= self.cfg.max_len:
                return b
        return self.cfg.max_len

    def _buckets(self, texts: Sequence[str]):
        """Token ids and masks of every text, and the text positions in
        each length bucket."""
        ids_full, mask_full = self.tokenizer.encode_batch(
            texts, max_len=self.cfg.max_len)
        buckets: dict = {}
        for i, ln in enumerate(mask_full.sum(axis=1)):
            buckets.setdefault(self._bucket_for(int(ln)), []).append(i)
        return ids_full, mask_full, buckets

    def _forward(self, ids_full: np.ndarray, mask_full: np.ndarray,
                 sel: Sequence[int], L: int) -> torch.Tensor:
        """Launch the model on one batch of texts (asynchronous)."""
        packed = self._upload(np.stack(
            [ids_full[sel, :L], mask_full[sel, :L]]).astype(np.int64))
        return self.model(packed[0], packed[1])

    @torch.no_grad()
    def encode_device(self, texts: Sequence[str], batch_size: int = 256
                      ) -> torch.Tensor:
        """Encode to a DEVICE-RESIDENT (N, hidden_dim) float32 tensor, in
        input order, with no host fetch: the serve path feeds it straight
        into the dense top-k. Launches are asynchronous; uploads go through
        pinned memory so they do not wait for earlier batches. A batch
        whose launch runs out of device memory is retried at half the size
        (down to one text); any other error propagates."""
        if not len(texts):
            return torch.zeros((0, self.cfg.hidden_dim), dtype=torch.float32,
                               device=self.device)
        ids_full, mask_full, buckets = self._buckets(texts)
        order_parts, emb_parts = [], []
        for L, idxs in buckets.items():
            eff, s = batch_size, 0
            while s < len(idxs):
                sel = idxs[s: s + eff]
                try:
                    emb = self._forward(ids_full, mask_full, sel, L)
                except Exception as exc:
                    if not _is_oom(exc) or eff == 1:
                        raise
                    eff = max(1, eff // 2)
                    continue
                emb_parts.append(emb)
                order_parts.append(np.asarray(sel, np.int64))
                s += len(sel)
        order = np.concatenate(order_parts)
        embs = emb_parts[0] if len(emb_parts) == 1 else torch.cat(emb_parts)
        if np.array_equal(order, np.arange(order.size)):
            return embs
        inv = np.empty_like(order)
        inv[order] = np.arange(order.size)
        return embs[self._upload(inv)]

    def _upload(self, host: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without waiting for queued work: a
        pageable copy would synchronize the stream, a pinned one does not."""
        t = torch.from_numpy(host)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    @staticmethod
    def _fetch(emb: torch.Tensor) -> np.ndarray:
        """A batch's embeddings on the host (waits for its launch)."""
        return emb.cpu().numpy()

    @torch.no_grad()
    def encode(self, texts: Sequence[str], batch_size: int = 256
               ) -> np.ndarray:
        """Encode texts to (N, hidden_dim) float32 unit vectors on the host,
        in input order.

        Double-buffered: batch i is launched before batch i-1 is fetched,
        so the card computes while the host copies. Out of device memory,
        whether raised at a launch or only at the fetch of an earlier
        launch (an asynchronous failure surfaces at the next synchronize),
        the bucket restarts at the earliest batch not yet fetched with half
        the batch size (down to one text); any other error propagates."""
        out = np.zeros((len(texts), self.cfg.hidden_dim), np.float32)
        if not len(texts):
            return out
        ids_full, mask_full, buckets = self._buckets(texts)
        for L, idxs in buckets.items():
            eff, s = batch_size, 0
            pending = None  # (embeddings, texts, start) launched, unfetched
            while s < len(idxs) or pending is not None:
                try:
                    launched = None
                    if s < len(idxs):
                        sel = idxs[s: s + eff]
                        launched = (self._forward(ids_full, mask_full, sel,
                                                  L), sel, s)
                    if pending is not None:
                        out[pending[1]] = self._fetch(pending[0])
                    pending = launched
                    if launched is not None:
                        s += len(launched[1])
                except Exception as exc:
                    if not _is_oom(exc) or eff == 1:
                        raise
                    if pending is not None:  # it may be the batch that failed
                        s = pending[2]
                        pending = None
                    eff = max(1, eff // 2)
        return out


def _is_oom(exc: BaseException) -> bool:
    """An out-of-device-memory error: the allocator's, or any error whose
    message says so (a failure surfacing at a later synchronize)."""
    return (isinstance(exc, torch.cuda.OutOfMemoryError)
            or "out of memory" in str(exc).lower())


_ENCODER_CACHE: dict = {}


def get_encoder(cfg: EncoderConfig = EncoderConfig(), device="cuda",
                seed: int = 0) -> SentenceEncoder:
    """Cached encoder lookup, one instance per (config, device, seed)."""
    key = (cfg, str(torch.device(device)), seed)
    if key not in _ENCODER_CACHE:
        _ENCODER_CACHE[key] = SentenceEncoder(cfg, device=device, seed=seed)
    return _ENCODER_CACHE[key]
