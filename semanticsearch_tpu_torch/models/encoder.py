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

Packed texts: the unsharded inference forward (``encode``,
``encode_device``) runs on the real tokens of its texts end to end, (N,)
ids with an ``ops.flash_attention.Varlen`` layout in place of the mask, so
the embeddings, every LayerNorm, dense layer, GELU and residual add take
(N, hidden) and no padding; attention takes the kernel's packed entry
(flash) or its plain version (stock, and the CPU), and mean pooling is a
segment sum over the texts' offsets. Training, ``return_tokens`` callers,
the mesh and head widths past 256 under flash keep (B, T) and a mask.

Meshes (``core/mesh.py``): with ``mesh=`` the encoder is data parallel,
as the JAX encoder is under a batch sharded over ``data``. A batch is
padded to a multiple of the data shards, each row slice runs its forward
on its shard's device (a replica of the serving module there; the flash
kernel launches once per slice on a card), and the outputs are
concatenated in order on the first device. On a mesh with a ``model`` axis
that divides the heads and the MLP width, each slice runs the
tensor-parallel forward of ``parallel/tensor.py`` instead. A mesh of one
device is the single-device path. On a mesh across processes
(``core/distributed.py``) training is data parallel across them too: each
process forwards only its own rows of the global batch
(:meth:`SentenceEncoder.train_forward`); encoding stays replicated, every
process encoding the whole batch on its own shards.

Parameters: as flax keeps float32 parameters and computes in ``dtype``,
the BERT family keeps float32 master parameters (``master``) beside the
serving module (``model``, in ``cfg.dtype``; the same module when that is
float32). Training (``train/encoder_train.py``, ``train/mlm_pretrain.py``)
runs the serving module's forward on the masters cast to ``cfg.dtype``
(:meth:`SentenceEncoder.train_forward`), so the gradient reaches the
float32 masters, and :meth:`SentenceEncoder.sync` copies them into the
serving module after a step.

Families: a config's type names its model family's module
(``_FAMILIES``, the one place that names one): this module's BERT block
for an ``EncoderConfig``, ``models/lfm2_moe.py``'s causal LFM2-MoE model,
pooled at each text's last token, for an ``LFM2MoEConfig``. Each module
has ``build_model(cfg, device, seed, state_dict)``, which builds every
module once, on the meta device, then gives it its weights, and returns
the serving module with its float32 masters, or None; and ``ON_MESH``,
whether the family runs on a mesh. Each model's ``packs(lens)`` says
whether a batch of texts of these token counts runs packed. LFM2-MoE is
inference only: built in ``cfg.dtype`` from the state dict's own tensors,
with no float32 master (an 8B-parameter model's masters would not fit
beside its index), so training, :meth:`SentenceEncoder.sync` and a mesh
raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import importlib
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F
from torch.overrides import TorchFunctionMode

from ..core import profiling
from ..core.config import EncoderConfig, LFM2MoEConfig
from ..ops.flash_attention import (
    Varlen, flash_attention, flash_attention_varlen,
    flash_attention_varlen_plain, varlen_tiles)
from .tokenizer import HashingTokenizer

_LN_EPS = 1e-6  # flax LayerNorm's epsilon (torch's default is 1e-5)
_BUCKETS = (64, 128, 256)
# tokens the encoder's forwards took in this process (encode and
# encode_device): the texts' real tokens, and the positions run (a packed
# forward's real tokens; a padded one's rows x bucket length, rows padded
# to the mesh's shards included); and the forwards that ran packed
TOKENS_REAL = 0
TOKENS_RUN = 0
PACKED_FORWARDS = 0
# a config's type -> its model family's module (``build_model``,
# ``ON_MESH``): the one place that names a family
_FAMILIES = {EncoderConfig: __name__,
             LFM2MoEConfig: f"{__package__}.lfm2_moe"}
ON_MESH = True  # the BERT family runs data or tensor parallel on a mesh


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

    def keep_mask(self, shape, device) -> torch.Tensor:
        """A mask of elements kept, drawn on the generator's device (a
        data-parallel slice may run on another) and placed on ``device``."""
        g = self.generator
        return (torch.rand(shape, generator=g,
                           device=device if g is None else g.device)
                >= self.p).to(device)

    def forward(self, x: torch.Tensor,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``keep``: a mask the caller drew (:meth:`keep_mask`), else one
        is drawn here."""
        if not self.training or self.p == 0.0:
            return x
        if keep is None:
            keep = self.keep_mask(x.shape, x.device)
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
    adapter takes none.

    The module also runs on one tensor-parallel position's parameter
    slices (``parallel/tensor.py``): its heads are then the query weight's
    rows over the head width, its output a partial product of the out
    projection, and ``keep`` that position's heads of the attention-weight
    dropout mask."""

    def __init__(self, hidden_dim: int, num_heads: int,
                 dropout_rate: float = 0.0) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = hidden_dim // num_heads
        self.query = nn.Linear(hidden_dim, hidden_dim)
        self.key = nn.Linear(hidden_dim, hidden_dim)
        self.value = nn.Linear(hidden_dim, hidden_dim)
        self.out = nn.Linear(hidden_dim, hidden_dim)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, mask, flash: bool,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, T, hidden) with a (B, T) mask, or packed texts' (N,
        hidden) with their ``Varlen`` layout."""
        dh = self.head_dim
        h = self.query.weight.shape[0] // dh
        if isinstance(mask, Varlen):
            q, k, v = (p(x).unflatten(-1, (h, dh))
                       for p in (self.query, self.key, self.value))
            attend = (flash_attention_varlen if flash
                      else flash_attention_varlen_plain)
            return self.out(attend(q, k, v, mask).flatten(1))
        b, t, _ = x.shape
        q = self.query(x).view(b, t, h, dh)
        k = self.key(x).view(b, t, h, dh)
        v = self.value(x).view(b, t, h, dh)
        if flash:
            o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), mask.to(torch.float32))
            o = o.transpose(1, 2)
        else:
            q = q / torch.tensor(math.sqrt(dh), dtype=q.dtype)
            s = torch.einsum("bqhd,bkhd->bhqk", q, k)
            s = s.masked_fill(~mask.bool()[:, None, None, :],
                              torch.finfo(s.dtype).min)
            w = self.dropout(torch.softmax(s.float(), dim=-1).to(v.dtype),
                             keep)
            o = torch.einsum("bhqk,bkhd->bqhd", w, v)
        return self.out(o.reshape(b, t, h * dh))


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

    def forward(self, x, mask, flash: bool, branch: Optional[str] = None,
                keep: Optional[torch.Tensor] = None):
        """The pre-LN block. ``branch`` ("attn" or "mlp") returns that
        residual branch alone, the MLP's before its dropout: the
        tensor-parallel forward sums each branch over the model axis."""
        if branch == "attn":
            return self.attn(self.ln_attn(x), mask, flash, keep)
        if branch == "mlp":
            return self.mlp_out(F.gelu(self.mlp_in(self.ln_mlp(x)),
                                       approximate="tanh"))
        x = x + self.forward(x, mask, flash, "attn")
        return x + self.dropout(self.forward(x, mask, flash, "mlp"))


class SentenceTransformerModel(nn.Module):
    """Token+position embed -> N pre-LN blocks -> masked mean pool -> L2.

    ``forward(ids, mask)`` returns (B, hidden_dim) float32 embeddings;
    ``return_tokens=True`` returns the final (B, T, hidden_dim) token states
    in float32 instead. ``forward(ids, layout)`` takes packed texts, (N,)
    ids and their ``Varlen`` layout, and returns one embedding a text.
    Parameters follow the module's dtype."""

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

    def forward(self, ids: torch.Tensor, mask,
                return_tokens: bool = False,
                run_block: Optional[Callable] = None) -> torch.Tensor:
        """``run_block(i, x, flash)`` takes the place of block i's call
        (the tensor-parallel forward, ``parallel/tensor.py``)."""
        c = self.cfg
        flash = use_flash(c, ids.device)
        if isinstance(mask, Varlen):  # each token at its place in its text
            x = self.token_embed(ids) + self.pos_embed(mask.pos)
        else:
            pos = torch.arange(ids.shape[1], device=ids.device)
            x = self.token_embed(ids) + self.pos_embed(pos)[None]
        x = self.ln_embed(x)
        for i, layer in enumerate(self.layers):
            x = (layer(x, mask, flash) if run_block is None
                 else run_block(i, x, flash))
        return pool_tokens(c, self.ln_final(x), mask, return_tokens)

    def packs(self, lens: np.ndarray) -> bool:
        """Whether texts with these token counts run packed: not at a head
        width the packed kernel lacks (past 256, under flash), nor under
        cls pooling with a text of no token, whose first position is a pad
        that packing has no place for."""
        c = self.cfg
        return ((c.hidden_dim // c.num_heads <= 256
                 or not use_flash(c, self.ln_final.weight.device))
                and (c.pooling != "cls" or int(lens.min()) > 0))


def pool_tokens(cfg: EncoderConfig, x: torch.Tensor, mask,
                return_tokens: bool = False) -> torch.Tensor:
    """The model's head on the final token states ``x``: the tokens in
    float32, or the masked mean (or first token) pooled and L2-normalized
    by the rsqrt of the clamped squared norm. Packed texts (``mask`` a
    ``Varlen``) pool by their offsets: a segment sum, rounded to x's dtype
    as the masked sum is, over the length clamped at 1 (a text with no
    token pools to 0), or the text's first token."""
    if return_tokens:
        return x.float()
    if isinstance(mask, Varlen):
        cu = mask.cu_seqlens
        if cfg.pooling == "cls":
            pooled = x.index_select(0, cu[:-1])
        else:
            n = torch.clamp(cu[1:] - cu[:-1], min=1).to(x.dtype)[:, None]
            pooled = torch.segment_reduce(x.float(), "sum", offsets=cu,
                                          axis=0).to(x.dtype) / n
    elif cfg.pooling == "cls":
        pooled = x[:, 0, :]
    else:
        m = mask[..., None].to(x.dtype)
        pooled = (x * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
    return l2_head(cfg, pooled.float())


def l2_head(cfg: EncoderConfig, pooled: torch.Tensor) -> torch.Tensor:
    """Both families' last step on their pooled (B, hidden) float32
    states: where ``cfg.normalize``, each row times the rsqrt of its
    squared norm clamped at 1e-18 (a zero row stays zero)."""
    if not cfg.normalize:
        return pooled
    sq = (pooled * pooled).sum(dim=-1, keepdim=True)
    return pooled * torch.rsqrt(torch.clamp(sq, min=1e-18))


class _SkipInit(TorchFunctionMode):
    """Leaves every ``torch.nn.init`` call undone: a module built on the
    meta device is given its weights afterwards, and those calls' meta
    kernels import ``torch._dynamo`` the first time, seconds of set-up."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__module__", None) == "torch.nn.init":
            return args[0] if args else kwargs["tensor"]
        return func(*args, **(kwargs or {}))


def on_meta(model_cls, cfg: EncoderConfig) -> nn.Module:
    """``model_cls(cfg)`` on the meta device, with no default init."""
    with torch.device("meta"), _SkipInit():
        return model_cls(cfg)


def _assigned(cfg: EncoderConfig, tensors: dict) -> SentenceTransformerModel:
    """The model built on the meta device and given ``tensors`` themselves
    (``load_state_dict(assign=True)``, strict), in eval mode."""
    model = on_meta(SentenceTransformerModel, cfg)
    model.load_state_dict(tensors, assign=True)
    return model.eval()


def build_model(cfg: EncoderConfig, device: torch.device, seed: int = 0,
                state_dict: Optional[dict] = None):
    """The BERT family's (serving module, float32 masters) on ``device``,
    each module built once. The masters take ``state_dict``'s tensors as
    float32 copies of their own (training updates them in place, and must
    not write into the caller's), or the seeded init drawn from the host
    generator of ``seed``. The serving module is the masters at float32,
    else a module given their casts to ``cfg.dtype``."""
    if state_dict is None:
        master = on_meta(SentenceTransformerModel, cfg)
        master.to_empty(device=device).eval()
        master.reset_parameters(torch.Generator().manual_seed(seed))
    else:
        master = _assigned(cfg, {
            k: v.to(device=device, dtype=torch.float32, copy=True,
                    memory_format=torch.contiguous_format)
            for k, v in state_dict.items()})
    dtype = getattr(torch, cfg.dtype)
    if dtype == torch.float32:
        return master, master
    return _assigned(cfg, {k: v.to(dtype)
                           for k, v in master.state_dict().items()}), master


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU")
    return device


class SentenceEncoder:
    """Batched sentence encoding on one device or a mesh.

    Texts are tokenized on the host. On one device they run in input
    order, ``batch_size`` a forward, packed (the module docstring), or,
    where the model cannot pack them (its ``packs``), padded to the length
    bucket (64/128/256, capped at ``max_len``) of the forward's longest
    text. On a mesh they are padded into the smallest bucket that holds
    each, run per bucket and batch, and reassembled in input order.
    ``master`` holds the float32 parameters (what training updates and
    ``save_encoder`` writes; None for an inference-only family), ``model``
    serves in ``cfg.dtype``. With
    ``mesh`` (see the module docstring) ``device`` is the mesh's first
    device.
    """

    def __init__(
        self,
        cfg: EncoderConfig = EncoderConfig(),
        device="cuda",
        seed: int = 0,
        tokenizer=None,
        state_dict: Optional[dict] = None,
        mesh=None,
    ) -> None:
        from ..parallel.tensor import mesh_tp_size, tp_compatible

        self.cfg = cfg
        self.mesh = mesh
        family = importlib.import_module(_FAMILIES[type(cfg)])
        if mesh is not None and not family.ON_MESH:
            raise NotImplementedError(f"the {cfg.arch} encoder runs on one "
                                      f"device, not on a mesh")
        if mesh is not None:
            from ..core.mesh import local_row_devices, local_rows

            # one row slice a data shard, on its shard's device
            self._data_devices = local_row_devices(mesh)
            self._data_rows = local_rows(mesh)
            device = self._data_devices[0]
        self.device = _resolve_device(device)
        self._tp = (mesh_tp_size(mesh)
                    if tp_compatible(cfg, mesh_tp_size(mesh)) else 1)
        self._n_data = len(self._data_devices) if mesh is not None else 1
        # processes split the global batch (train_forward)
        self._multiprocess = mesh is not None and mesh.group is not None
        self.tokenizer = tokenizer or HashingTokenizer(
            vocab_size=cfg.vocab_size, max_len=cfg.max_len)
        if self._tp > 1:
            # stock attention under TP, as in the JAX package
            cfg = dataclasses.replace(cfg, attention="stock")
        # master None: inference only, the serving weights alone
        self.model, self.master = family.build_model(cfg, self.device, seed,
                                                     state_dict)
        self._place()

    @property
    def sharded(self) -> bool:
        """True when forwards split over several data shards or run
        tensor parallel."""
        return self._n_data > 1 or self._tp > 1

    def _place(self) -> None:
        """The serving module's copies on the mesh: a replica on every
        other device of the data shards, or each TP position's parameter
        slices."""
        if not self.sharded:
            return
        if self._tp > 1:
            from ..parallel.tensor import shard_encoder_params

            self._tp_shards = shard_encoder_params(
                dict(self.model.named_parameters()), self.mesh, self.cfg)
            return
        self._replicas = {self.device: self.model}
        for dev in self._data_devices:
            if dev not in self._replicas:
                self._replicas[dev] = _assigned(self.model.cfg, {
                    k: v.to(dev) for k, v in self.model.state_dict().items()})

    def _trainable(self) -> None:
        if self.master is None:
            raise NotImplementedError(
                f"the {self.cfg.arch} encoder is inference only: it holds "
                f"its serving weights in {self.cfg.dtype} and no float32 "
                f"masters")

    def sync(self) -> None:
        """Copy the float32 masters into the serving module (cast to
        ``cfg.dtype``) and its copies on the mesh."""
        self._trainable()
        if self.model is not self.master:
            with torch.no_grad():
                for p, m in zip(self.model.parameters(),
                                self.master.parameters()):
                    p.copy_(m)
        self._place()

    def _tp_row(self, i: int, params: Optional[dict], dtype):
        """Data shard i's model row: (parameter slices per device,
        devices)."""
        from ..parallel.tensor import encoder_param_specs, shard_row

        row = list(self.mesh.devices[i])
        if params is None:
            return [self._tp_shards[(i, j)] for j in range(len(row))], row
        cast = {k: v.to(dtype) for k, v in params.items()}
        return shard_row(cast, encoder_param_specs(cast), row), row

    def _mesh_apply(self, ids: Sequence[torch.Tensor],
                    masks: Sequence[torch.Tensor],
                    params: Optional[dict] = None,
                    return_tokens: bool = False) -> torch.Tensor:
        """One forward per data shard on its row slice (``ids[i]`` and
        ``masks[i]`` already on shard i's device): the serving copies, or
        in training (``params``, the float32 masters) the serving module
        on their casts, one cast a shard even where shards share a device,
        so each shard's gradient reaches the masters in float32 and the
        shards' gradients sum there, as they do across devices and across
        processes. Each shard's launches are issued before its output is
        copied to the first device; outputs concatenate in order."""
        dtype = getattr(torch, self.cfg.dtype)
        training = params is not None
        outs = []
        for i, (dev, ids_i, mask_i) in enumerate(
                zip(self._data_devices, ids, masks)):
            if self._tp > 1:
                from ..parallel.tensor import tp_forward

                shards, row = self._tp_row(self._data_rows[i], params,
                                           dtype)
                out = tp_forward(self.model, shards, row, ids_i, mask_i,
                                 return_tokens=return_tokens)
            elif not training:
                out = self._replicas[dev](ids_i, mask_i,
                                          return_tokens=return_tokens)
            else:
                cast = {k: v.to(dtype).to(dev, non_blocking=True)
                        for k, v in params.items()}
                out = torch.func.functional_call(
                    self.model, cast, (ids_i, mask_i),
                    {"return_tokens": return_tokens})
            outs.append(out.to(self.device, non_blocking=True))
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def _row_bounds(self, b: int):
        """The row offsets of a global batch of ``b`` rows over the global
        row shards (``tensor_split``); each process forwards its block of
        shards, so its rows are contiguous on a process-major mesh."""
        from ..core.distributed import check_process_major
        from ..core.mesh import n_row_shards, split_bounds

        check_process_major(self.mesh)
        return split_bounds(b, n_row_shards(self.mesh))

    def local_shard_rows(self, b: int) -> list:
        """The rows of a global training batch of ``b`` rows that each of
        this process's row shards forwards in :meth:`train_forward`, in
        shard order; one slice of every row without a mesh."""
        if self.mesh is None:
            return [slice(0, b)]
        bounds = self._row_bounds(b)
        return [slice(bounds[i], bounds[i + 1]) for i in self._data_rows]

    def _process_generator(self, generator: torch.Generator
                           ) -> torch.Generator:
        """This process's dropout generator for one :meth:`train_forward`
        call across processes. ``generator`` is shared: every process holds
        it in the same state, so its state names the call, and one draw
        from it moves it on for the next call. The state is read on the
        host, so nothing waits for the card."""
        place = hashlib.sha256(
            generator.get_state().numpy().tobytes()).digest()
        torch.rand(1, generator=generator, device=generator.device)
        return dropout_generator(generator.device,
                                 int.from_bytes(place[:8], "little"),
                                 self._data_rows[0])

    def train_forward(self, ids: torch.Tensor, mask: torch.Tensor,
                      params: dict, return_tokens: bool = False,
                      generator: Optional[torch.Generator] = None,
                      gather: bool = True) -> torch.Tensor:
        """The serving module's forward in training mode on ``params`` (the
        float32 masters by name) cast to ``cfg.dtype``: the casts carry the
        gradient back to float32, as flax's ``dtype`` does. Dropout masks
        come from ``generator``.

        On a mesh the global batch's rows split with ``tensor_split`` over
        the global row shards, as JAX's ``P("data")`` cuts them. Inside one
        process every shard is local and the output is the whole batch's
        on the first device, so a loss over it sees every shard's rows.
        Across processes (a mesh with a group, process-major) this process
        forwards only its block of shards' rows (:meth:`local_shard_rows`)
        and returns every process's rows gathered in process order
        (``gather``; differentiable, ``core.distributed.gather_rows``: what
        a loss with in-batch negatives needs) or its own rows alone
        (``gather=False``, for a loss that splits by row).

        Dropout across processes: each call draws from a generator of this
        process's own (:meth:`_process_generator`), seeded from where
        ``generator`` stands in its stream and from the first row shard,
        and then moves ``generator`` on. So no two processes draw the same
        masks for different rows, two calls of one step (a trainer's query
        side, then its chunk side) draw fresh ones, and a rerun draws the
        same; inside one process the shards draw from ``generator``
        itself, in shard order."""
        self._trainable()
        dtype = getattr(torch, self.cfg.dtype)
        if self._multiprocess and generator is not None:
            generator = self._process_generator(generator)
        set_dropout_generator(self.model, generator)
        self.model.train()
        try:
            if self.sharded or self._multiprocess:
                shards = self.local_shard_rows(ids.shape[0])
                out = self._mesh_apply(
                    [ids[s].to(d, non_blocking=True)
                     for s, d in zip(shards, self._data_devices)],
                    [mask[s].to(d, non_blocking=True)
                     for s, d in zip(shards, self._data_devices)],
                    params, return_tokens)
                if self._multiprocess and gather:
                    from ..core.distributed import gather_rows

                    bounds, per = self._row_bounds(ids.shape[0]), self._n_data
                    out = gather_rows(self.mesh, out, [
                        bounds[p + per] - bounds[p]
                        for p in range(0, len(bounds) - 1, per)])
                return out
            cast = {k: v.to(dtype) for k, v in params.items()}
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

    def _groups(self, texts: Sequence[str]) -> list:
        """Tokenize ``texts`` into forward groups, each (launch, positions)
        with ``launch(sel)`` the asynchronous forward of the texts at
        positions ``sel``: on one device one group, every text in input
        order (:meth:`_forward_batch`); on a mesh one a length bucket
        (:meth:`_buckets`, :meth:`_forward_bucket`)."""
        with profiling.span("encoder.tokenize"):
            ids, mask = self.tokenizer.encode_batch(
                texts, max_len=self.cfg.max_len)
            lens = mask.sum(axis=1)
            if not self.sharded:
                return [(functools.partial(self._forward_batch, ids, mask,
                                           lens), np.arange(len(texts)))]
            return [(functools.partial(self._forward_bucket, ids, mask, lens,
                                       L), idxs)
                    for L, idxs in self._buckets(lens).items()]

    def _buckets(self, lens: np.ndarray) -> dict:
        """A mesh's forward groups: the positions of the texts of each
        length bucket, by the bucket."""
        buckets: dict = {}
        for i, ln in enumerate(lens):
            buckets.setdefault(self._bucket_for(int(ln)), []).append(i)
        return buckets

    def _forward_batch(self, ids: np.ndarray, mask: np.ndarray,
                       lens: np.ndarray, sel: np.ndarray) -> torch.Tensor:
        """One device: launch the model on a run of texts in input order
        (asynchronous), packed, or, where the model cannot pack them,
        padded to their longest text's bucket. Counts the batch's real
        tokens and the positions it runs."""
        global TOKENS_REAL, TOKENS_RUN, PACKED_FORWARDS
        rows = slice(int(sel[0]), int(sel[-1]) + 1)
        ids, mask, lens = ids[rows], mask[rows], lens[rows]
        if self.model.packs(lens):
            out, run = self._forward_packed(ids, mask)
            TOKENS_REAL += run
            TOKENS_RUN += run
            PACKED_FORWARDS += 1
            return out
        L = self._bucket_for(int(lens.max()))
        with profiling.span("encoder.forward", {"L": L, "rows": len(sel)}):
            padded = self._upload(
                np.stack([ids[:, :L], mask[:, :L]]).astype(np.int64))
            out = self.model(padded[0], padded[1])
        TOKENS_REAL += int(lens.sum())
        TOKENS_RUN += len(sel) * L
        return out

    def _forward_packed(self, ids: np.ndarray, mask: np.ndarray):
        """Launch the model on one batch of texts, (B, max_len) ids and
        mask, packed end to end: their real tokens, each one's text and
        place in it, the texts' offsets and the attention tiles, built on
        the host and uploaded as one int32 array. Returns the embeddings
        and the tokens run."""
        cols = np.flatnonzero(mask.any(axis=0))
        width = int(cols[-1]) + 1 if cols.size else 0
        seg, pos = np.nonzero(mask[:, :width])
        n = seg.size
        with profiling.span("encoder.forward", {"rows": len(mask),
                                                "tokens": n}):
            cu = np.zeros(len(mask) + 1, np.int64)
            np.cumsum(np.bincount(seg, minlength=len(mask)), out=cu[1:])
            tiles = varlen_tiles(cu)
            host = np.concatenate([ids[seg, pos], pos, seg, cu,
                                   tiles.ravel()]).astype(np.int32)
            tok, pos_d, seg_d, cu_d, tiles_d = torch.split(
                self._upload(host), [n, n, n, len(cu), tiles.size])
            layout = Varlen(cu_d, tiles_d.view(-1, 4), seg_d, pos_d, width)
            return self.model(tok, layout), n

    def _forward_bucket(self, ids: np.ndarray, mask: np.ndarray,
                        lens: np.ndarray, L: int, sel: Sequence[int]
                        ) -> torch.Tensor:
        """A mesh: launch the model on texts of bucket ``L`` (asynchronous),
        padded to ``L`` tokens and to a multiple of the data shards, each
        shard's slice uploaded to its own device. Counts the batch's real
        tokens and the positions it runs."""
        global TOKENS_REAL, TOKENS_RUN
        b, n = len(sel), self._n_data
        b_pad = -(-b // n) * n
        with profiling.span("encoder.forward", {"L": L, "rows": b_pad}):
            padded = np.zeros((2, b_pad, L), np.int64)
            padded[:, :b] = np.stack([ids[sel, :L], mask[sel, :L]])
            step = b_pad // n
            parts = [self._upload(padded[:, i * step: (i + 1) * step], dev)
                     for i, dev in enumerate(self._data_devices)]
            out = self._mesh_apply([p[0] for p in parts],
                                   [p[1] for p in parts])[:b]
        TOKENS_REAL += int(lens[sel].sum())
        TOKENS_RUN += b_pad * L
        return out

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
        order_parts, emb_parts = [], []
        for launch, idxs in self._groups(texts):
            eff, s = batch_size, 0
            while s < len(idxs):
                sel = idxs[s: s + eff]
                try:
                    emb = launch(sel)
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
        with profiling.span("encoder.reorder"):
            inv = np.empty_like(order)
            inv[order] = np.arange(order.size)
            return embs[self._upload(inv)]

    def _upload(self, host: np.ndarray, device=None) -> torch.Tensor:
        """Host array -> device tensor (``device``, default the encoder's)
        without waiting for queued work: a pageable copy would synchronize
        the stream, a pinned one does not."""
        device = self.device if device is None else device
        t = torch.from_numpy(np.ascontiguousarray(host))
        if device.type == "cuda":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

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
        for launch, idxs in self._groups(texts):
            eff, s = batch_size, 0
            pending = None  # (embeddings, texts, start) launched, unfetched
            while s < len(idxs) or pending is not None:
                try:
                    launched = None
                    if s < len(idxs):
                        sel = idxs[s: s + eff]
                        launched = (launch(sel), sel, s)
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
                seed: int = 0, mesh=None) -> SentenceEncoder:
    """Cached encoder lookup, one instance per (config, device, seed,
    mesh); the key holds the mesh itself, which equal meshes share."""
    key = (cfg, str(torch.device(device)), seed, mesh)
    if key not in _ENCODER_CACHE:
        _ENCODER_CACHE[key] = SentenceEncoder(cfg, device=device, seed=seed,
                                              mesh=mesh)
    return _ENCODER_CACHE[key]
