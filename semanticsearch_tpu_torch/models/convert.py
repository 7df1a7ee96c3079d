"""Flax parameter trees <-> the port's ``state_dict``s.

The JAX package's parameter trees come as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``, or ``core/checkpoint.py``'s reader).
Each model is described by its links: a flax subtree path, the torch module
prefix it maps to, and the kind of layer, whose rule converts one way and
back:

    embed     embedding (V, D)                  -> weight (V, D)
    dense     kernel (in, out), bias            -> weight (out, in), bias
    conv      kernel (*k, in, out), bias        -> weight (out, in, *k), bias
    ln        scale, bias                       -> weight, bias
    qkv       kernel (D, H, Dh), bias (H, Dh)   -> weight (H*Dh, D), bias
    attn_out  kernel (H, Dh, D), bias (D,)      -> weight (D, H*Dh), bias
    lstm      one flax OptimizedLSTMCell: ii/if/ig/io kernels (in, H) with
              no bias, hi/hf/hg/ho kernels (H, H) with bias
                                                -> weight_ih = [i;f;g;o]^T,
                                                   weight_hh likewise,
                                                   bias_hh, bias_ih = 0
    param     a bare array                      -> the same array

The encoder (``SentenceTransformerModel``), the cross-encoder and the
neural OIE tagger's backbone share the transformer block's links. Flax
names its LSTM cells by the parent module in build order
(``OptimizedLSTMCell_0`` and ``_1`` are the first bidirectional LSTM,
forward then backward), not under ``encode``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

_GATES = ("i", "f", "g", "o")  # torch.nn.LSTM's gate order

# (flax path, torch prefix, kind, heads for qkv/attn_out or the LSTM
# direction suffix)
Link = Tuple[Tuple[str, ...], str, str, Any]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().cpu().numpy().copy()


def _to_torch(kind: str, tree, prefix: str, arg) -> Dict[str, torch.Tensor]:
    if kind == "param":
        return {prefix: _t(tree)}
    if kind == "embed":
        return {f"{prefix}.weight": _t(tree["embedding"])}
    if kind == "ln":
        return {f"{prefix}.weight": _t(tree["scale"]),
                f"{prefix}.bias": _t(tree["bias"])}
    if kind == "lstm":
        w_ih = np.concatenate([tree[f"i{g}"]["kernel"] for g in _GATES], 1)
        w_hh = np.concatenate([tree[f"h{g}"]["kernel"] for g in _GATES], 1)
        b_hh = np.concatenate([tree[f"h{g}"]["bias"] for g in _GATES])
        return {f"{prefix}.weight_ih_l0{arg}": _t(w_ih.T),
                f"{prefix}.weight_hh_l0{arg}": _t(w_hh.T),
                f"{prefix}.bias_ih_l0{arg}": torch.zeros(b_hh.shape[0]),
                f"{prefix}.bias_hh_l0{arg}": _t(b_hh)}
    kernel = np.asarray(tree["kernel"], np.float32)
    bias = _t(np.asarray(tree["bias"]).reshape(-1))
    if kind == "conv":
        nd = kernel.ndim - 2
        weight = kernel.transpose(nd + 1, nd, *range(nd))
    elif kind == "attn_out":
        weight = kernel.reshape(-1, kernel.shape[-1]).T
    else:  # dense, qkv
        weight = kernel.reshape(kernel.shape[0], -1).T
    return {f"{prefix}.weight": _t(weight), f"{prefix}.bias": bias}


def _to_flax(kind: str, sd: Mapping[str, torch.Tensor], prefix: str, arg):
    if kind == "param":
        return _np(sd[prefix])
    if kind == "embed":
        return {"embedding": _np(sd[f"{prefix}.weight"])}
    if kind == "ln":
        return {"scale": _np(sd[f"{prefix}.weight"]),
                "bias": _np(sd[f"{prefix}.bias"])}
    if kind == "lstm":
        w_ih = _np(sd[f"{prefix}.weight_ih_l0{arg}"])
        w_hh = _np(sd[f"{prefix}.weight_hh_l0{arg}"])
        # flax's input kernels have no bias: fold torch's into the hidden
        b = (_np(sd[f"{prefix}.bias_hh_l0{arg}"])
             + _np(sd[f"{prefix}.bias_ih_l0{arg}"]))
        h = w_hh.shape[1]
        cell = {}
        for n, g in enumerate(_GATES):
            rows = slice(n * h, (n + 1) * h)
            cell[f"i{g}"] = {"kernel": w_ih[rows].T.copy()}
            cell[f"h{g}"] = {"kernel": w_hh[rows].T.copy(),
                             "bias": b[rows].copy()}
        return cell
    weight = _np(sd[f"{prefix}.weight"])
    bias = _np(sd[f"{prefix}.bias"])
    if kind == "conv":
        nd = weight.ndim - 2
        kernel = weight.transpose(*range(2, nd + 2), 1, 0)
    elif kind == "qkv":
        d_in = weight.shape[1]
        kernel = weight.T.reshape(d_in, arg, -1)
        bias = bias.reshape(arg, -1)
    elif kind == "attn_out":
        kernel = weight.T.reshape(arg, -1, weight.shape[0])
    else:  # dense
        kernel = weight.T
    return {"kernel": kernel.copy(), "bias": bias}


def _block_links(flax_name: str, prefix: str, heads: Optional[int]
                 ) -> List[Link]:
    """One transformer block (``models/encoder.py::TransformerBlock``)."""
    mha = (flax_name, "MultiHeadDotProductAttention_0")
    return [
        ((flax_name, "LayerNorm_0"), f"{prefix}.ln_attn", "ln", None),
        ((flax_name, "LayerNorm_1"), f"{prefix}.ln_mlp", "ln", None),
        *[(mha + (n,), f"{prefix}.attn.{n}", "qkv", heads)
          for n in ("query", "key", "value")],
        (mha + ("out",), f"{prefix}.attn.out", "attn_out", heads),
        ((flax_name, "Dense_0"), f"{prefix}.mlp_in", "dense", None),
        ((flax_name, "Dense_1"), f"{prefix}.mlp_out", "dense", None),
    ]


def _stack_links(table: str, n_layers: int, heads: Optional[int]
                 ) -> List[Link]:
    """The embedding-LayerNorm-blocks-LayerNorm stack of the encoder
    (token table ``token_embed``) and the cross-encoder (``embedding``)."""
    links: List[Link] = [
        ((table,), table, "embed", None),
        (("pos_embed",), "pos_embed", "embed", None),
        (("LayerNorm_0",), "ln_embed", "ln", None),
        (("LayerNorm_1",), "ln_final", "ln", None),
    ]
    for i in range(n_layers):
        links += _block_links(f"layer_{i}", f"layers.{i}", heads)
    return links


def _lstm_links(first_cell: int, prefix: str, bidirectional: bool
                ) -> List[Link]:
    dirs = ("", "_reverse") if bidirectional else ("",)
    return [((f"OptimizedLSTMCell_{first_cell + n}",), prefix, "lstm", d)
            for n, d in enumerate(dirs)]


def _single(*names: str, kind: str = "dense") -> List[Link]:
    return [((n,), n, kind, None) for n in names]


def _links(model: torch.nn.Module) -> List[Link]:
    """The links of a reranker (or MLPHead) instance."""
    name = type(model).__name__
    emb = _single("embedding", kind="embed")
    if name == "MLPHead":
        return _single(*(f"Dense_{i}" for i in range(model.n_hidden + 1)))
    if name == "KNRM":
        return emb + _single("out")
    if name == "ConvKNRM":
        return emb + [(("ngrams", f"conv_{n}"), f"ngrams.conv_{n}", "conv",
                       None) for n in range(1, model.ngrams.max_ngram + 1)
                      ] + _single("out")
    if name == "MatchPyramid":
        return emb + _single(*(f"conv_{i}" for i in range(model.n_conv)),
                             kind="conv") + _single("out")
    if name == "ArcII":
        return emb + _single(
            "conv1d_left", "conv1d_right",
            *(f"conv2d_{i}" for i in range(model.n_conv)), kind="conv"
        ) + _single("out")
    if name == "ESIM":
        return (emb + _lstm_links(0, "encode", True)
                + _lstm_links(2, "compose", True)
                + _single("projection", "mlp", "out"))
    if name == "MatchLSTM":
        return (emb + _lstm_links(0, "encode", True)
                + _lstm_links(2, "compose", False)
                + _single("projection", "out"))
    if name == "MVLSTM":
        return emb + _lstm_links(0, "encode", True) + _single("mlp", "out")
    if name == "CrossEncoder":
        heads = model.layers[0].attn.num_heads if len(model.layers) else None
        return (_stack_links("embedding", len(model.layers), heads)
                + _single("seg_embed", kind="embed")
                + _single("cls_token", kind="param")
                + _single("pool_dense", "score"))
    raise KeyError(f"no parameter links for {name}")


def _subtree(params: Mapping, path: Tuple[str, ...]):
    node = params
    for key in path:
        node = node[key]
    return node


def _leaf_paths(tree, prefix=()) -> set:
    if isinstance(tree, Mapping):
        out = set()
        for k, v in tree.items():
            out |= _leaf_paths(v, prefix + (k,))
        return out
    return {prefix}


def _convert(links: List[Link], params: Mapping) -> Dict[str, torch.Tensor]:
    """Apply the links flax -> torch; every flax leaf must be consumed and
    every link found, or ValueError names the difference."""
    sd: Dict[str, torch.Tensor] = {}
    used: set = set()
    for path, prefix, kind, arg in links:
        try:
            sub = _subtree(params, path)
            sd.update(_to_torch(kind, sub, prefix, arg))
        except (KeyError, TypeError) as exc:
            raise ValueError(
                f"flax tree lacks {'/'.join(path)} ({kind}): {exc!r}") from exc
        used |= {path + p for p in _leaf_paths(sub)}
    extra = _leaf_paths(params) - used
    if extra:
        raise ValueError(
            "flax tree has parameters the port's model does not: "
            f"{sorted('/'.join(p) for p in extra)[:8]}")
    return sd


def _links_to_flax(links: List[Link], sd: Mapping[str, torch.Tensor]
                   ) -> Dict[str, Any]:
    """Apply the links torch -> flax: nested dicts of float32 arrays."""
    tree: Dict[str, Any] = {}
    for path, prefix, kind, arg in links:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _to_flax(kind, sd, prefix, arg)
    return tree


def flax_to_state_dict(params: Mapping, num_layers: int
                       ) -> Dict[str, torch.Tensor]:
    """Map the encoder's flax parameter tree onto
    ``SentenceTransformerModel``'s ``state_dict`` keys (float32 tensors on
    the CPU)."""
    return _convert(_stack_links("token_embed", num_layers, None), params)


def encoder_flax_tree(state_dict: Mapping[str, torch.Tensor],
                      num_layers: int, num_heads: int) -> Dict[str, Any]:
    """The inverse of :func:`flax_to_state_dict`: the encoder's flax
    parameter tree (nested dicts of float32 numpy arrays) from a
    ``SentenceTransformerModel`` ``state_dict`` or any mapping with its
    keys (an optimizer's moments)."""
    return _links_to_flax(_stack_links("token_embed", num_layers, num_heads),
                          state_dict)


def _tagger_links(num_layers: int, heads: Optional[int]) -> List[Link]:
    """The neural OIE tagger (``oie/neural.py``): the encoder's stack under
    ``backbone`` and a dense ``tag_head``."""
    return [(("backbone",) + path, f"backbone.{prefix}", kind, arg)
            for path, prefix, kind, arg in
            _stack_links("token_embed", num_layers, heads)
            ] + _single("tag_head")


def oie_tagger_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Map the tagger's flax tree ``{"backbone": <encoder tree>,
    "tag_head": {kernel, bias}}`` onto ``OIETagModel``'s ``state_dict``
    (float32 tensors on the CPU); the depth is read from the tree."""
    try:
        n_layers = sum(k.startswith("layer_") for k in params["backbone"])
    except (KeyError, TypeError) as exc:
        raise ValueError("flax tree has no backbone") from exc
    return _convert(_tagger_links(n_layers, None), params)


def oie_tagger_flax_tree(state_dict: Mapping[str, torch.Tensor],
                         num_layers: int, num_heads: int) -> Dict[str, Any]:
    """The inverse of :func:`oie_tagger_state_dict`: the tagger's flax tree
    (nested dicts of float32 numpy arrays)."""
    return _links_to_flax(_tagger_links(num_layers, num_heads), state_dict)


def reranker_state_dict(name: str, params: Mapping, **model_kwargs
                        ) -> Dict[str, torch.Tensor]:
    """Map the flax parameter tree of reranker ``name`` (built with
    ``model_kwargs``) onto its module's ``state_dict`` (float32 tensors on
    the CPU). Names the model does not have, or lacks, and shapes other
    than the model's raise ValueError."""
    from .rerankers import make_model

    try:
        vocab, dim = np.shape(params["embedding"]["embedding"])
    except (KeyError, TypeError, ValueError) as exc:
        raise ValueError(f"{name}: flax tree has no embedding table") from exc
    model = make_model(name, vocab_size=vocab, embed_dim=dim, **model_kwargs)
    sd = _convert(_links(model), params)
    want = model.state_dict()
    if set(sd) != set(want):
        raise ValueError(f"{name}: converted keys differ from the model's: "
                         f"{sorted(set(sd) ^ set(want))[:8]}")
    for key, t in want.items():
        lazy = isinstance(t, torch.nn.parameter.UninitializedParameter)
        if not lazy and tuple(sd[key].shape) != tuple(t.shape):
            raise ValueError(
                f"{name}: {key} has shape {tuple(sd[key].shape)} in the "
                f"tree, {tuple(t.shape)} in the model built with "
                f"{model_kwargs}")
    return sd


def reranker_flax_tree(model: torch.nn.Module,
                       tensors: Optional[Mapping[str, torch.Tensor]] = None
                       ) -> Dict[str, Any]:
    """The inverse of :func:`reranker_state_dict`: the flax parameter tree
    (nested dicts of float32 numpy arrays) of a reranker instance, or of
    ``tensors`` keyed like its ``state_dict`` (an optimizer's moments)."""
    return _links_to_flax(_links(model),
                          model.state_dict() if tensors is None else tensors)


def reranker_tensors(model: torch.nn.Module, tree: Mapping
                     ) -> Dict[str, torch.Tensor]:
    """A flax tree laid out like ``model``'s (its parameters, or an
    optimizer's moments of them) as tensors keyed like its
    ``state_dict``; LSTM ``bias_ih`` come back zero."""
    return _convert(_links(model), tree)
