"""Tensor parallelism for the sentence encoder over the mesh ``model`` axis.

Counterpart of ``semanticsearch_tpu/parallel/tensor.py``, with its
Megatron-style layout on the port's parameter names (torch ``Linear``
weights are (out, in)):

  - attention query/key/value weights (H*Dh, hidden) and biases: split by
    head over ``model``, so each device computes its heads end to end;
  - attention out weight (hidden, H*Dh): split on its contracting (head)
    columns, so each device makes a partial product; bias replicated;
  - MLP up (``mlp_in``, (mlp, hidden)) and its bias: split by output
    column;
  - MLP down (``mlp_out``, (hidden, mlp)): split on its contracting
    columns; bias replicated;
  - embeddings, LayerNorms: replicated.

Where XLA's partitioner inserted the two all-reduces of a block, the port's
forward (:func:`tp_forward`) runs the model's own block on each device's
slices, one residual branch at a time, copies each partial product to the
row's first device and sums them in model-axis order. Attention is the
stock math under TP, as in the JAX package (the flash kernel takes whole
heads of one device). Gradients flow back through the slices and copies
into the one set of float32 masters, so training is TP-transparent.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ..core.logging import get_logger
from ..core.mesh import Mesh

logger = get_logger("tensor_parallel")

Spec = Tuple[Optional[str], ...]
# the biases of the products split on their contracting axis: added once,
# after the sum, so they live on the row's first device and are zero on
# the others
_ROW_PARALLEL_BIASES = (".attn.out.bias", ".mlp_out.bias")


def mesh_tp_size(mesh: Optional[Mesh]) -> int:
    """Tensor-parallel degree of a mesh (1 when no ``model`` axis)."""
    if mesh is None or "model" not in mesh.axis_names:
        return 1
    return int(mesh.shape["model"])


def tp_compatible(cfg: Any, tp: int) -> bool:
    """A config shards over ``tp`` devices iff the head and MLP widths
    divide evenly; otherwise the parameters are replicated."""
    return tp > 1 and cfg.num_heads % tp == 0 and cfg.mlp_dim % tp == 0


def _spec_for_name(name: str, ndim: int) -> Spec:
    parts = name.split(".")
    leaf = parts[-1]
    parent = parts[-2] if len(parts) >= 2 else ""
    grand = parts[-3] if len(parts) >= 3 else ""
    if grand == "attn" and parent in ("query", "key", "value"):
        return ("model", None) if leaf == "weight" else ("model",)
    if grand == "attn" and parent == "out":
        return (None, "model") if leaf == "weight" else (None,) * ndim
    if parent == "mlp_in":
        return ("model", None) if leaf == "weight" else ("model",)
    if parent == "mlp_out":
        return (None, "model") if leaf == "weight" else (None,) * ndim
    return (None,) * ndim  # embeddings, LayerNorms: replicated


def encoder_param_specs(params: Dict[str, torch.Tensor]) -> Dict[str, Spec]:
    """Per-dimension axis names (``None`` = replicated) of every encoder
    parameter, by its name in ``SentenceTransformerModel``."""
    return {name: _spec_for_name(name, p.ndim) for name, p in params.items()}


def _shard(p: torch.Tensor, spec: Spec, j: int, tp: int) -> torch.Tensor:
    for dim, ax in enumerate(spec):
        if ax == "model":
            step = p.shape[dim] // tp
            return p.narrow(dim, j * step, step)
    return p


def shard_row(params: Dict[str, torch.Tensor], specs: Dict[str, Spec],
              devices: List[torch.device]) -> List[Dict[str, torch.Tensor]]:
    """One model row's parameters: for each device of the row, every
    parameter's slice on that device (a view where it already lives
    there); a row-parallel bias is zero past the first device."""
    tp = len(devices)

    def place(name, p, j, dev):
        if j and tp > 1 and name.endswith(_ROW_PARALLEL_BIASES) \
                and "model" not in specs[name]:
            return torch.zeros(p.shape, dtype=p.dtype, device=dev)
        return _shard(p, specs[name], j, tp).to(dev, non_blocking=True)

    return [{name: place(name, p, j, dev) for name, p in params.items()}
            for j, dev in enumerate(devices)]


def shard_encoder_params(params: Dict[str, torch.Tensor], mesh: Mesh,
                         cfg: Any) -> Dict[Tuple[int, int],
                                           Dict[str, torch.Tensor]]:
    """Place encoder parameters on ``mesh`` with the TP layout: for each
    (data, model) position this process drives, its slice of every
    parameter on that position's device.

    Falls back to full replication (with a warning) when the config's head
    or MLP width does not divide the ``model`` axis: the model still runs,
    without tensor parallelism."""
    tp = mesh_tp_size(mesh)
    compatible = tp_compatible(cfg, tp)
    if not compatible and tp > 1:
        logger.warning(
            "encoder config (heads=%d, mlp=%d) does not divide the model "
            "axis (%d): replicating parameters instead of TP",
            cfg.num_heads, cfg.mlp_dim, tp)
    specs = (encoder_param_specs(params) if compatible else
             {n: (None,) * p.ndim for n, p in params.items()})
    out = {}
    for i in range(mesh.devices.shape[0]):
        row = list(mesh.devices[i])
        if any(mesh.process_ids[i, j] != mesh.rank for j in range(len(row))):
            continue
        for j, shard in enumerate(shard_row(params, specs, row)):
            out[(i, j)] = shard
    return out


def tp_forward(model: torch.nn.Module,
               shards: List[Dict[str, torch.Tensor]],
               devices: List[torch.device], ids: torch.Tensor,
               mask: torch.Tensor, return_tokens: bool = False
               ) -> torch.Tensor:
    """``model``'s own forward (a ``SentenceTransformerModel``) over one
    model row: ``shards[j]`` holds device j's parameter slices
    (:func:`shard_row`); ``ids`` and ``mask`` live on ``devices[0]``,
    where the replicated layers run. Each block runs its two residual
    branches on every device's slices and sums the partial products in
    model-axis order. In training the attention-weight dropout mask is
    drawn at full width on the first device and sliced by head, so a
    seeded step draws the single-device masks."""
    from torch.func import functional_call

    lead = devices[0]
    masks = [mask.to(dev, non_blocking=True) for dev in devices]

    def branch(i, name, x, flash, keep=None):
        layer, pre = model.layers[i], f"layers.{i}."
        acc = None
        for j, dev in enumerate(devices):
            params = {k[len(pre):]: v for k, v in shards[j].items()
                      if k.startswith(pre)}
            kw = {"branch": name}
            if keep is not None:
                h = keep.shape[1] // len(devices)
                kw["keep"] = keep[:, j * h:(j + 1) * h].to(dev,
                                                           non_blocking=True)
            part = functional_call(
                layer, params, (x.to(dev, non_blocking=True), masks[j],
                                flash), kw).to(lead, non_blocking=True)
            acc = part if acc is None else acc + part
        return acc

    def run_block(i, x, flash):
        drop = model.layers[i].attn.dropout
        keep = None
        if drop.training and drop.p > 0.0:
            b, t = ids.shape
            keep = drop.keep_mask((b, model.cfg.num_heads, t, t), lead)
        x = x + branch(i, "attn", x, flash, keep)
        return x + model.layers[i].dropout(branch(i, "mlp", x, flash))

    return functional_call(model, shards[0], (ids, mask),
                           {"return_tokens": return_tokens,
                            "run_block": run_block})
