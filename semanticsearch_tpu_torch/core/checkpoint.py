"""Checkpoint reader and writer for the trees the JAX package saves.

Counterpart of ``semanticsearch_tpu/core/checkpoint.py``. A checkpoint
directory holds one of two layouts, and ``format.json`` names the one its
latest save completed with:

- ``orbax``: a ``state/`` directory in orbax's OCDBT + zarr layout. It is
  read here through ``tensorstore`` alone (orbax's own reader imports JAX):
  the tree's paths are the keys of ``tree_metadata`` in ``state/_METADATA``
  and each leaf is the zarr array under ``<path joined by '.'>/``. Without
  ``tensorstore`` such a checkpoint raises.
- ``npz``: ``state.npz`` holds the leaves as ``arr_0..arr_{n-1}`` in
  ``jax.tree.flatten`` order (dict keys sorted) and ``treedef.txt`` the
  tree's ``str(treedef)``, e.g. ``PyTreeDef({'params': {'out': {'bias': *,
  'kernel': *}}})``, from which the nested dict is rebuilt. Optimizer
  states appear there as optax writes them,
  ``CustomNode(namedtuple[ScaleByAdamState], [*, {...}, {...}])``, and
  come back as the namedtuples of :data:`OPTAX_STATES`.

:func:`save_checkpoint` writes the npz layout only (the card's machine has
no orbax), leaves in ``jax.tree.flatten`` order, so the JAX package's
``restore_checkpoint`` reads what the port writes and the reverse.

The rule follows the JAX reader: an orbax ``state/`` directory is read
unless ``format.json`` says the latest save was ``npz`` (a stale orbax
directory may sit next to a newer npz save). Trees come back as nested
dicts (tuples and lists where the saved tree had them) of numpy arrays.
"""
from __future__ import annotations

import ast
import io
import json
import os
import tokenize
from collections import namedtuple
from typing import Any, Dict, List, Optional

import numpy as np

_LEAF = "_LEAF_"

# the optax states the trainers' optimizers hold, with optax's field order
# (``jax.tree.flatten`` takes a namedtuple's fields in this order)
OPTAX_STATES = {
    name: namedtuple(name, fields) for name, fields in (
        ("EmptyState", ()),
        ("ScaleByAdamState", ("count", "mu", "nu")),
        ("ScaleByAdaDeltaState", ("e_g", "e_x")),
        ("ScaleByScheduleState", ("count",)),
    )}


class _Leaf:
    """A leaf position in a parsed tree structure."""


def parse_treedef(text: str) -> Any:
    """The structure of ``str(jax.tree.structure(tree))`` as nested dicts,
    tuples, lists and :data:`OPTAX_STATES` namedtuples with :class:`_Leaf`
    at the leaves and ``None`` where the tree held None. Raises ValueError
    on any other node kind (a custom pytree node cannot be rebuilt without
    its class)."""
    text = text.strip()
    if not (text.startswith("PyTreeDef(") and text.endswith(")")):
        raise ValueError(f"not a PyTreeDef string: {text[:80]!r}")
    body = text[len("PyTreeDef("):-1]
    # '*' marks a leaf: swap it for a name so the body parses as Python
    toks = []
    for tok in tokenize.generate_tokens(io.StringIO(body).readline):
        if tok.type == tokenize.OP and tok.string == "*":
            toks.append((tokenize.NAME, _LEAF))
        else:
            toks.append((tok.type, tok.string))
    try:
        node = ast.parse(tokenize.untokenize(toks).strip(), mode="eval").body
    except SyntaxError as exc:
        raise ValueError(f"unparseable treedef: {exc}") from exc

    def build(n):
        if isinstance(n, ast.Name) and n.id == _LEAF:
            return _Leaf()
        if isinstance(n, ast.Constant) and n.value is None:
            return None
        if isinstance(n, ast.Dict):
            keys = []
            for k in n.keys:
                if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
                    raise ValueError("treedef dict keys must be strings")
                keys.append(k.value)
            return {k: build(v) for k, v in zip(keys, n.values)}
        if isinstance(n, ast.Tuple):
            return tuple(build(e) for e in n.elts)
        if isinstance(n, ast.List):
            return [build(e) for e in n.elts]
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                and n.func.id == "CustomNode" and len(n.args) == 2
                and isinstance(n.args[0], ast.Subscript)
                and isinstance(n.args[0].value, ast.Name)
                and n.args[0].value.id == "namedtuple"
                and isinstance(n.args[0].slice, ast.Name)
                and isinstance(n.args[1], ast.List)):
            name = n.args[0].slice.id
            if name not in OPTAX_STATES:
                raise ValueError(f"unsupported treedef namedtuple: {name}")
            cls = OPTAX_STATES[name]
            if len(n.args[1].elts) != len(cls._fields):
                raise ValueError(f"{name} has fields {cls._fields}, the "
                                 f"treedef {len(n.args[1].elts)} children")
            return cls(*(build(e) for e in n.args[1].elts))
        raise ValueError(f"unsupported treedef node: {ast.dump(n)[:80]}")

    return build(node)


def _fill(struct: Any, leaves: List[np.ndarray]) -> Any:
    """Put ``leaves`` into ``struct`` in ``jax.tree.flatten`` order (dict
    keys sorted, sequences in order); consumes the list from the front."""
    if isinstance(struct, _Leaf):
        return leaves.pop(0)
    if isinstance(struct, dict):
        return {k: _fill(struct[k], leaves) for k in sorted(struct)}
    if hasattr(struct, "_fields"):
        return type(struct)(*(_fill(s, leaves) for s in struct))
    if isinstance(struct, (tuple, list)):
        return type(struct)(_fill(s, leaves) for s in struct)
    return struct  # None


def _count_leaves(struct: Any) -> int:
    if isinstance(struct, _Leaf):
        return 1
    if isinstance(struct, dict):
        return sum(_count_leaves(v) for v in struct.values())
    if isinstance(struct, (tuple, list)):
        return sum(_count_leaves(v) for v in struct)
    return 0


def _restore_npz(path: str) -> Any:
    with open(os.path.join(path, "treedef.txt")) as f:
        struct = parse_treedef(f.read())
    with np.load(os.path.join(path, "state.npz")) as npz:
        n = _count_leaves(struct)
        if len(npz.files) != n:
            raise ValueError(
                f"{path}: state.npz holds {len(npz.files)} arrays but "
                f"treedef.txt has {n} leaves")
        leaves = [npz[f"arr_{i}"] for i in range(n)]
    return _fill(struct, leaves)


def _restore_orbax(state_dir: str) -> Any:
    try:
        import tensorstore as ts
    except ImportError as exc:
        raise ImportError(
            f"{state_dir} is an orbax checkpoint, which is read with the "
            "'tensorstore' package, and it is not installed; re-save the "
            "checkpoint in the npz layout or install tensorstore") from exc
    with open(os.path.join(state_dir, "_METADATA")) as f:
        meta = json.load(f)
    driver = "zarr3" if meta.get("use_zarr3") else "zarr"
    base = "file://" + os.path.abspath(state_dir) + "/"
    use_ocdbt = meta.get("use_ocdbt", True)
    tree: Dict[str, Any] = {}
    for entry in meta["tree_metadata"].values():
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        leaf_path = ".".join(keys) + "/"
        kvstore = ({"driver": "ocdbt", "base": base, "path": leaf_path}
                   if use_ocdbt else base + leaf_path)
        arr = ts.open({"driver": driver, "kvstore": kvstore}).result()
        value = np.asarray(arr.read().result())
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return tree


def _format(path: str) -> str:
    """"orbax" or "npz": the layout to read, by the JAX reader's rule."""
    fmt = None
    fmt_path = os.path.join(path, "format.json")
    if os.path.exists(fmt_path):
        try:
            with open(fmt_path) as f:
                fmt = json.load(f).get("format")
        except (OSError, ValueError):
            fmt = None
    state_dir = os.path.join(path, "state")
    return "orbax" if fmt != "npz" and os.path.isdir(state_dir) else "npz"


def _treedef(tree: Any) -> str:
    """``str(jax.tree.structure(tree))`` without JAX, for the node kinds
    :func:`parse_treedef` reads."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if hasattr(tree, "_fields"):
        return (f"CustomNode(namedtuple[{type(tree).__name__}], ["
                + ", ".join(_treedef(v) for v in tree) + "])")
    if isinstance(tree, tuple):
        inner = ", ".join(_treedef(v) for v in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    if isinstance(tree, list):
        return "[" + ", ".join(_treedef(v) for v in tree) + "]"
    return "None" if tree is None else "*"


def _leaves(tree: Any) -> List[np.ndarray]:
    """The leaves in ``jax.tree.flatten`` order, as numpy arrays (torch
    tensors copied to the host)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    if tree is None:
        return []
    if hasattr(tree, "detach"):
        return [tree.detach().cpu().numpy()]
    return [np.asarray(tree)]


def save_checkpoint(path: str, state: Any, metadata: Optional[Dict] = None,
                    async_save: bool = False) -> str:
    """Save a tree (nested dicts, tuples, lists, :data:`OPTAX_STATES`
    namedtuples; numpy arrays, torch tensors or numbers at the leaves) in
    the npz layout the JAX writer falls back to
    (``semanticsearch_tpu/core/checkpoint.py:68-84``): ``state.npz``,
    ``treedef.txt``, then ``format.json`` by a temporary file and
    ``os.replace``, then ``metadata.json``. The write is synchronous
    whatever ``async_save`` says (it is accepted for the JAX signature), so
    :func:`wait_for_checkpoints` has nothing to wait for."""
    del async_save
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "state.npz"), *_leaves(state))
    with open(os.path.join(path, "treedef.txt"), "w") as f:
        f.write(f"PyTreeDef({_treedef(state)})")
    fmt_tmp = os.path.join(path, "format.json.tmp")
    with open(fmt_tmp, "w") as f:
        json.dump({"format": "npz"}, f)
    os.replace(fmt_tmp, os.path.join(path, "format.json"))
    if metadata is not None:
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(metadata, f, indent=2, default=str)
    return path


def wait_for_checkpoints() -> None:
    """A no-op: :func:`save_checkpoint` returns once its files are
    written."""


def restore_checkpoint(path: str) -> Any:
    """The tree saved at ``path`` by the JAX package's ``save_checkpoint``,
    as nested dicts of numpy arrays. Whether it fits a model is the
    converter's check (``models/convert.py``)."""
    if _format(path) == "orbax":
        return _restore_orbax(os.path.join(path, "state"))
    return _restore_npz(path)


def load_metadata(path: str) -> Optional[Dict]:
    meta_path = os.path.join(path, "metadata.json")
    if not os.path.exists(meta_path):
        return None
    with open(meta_path) as f:
        return json.load(f)
