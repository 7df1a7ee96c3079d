"""The port's optax pieces (``train/optim.py``) against optax itself.

The schedule at every count, and each optimizer the trainers build (adamw
on a schedule, adam, adadelta, adam behind ``clip_by_global_norm``) on the
same random gradient streams for 20 updates. Tolerance 1e-6 of each
tensor's largest magnitude: the same f32 update computed in another order
(torch's ``p * (1 - lr wd)`` then ``sqrt(nu) / sqrt(1 - b2^t)`` for optax's
``-lr (u + wd p)`` and ``sqrt(nu / (1 - b2^t))``) rounds each parameter
differently by about an ulp a step; the moments, which are not rounded
into the parameters, to 1e-5 (nu of the clipped stream is a square of
rounded values). The state maps to optax's tree and back bit for bit, and
:func:`core.checkpoint.save_checkpoint` writes optax's own treedef string."""
import jax
import numpy as np
import optax
import pytest
import torch

from semanticsearch_tpu_torch.core.checkpoint import (_treedef, parse_treedef,
                                                      restore_checkpoint,
                                                      save_checkpoint)
from semanticsearch_tpu_torch.train.optim import (Optimizer,
                                                  warmup_cosine_decay_schedule)

SHAPES = {"a": (3,), "b.kernel": (4, 5), "b.bias": (5,)}


def _to_tree(d):
    """name -> tensor as a flax-like nested dict of numpy arrays."""
    return {"a": d["a"].detach().numpy().copy(),
            "b": {"kernel": d["b.kernel"].detach().numpy().copy(),
                  "bias": d["b.bias"].detach().numpy().copy()}}


def _from_tree(t):
    return {"a": torch.as_tensor(np.asarray(t["a"])),
            "b.kernel": torch.as_tensor(np.asarray(t["b"]["kernel"])),
            "b.bias": torch.as_tensor(np.asarray(t["b"]["bias"]))}


def _close(got, want, rel):
    """Equal to ``rel`` of the tensor's largest magnitude."""
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rel * scale


@pytest.mark.parametrize("total", [2, 7, 40, 1000])
def test_schedule_equals_optax(total):
    lr = 3e-4
    args = (0.0, lr, max(1, int(total * 0.05)), max(2, total), lr * 0.1)
    ref = optax.warmup_cosine_decay_schedule(*args)
    mine = warmup_cosine_decay_schedule(*args)
    assert mine(0) == 0.0
    for count in range(total + 5):
        assert np.isclose(mine(count), float(ref(count)), rtol=1e-6,
                          atol=0.0), count


def _optax_tx(kind, clip):
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 20, 1e-3)
    tx = {"adamw": lambda: optax.adamw(sched, weight_decay=0.01),
          "adam": lambda: optax.adam(1e-2),
          "adadelta": lambda: optax.adadelta(1.0)}[kind]()
    return optax.chain(optax.clip_by_global_norm(clip), tx) if clip else tx


def _port_opt(kind, clip, params):
    lr = (warmup_cosine_decay_schedule(0.0, 1e-2, 2, 20, 1e-3)
          if kind == "adamw" else {"adam": 1e-2, "adadelta": 1.0}[kind])
    return Optimizer(params, kind, lr,
                     weight_decay=0.01 if kind == "adamw" else 0.0,
                     clip_norm=clip)


@pytest.mark.parametrize("kind,clip", [("adamw", None), ("adam", None),
                                       ("adadelta", None), ("adam", 0.5)])
def test_optimizers_equal_optax(kind, clip, tmp_path):
    rng = np.random.default_rng(3)
    init = {k: rng.normal(size=s).astype(np.float32)
            for k, s in SHAPES.items()}
    grads = [{k: (rng.normal(size=s) * (1.0 if i % 3 else 5.0)
                  ).astype(np.float32) for k, s in SHAPES.items()}
             for i in range(20)]
    tx = _optax_tx(kind, clip)
    j_params = _to_tree({k: torch.from_numpy(v) for k, v in init.items()})
    j_state = tx.init(j_params)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in init.items()}
    opt = _port_opt(kind, clip, params)
    for g in grads:
        upd, j_state = tx.update(
            _to_tree({k: torch.from_numpy(v) for k, v in g.items()}),
            j_state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    for got, want in zip(jax.tree.leaves(_to_tree(params)),
                         jax.tree.leaves(j_params)):
        _close(got, np.asarray(want), 1e-6)

    # the state is optax's tree: structure string, leaves to 1e-6
    tree = opt.state_tree(_to_tree)
    assert _treedef(tree) == str(jax.tree.structure(j_state))[
        len("PyTreeDef("):-1]
    j_leaves = jax.tree.leaves(j_state)
    for got, want in zip(jax.tree.leaves(tree), j_leaves):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        _close(got, want, 1e-5)

    # and back, bit for bit, through a checkpoint
    save_checkpoint(str(tmp_path), {"opt_state": tree})
    restored = restore_checkpoint(str(tmp_path))["opt_state"]
    fresh = _port_opt(kind, clip, {k: torch.nn.Parameter(p.detach().clone())
                                   for k, p in params.items()})
    fresh.load_state_tree(restored, _from_tree, count=opt.count)
    assert fresh.count == opt.count == 20
    again = fresh.state_tree(_to_tree)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(tree)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    # a restored optimizer continues as the original does
    for o in (opt, fresh):
        for k, p in o.params.items():
            p.grad = torch.from_numpy(grads[0][k].copy())
        o.step()
    for k in params:
        assert torch.equal(opt.params[k], fresh.params[k])


def test_parse_treedef_reads_optax_states():
    p = {"b": {"kernel": np.zeros((2, 2), np.float32)}, "a": np.zeros(3)}
    state = optax.chain(optax.clip_by_global_norm(1.0),
                        optax.adam(1e-3)).init(p)
    text = str(jax.tree.structure({"opt_state": state, "epoch": 0}))
    struct = parse_treedef(text)
    clip, (adam, empty) = struct["opt_state"]
    assert type(clip).__name__ == "EmptyState" and clip._fields == ()
    assert adam._fields == ("count", "mu", "nu")
    assert set(adam.mu) == {"a", "b"}
    assert "PyTreeDef(" + _treedef(struct) + ")" == text
