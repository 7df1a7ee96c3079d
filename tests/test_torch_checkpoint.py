"""The port's checkpoint reader on checkpoints the JAX package writes.

``semanticsearch_tpu.core.checkpoint.save_checkpoint`` writes a reranker
tree in both of its layouts (orbax, and the npz fallback it takes when
orbax is missing); ``semanticsearch_tpu_torch.core.checkpoint`` must read
each back bit for bit, follow ``format.json`` past a stale orbax directory,
and raise where the tree and the model disagree or ``tensorstore`` is
missing."""
import functools
import json
import os
import sys

import jax
import numpy as np
import pytest

from semanticsearch_tpu.core.checkpoint import restore_checkpoint as j_restore
from semanticsearch_tpu.core.checkpoint import save_checkpoint
from semanticsearch_tpu.models.rerankers import make_model as j_make
from semanticsearch_tpu_torch.core.checkpoint import (load_metadata,
                                                      parse_treedef,
                                                      restore_checkpoint)
from semanticsearch_tpu_torch.models.convert import reranker_state_dict

KW = {"hidden_size": 6}


@functools.lru_cache(maxsize=None)
def _init():
    model = j_make("esim", vocab_size=40, embed_dim=8, **KW)
    return jax.jit(lambda key: model.init(key, np.zeros((2, 4), np.int32),
                                          np.zeros((2, 6), np.int32)))


def _params(seed):
    return jax.tree.map(np.asarray,
                        _init()(jax.random.PRNGKey(seed))["params"])


def _assert_bit_equal(got, want):
    got_l, got_t = jax.tree.flatten(got)
    want_l, want_t = jax.tree.flatten(want)
    assert got_t == want_t
    for g, w in zip(got_l, want_l):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


def _save_npz(path, state, monkeypatch):
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "orbax.checkpoint", None)
        save_checkpoint(str(path), state, metadata={"layout": "npz"})
    with open(os.path.join(path, "format.json")) as f:
        assert json.load(f)["format"] == "npz"


def test_orbax_layout_bit_for_bit(tmp_path):
    state = {"params": _params(0)}
    save_checkpoint(str(tmp_path), state, metadata={"model": "ESIM"})
    assert os.path.isdir(tmp_path / "state")
    _assert_bit_equal(restore_checkpoint(str(tmp_path)), state)


def test_npz_layout_bit_for_bit(tmp_path, monkeypatch):
    state = {"params": _params(1), "epoch": np.int32(3),
             "opt": (np.arange(3.0), [np.ones((2, 2), np.float16)], None)}
    _save_npz(tmp_path, state, monkeypatch)
    assert not os.path.isdir(tmp_path / "state")
    got = restore_checkpoint(str(tmp_path))
    _assert_bit_equal(got, jax.tree.map(np.asarray, state))
    assert isinstance(got["opt"], tuple) and got["opt"][2] is None
    # and the JAX reader agrees, given the structure
    _assert_bit_equal(j_restore(str(tmp_path), state), got)


def test_stale_orbax_next_to_newer_npz(tmp_path, monkeypatch):
    old, new = {"params": _params(2)}, {"params": _params(3)}
    save_checkpoint(str(tmp_path), old)
    _save_npz(tmp_path, new, monkeypatch)
    assert os.path.isdir(tmp_path / "state")  # the stale orbax save stays
    _assert_bit_equal(restore_checkpoint(str(tmp_path)), new)
    _assert_bit_equal(j_restore(str(tmp_path), new), new)


def test_load_metadata(tmp_path):
    assert load_metadata(str(tmp_path)) is None
    meta = {"model": "ESIM", "config": {"model": "esim", "eval_metrics":
                                        ["map"]}, "model_kwargs": KW}
    save_checkpoint(str(tmp_path), {"params": _params(0)}, metadata=meta)
    assert load_metadata(str(tmp_path)) == meta


def test_treedef_that_disagrees_with_the_model_raises(tmp_path, monkeypatch):
    state = {"params": _params(4)}
    _save_npz(tmp_path, state, monkeypatch)
    good = restore_checkpoint(str(tmp_path))["params"]
    assert set(reranker_state_dict("esim", good, **KW))
    treedef = tmp_path / "treedef.txt"
    text = treedef.read_text()
    # a renamed layer: the converter misses 'projection' and finds 'projektion'
    treedef.write_text(text.replace("'projection'", "'projektion'"))
    renamed = restore_checkpoint(str(tmp_path))["params"]
    with pytest.raises(ValueError, match="projection"):
        reranker_state_dict("esim", renamed, **KW)
    # a leaf more than state.npz holds
    treedef.write_text(text.replace("'out': {", "'extra': *, 'out': {"))
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(str(tmp_path))
    # an architecture other than the checkpoint's
    treedef.write_text(text)
    with pytest.raises(ValueError):
        reranker_state_dict("esim", good, hidden_size=7)


def test_orbax_without_tensorstore_raises(tmp_path, monkeypatch):
    save_checkpoint(str(tmp_path), {"params": _params(0)})
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="tensorstore"):
        restore_checkpoint(str(tmp_path))


def test_parse_treedef_structures():
    tree = {"b": (1, [2, None], {"z": 3, "a": 4}), "a": 5}
    struct = parse_treedef(str(jax.tree.structure(tree)))
    assert set(struct) == {"a", "b"} and isinstance(struct["b"], tuple)
    assert isinstance(struct["b"][1], list) and struct["b"][1][1] is None
    with pytest.raises(ValueError):
        parse_treedef("PyTreeDef(CustomNode(Foo[()], [*]))")
    with pytest.raises(ValueError):
        parse_treedef("not a treedef")


@pytest.mark.parametrize("optimizer,clip", [("adam", None),
                                            ("adadelta", None),
                                            ("adam", 1.0)])
def test_reads_jax_trainer_resume_checkpoint(tmp_path, monkeypatch,
                                             optimizer, clip):
    """The JAX trainer's step and epoch checkpoints (params, optax state,
    the cursor) in the npz layout: every leaf bit for bit, the optax
    states as namedtuples with their fields named."""
    from semanticsearch_tpu.core.config import TrainConfig
    from semanticsearch_tpu.train.pairs import PairDataset
    from semanticsearch_tpu.train.trainer import RerankTrainer

    rng = np.random.default_rng(0)
    ds = PairDataset(left=rng.integers(1, 30, (12, 4)).astype(np.int32),
                     right=rng.integers(1, 30, (12, 6)).astype(np.int32),
                     labels=np.tile([1.0, 0.0, 0.0], 4).astype(np.float32),
                     query_ids=np.repeat(np.arange(4), 3))
    cfg = TrainConfig(model="knrm", epochs=2, batch_size=2, embedding_dim=8,
                      optimizer=optimizer, clip_norm=clip)
    trainer = RerankTrainer("knrm", vocab_size=30, cfg=cfg)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    trainer.fit(ds, checkpoint_dir=str(tmp_path), checkpoint_every=1,
                checkpoint_every_steps=3)
    params = trainer.init_params(ds)
    target = {"params": params, "opt_state": trainer.tx.init(params),
              "epoch": 0}
    for sub, cursor in (("step_3", True), ("epoch_1", False)):
        path = str(tmp_path / sub)
        want = j_restore(path, {**target, "step_in_epoch": 0} if cursor
                         else target)
        got = restore_checkpoint(path)
        # the port's namedtuple classes print as optax's
        assert str(jax.tree.structure(got)) == str(jax.tree.structure(want))
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        assert ("step_in_epoch" in got) == cursor
        opt = got["opt_state"][1] if clip else got["opt_state"]
        if clip:
            assert type(got["opt_state"][0]).__name__ == "EmptyState"
        names = [type(s).__name__ for s in opt]
        if optimizer == "adam":
            assert names == ["ScaleByAdamState", "EmptyState"]
            assert opt[0]._fields == ("count", "mu", "nu")
            assert opt[0].count.dtype == np.int32
            assert set(opt[0].mu) == set(got["params"])
        else:
            assert names == ["EmptyState", "ScaleByAdaDeltaState",
                             "EmptyState"]
            assert opt[1]._fields == ("e_g", "e_x")
