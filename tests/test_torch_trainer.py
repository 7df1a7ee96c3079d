"""Reranker training in the port against the JAX package's.

The pair sampler's batches are bit-equal; the three losses agree to 1e-6;
KNRM and ArcII (dropout 0) trained from one flax tree (the JAX trainer's
``warm_start_fn`` hook on both sides) give per-epoch losses within 1e-4
relative and equal metrics. Step checkpoints resume across packages (JAX
-> port and port -> JAX, losses of the remaining epochs within 1e-4 of the
uninterrupted run's), and port -> port with dropout bit for bit on the
CPU. A forced out-of-memory error halves the batch; distillation without
teacher scores raises."""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semanticsearch_tpu.core.config import TrainConfig as JTrainConfig
from semanticsearch_tpu.models.rerankers import make_model as j_make
from semanticsearch_tpu.train import trainer as jtr
from semanticsearch_tpu.train.pairs import PairDataset as JPairDataset
from semanticsearch_tpu_torch.core.config import TrainConfig
from semanticsearch_tpu_torch.models.convert import reranker_state_dict
from semanticsearch_tpu_torch.train import trainer as ttr
from semanticsearch_tpu_torch.train.pairs import PairDataset

VOCAB = 64


def _arrays(seed=0, n_q=6, docs=5, lr=4, rr=12, teacher=False):
    rng = np.random.default_rng(seed)
    left, right, labels, qids = [], [], [], []
    for q in range(n_q):
        for d in range(docs):
            left.append(rng.integers(2, VOCAB, size=lr))
            r = rng.integers(2, VOCAB, size=rr)
            r[int(rng.integers(3, rr + 1)):] = 0  # padded tails
            right.append(r)
            labels.append(1.0 if d < 2 else 0.0)
            qids.append(f"q{q}")
    out = dict(left=np.asarray(left, np.int32),
               right=np.asarray(right, np.int32),
               labels=np.asarray(labels, np.float32),
               query_ids=np.asarray(qids))
    if teacher:
        out["teacher"] = rng.normal(size=len(labels)).astype(np.float32)
    return out


@pytest.mark.parametrize("kw", [
    dict(batch_size=4), dict(batch_size=3, num_neg=2, num_dup=2),
    dict(batch_size=5, length_buckets=(4, 8)),
    dict(batch_size=4, resample=False, epoch=3)])
def test_pair_batches_bit_equal(kw):
    a = _arrays(teacher=True)
    mine = list(PairDataset(**a).iter_pair_batches(seed=7, **kw))
    theirs = list(JPairDataset(**a).iter_pair_batches(seed=7, **kw))
    assert len(mine) == len(theirs) > 0
    for m, t in zip(mine, theirs):
        assert m.keys() == t.keys()
        for k in m:
            assert np.array_equal(m[k], t[k])
    for m, t in zip(PairDataset(**a).iter_point_batches(7),
                    JPairDataset(**a).iter_point_batches(7)):
        for k in m:
            assert np.array_equal(m[k], t[k])


def test_losses_match_jax():
    rng = np.random.default_rng(1)
    s = rng.normal(size=12).astype(np.float32)
    teacher = rng.normal(size=12).astype(np.float32)
    for g in (2, 3):
        st = torch.from_numpy(s)
        pairs = [(ttr.rank_hinge_loss(st, g), jtr.rank_hinge_loss(s, g)),
                 (ttr.rank_xent_loss(st, g), jtr.rank_xent_loss(s, g)),
                 (ttr.margin_mse_loss(st, torch.from_numpy(teacher), g, 0.5),
                  jtr.margin_mse_loss(s, teacher, g, 0.5))]
        for mine, theirs in pairs:
            np.testing.assert_allclose(float(mine), float(theirs),
                                       rtol=1e-6)


def _cfgs(**kw):
    base = dict(model="knrm", epochs=3, batch_size=4, num_neg=1,
                optimizer="adam", learning_rate=0.01, embedding_dim=8,
                eval_metrics=("map", "ndcg@3"))
    base.update(kw)
    return JTrainConfig(**base), TrainConfig(**base)


def _tree(name, ds, kw):
    model = j_make(name, vocab_size=VOCAB, embed_dim=8, **kw)
    return jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.asarray(ds["left"][:2]),
        jnp.asarray(ds["right"][:2]))["params"])


def _trainers(name, kw, jcfg, tcfg, tree):
    j = jtr.RerankTrainer(name, VOCAB, jcfg, model_kwargs=kw,
                          warm_start_fn=lambda p: tree)
    t = ttr.RerankTrainer(
        name, VOCAB, tcfg, model_kwargs=kw, device="cpu",
        warm_start_fn=lambda sd: reranker_state_dict(name, tree, **kw))
    return j, t


@pytest.mark.parametrize("name,kw,opt", [
    ("knrm", {"kernel_num": 5}, "adam"),
    ("knrm", {"kernel_num": 5}, "adadelta"),
    ("arcii", {"kernel_1d_count": 4, "kernel_2d_count": (4, 4),
               "dropout_rate": 0.0}, "adam")])
def test_fit_matches_jax(name, kw, opt):
    a = _arrays(lr=9, rr=18) if name == "arcii" else _arrays()
    # ArcII at its preset rate: at 1e-2 a ReLU or hinge kink flips in the
    # third epoch and the runs part (2.7e-4), as two runs of one package do
    # under any change of summation order
    lr = {"adadelta": 1.0, "adam": 1e-3 if name == "arcii" else 1e-2}[opt]
    jcfg, tcfg = _cfgs(model=name, optimizer=opt, learning_rate=lr,
                       clip_norm=1.0 if opt == "adadelta" else None)
    tree = _tree(name, a, kw)
    j, t = _trainers(name, kw, jcfg, tcfg, tree)
    jr = j.fit(JPairDataset(**a), test_ds=JPairDataset(**a))
    tr = t.fit(PairDataset(**a), test_ds=PairDataset(**a))
    assert len(tr.history) == len(jr.history) == 3
    for mine, theirs in zip(tr.history, jr.history):
        np.testing.assert_allclose(mine["loss"], theirs["loss"], rtol=1e-4)
        for m in ("map", "ndcg@3"):
            np.testing.assert_allclose(mine[m], theirs[m], rtol=1e-6)
    # up to a constant: the output bias cancels in every pairwise loss, so
    # its gradient is rounding noise that Adam scales up to a step
    mine = t.predict(tr.params, PairDataset(**a))
    theirs = j.predict(jr.params, JPairDataset(**a))
    np.testing.assert_allclose(mine - mine.mean(), theirs - theirs.mean(),
                               rtol=1e-4, atol=1e-5)


def _remaining(history, from_epoch):
    return [h["loss"] for h in history if h["epoch"] > from_epoch]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_resume_across_packages(direction, tmp_path, monkeypatch):
    """A step checkpoint mid-epoch 0 written by one package, resumed by
    the other: the later epochs' losses equal the uninterrupted run's."""
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    a = _arrays()
    kw = {"kernel_num": 5}
    jcfg, tcfg = _cfgs(clip_norm=0.5)
    tree = _tree("knrm", a, kw)
    j, t = _trainers("knrm", kw, jcfg, tcfg, tree)
    ck = str(tmp_path / "ck")
    if direction == "jax_to_port":
        full = j.fit(JPairDataset(**a), checkpoint_dir=ck,
                     checkpoint_every_steps=2)
        _, t2 = _trainers("knrm", kw, jcfg, tcfg, tree)
        resumed = t2.fit(PairDataset(**a), resume_from=ck + "/step_2")
    else:
        full = t.fit(PairDataset(**a), checkpoint_dir=ck,
                     checkpoint_every_steps=2)
        j2, _ = _trainers("knrm", kw, jcfg, tcfg, tree)
        resumed = j2.fit(JPairDataset(**a), resume_from=ck + "/step_2")
    assert [h["epoch"] for h in resumed.history] == [0, 1, 2]
    np.testing.assert_allclose(_remaining(resumed.history, 0),
                               _remaining(full.history, 0), rtol=1e-4)


@pytest.mark.parametrize("every", ["steps", "epochs"])
def test_resume_port_to_port_bit_for_bit(every, tmp_path):
    a = _arrays()
    kw = {"kernel_count": (4, 4), "dpool_size": (2, 3), "dropout_rate": 0.3}
    _, tcfg = _cfgs(model="match_pyramid")
    ck = str(tmp_path / "ck")
    t1 = ttr.RerankTrainer("match_pyramid", VOCAB, tcfg, model_kwargs=kw,
                           device="cpu")
    if every == "steps":
        full = t1.fit(PairDataset(**a), checkpoint_dir=ck,
                      checkpoint_every_steps=5)
        # 3 steps an epoch: step 5 is epoch 1's second
        start, epoch0 = ck + "/step_5", 1
    else:
        full = t1.fit(PairDataset(**a), checkpoint_dir=ck, checkpoint_every=1)
        start, epoch0 = ck + "/epoch_0", 0
    t2 = ttr.RerankTrainer("match_pyramid", VOCAB, tcfg, model_kwargs=kw,
                           device="cpu")
    resumed = t2.fit(PairDataset(**a), resume_from=start)
    assert (_remaining(resumed.history, epoch0)
            == _remaining(full.history, epoch0))
    for k, v in full.params.items():
        assert torch.equal(v, resumed.params[k]), k


def test_oom_halves_the_batch(monkeypatch):
    a = _arrays()
    _, tcfg = _cfgs(epochs=1, batch_size=8)
    t = ttr.RerankTrainer("knrm", VOCAB, tcfg, model_kwargs={"kernel_num": 5},
                          device="cpu")
    forward = t.model.forward
    seen = []

    def tight(left, right):
        seen.append(left.shape[0])
        if t.model.training and left.shape[0] > 8:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        return forward(left, right)

    monkeypatch.setattr(t.model, "forward", tight)
    result = t.fit(PairDataset(**a))
    assert seen[0] == 16 and 8 in seen and len(result.history) == 1


def test_distillation_without_teacher_raises():
    _, tcfg = _cfgs(distill_weight=0.5)
    t = ttr.RerankTrainer("knrm", VOCAB, tcfg, device="cpu")
    with pytest.raises(ValueError, match="teacher"):
        t.fit(PairDataset(**_arrays()))
    a = _arrays(teacher=True)
    assert len(t.fit(PairDataset(**a)).history) == 3
