"""The port's data-parallel training across processes: two OS processes join
one gloo group and train the encoder, each forwarding only its own rows of
the global batch (tests/_torch_dist_train_worker.py). Every leg is held
against the JAX trainer on a CPU mesh of as many row shards and against the
one-process port on a mesh of repeated CPU devices: per-step losses to 1e-4
relative, the float32 masters to 1e-5 (the attention key biases to twice
the summed learning rates: their true gradient is zero, see
tests/test_torch_encoder_train.py). The two processes' masters are equal bit
for bit, and each forwards 1/2 of the global rows.

One spawn of the pair backs every leg; a hang fails the test at its
timeout instead of using up the suite's clock. The JAX references are
computed while the pair runs."""
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import _torch_dist_train_worker as worker
from semanticsearch_tpu.core.config import EncoderConfig as JCfg
from semanticsearch_tpu.models.encoder import SentenceEncoder as JEncoder
from semanticsearch_tpu.train import encoder_train as jt
from semanticsearch_tpu.train import mlm_pretrain as jm
from semanticsearch_tpu_torch.core import distributed
from semanticsearch_tpu_torch.core.mesh import Mesh
from semanticsearch_tpu_torch.models.convert import (encoder_flax_tree,
                                                     flax_to_state_dict)
from test_torch_tensor_parallel import (CFG, PARAM_ATOL, _lr_sum, _port,
                                        jmesh, tmesh, tree)  # noqa: F401

LOSS_RTOL = 1e-4
STEPS = 3  # every leg: one step an epoch, three epochs
TRAIN_LEGS = tuple(worker.LEGS)
JAX_LEGS = ("contrastive", "contrastive_hn", "mlm", "tp")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Pair:
    """The two worker processes; :meth:`wait` collects them once."""

    def __init__(self, out_dir):
        self.out_dir = out_dir
        script = os.path.join(os.path.dirname(__file__),
                              "_torch_dist_train_worker.py")
        port = _free_port()
        env = {k: v for k, v in os.environ.items()
               if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
                            "RANK")}
        env["CUDA_VISIBLE_DEVICES"] = ""
        self.procs = [subprocess.Popen(
            [sys.executable, script, str(pid), str(port), out_dir],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env) for pid in range(2)]
        self.outs = None

    def wait(self):
        if self.outs is None:
            outs = []
            for p in self.procs:
                try:
                    out, _ = p.communicate(timeout=240)
                except subprocess.TimeoutExpired:
                    for q in self.procs:
                        q.kill()
                    pytest.fail("distributed training worker timed out")
                outs.append(out)
            self.outs = outs
        return self.outs

    def leg(self, leg):
        got = []
        for pid, (p, out) in enumerate(zip(self.procs, self.wait())):
            assert p.returncode == 0, f"proc {pid} failed:\n{out}"
            assert f"LEG_OK {leg} proc={pid}" in out, out
            got.append(dict(np.load(os.path.join(self.out_dir,
                                                 f"{leg}_{pid}.npz"))))
        return got


@pytest.fixture(scope="module")
def pair(tree, tmp_path_factory):
    """Start the two-process group once, on the shared tree."""
    out_dir = str(tmp_path_factory.mktemp("dist_train"))
    with open(os.path.join(out_dir, "cfg.json"), "w") as f:
        json.dump(CFG, f)
    np.savez(os.path.join(out_dir, "state.npz"),
             **{k: v.numpy() for k, v in
                flax_to_state_dict(tree, CFG["num_layers"]).items()})
    p = _Pair(out_dir)
    yield p
    for q in p.procs:
        if q.poll() is None:
            q.kill()


def _masters(got, prefix="p:"):
    return {k[len(prefix):]: torch.from_numpy(v) for k, v in got.items()
            if k.startswith(prefix)}


def _assert_close_to_tree(want_tree, masters):
    """Masters against a flax tree within PARAM_ATOL, the key biases within
    twice the summed learning rates."""
    got = encoder_flax_tree(masters, CFG["num_layers"], CFG["num_heads"])
    flat, _ = jax.tree_util.tree_flatten_with_path(got)
    key_bias_atol = 2 * _lr_sum(STEPS, worker.CONTRASTIVE["learning_rate"])
    for (path, g), w in zip(flat, jax.tree.leaves(want_tree)):
        name = jax.tree_util.keystr(path)
        tol = key_bias_atol if "['key']['bias']" in name else PARAM_ATOL
        assert np.abs(np.asarray(g) - np.asarray(w)).max() <= tol, name


def _mesh_shape(leg):
    _, shards, model, _, _, _ = worker.LEGS[leg]
    return 2 * shards, model


def _jax_run(tree, leg):
    data, negs = worker.leg_data(leg)
    jenc = JEncoder(JCfg(**CFG), mesh=jmesh(*_mesh_shape(leg)), params=tree)
    if worker.LEGS[leg][0] == "mlm":
        hist = jm.MLMPretrainer(jenc, jm.MLMConfig(**worker.MLM)).fit(data)
    else:
        hist = jt.ContrastiveEncoderTrainer(
            jenc, jt.ContrastiveConfig(**worker.CONTRASTIVE)).fit(
                data, hard_negatives=negs)
    return [h["loss"] for h in hist], jenc.params


def _one_process_run(tree, leg):
    enc = _port(tree, tmesh(*_mesh_shape(leg)), **worker.LEGS[leg][5])
    losses = worker.train(enc, leg)
    return losses, encoder_flax_tree(enc.master.state_dict(),
                                     CFG["num_layers"], CFG["num_heads"])


@pytest.mark.parametrize("leg", JAX_LEGS)
def test_two_process_training_matches_jax(pair, tree, leg):
    want_losses, want_params = _jax_run(tree, leg)
    for g in pair.leg(leg):
        np.testing.assert_allclose(g["losses"], want_losses, rtol=LOSS_RTOL)
        _assert_close_to_tree(want_params, _masters(g))


@pytest.mark.parametrize("leg", TRAIN_LEGS[:-1])
def test_two_process_training_matches_one_process(pair, tree, leg):
    want_losses, want_params = _one_process_run(tree, leg)
    for g in pair.leg(leg):
        np.testing.assert_allclose(g["losses"], want_losses, rtol=LOSS_RTOL)
        _assert_close_to_tree(want_params, _masters(g))


@pytest.mark.parametrize("leg", TRAIN_LEGS)
def test_two_process_masters_bit_equal_and_rows_split(pair, leg):
    """Both processes end on the same masters, bit for bit, and each
    train_forward forwards this process's block: 1/2 of the global rows
    (the uneven batch of 7: 4 rows on process 0, 3 on process 1)."""
    got = pair.leg(leg)
    m0, m1 = _masters(got[0]), _masters(got[1])
    assert m0.keys() == m1.keys()
    for name in m0:
        assert torch.equal(m0[name], m1[name]), name
    np.testing.assert_array_equal(got[0]["losses"], got[1]["losses"])
    kind, _, _, hard, n, _ = worker.LEGS[leg]
    if kind == "mlm":
        want = [[n // 2] * STEPS] * 2
    else:
        q = [(n + 1) // 2, n // 2]
        want = [[r, 2 * r if hard else r] * STEPS for r in
                ([n // 2] * 2 if hard else q)]
    for pid, g in enumerate(got):
        assert g["rows"].tolist() == want[pid], (pid, g["rows"])


def test_two_process_dropout(pair):
    """Dropout 0.25: a rerun from the same start is bit-equal, the two
    processes draw different masks for their different rows, and a step's
    chunk side draws fresh masks, not the query side's again."""
    got = pair.leg("dropout")
    for g in got:
        q, c = g["mask"].ravel(), g["mask_chunk"].ravel()
        assert not np.array_equal(q[:c.size], c[:q.size])
        np.testing.assert_array_equal(g["losses"], g["losses2"])
        np.testing.assert_array_equal(g["mask"], g["mask2"])
        m, m2 = _masters(g), _masters(g, "2p:")
        for name in m:
            assert torch.equal(m[name], m2[name]), name
        assert np.isfinite(g["losses"]).all()
    assert got[0]["mask"].shape == got[1]["mask"].shape
    assert not np.array_equal(got[0]["mask"], got[1]["mask"])


def test_two_process_collectives(pair):
    got = pair.leg("collectives")
    x0 = np.arange(3)[:, None] * 10.0 + np.arange(4)
    x1 = np.arange(2)[:, None] * 10.0 + 1 + np.arange(4)
    weight = np.arange(20, dtype=np.float64).reshape(5, 4)
    for g in got:
        np.testing.assert_array_equal(g["gathered"], np.concatenate([x0, x1]))
        np.testing.assert_array_equal(g["a"], np.full((2, 3), 3.0))
        np.testing.assert_array_equal(g["b"], np.full(5, 30.0))
    np.testing.assert_array_equal(got[0]["grad"], weight[:3])
    np.testing.assert_array_equal(got[1]["grad"], weight[3:])


def test_two_process_save_encoder_writes_once(pair):
    got = pair.leg("save")
    assert [int(g["writes"]) for g in got] == [1, 0]
    assert all(bool(g["complete"]) for g in got)


# ------------------------------------------------- gather_rows, one process

def _fake_mesh(rank):
    return Mesh(np.array([torch.device("cpu")] * 2, dtype=object), ("data",),
                group=object(), rank=rank)


@pytest.mark.parametrize("world,rank", [(1, 0), (2, 0), (2, 1)])
def test_gather_rows_backward_matches_cat(monkeypatch, world, rank):
    """gather_rows' backward against autograd through torch.cat: world
    size 1 is the identity; a fake 2-way split (uneven, 3 rows then 2)
    gathers this process's rows beside the other's and takes back the
    gradient of its own rows only."""
    rng = np.random.default_rng(world + rank)
    blocks = [torch.from_numpy(rng.standard_normal((c, 4))) for c in (3, 2)]
    weight = torch.from_numpy(rng.standard_normal((5, 4)))
    if world == 1:
        mesh = Mesh(np.array([torch.device("cpu")], dtype=object), ("data",))
        x = blocks[0].clone().requires_grad_(True)
        (distributed.gather_rows(mesh, x) * weight[:3]).sum().backward()
        torch.testing.assert_close(x.grad, weight[:3], rtol=0, atol=0)
        return

    def fake_all_gather(mesh, x):  # the other process's block, padded
        other = blocks[1 - rank]
        pad = torch.zeros((x.shape[0] - other.shape[0], 4), dtype=x.dtype)
        parts = [x.detach(), torch.cat([other, pad])]
        return torch.cat(parts if rank == 0 else parts[::-1])

    monkeypatch.setattr(distributed, "all_gather_rows", fake_all_gather)
    x = blocks[rank].clone().requires_grad_(True)
    got = distributed.gather_rows(_fake_mesh(rank), x, [3, 2])
    (got * weight).sum().backward()
    ref = [b.clone().requires_grad_(True) for b in blocks]
    cat = torch.cat(ref)
    (cat * weight).sum().backward()
    torch.testing.assert_close(got.detach(), cat.detach(), rtol=0, atol=0)
    torch.testing.assert_close(x.grad, ref[rank].grad, rtol=0, atol=0)
    with pytest.raises(ValueError):
        distributed.gather_rows(_fake_mesh(rank), x[:1], [3, 2])
