"""The port's multi-process path: two OS processes join one gloo group
through ``core.distributed.initialize`` and run every leg that crosses the
process boundary (tests/_torch_dist_worker.py): the sharded top-k with one
and with two shards a process, a skewed layout, the two-level merge, the
ring similarity, the column-sharded device BM25 and the raw collectives.
Their results are held against the JAX package's functions on a mesh of as
many devices (the JAX package's own two-process test is
tests/test_multiprocess.py).

One spawn of the pair backs every leg; a hang fails the test at its
timeout instead of using up the suite's clock."""
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist_worker as worker
from semanticsearch_tpu.core.mesh import MeshSpec, hybrid_mesh, make_mesh
from semanticsearch_tpu.parallel import sharding as js
from semanticsearch_tpu.parallel.ring_similarity import (
    ring_similarity_matrix, sharded_doc_similarity)

TOL = 1e-6
LEGS = ("topk", "topk4", "skewed", "twolevel", "ring", "bm25", "collectives")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def dist_outputs(tmp_path_factory):
    """Launch the two-process group once; return (procs, outputs, dir)."""
    out_dir = str(tmp_path_factory.mktemp("dist"))
    script = os.path.join(os.path.dirname(__file__), "_torch_dist_worker.py")
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env["CUDA_VISIBLE_DEVICES"] = ""
    procs = [subprocess.Popen(
        [sys.executable, script, str(pid), str(port), out_dir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for pid in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed worker timed out")
        outs.append(out)
    return procs, outs, out_dir


def _leg(dist_outputs, leg):
    procs, outs, out_dir = dist_outputs
    got = []
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"LEG_OK {leg} proc={pid}" in out, out
        got.append(dict(np.load(os.path.join(out_dir, f"{leg}_{pid}.npz"))))
    return got


def _jmesh(n):
    return make_mesh(MeshSpec(data=n), devices=jax.devices("cpu")[:n])


def _jax_topk(mesh, corpus, queries, k, fn=js.sharded_topk):
    emb, valid = js.pad_to_shards(jnp.asarray(corpus), mesh)
    v, i = fn(jnp.asarray(queries), js.shard_corpus(emb, mesh), mesh, k=k,
              valid_n=valid)
    return np.asarray(v), np.asarray(i)


def _assert_topk(got, want):
    for g in got:  # every process ends with the same merged lists
        np.testing.assert_array_equal(g["idx"], want[1])
        np.testing.assert_allclose(g["vals"], want[0], rtol=0, atol=TOL)


def test_two_process_group_joins(dist_outputs):
    procs, outs, _ = dist_outputs
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"DIST_OK proc={pid}" in out, out


@pytest.mark.parametrize("leg,n_dev,corpus,queries", [
    ("topk", 2, "corpus", "queries"),
    ("topk4", 4, "corpus", "queries"),
    ("skewed", 2, "skew", "skew_queries"),
])
def test_two_process_sharded_topk(dist_outputs, mesh8, leg, n_dev, corpus,
                                  queries):
    data = worker.leg_inputs()
    _assert_topk(_leg(dist_outputs, leg),
                 _jax_topk(_jmesh(n_dev), data[corpus], data[queries], 5))


def test_two_process_2level_merge(dist_outputs, mesh8):
    data = worker.leg_inputs()
    want = _jax_topk(hybrid_mesh(2, jax.devices("cpu")[:4]), data["corpus2"],
                     data["queries"], 5, fn=js.sharded_topk_2level)
    _assert_topk(_leg(dist_outputs, "twolevel"), want)


def test_two_process_ring_similarity(dist_outputs, mesh8):
    from jax.sharding import NamedSharding, PartitionSpec as P

    data = worker.leg_inputs()
    S = sharded_doc_similarity(data["ring"], _jmesh(4))
    m2 = _jmesh(2)
    rows = ring_similarity_matrix(jax.device_put(
        jnp.asarray(data["ring"][:16]), NamedSharding(m2, P("data", None))),
        m2)
    got = _leg(dist_outputs, "ring")
    for g in got:
        np.testing.assert_allclose(g["S"], S, rtol=0, atol=TOL)
    # each process holds its own row block of the 2-shard ring
    for pid, g in enumerate(got):
        np.testing.assert_allclose(
            g["rows"], np.asarray(rows)[pid * 8: (pid + 1) * 8], rtol=0,
            atol=TOL)


def test_two_process_device_bm25(dist_outputs):
    from semanticsearch_tpu.index.bm25 import BM25Okapi

    data = worker.leg_inputs()
    want_i, want_s = BM25Okapi(data["docs"]).get_topk_batch(
        data["bm25_queries"], 5)
    for g in _leg(dist_outputs, "bm25"):
        np.testing.assert_array_equal(g["idx"], want_i)
        np.testing.assert_array_equal(g["scores"], want_s)


def test_two_process_raw_collectives(dist_outputs):
    x = np.arange(16, dtype=np.float32).reshape(2, 8)
    both = np.concatenate([x, x + 100])
    got = _leg(dist_outputs, "collectives")
    for g in got:
        np.testing.assert_array_equal(g["gathered"], both)
    # the ring over four shards, two a process: each shard takes its
    # predecessor's block, process 0's first from process 1's last
    np.testing.assert_array_equal(got[0]["shifted"], both[[3, 0]])
    np.testing.assert_array_equal(got[1]["shifted"], both[[1, 2]])
