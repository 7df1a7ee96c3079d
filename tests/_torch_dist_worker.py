"""Worker for the port's two-process tests (spawned by
tests/test_torch_multiprocess.py). Joins a gloo process group through
``core.distributed.initialize``, builds global meshes and runs every leg
that crosses the process boundary: the corpus-sharded top-k (one shard a
process, and two a process), a skewed layout, the two-level merge, the ring
similarity, the column-sharded device BM25, and the raw collectives.

Each leg writes ``<leg>_<pid>.npz`` into the output directory and prints
``LEG_OK <leg> proc=<pid>``; the parent test holds the files against the
JAX package's functions on a mesh of as many devices. The inputs come from
:func:`leg_inputs`, which the parent calls too.

Run: python tests/_torch_dist_worker.py <process_id> <port> <output_dir>
"""
import os
import sys

import numpy as np


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def leg_inputs():
    """Every leg's seeded inputs (the same in every process)."""
    rng = np.random.default_rng(0)
    skew = rng.standard_normal((64, 32)).astype(np.float32) * 0.01
    skew[:5] = _unit(rng.standard_normal((5, 32)) + 3.0)
    words = [f"w{i}" for i in range(120)]
    p = 1.0 / np.arange(1, 121) ** 1.1
    p /= p.sum()
    return {
        "corpus": _unit(rng.standard_normal((101, 32))),
        "queries": _unit(rng.standard_normal((3, 32))),
        "skew": skew,
        "skew_queries": _unit(rng.standard_normal((3, 32)) * 0.1 + 1.0),
        "corpus2": _unit(rng.standard_normal((96, 32))),
        "ring": _unit(rng.standard_normal((17, 24))),
        "docs": [list(rng.choice(words, size=rng.integers(4, 20), p=p))
                 for _ in range(300)],
        "bm25_queries": [list(rng.choice(words, size=3, p=p))
                         for _ in range(20)],
    }


def main() -> int:
    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    pid, port, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    import torch

    from semanticsearch_tpu_torch.core import distributed
    from semanticsearch_tpu_torch.core.mesh import MeshSpec
    from semanticsearch_tpu_torch.parallel.ring_similarity import (
        ring_similarity_matrix, sharded_doc_similarity)
    from semanticsearch_tpu_torch.parallel.sharding import (
        pad_to_shards, shard_corpus, sharded_topk, sharded_topk_2level)

    assert distributed.initialize(f"127.0.0.1:{port}", 2, pid,
                                  backend="gloo") is True
    assert distributed.is_primary() == (pid == 0)
    data = leg_inputs()
    cpu = torch.device("cpu")

    def save(leg, **arrays):
        np.savez(os.path.join(out_dir, f"{leg}_{pid}.npz"), **arrays)
        print(f"LEG_OK {leg} proc={pid}", flush=True)

    def topk(mesh, corpus, queries, k, fn=sharded_topk):
        emb, valid = pad_to_shards(torch.from_numpy(corpus), mesh)
        v, i = fn(torch.from_numpy(queries), shard_corpus(emb, mesh), mesh,
                  k=k, valid_n=valid)
        return v.numpy(), i.numpy()

    mesh = distributed.global_mesh(MeshSpec())  # one CPU a process
    assert mesh.shape == {"data": 2, "model": 1}
    v, i = topk(mesh, data["corpus"], data["queries"], 5)
    save("topk", vals=v, idx=i)

    # two shards a process: the 4-shard merge gathers across processes
    mesh4 = distributed.global_mesh(MeshSpec(), local_devices=[cpu] * 2)
    v, i = topk(mesh4, data["corpus"], data["queries"], 5)
    save("topk4", vals=v, idx=i)

    # every top-k row on process 0's shard
    v, i = topk(mesh, data["skew"], data["skew_queries"], 5)
    save("skewed", vals=v, idx=i)

    # (dcn 2, data 2), one slice a process: each merges its slice, then one
    # list a slice crosses the process boundary
    mesh2d = distributed.global_mesh(n_slices=2, local_devices=[cpu] * 2)
    assert mesh2d.shape == {"dcn": 2, "data": 2}
    v, i = topk(mesh2d, data["corpus2"], data["queries"], 5,
                fn=sharded_topk_2level)
    save("twolevel", vals=v, idx=i)

    S = sharded_doc_similarity(data["ring"], mesh4)
    rows = ring_similarity_matrix(
        shard_corpus(torch.from_numpy(data["ring"][:16].copy()), mesh), mesh)
    # hybrid meshes: each process rings inside its own slice (dcn 2, data
    # 2), or both ring over their subgroup in one slice (dcn 1, data 2)
    S_slices = sharded_doc_similarity(data["ring"], mesh2d)
    mesh1 = distributed.global_mesh(n_slices=1)
    assert mesh1.shape == {"dcn": 1, "data": 2}
    S_group = sharded_doc_similarity(data["ring"], mesh1)
    save("ring", S=S, rows=torch.cat(rows).numpy(), S_slices=S_slices,
         S_group=S_group)

    from semanticsearch_tpu_torch.index.bm25 import BM25Okapi
    from semanticsearch_tpu_torch.index.bm25_tpu import DeviceBM25

    leg = DeviceBM25(BM25Okapi(data["docs"]), n_dense_terms=32,
                     topk_device=16, device="cpu", mesh=mesh4)
    bi, bs = leg.get_topk_batch(data["bm25_queries"], 5)
    save("bm25", idx=bi, scores=bs)

    x = torch.arange(2 * 8, dtype=torch.float32).reshape(2, 8) + 100 * pid
    g = distributed.all_gather_rows(mesh, x)
    shifted = distributed.ring_shift(mesh4, [x[:1], x[1:]], [cpu, cpu])
    save("collectives", gathered=g.numpy(),
         shifted=torch.cat(shifted).numpy())
    print(f"DIST_OK proc={pid}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
