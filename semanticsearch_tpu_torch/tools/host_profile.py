"""Split the host time of the served query path by part, on one CUDA card.

    python -m semanticsearch_tpu_torch.tools.host_profile \
        [--tree DIR] [--label NAME] [--out FILE.jsonl]

Drives the two served workloads of ``chip_smoke.py`` through the tree's
``HybridQueryEngine`` and times each host part of them with
:class:`HostSplit`: phase 3's 768 queries (four 64-query batches hybrid,
then dense-only, then pipelined, over a 20,000-chunk index) and phase 5's
live search (2,000 chunks added, 500 removed, 10,000 hybrid queries at
k = 50). ``--tree`` names the root of another checkout (default: the one
this file lies in), whose package is then the one driven, so two versions
can be timed in turns on one card: run the script once per tree, all in one
shell command. The corpus and queries are made here, from fixed seeds, so
every tree sees the same ones. One JSON line per run goes to stdout (and is
appended to ``--out``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict

import numpy as np

PARTS = ("tokenize", "bm25_topk", "delta_score", "fetch_and_lists", "rrf",
         "rest")


class HostSplit:
    """Times the host parts of an engine's searches while in the ``with``
    block, by wrapping the engine's own objects (nothing is changed once it
    exits):

    - ``tokenize``: the encoder's ``tokenizer.encode_batch`` and the BM25
      whitespace tokenizer of ``index/query_engine.py``;
    - ``bm25_topk``: the lexical leg's call (``bm25.get_topk_batch``, or the
      device leg's launch and rare-term traversal under ``lexical_device``,
      whose host fallbacks then add the time they run on the worker);
    - ``delta_score``: ``DeltaBM25.score`` over the added documents;
    - ``fetch_and_lists``: ``_leg_lists``, the wait for the card and the
      per-query list building (and the join of a device lexical leg);
    - ``rrf``: ``_finish_legs`` less its ``_leg_lists``, the fusion;
    - ``rest``: the wall time of the block less all of the above.
    """

    def __init__(self, engine) -> None:
        self.engine = engine
        self.seconds: Dict[str, float] = dict.fromkeys(PARTS, 0.0)
        self._undo = []

    def _wrap(self, obj, name: str, part: str) -> None:
        if obj is None or not hasattr(obj, name):
            return
        fn = getattr(obj, name)
        seconds = self.seconds

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                seconds[part] += time.perf_counter() - t0

        # a module's function or an instance's own attribute is put back;
        # a method the instance takes from its class is just deleted
        self._undo.append((obj, name, fn, name in vars(obj)))
        setattr(obj, name, timed)

    def __enter__(self) -> "HostSplit":
        from importlib import import_module

        eng = self.engine
        qe = import_module(type(eng).__module__)
        self._wrap(getattr(eng.encoder, "tokenizer", None), "encode_batch",
                   "tokenize")
        self._wrap(qe, "tokenize", "tokenize")
        if getattr(eng.cfg, "lexical_device", False):
            self._wrap(eng, "_start_device_lexical", "bm25_topk")
        self._wrap(eng.bm25, "get_topk_batch", "bm25_topk")
        self._wrap(getattr(eng, "_delta_bm25", None), "score", "delta_score")
        self._wrap(eng, "_leg_lists", "fetch_and_lists")
        self._wrap(eng, "_finish_legs", "rrf")
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        total = time.perf_counter() - self._t0
        for obj, name, fn, own in reversed(self._undo):
            if own:
                setattr(obj, name, fn)
            else:
                delattr(obj, name)
        self._undo = []
        s = self.seconds
        # _finish_legs holds _leg_lists: the fusion is the difference
        s["rrf"] = max(0.0, s["rrf"] - s["fetch_and_lists"])
        s["rest"] = total - sum(s[p] for p in PARTS if p != "rest")
        s["total"] = total

    def line(self) -> str:
        return ", ".join(f"{p} {self.seconds[p]:.3f}" for p in (*PARTS,
                                                              "total"))


def zipf_text(rng, words, n_words: int) -> str:
    """n_words drawn Zipf(1.2) from the word list (chip_smoke's corpus)."""
    ranks = np.minimum(rng.zipf(1.2, size=n_words), len(words)) - 1
    return " ".join(words[r] for r in ranks)


def serve_corpus(seed: int = 7, n_chunks: int = 20000):
    """(words, rows, queries) of chip_smoke phase 3: 20,000 chunks of
    40-240 words over a 6,000-word vocabulary, 256 queries of 3-8 words."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = ["".join(rng.choice(letters, size=int(rng.integers(3, 10))))
             for _ in range(6000)]
    lengths = rng.integers(40, 241, size=n_chunks)
    rows = [{"chunk_id": f"c{i}", "query_id": "", "document_id": f"d{i // 4}",
             "chunk_text": zipf_text(rng, words, int(n))}
            for i, n in enumerate(lengths)]
    queries = [zipf_text(rng, words, int(rng.integers(3, 9)))
               for _ in range(256)]
    return words, rows, queries


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    for mod in [m for m in sys.modules
                if m.startswith("semanticsearch_tpu_torch")]:
        del sys.modules[mod]
    import torch

    if not torch.cuda.is_available():
        print("host_profile: no CUDA device", file=sys.stderr)
        return 2
    import semanticsearch_tpu_torch
    from semanticsearch_tpu_torch.core.config import EncoderConfig
    from semanticsearch_tpu_torch.data.tsv import write_tsv
    from semanticsearch_tpu_torch.index.query_engine import HybridQueryEngine
    from semanticsearch_tpu_torch.models.encoder import SentenceEncoder
    from semanticsearch_tpu_torch.ops import _build

    assert Path(semanticsearch_tpu_torch.__file__).resolve().is_relative_to(
        tree), semanticsearch_tpu_torch.__file__
    _build.build_all()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    res = {"tree": str(tree), "label": args.label or tree.name, "card": smi}
    words, rows, queries = serve_corpus()
    batches = [queries[s: s + 64] for s in range(0, 256, 64)]
    with tempfile.TemporaryDirectory() as tmp:
        tsv = os.path.join(tmp, "chunks.tsv")
        write_tsv(tsv, rows, ["chunk_id", "query_id", "document_id",
                              "chunk_text"])
        encoder = SentenceEncoder(EncoderConfig(attention="flash"),
                                  device="cuda", seed=0)
        t0 = time.perf_counter()
        HybridQueryEngine.build(tsv, encoder, os.path.join(tmp, "idx"))
        torch.cuda.synchronize()
        res["build_s"] = time.perf_counter() - t0
        engine = HybridQueryEngine.load(os.path.join(tmp, "idx"), encoder)
        engine.search(batches[0], k=10)  # warm-up: kernels and allocator
        torch.cuda.synchronize()
        with HostSplit(engine) as split:
            for b in batches:
                engine.search(b, k=10)
            for b in batches:
                engine.search(b, k=10, hybrid=False)
            engine.search_pipelined(batches, k=10)
            torch.cuda.synchronize()
        res["serve"] = split.seconds
        rng = np.random.default_rng(17)
        adds = [zipf_text(rng, words, int(n))
                for n in rng.integers(40, 241, size=2000)]
        engine.add_documents([f"a{i}" for i in range(2000)], adds)
        dead = rng.choice(engine.index.size + 2000, size=500, replace=False)
        engine.remove_documents([engine.chunk_ids[r] for r in dead])
        live_q = [zipf_text(rng, words, int(rng.integers(3, 9)))
                  for _ in range(10000)]
        with HostSplit(engine) as split:
            engine.search(live_q, k=50)
            torch.cuda.synchronize()
        res["live"] = split.seconds
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
