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
shell command. The parts are read from the driven package's own spans, so
a tree must have them (``core/profiling.py``'s ``span``). The corpus and queries are made here, from fixed seeds, so
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
    block, from the program's spans (``core/profiling.py``), which it
    switches on for the block:

    - ``tokenize``: ``encoder.tokenize`` (the encoder's tokenizer and length
      buckets) and ``serve.tokenize_lexical`` (the BM25 whitespace
      tokenizer);
    - ``bm25_topk``: ``serve.lexical``, the lexical leg's call (the native
      top-k, or the device leg's launch and rare-term traversal under
      ``lexical_device``);
    - ``delta_score``: ``serve.delta_lexical``, ``DeltaBM25.score`` over
      the added documents;
    - ``fetch_and_lists``: ``serve.lists``, the wait for the card and the
      per-query list building (and the join of a device lexical leg);
    - ``rrf``: ``serve.fuse``, the fusion;
    - ``rest``: the wall time of the block less all of the above.

    ``engine`` is the engine searched; the spans are the whole process's,
    so nothing else should search in the block.
    """

    SPANS = {"tokenize": ("encoder.tokenize", "serve.tokenize_lexical"),
             "bm25_topk": ("serve.lexical",),
             "delta_score": ("serve.delta_lexical",),
             "fetch_and_lists": ("serve.lists",),
             "rrf": ("serve.fuse",)}

    def __init__(self, engine) -> None:
        self.engine = engine
        self.seconds: Dict[str, float] = dict.fromkeys(PARTS, 0.0)

    def __enter__(self) -> "HostSplit":
        from ..core import profiling

        self._was_on = profiling.enable(True)
        self._before = profiling.span_totals()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        from ..core import profiling

        total = time.perf_counter() - self._t0
        after = profiling.span_totals()
        profiling.enable(self._was_on)
        s = self.seconds
        for part, names in self.SPANS.items():
            s[part] = sum(after.get(n, (0.0, 0))[0]
                          - self._before.get(n, (0.0, 0))[0] for n in names)
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
