"""Neural open-information extraction: a device-batched BIO tagger.

Counterpart of ``semanticsearch_tpu/oie/neural.py``. The in-repo
transformer backbone (``models/encoder.py``'s ``SentenceTransformerModel``
with ``return_tokens=True``) feeds a float32 token-level tag head that emits
BIO spans for SUBJ / REL / OBJ, decoded to triples on the host. The tagger
trains on SILVER labels the heuristic extractor (``oie/heuristic.py``)
produces over any corpus, and because its input is subword pieces it
generalizes the decision to unseen verbs with familiar morphology,
position, and context. Inference is a fixed-shape batched forward on
``device``: thousands of sentences per batch instead of one HTTP round trip
per paragraph. With a ``mesh`` tagging is data parallel: each batch's rows
split over the data shards, each slice's forward runs on its shard's
device with a copy of the parameters there; training stays on the first
device, as in the JAX package.

It gives the JAX package's tags and training steps: the same piece cache
and first-piece tagging, the same ``np.random.default_rng(cfg.seed)`` draws
(negative sampling in the sentence loop, then one permutation per epoch,
the last batch wrap-padded), optax's Adam (``train/optim.py``), the loss at
word-start positions only, no dropout (the JAX step applies the model
deterministically), and every tag batch padded to ``batch_size``.
Checkpoints are the flax tree ``{"backbone": ..., "tag_head": ...}`` in the
npz layout (``models/convert.py::oie_tagger_flax_tree``), so a tagger
trained by either package loads in the other.

Triple contract invariants (same as the heuristic): every emitted word
appears in the sentence; triples are (subject, relation, object) strings;
exact duplicates are filtered per text.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..core.checkpoint import load_metadata, restore_checkpoint, save_checkpoint
from ..core.config import EncoderConfig
from ..core.logging import get_logger
from ..models.convert import oie_tagger_flax_tree, oie_tagger_state_dict
from ..models.encoder import SentenceTransformerModel, _resolve_device
from .heuristic import _clause_spans, _tokens

logger = get_logger("oie.neural")

Triple = Dict[str, str]

# BIO tag set over word positions. Index 0 MUST stay "O" (padding target).
BIO_TAGS = ("O", "B-SUBJ", "I-SUBJ", "B-REL", "I-REL", "B-OBJ", "I-OBJ")
_TAG_ID = {t: i for i, t in enumerate(BIO_TAGS)}
_SPAN_KIND = {"SUBJ": "subject", "REL": "relation", "OBJ": "object"}


def silver_spans(
    words: Sequence[str],
) -> Optional[Tuple[Tuple[int, int], Tuple[int, int], Tuple[int, int]]]:
    """Heuristic SVO spans over ``words`` as (subj, rel, obj) index ranges.

    Delegates to ``heuristic._clause_spans`` — the SAME function
    ``_clause_triple`` joins to strings — so the silver BIO tags align with
    token positions by construction and can never drift from the teacher.
    """
    return _clause_spans(list(words))


def silver_bio_tags(words: Sequence[str]) -> Optional[List[int]]:
    """Per-word BIO tag ids for one sentence, or None when the heuristic
    finds no triple (such sentences still train as all-"O" negatives)."""
    spans = silver_spans(words)
    if spans is None:
        return None
    tags = [0] * len(words)
    for (a, b), kind in zip(spans, ("SUBJ", "REL", "OBJ")):
        tags[a] = _TAG_ID[f"B-{kind}"]
        for i in range(a + 1, b):
            tags[i] = _TAG_ID[f"I-{kind}"]
    return tags


def decode_bio(words: Sequence[str], tags: Sequence[int]) -> List[Triple]:
    """BIO tag ids -> triples. Spans are read left to right; a triple is
    flushed whenever all three roles are filled, and a B- tag for an
    already-filled role starts the next triple (multi-triple sentences)."""
    spans: List[Tuple[str, int, int]] = []  # (kind, start, end)
    cur_kind, cur_start = None, 0
    for i, t in enumerate(list(tags) + [0]):  # sentinel flush
        name = BIO_TAGS[t] if 0 <= t < len(BIO_TAGS) else "O"
        if cur_kind is not None and name != f"I-{cur_kind}":
            spans.append((cur_kind, cur_start, i))
            cur_kind = None
        if name.startswith("B-"):
            cur_kind, cur_start = name[2:], i
    triples: List[Triple] = []
    parts: Dict[str, str] = {}
    for kind, a, b in spans:
        role = _SPAN_KIND[kind]
        if role in parts:  # role repeats -> previous triple is as complete
            if len(parts) == 3:
                triples.append(dict(parts))
            parts = {}
        parts[role] = " ".join(words[a:b])
    if len(parts) == 3:
        triples.append(dict(parts))
    return [
        {"subject": t["subject"], "relation": t["relation"],
         "object": t["object"]}
        for t in triples
    ]


@dataclasses.dataclass
class NeuralOIEConfig:
    """Tagger hyperparameters. The backbone is the in-repo transformer at a
    small footprint (OIE labels local syntax; 2 layers suffice on silver
    data); ``max_words`` bounds the decoded word positions, ``max_len`` the
    subword-piece sequence the backbone sees."""

    hidden_dim: int = 128
    num_layers: int = 2
    num_heads: int = 4
    mlp_dim: int = 256
    max_len: int = 96
    max_words: int = 48
    vocab_size: int = 4096      # used only with the hash fallback tokenizer
    dtype: str = "float32"
    epochs: int = 8
    batch_size: int = 64
    learning_rate: float = 1e-3
    negative_fraction: float = 0.25  # share of no-triple sentences kept
    seed: int = 0


class OIETagModel(nn.Module):
    """The backbone's final token states (float32) through a float32 dense
    tag head: (B, T) ids and mask -> (B, T, len(BIO_TAGS)) logits."""

    def __init__(self, enc_cfg: EncoderConfig) -> None:
        super().__init__()
        self.backbone = SentenceTransformerModel(enc_cfg)
        self.tag_head = nn.Linear(enc_cfg.hidden_dim, len(BIO_TAGS))

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self.tag_head(self.backbone(ids, mask, return_tokens=True))


class NeuralOIE:
    """Batched neural OIE extractor (train on silver labels, tag in fixed
    shape batches) on ``device``."""

    def __init__(self, cfg: NeuralOIEConfig = NeuralOIEConfig(),
                 tokenizer=None, state_dict: Optional[dict] = None,
                 mesh=None, device="cuda") -> None:
        """``state_dict``: the tagger's parameters (``OIETagModel``'s keys,
        e.g. :func:`models.convert.oie_tagger_state_dict` of a flax tree);
        None draws them from ``cfg.seed``. ``mesh``: tag batches row-shard
        over its data shards (``device`` is its first device)."""
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:
            from ..core.mesh import local_row_devices

            self._data_devices = local_row_devices(mesh)
            device = self._data_devices[0]
        else:
            self._data_devices = [torch.device(device)]
        self.tokenizer = tokenizer
        self.device = _resolve_device(device)
        self._piece_cache: Dict[str, List[int]] = {}
        vocab = tokenizer.vocab_size if tokenizer is not None else cfg.vocab_size
        self._enc_cfg = EncoderConfig(
            vocab_size=vocab, hidden_dim=cfg.hidden_dim,
            num_layers=cfg.num_layers, num_heads=cfg.num_heads,
            mlp_dim=cfg.mlp_dim, max_len=cfg.max_len, dtype=cfg.dtype,
        )
        model = OIETagModel(self._enc_cfg)
        if state_dict is None:
            gen = torch.Generator().manual_seed(cfg.seed)
            model.backbone.reset_parameters(gen)
            with torch.no_grad():
                w = model.tag_head.weight
                w.copy_(torch.randn(w.shape, generator=gen)
                        / float(np.sqrt(cfg.hidden_dim)))
                model.tag_head.bias.zero_()
        else:
            model.load_state_dict(state_dict)
        # float32 parameters, eval mode throughout: no dropout in training
        self.model = model.to(device=self.device, dtype=torch.float32).eval()

    def _logits(self, params: Dict[str, torch.Tensor], ids: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        """(B, T, 7) float32 logits: the backbone computes in ``cfg.dtype``
        on casts of the float32 parameters (as flax's ``dtype`` does), the
        tag head in float32."""
        dtype = getattr(torch, self.cfg.dtype)
        cast = {k: v.to(dtype) if k.startswith("backbone.") else v
                for k, v in params.items()}
        return torch.func.functional_call(self.model, cast, (ids, mask))

    def _upload(self, host: np.ndarray, device=None) -> torch.Tensor:
        return torch.from_numpy(host.astype(np.int64)).to(
            self.device if device is None else device)

    # ------------------------------------------------------------ encoding

    def _encode_words(self, words: Sequence[str]
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Words -> (piece ids, mask, word-start piece index per word).

        With a subword tokenizer each word contributes its pieces and the
        tag for the word is read at its FIRST piece (standard first-subtoken
        tagging); with the hash fallback each word is one FNV id. Words
        whose first piece would overflow ``max_len`` are dropped (and so is
        their tag) — callers cap sentences at ``max_words`` anyway.
        """
        cfg = self.cfg
        cache = self._piece_cache
        ids: List[int] = []
        starts: List[int] = []
        for w in words[: cfg.max_words]:
            lw = w.lower()
            pieces = cache.get(lw)
            if pieces is None:
                if self.tokenizer is not None:
                    pieces = self.tokenizer.encode_word(lw) or [1]
                else:
                    from ..models.tokenizer import _hash_token

                    pieces = [_hash_token(lw, cfg.vocab_size)]
                if len(cache) < 262144:  # Zipfian reuse; bounded host RSS
                    cache[lw] = pieces
            if len(ids) + 1 > cfg.max_len:
                break
            starts.append(len(ids))
            room = cfg.max_len - len(ids)
            ids.extend(pieces[:room])
        out = np.zeros(cfg.max_len, np.int32)
        out[: len(ids)] = ids
        mask = np.zeros(cfg.max_len, np.int32)
        mask[: len(ids)] = 1
        return out, mask, np.asarray(starts, np.int32)

    def _batch_arrays(self, sentences: Sequence[Sequence[str]]):
        """Encode tokenized sentences into fixed-shape batch arrays:
        (ids, mask, starts, nwords). ``starts`` is padded with 0s past
        ``nwords`` (those positions are masked out by callers)."""
        cfg = self.cfg
        n = len(sentences)
        ids = np.zeros((n, cfg.max_len), np.int32)
        mask = np.zeros((n, cfg.max_len), np.int32)
        starts = np.zeros((n, cfg.max_words), np.int32)
        nwords = np.zeros(n, np.int32)
        for i, words in enumerate(sentences):
            ids[i], mask[i], st = self._encode_words(words)
            starts[i, : len(st)] = st
            nwords[i] = len(st)
        return ids, mask, starts, nwords

    # ------------------------------------------------------------ training

    def _loss(self, params, ids, mask, starts, nwords, tags) -> torch.Tensor:
        """Cross entropy at word-start positions, averaged over the
        ``nwords`` mask."""
        logits = self._logits(params, ids, mask)
        word_logits = torch.gather(
            logits, 1, starts[..., None].expand(-1, -1, logits.shape[-1]))
        logp = torch.log_softmax(word_logits, dim=-1)
        nll = -torch.gather(logp, -1, tags[..., None])[..., 0]
        pos = torch.arange(self.cfg.max_words, device=nll.device)
        wmask = (pos[None, :] < nwords[:, None]).to(nll.dtype)
        return (nll * wmask).sum() / torch.clamp(wmask.sum(), min=1.0)

    def fit_silver(self, texts: Sequence[str]) -> List[Dict[str, float]]:
        """Bootstrap from the heuristic teacher over ``texts``.

        Sentences where the teacher finds a triple become positive
        examples; a ``negative_fraction`` share of no-triple sentences is
        kept as all-"O" so the student learns to stay silent. Loss is
        cross-entropy at word-start positions only.
        """
        from ..chunking.segmenter import extract_sentences
        from ..train.optim import Optimizer

        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed)
        sents: List[List[str]] = []
        tag_rows: List[np.ndarray] = []
        for text in texts:
            for sentence in extract_sentences(text):
                words = _tokens(sentence)[: cfg.max_words]
                if len(words) < 3:
                    continue
                tags = silver_bio_tags(words)
                if tags is None:
                    if rng.random() > cfg.negative_fraction:
                        continue
                    tags = [0] * len(words)
                sents.append(words)
                row = np.zeros(cfg.max_words, np.int32)
                row[: len(tags)] = tags
                tag_rows.append(row)
        if not sents:
            raise ValueError("no trainable sentences in the silver corpus")
        arrays = self._batch_arrays(sents)
        tags = np.stack(tag_rows)
        logger.info("silver dataset: %d sentences (%d with triples)",
                    len(sents), int((tags.max(axis=1) > 0).sum()))
        # the whole silver set lives on the device; batches index it
        data = [self._upload(x) for x in (*arrays, tags)]

        params = dict(self.model.named_parameters())
        opt = Optimizer(params, "adam", cfg.learning_rate)
        n = len(sents)
        history: List[Dict[str, float]] = []
        for epoch in range(cfg.epochs):
            t0 = time.perf_counter()
            order = rng.permutation(n)
            losses = []
            for s in range(0, n, cfg.batch_size):
                sel = order[s: s + cfg.batch_size]
                if len(sel) < cfg.batch_size:  # static shapes: wrap-pad
                    sel = np.concatenate(
                        [sel, order[: cfg.batch_size - len(sel)]])
                idx = self._upload(sel)
                opt.zero_grad()
                loss = self._loss(params, *(x[idx] for x in data))
                loss.backward()
                opt.step()
                losses.append(loss.detach())
            row = {"epoch": epoch,
                   "loss": float(np.mean(torch.stack(losses).cpu().numpy())),
                   "time_s": time.perf_counter() - t0}
            history.append(row)
            logger.info("neural-oie epoch %d: %s", epoch, row)
        opt.zero_grad()
        return history

    # ----------------------------------------------------------- inference

    @torch.no_grad()
    def tag_sentences(self, sentences: Sequence[Sequence[str]],
                      batch_size: int = 256) -> List[np.ndarray]:
        """Per-sentence word-level tag ids (int32), from fixed-shape
        forwards: each batch is padded to ``batch_size`` rows and the
        padded rows are dropped."""
        if not sentences:
            return []
        n_data = len(self._data_devices)
        batch_size = -(-batch_size // n_data) * n_data  # shardable
        ids, mask, starts, nwords = self._batch_arrays(sentences)
        params = dict(self.model.named_parameters())
        # the parameters on every other device of the data shards
        replicas = {self.device: params}
        for dev in self._data_devices:
            if dev not in replicas:
                replicas[dev] = {k: v.to(dev) for k, v in params.items()}
        step = batch_size // n_data
        out: List[np.ndarray] = []
        n = len(sentences)
        for s in range(0, n, batch_size):
            e = min(s + batch_size, n)
            bi, bm = ids[s:e], mask[s:e]
            if e - s < batch_size:  # keep ONE shape
                pad = np.zeros((batch_size - (e - s), bi.shape[1]), np.int32)
                bi = np.concatenate([bi, pad])
                bm = np.concatenate([bm, pad])
            tags = []
            for j, dev in enumerate(self._data_devices):
                rows = slice(j * step, (j + 1) * step)
                logits = self._logits(replicas[dev],
                                      self._upload(bi[rows], dev),
                                      self._upload(bm[rows], dev))
                tags.append(logits.argmax(dim=-1).to(torch.int32)
                            .to(self.device, non_blocking=True))
            piece_tags = torch.cat(tags).cpu().numpy()
            for i in range(e - s):
                nw = int(nwords[s + i])
                out.append(piece_tags[i, starts[s + i, :nw]])
        return out

    def extract(self, texts: Sequence[str], batch_size: int = 256
                ) -> List[List[Triple]]:
        """Triples per text: segment -> ONE batched tag pass over every
        sentence of every text -> host BIO decode + per-text dedup."""
        from ..chunking.segmenter import extract_sentences

        sent_words: List[List[str]] = []
        owner: List[int] = []
        for ti, text in enumerate(texts):
            if not text or not text.strip():
                continue
            for sentence in extract_sentences(text):
                words = _tokens(sentence)[: self.cfg.max_words]
                if len(words) >= 3:
                    sent_words.append(words)
                    owner.append(ti)
        tag_rows = self.tag_sentences(sent_words, batch_size=batch_size)
        out: List[List[Triple]] = [[] for _ in texts]
        seen = [set() for _ in texts]
        for words, tags, ti in zip(sent_words, tag_rows, owner):
            for t in decode_bio(words, tags):
                key = (t["subject"], t["relation"], t["object"])
                if key in seen[ti]:
                    continue
                seen[ti].add(key)
                out[ti].append(t)
        return out

    # ------------------------------------------------------- self-check
    def teacher_agreement(self, texts: Sequence[str], sample: int = 64,
                          seed: int = 0) -> Dict[str, float]:
        """Extract-time domain check: does the student still reproduce its
        heuristic TEACHER on this corpus?

        The tagger only learns the teacher's decisions over the training
        domain's vocabulary. Since the teacher is always available and
        domain-independent, agreement with it on a sample of the CURRENT
        corpus is a deployment-time proxy for the domain gap: agreement is
        high exactly when the tagger is used in-domain (the
        ``oie-train``-on-the-serving-corpus contract).

        Returns {"agreement", "n_teacher_sentences", "n_sampled"}:
        agreement = fraction of teacher-positive sampled sentences where
        the student emits a triple whose subject/relation/object each
        share a token with the teacher's. Sentences the teacher finds no
        triple in carry no signal and are skipped.
        """
        from ..chunking.segmenter import extract_sentences
        from .heuristic import _clause_triple

        rng = np.random.default_rng(seed)
        sents: List[List[str]] = []
        for text in texts:
            if not text or not text.strip():
                continue
            for sentence in extract_sentences(text):
                words = _tokens(sentence)[: self.cfg.max_words]
                if len(words) >= 3:
                    sents.append(words)
        if not sents:
            return {"agreement": 1.0, "n_teacher_sentences": 0,
                    "n_sampled": 0}
        if len(sents) > sample:
            sel = rng.choice(len(sents), size=sample, replace=False)
            sents = [sents[i] for i in sel]
        # teacher triples per sampled sentence (positional spans -> strings)
        teacher: List[Optional[Triple]] = [_clause_triple(w) for w in sents]
        pos_idx = [i for i, t in enumerate(teacher) if t is not None]
        if not pos_idx:
            return {"agreement": 1.0, "n_teacher_sentences": 0,
                    "n_sampled": len(sents)}
        tag_rows = self.tag_sentences([sents[i] for i in pos_idx])

        def toks(s: str) -> set:
            return set(s.lower().split())

        agree = 0
        for row_i, i in enumerate(pos_idx):
            t = teacher[i]
            student = decode_bio(sents[i], tag_rows[row_i])
            if any(toks(s["subject"]) & toks(t["subject"])
                   and toks(s["relation"]) & toks(t["relation"])
                   and toks(s["object"]) & toks(t["object"])
                   for s in student):
                agree += 1
        return {"agreement": agree / len(pos_idx),
                "n_teacher_sentences": len(pos_idx),
                "n_sampled": len(sents)}

    # --------------------------------------------------------- persistence

    def save(self, path: str) -> str:
        """The flax tree ``{"params": {"backbone", "tag_head"}}`` in the
        npz layout with the config in the metadata, and a trained subword
        tokenizer beside it as ``tokenizer.json``: the JAX package's
        ``NeuralOIE.load`` reads it."""
        cfg = self.cfg
        out = save_checkpoint(
            path,
            {"params": oie_tagger_flax_tree(self.model.state_dict(),
                                            cfg.num_layers, cfg.num_heads)},
            metadata={"neural_oie_config": dataclasses.asdict(cfg),
                      "kind": "neural_oie"},
        )
        if self.tokenizer is not None and hasattr(self.tokenizer, "save"):
            self.tokenizer.save(os.path.join(path, "tokenizer.json"))
        return out

    @classmethod
    def load(cls, path: str, device="cuda") -> "NeuralOIE":
        """A tagger either package saved, on ``device``."""
        meta = load_metadata(path) or {}
        cfg_dict = meta.get("neural_oie_config")
        if not cfg_dict:
            raise FileNotFoundError(f"no neural-oie metadata at {path}")
        cfg = NeuralOIEConfig(**cfg_dict)
        tokenizer = None
        tok_path = os.path.join(path, "tokenizer.json")
        if os.path.exists(tok_path):
            from ..models.subword import SubwordTokenizer

            tokenizer = SubwordTokenizer.load(tok_path)
        params = restore_checkpoint(path)["params"]
        return cls(cfg, tokenizer=tokenizer,
                   state_dict=oie_tagger_state_dict(params), device=device)


def train_neural_oie(
    texts: Sequence[str],
    cfg: NeuralOIEConfig = NeuralOIEConfig(),
    save_dir: Optional[str] = None,
    bpe_vocab_size: int = 2048,
    device="cuda",
) -> NeuralOIE:
    """Convenience: fit a BPE tokenizer on ``texts``, bootstrap the tagger
    from the heuristic teacher on ``device``, optionally persist."""
    from ..models.subword import train_bpe

    tokenizer = train_bpe(list(texts), vocab_size=bpe_vocab_size,
                          max_len=cfg.max_len)
    oie = NeuralOIE(cfg, tokenizer=tokenizer, device=device)
    oie.fit_silver(texts)
    if save_dir:
        oie.save(save_dir)
    return oie
