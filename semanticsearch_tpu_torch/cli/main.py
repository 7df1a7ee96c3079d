"""One CLI with subcommands: integrate / chunk / rank / index / index-add /
search / serve / tune-fusion / oie / oie-train / validate / folds / train /
evaluate / train-encoder / train-tokenizer / analyze / mapping.

Counterpart of ``semanticsearch_tpu/cli/main.py`` (the ``semsearch``
command) as ``semsearch-torch`` or ``python -m
semanticsearch_tpu_torch.cli.main``: the same subcommands, flags, JSON
lines on stdout and exit codes. The JAX CLI's ``--platform {cpu,tpu}`` is
the top-level ``--device {cuda,cpu}`` here (default ``cuda``, which
raises without a card), handed to every encoder, engine, pipeline, trainer,
evaluator and tagger a subcommand builds. ``index-add``, ``serve``,
``search`` and ``tune-fusion`` load their engine on ``local_mesh(device)``,
every local device of that kind, as the JAX CLI passes ``local_mesh()``: the
corpus row-shards over several cards, and one card (or the CPU) is the
unsharded path.

Replaces the reference's per-script argparse CLIs and ``input()`` wizards
with a single entry point plus the named-config registry (``--config``
picks a preset; ``--set a.b=c`` overrides any field in the typed config
tree).
"""
from __future__ import annotations

import argparse
import ast
import json
import os
import sys
from typing import Any, Dict, List

from ..core.config import Config, NAMED_CONFIGS, get_named_config


def _apply_sets(cfg: Config, sets: List[str]) -> Config:
    """Apply --set dotted.path=value overrides onto the config tree."""
    tree: Dict[str, Any] = {}
    for item in sets or []:
        path, _, raw = item.partition("=")
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        node = tree
        keys = path.strip().split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return cfg.override(**tree) if tree else cfg


def _add_config_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", default="default",
                   help=f"named config: {sorted(NAMED_CONFIGS)}")
    p.add_argument("--set", action="append", default=[],
                   help="override config fields, e.g. --set chunking.method=grouping")
    p.add_argument("--encoder-ckpt",
                   help="load trained encoder weights (see train-encoder) "
                        "instead of random init")
    p.add_argument("--tokenizer",
                   help="trained subword tokenizer.json (see "
                        "train-tokenizer); default = hashing tokenizer")


def _make_encoder(cfg: Config, args):
    """Encoder for a subcommand: trained checkpoint when given, else
    config-built random init (the reference's pretrained-model slot,
    ``Tool/Sentence_Embedding.py:75``)."""
    if getattr(args, "encoder_ckpt", None):
        from ..train.encoder_train import load_encoder

        return load_encoder(args.encoder_ckpt, device=args.device)
    from ..models.encoder import SentenceEncoder

    tokenizer = None
    tok_path = getattr(args, "tokenizer", None)
    if tok_path:
        from ..models.tokenizer import load_tokenizer

        tokenizer = load_tokenizer(tok_path, max_len=cfg.encoder.max_len)
        import dataclasses as _dc

        # the embedding table must cover the trained vocabulary
        cfg = _dc.replace(cfg, encoder=_dc.replace(
            cfg.encoder, vocab_size=tokenizer.vocab_size))
    return SentenceEncoder(cfg.encoder, device=args.device,
                           tokenizer=tokenizer)


def cmd_integrate(args) -> int:
    from ..data.integrate import integrate_corpus

    stats = integrate_corpus(args.qrels, args.topics, args.docs, args.output)
    print(json.dumps({"written": stats.written, "skipped": stats.skipped}))
    return 0


def cmd_chunk(args) -> int:
    from ..chunking.pipeline import ChunkPipeline

    cfg = _apply_sets(get_named_config(args.config), args.set)
    # --encoder-ckpt / --tokenizer choose the embedding model (the JAX CLI
    # accepts both here but chunks with a random-init encoder); without
    # them the pipeline builds its config's encoder only if it embeds
    encoder = (_make_encoder(cfg, args)
               if args.encoder_ckpt or args.tokenizer else None)
    summary = ChunkPipeline(cfg, encoder=encoder, device=args.device).run(
        args.input, args.output_dir, limit=args.limit,
        write_chunk_map=args.chunk_map,
    )
    print(json.dumps(summary))
    return 0


def cmd_rank(args) -> int:
    from ..core.config import RankingConfig
    from ..data.tsv import read_tsv, write_tsv
    from ..index.ranker import QueryGroup, rank_and_filter_groups

    cfg = _apply_sets(get_named_config(args.config), args.set)
    rcfg = cfg.ranking

    qmap = {}
    if args.original:
        from ..data.mapping import build_query_map

        qmap = build_query_map(args.original)

    encoder = _make_encoder(cfg, args)

    # Stream query groups: rows for one query are processed and written as
    # soon as the next query starts, so host memory holds one BATCH of
    # groups, never the whole chunk TSV (the reference chunk-reads with a
    # RAM estimator, ``rank_chunks_optimized.py:28-50,373-378``; a 10M-chunk
    # file would not fit as QueryGroup dicts). Requires the input grouped by
    # query_id — which the chunking pipeline emits — and fails loudly
    # otherwise (use --in-memory for unsorted files).
    def stream_groups():
        if args.in_memory:
            groups: Dict[str, QueryGroup] = {}
            for row in read_tsv(args.input):
                qid = row.get("query_id", "")
                qtext = row.get("query_text") or qmap.get(qid, "")
                if not qtext:
                    continue
                g = groups.setdefault(
                    qid, QueryGroup(query_id=qid, query_text=qtext)
                )
                g.chunk_ids.append(
                    row.get("chunk_id", f"{qid}_{len(g.chunk_ids)}")
                )
                g.chunk_texts.append(row.get("chunk_text", ""))
            yield from groups.values()
            return
        seen: set = set()
        cur: QueryGroup | None = None
        for row in read_tsv(args.input):
            qid = row.get("query_id", "")
            qtext = row.get("query_text") or qmap.get(qid, "")
            if not qtext:
                continue
            if cur is None or qid != cur.query_id:
                if cur is not None:
                    yield cur
                if qid in seen:
                    raise ValueError(
                        f"input is not grouped by query_id ({qid!r} "
                        "reappears); sort the chunk TSV by query_id first "
                        "or pass --in-memory"
                    )
                seen.add(qid)
                cur = QueryGroup(query_id=qid, query_text=qtext)
            cur.chunk_ids.append(row.get("chunk_id", f"{qid}_{len(cur.chunk_ids)}"))
            cur.chunk_texts.append(row.get("chunk_text", ""))
        if cur is not None:
            yield cur

    def ranked_rows():
        # micro-batch groups so each device call embeds MANY queries' texts
        # (deduplicated across the batch) — one encode round trip per query
        # would dominate through remote links
        batch: List[QueryGroup] = []
        texts = 0
        for group in stream_groups():
            batch.append(group)
            texts += len(group.chunk_texts) + 1
            if len(batch) >= args.group_batch or texts >= 8192:
                yield from rank_and_filter_groups(batch, encoder.encode, rcfg)
                batch, texts = [], 0
        if batch:
            yield from rank_and_filter_groups(batch, encoder.encode, rcfg)

    full = args.output.replace(".tsv", "") + "_rrf_filtered_full.tsv"
    n_rows = 0
    with open(full, "w", encoding="utf-8") as f_full, \
            open(args.output, "w", encoding="utf-8") as f_out:
        # 3-column training file at a DISTINCT path (the reference overwrote
        # its full output with the 3-col one — defect 3 in SURVEY.md §7).
        f_full.write("query_id\tchunk_id\tchunk_text\tcosine_score\t"
                     "bm25_score\trrf_score\tlabel\n")
        f_out.write("query_id\tchunk_text\tlabel\n")
        for r in ranked_rows():
            text = r.chunk_text.replace("\t", " ").replace("\n", " ")
            f_full.write(
                f"{r.query_id}\t{r.chunk_id}\t{text}\t{r.cosine_score:.6f}\t"
                f"{r.bm25_score:.6f}\t{r.rrf_score:.8f}\t{r.label}\n"
            )
            f_out.write(f"{r.query_id}\t{text}\t{r.label}\n")
            n_rows += 1
    print(json.dumps({"ranked_rows": n_rows, "output": args.output,
                      "full_output": full}))
    return 0


def cmd_index(args) -> int:
    cfg = _apply_sets(get_named_config(args.config), args.set)
    enc = _make_encoder(cfg, args)
    if args.bm25:
        from ..index.query_engine import HybridQueryEngine

        engine = HybridQueryEngine.build(
            args.input, enc, args.output_dir,
            index_cfg=cfg.index, rank_cfg=cfg.ranking, limit=args.limit,
            device=args.device,
        )
        print(json.dumps({"rows": engine.index.size, "bm25": True}))
    else:
        from ..index.builder import build_corpus_index

        meta = build_corpus_index(args.input, enc, args.output_dir,
                                  batch_size=args.batch_size, limit=args.limit)
        print(json.dumps(meta))
    return 0


def cmd_index_add(args) -> int:
    """Incrementally add documents to a persisted index: embeds ONLY the
    new rows (a full rebuild re-embeds everything), merges via the delta
    path, and compacts back to disk."""
    import dataclasses

    from ..data.tsv import CHUNK_TEXT_KEYS, read_tsv
    from ..index.builder import META_FILE
    from ..index.query_engine import HybridQueryEngine

    cfg = _apply_sets(get_named_config(args.config), args.set)
    enc = _make_encoder(cfg, args)

    # refuse mismatched embedding spaces up front: compare against the
    # encoder config persisted at build time (meta.json). NOTE: this checks
    # the architecture/config, not the checkpoint WEIGHTS — pass the same
    # --encoder-ckpt the index was built with.
    meta_path = os.path.join(args.index_dir, META_FILE)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            built_cfg = json.load(f).get("encoder_config")
        if built_cfg and built_cfg != dataclasses.asdict(enc.cfg):
            print(json.dumps({
                "error": "encoder config mismatch with the one that built "
                         "this index — adds would land in a different "
                         "embedding space",
                "built": built_cfg,
                "current": dataclasses.asdict(enc.cfg),
            }))
            return 1

    engine = HybridQueryEngine.load(
        args.index_dir, enc, mesh=_local_mesh(args),
        index_cfg=cfg.index, rank_cfg=cfg.ranking, device=args.device,
    )
    if engine.texts is None:
        print(json.dumps({
            "error": "index has no texts.tsv (built without --bm25); "
                     "index-add needs it to compact — rebuild with "
                     "`semsearch index --bm25`",
        }))
        return 1
    before = engine.index.size
    # read_tsv canonicalizes every chunk-text alias to 'chunk_text'
    col = ("chunk_text" if args.text_column.lower() in CHUNK_TEXT_KEYS
           else args.text_column)
    ids, texts = [], []
    for i, row in enumerate(read_tsv(args.input)):
        ids.append(row.get("chunk_id", f"add{before + i}"))
        texts.append(row.get(col, ""))
    engine.add_documents(ids, texts)
    engine.compact()
    print(json.dumps({"rows_before": before, "rows_added": len(ids),
                      "rows_total": engine.index.size}))
    return 0


def _local_mesh(args):
    """Every local device of ``--device``'s kind (the JAX CLI's
    ``local_mesh()``)."""
    from ..core.mesh import local_mesh

    return local_mesh(args.device)


def _lexical_rank_cfg(rank_cfg, args):
    """Apply the serve-time lexical-leg flags shared by search/serve."""
    if getattr(args, "device_bm25", False):
        import dataclasses as _dc

        rank_cfg = _dc.replace(
            rank_cfg, lexical_device=True,
            lexical_cache=getattr(args, "bm25_cache", False))
    return rank_cfg


def cmd_serve(args) -> int:
    from ..index.query_engine import HybridQueryEngine
    from ..index.server import make_server

    cfg = _apply_sets(get_named_config(args.config), args.set)
    enc = _make_encoder(cfg, args)
    rank_cfg = _lexical_rank_cfg(cfg.ranking, args)
    engine = HybridQueryEngine.load(
        args.index_dir, enc, mesh=_local_mesh(args),
        index_cfg=cfg.index, rank_cfg=rank_cfg,
        reranker_dir=getattr(args, "rerank", None), device=args.device,
    )
    srv = make_server(engine, host=args.host, port=args.port,
                      coalesce=args.coalesce, max_batch=args.max_batch,
                      max_wait_ms=args.max_wait_ms)
    print(f"serving http://{srv.server_address[0]}:"
          f"{srv.server_address[1]} (ctrl-c to stop)", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return 0


def cmd_search(args) -> int:
    from ..index.query_engine import HybridQueryEngine

    cfg = _apply_sets(get_named_config(args.config), args.set)
    enc = _make_encoder(cfg, args)
    rank_cfg = _lexical_rank_cfg(cfg.ranking, args)
    engine = HybridQueryEngine.load(
        args.index_dir, enc, mesh=_local_mesh(args),
        index_cfg=cfg.index, rank_cfg=rank_cfg,
        reranker_dir=getattr(args, "rerank", None), device=args.device,
    )
    results = engine.search(
        args.query, k=args.k, hybrid=not args.dense_only,
        rerank_top=args.rerank_top if getattr(args, "rerank", None) else 0,
    )
    out = [
        {
            "query": query,
            "hits": [
                {"chunk_id": h.chunk_id, "rrf_score": h.score,
                 "dense_rank": h.dense_rank, "lexical_rank": h.lexical_rank,
                 **({"rerank_score": h.rerank_score}
                    if h.rerank_score is not None else {})}
                for h in hits
            ],
        }
        for query, hits in zip(args.query, results)
    ]
    print(json.dumps(out))
    return 0


def cmd_tune_fusion(args) -> int:
    """Grid-search RankingConfig.fusion_alpha on a labeled validation TSV.

    Beyond-parity: the reference's fusion is untuned unweighted RRF
    (rank_chunks_optimized.py:225-239). Prints the tuned alpha + per-alpha
    MAP table; apply with `--set ranking.fusion_alpha=<best>` on
    search/serve."""
    from ..data.tsv import read_tsv
    from ..index.query_engine import HybridQueryEngine

    cfg = _apply_sets(get_named_config(args.config), args.set)
    enc = _make_encoder(cfg, args)
    rank_cfg = _lexical_rank_cfg(cfg.ranking, args)
    engine = HybridQueryEngine.load(
        args.index_dir, enc, mesh=_local_mesh(args),
        index_cfg=cfg.index, rank_cfg=rank_cfg,
        reranker_dir=args.reranker, device=args.device,
    )
    # group the labeled rows into per-query relevant chunk_id sets
    queries: dict = {}
    for row in read_tsv(args.input):
        qid = row.get("query_id", row.get("query_text", ""))
        qtext = row.get("query_text", qid)
        rel = queries.setdefault(qid, (qtext, set()))[1]
        try:
            label = float(row.get("label", "0"))
        except ValueError:
            continue
        if label > 0:
            rel.add(row.get("chunk_id", ""))
    pairs = [(qt, rel) for qt, rel in queries.values() if rel]
    if not pairs:
        print(json.dumps({"error": "no positively-labeled rows in input"}))
        return 1
    alpha, best, table = engine.tune_fusion(
        [qt for qt, _ in pairs], [sorted(rel) for _, rel in pairs],
        candidates=args.candidates,
    )
    blend = blend_best = blend_table = None
    if args.rerank_top > 0:
        if args.reranker is None:
            ap_err = ("--rerank-top needs --reranker CKPT_DIR (the blend is "
                      "tuned against a loaded reranker)")
            print(json.dumps({"error": ap_err}))
            return 1
        import dataclasses as _dc

        # the blend rides ON TOP of the fusion order — apply the alpha that
        # was just tuned before grid-searching beta
        engine.cfg = _dc.replace(engine.cfg, fusion_alpha=alpha)
        blend, blend_best, blend_table = engine.tune_rerank_blend(
            [qt for qt, _ in pairs], [sorted(rel) for _, rel in pairs],
            rerank_top=args.rerank_top,
        )
    saved = None
    if args.save:
        import os as _os

        from ..index.query_engine import FUSION_FILE

        saved = _os.path.join(args.index_dir, FUSION_FILE)
        with open(saved, "w") as f:
            json.dump({"fusion_alpha": alpha, "map_at_best": best,
                       "map_at_parity": table.get(0.5),
                       "queries": len(pairs),
                       **({"rerank_blend": blend,
                           "map_at_best_blend": blend_best}
                          if blend is not None else {})}, f)
    print(json.dumps({
        "best_alpha": alpha, "map_at_best": best,
        "map_at_parity": table.get(0.5),
        "queries": len(pairs),
        "table": {f"{a:.2f}": round(v, 6) for a, v in sorted(table.items())},
        "apply": f"--set ranking.fusion_alpha={alpha}",
        **({"best_blend": blend, "map_at_best_blend": blend_best,
            "blend_table": {f"{b:.3f}": round(v, 6)
                            for b, v in sorted(blend_table.items())},
            "apply_blend": f"--set ranking.rerank_blend={blend}"}
           if blend is not None else {}),
        **({"saved": saved} if saved else {}),
    }))
    return 0


def cmd_oie(args) -> int:
    from ..oie.client import enrich_chunk_tsv

    n = enrich_chunk_tsv(args.input, args.output, port=args.port,
                         json_sidecar=args.sidecar,
                         extractor=args.extractor,
                         model_dir=args.model_dir,
                         self_check=args.self_check,
                         on_low_agreement=args.on_low_agreement,
                         device=args.device)
    print(json.dumps({"enriched_rows": n, "output": args.output}))
    return 0


def cmd_oie_train(args) -> int:
    """Bootstrap the neural OIE tagger from the heuristic teacher over the
    text column of a TSV (oie/neural.py)."""
    from ..data.tsv import read_tsv
    from ..oie.neural import NeuralOIEConfig, train_neural_oie

    texts = [row.get(args.text_column, "") for row in read_tsv(args.input)]
    texts = [t for t in texts if t.strip()]
    cfg = NeuralOIEConfig(epochs=args.epochs, seed=args.seed,
                          hidden_dim=args.hidden_dim,
                          num_layers=args.num_layers,
                          num_heads=args.num_heads,
                          mlp_dim=args.hidden_dim * 2)
    oie = train_neural_oie(texts, cfg=cfg, save_dir=args.output,
                           bpe_vocab_size=args.bpe_vocab, device=args.device)
    print(json.dumps({"model_dir": args.output, "texts": len(texts),
                      "vocab": oie.tokenizer.vocab_size}))
    return 0


def cmd_validate(args) -> int:
    from ..data.validate import validate_and_clean

    report = validate_and_clean(args.input, args.output)
    print(json.dumps(report.to_dict()))
    return 0


def cmd_folds(args) -> int:
    from ..data.folds import create_cv_folds

    folds = create_cv_folds(args.input, args.output_dir,
                            num_folds=args.num_folds, seed=args.seed)
    print(json.dumps({"folds": [{"train": f.train, "test": f.test}
                                for f in folds]}))
    return 0


def cmd_train(args) -> int:
    from ..core.config import TrainConfig
    from ..data.folds import FoldPaths
    from ..train.evaluate import (
        CVEvaluator,
        format_comparison_table,
        write_comparison_csv,
    )

    cfg = _apply_sets(get_named_config(args.config), args.set)
    tcfg = cfg.train
    folds = [
        FoldPaths(
            train=f"{args.folds_dir}/fold_{k}_train.tsv",
            test=f"{args.folds_dir}/fold_{k}_test.tsv",
        )
        for k in range(1, args.num_folds + 1)
    ]
    models = args.models.split(",")
    evaluator = CVEvaluator(folds, device=args.device)
    if args.presets:
        from ..train.presets import get_preset

        cfgs, model_kwargs = {}, {}
        for m in models:
            pc, kw = get_preset(m)
            cfgs[m], model_kwargs[m] = pc, kw
        results = [
            evaluator.run_model(m, cfg=cfgs[m], model_kwargs=model_kwargs[m],
                                output_dir=args.output_dir)
            for m in models
        ]
    else:
        cfgs = {
            m: TrainConfig(**{**tcfg.__dict__, "model": m,
                              "eval_metrics": tuple(tcfg.eval_metrics)})
            for m in models
        }
        results = evaluator.run_models(models, cfgs=cfgs,
                                       output_dir=args.output_dir)
    print(format_comparison_table(results))
    if args.csv:
        write_comparison_csv(results, args.csv)
    return 0


def cmd_evaluate(args) -> int:
    """Evaluate SAVED reranker checkpoints on fold test sets — the
    reference's standalone artifact-reload path
    (``MatchZoo_Tool/evaluate_models.py:122-350``), without retraining."""
    from ..train.evaluate import evaluate_saved_model

    results = {}
    for model_dir in args.model_dirs:
        per_fold = []
        for k in range(1, args.num_folds + 1):
            fold_dir = os.path.join(model_dir, f"fold_{k}")
            test = os.path.join(args.folds_dir, f"fold_{k}_test.tsv")
            if not os.path.isdir(fold_dir):
                continue
            per_fold.append(evaluate_saved_model(fold_dir, test,
                                                 device=args.device))
        if per_fold:
            import numpy as np

            results[os.path.basename(model_dir)] = {
                m: {"mean": float(np.mean([f[m] for f in per_fold])),
                    "std": float(np.std([f[m] for f in per_fold]))}
                for m in per_fold[0]
            }
    print(json.dumps(results, indent=2))
    return 0 if results else 1


def cmd_train_tokenizer(args) -> int:
    """Corpus-fit BPE subword vocabulary (models/subword.py) — the
    zero-egress stand-in for the reference's pretrained WordPiece
    (``Tool/Sentence_Embedding.py:75-150``)."""
    from ..data.tsv import read_tsv
    from ..models.subword import train_bpe

    def _texts():
        for row in read_tsv(args.input, limit=args.limit):
            t = row.get(args.column) or row.get("document") \
                or row.get("chunk_text", "")
            if t:
                yield t

    tok = train_bpe(_texts(), vocab_size=args.vocab_size,
                    min_pair_freq=args.min_pair_freq, max_len=args.max_len)
    tok.save(args.output)
    print(json.dumps({
        "output": args.output,
        "vocab_size": tok.vocab_size,
        "pieces": len(tok.vocab),
    }))
    return 0


def cmd_train_encoder(args) -> int:
    from ..data.tsv import read_tsv
    from ..train.encoder_train import (
        ContrastiveConfig,
        ContrastiveEncoderTrainer,
        pairs_from_labeled_rows,
        save_encoder,
    )

    cfg = _apply_sets(get_named_config(args.config), args.set)
    rows = list(read_tsv(args.input))
    pairs, hard = pairs_from_labeled_rows(rows)
    if not pairs:
        print(json.dumps({"error": "no positive (query, chunk) pairs in input"}))
        return 1
    encoder = _make_encoder(cfg, args)
    mlm_history = []
    if args.mlm_epochs > 0:
        # unsupervised denoising pass over the corpus text BEFORE the
        # supervised contrastive stage (train/mlm_pretrain.py) — the
        # zero-egress analog of starting from hub-pretrained weights
        from ..train.mlm_pretrain import MLMConfig, MLMPretrainer

        # sorted: set iteration order is hash-randomized per process, and
        # text order feeds batch composition — keep runs reproducible
        mlm_texts = sorted({
            r.get("chunk_text") or r.get("document", "") for r in rows
        } - {""})
        mlm_history = MLMPretrainer(
            encoder,
            MLMConfig(epochs=args.mlm_epochs, seed=cfg.seed),
        ).fit(mlm_texts)
    ccfg = ContrastiveConfig(
        epochs=args.epochs, batch_size=args.batch_size,
        learning_rate=args.lr, seed=cfg.seed,
        max_len_chunk=min(cfg.encoder.max_len, 256),
    )
    if args.mine_rounds > 1:
        import dataclasses as _dc

        from ..train.encoder_train import (
            fit_with_mining,
            mining_inputs_from_labeled_rows,
        )

        corpus, relevant = mining_inputs_from_labeled_rows(rows, pairs)
        stage_cfg = _dc.replace(
            ccfg, epochs=max(1, args.epochs // args.mine_rounds))
        history = fit_with_mining(
            encoder, stage_cfg, pairs, corpus, relevant,
            initial_negatives=hard, rounds=args.mine_rounds,
            rank_floor=args.mine_rank_floor)
    else:
        history = ContrastiveEncoderTrainer(encoder, ccfg).fit(
            pairs, hard_negatives=hard
        )
    save_encoder(encoder, args.output_dir)
    print(json.dumps({
        "pairs": len(pairs), "epochs": len(history),
        "loss_first": history[0]["loss"], "loss_last": history[-1]["loss"],
        **({"mlm_epochs": len(mlm_history),
            "mlm_loss_first": mlm_history[0]["loss"],
            "mlm_loss_last": mlm_history[-1]["loss"]} if mlm_history else {}),
        **({"mine_rounds": args.mine_rounds} if args.mine_rounds > 1 else {}),
        "checkpoint": args.output_dir,
    }))
    return 0


def cmd_analyze(args) -> int:
    from ..data.analyze import (analyze_and_compare, analyze_chunks,
                                analyze_documents, save_report)

    if args.kind == "documents":
        report = analyze_documents(
            args.input[0], limit=args.limit,
            per_row_output=args.per_row_output,
        )
    elif len(args.input) > 1:
        # multi-config comparison (reference analyze_chunks.py:127-160)
        report = analyze_and_compare(args.input, limit=args.limit)
    else:
        report = analyze_chunks(args.input[0], limit=args.limit)
    if args.output:
        save_report(report, args.output)
    print(json.dumps(report))
    return 0


def cmd_mapping(args) -> int:
    from ..data.mapping import add_query_text_to_tsv

    out = add_query_text_to_tsv(args.input, args.original, args.output)
    print(json.dumps({"output": out}))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="semsearch-torch")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="where encoders, indexes, pipelines, trainers "
                             "and taggers run (default cuda; cpu runs the "
                             "kernels' plain versions)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("integrate", help="qrels+topics+docs -> 5-col TSV")
    p.add_argument("--qrels", required=True)
    p.add_argument("--topics", required=True)
    p.add_argument("--docs", required=True)
    p.add_argument("--output", required=True)
    p.set_defaults(fn=cmd_integrate)

    p = sub.add_parser("chunk", help="chunk a corpus TSV")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output-dir", required=True)
    p.add_argument("--limit", type=int)
    p.add_argument("--chunk-map", action="store_true")
    _add_config_args(p)
    p.set_defaults(fn=cmd_chunk)

    p = sub.add_parser("rank", help="hybrid rank + percentile labels")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--original", help="5-col TSV for query_id->text mapping")
    p.add_argument("--group-batch", type=int, default=32,
                   help="query groups ranked per device batch")
    p.add_argument("--in-memory", action="store_true",
                   help="accept inputs NOT grouped by query_id (loads all "
                        "groups into host memory, like round 1)")
    _add_config_args(p)
    p.set_defaults(fn=cmd_rank)

    p = sub.add_parser("index", help="embed chunks into a persisted index")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output-dir", required=True)
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--limit", type=int)
    p.add_argument("--bm25", action="store_true",
                   help="also persist BM25 term stats for hybrid search")
    _add_config_args(p)
    p.set_defaults(fn=cmd_index)

    p = sub.add_parser("index-add",
                       help="incrementally add chunks to a persisted index "
                            "(embeds only the new rows, then compacts)")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("--index-dir", required=True)
    p.add_argument("--text-column", default="chunk_text")
    _add_config_args(p)
    p.set_defaults(fn=cmd_index_add)

    p = sub.add_parser("search", help="query a persisted index (hybrid RRF)")
    p.add_argument("--index-dir", required=True)
    p.add_argument("-k", type=int, default=10)
    p.add_argument("--dense-only", action="store_true")
    p.add_argument("--rerank", metavar="CKPT_DIR",
                   help="trained reranker checkpoint dir: rescore the "
                        "top --rerank-top RRF candidates on device")
    p.add_argument("--rerank-top", type=int, default=20)
    p.add_argument("--device-bm25", action="store_true",
                   help="score the lexical leg on the device "
                        "(index/bm25_tpu.py; exact, certified)")
    p.add_argument("--bm25-cache", action="store_true",
                   help="persist/reuse the device-BM25 int8 matrix in the "
                        "index dir (RankingConfig.lexical_cache): restarts "
                        "memmap it instead of re-quantizing")
    p.add_argument("query", nargs="+")
    _add_config_args(p)
    p.set_defaults(fn=cmd_search)

    p = sub.add_parser(
        "serve", help="resident HTTP search server over a persisted index")
    p.add_argument("--index-dir", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--rerank", metavar="CKPT_DIR",
                   help="trained reranker checkpoint dir (enables "
                        "rerank_top in /search requests)")
    p.add_argument("--device-bm25", action="store_true",
                   help="score the lexical leg on the device")
    p.add_argument("--bm25-cache", action="store_true",
                   help="persist/reuse the device-BM25 int8 matrix in the "
                        "index dir")
    p.add_argument("--coalesce", action="store_true",
                   help="merge concurrent small /search requests into one "
                        "batched engine call (threaded accept, single "
                        "engine dispatcher)")
    p.add_argument("--max-batch", type=int, default=1024,
                   help="coalescing cap: max queries per merged engine call")
    p.add_argument("--max-wait-ms", type=float, default=4.0,
                   help="coalescing window: max extra latency a lone "
                        "request waits for company")
    _add_config_args(p)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser(
        "tune-fusion",
        help="tune the weighted-RRF fusion alpha on a labeled TSV")
    p.add_argument("--index-dir", required=True)
    p.add_argument("-i", "--input", required=True,
                   help="validation TSV: query_id/query_text/chunk_id/label "
                        "rows; label > 0 marks relevant chunks")
    p.add_argument("--candidates", type=int, default=None,
                   help="per-leg candidate depth (default: engine default)")
    p.add_argument("--save", action="store_true",
                   help="persist the tuned alpha as <index-dir>/fusion.json; "
                        "search/serve auto-apply it unless "
                        "ranking.fusion_alpha is set explicitly")
    p.add_argument("--device-bm25", action="store_true",
                   help="score the lexical leg on the device")
    p.add_argument("--bm25-cache", action="store_true")
    p.add_argument("--reranker",
                   help="trained reranker checkpoint dir: enables "
                        "--rerank-top blend tuning")
    p.add_argument("--rerank-top", type=int, default=0,
                   help=">0: after tuning the fusion alpha, also grid-search "
                        "ranking.rerank_blend over the reranked top-N on the "
                        "same validation split (engine.tune_rerank_blend); "
                        "persisted with --save")
    _add_config_args(p)
    p.set_defaults(fn=cmd_tune_fusion)

    p = sub.add_parser("oie", help="OpenIE triple enrichment of a chunk TSV")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--port", type=int, default=9000)
    p.add_argument("--sidecar")
    p.add_argument("--extractor", default="auto",
                   choices=["auto", "server", "heuristic", "neural"],
                   help="OpenIE5 sidecar, in-repo rule-based SVO extractor, "
                        "trained device-batched tagger (--model-dir), or "
                        "auto (server when its port answers)")
    p.add_argument("--model-dir",
                   help="NeuralOIE checkpoint (from `semsearch oie-train`); "
                        "required with --extractor neural")
    p.add_argument("--self-check", type=float, default=0.5,
                   help="neural extractor: teacher-agreement floor on a "
                        "sample of the input (0 disables) — guards the "
                        "tagger's in-domain contract (cross-domain F1 "
                        "collapses, BASELINE.md)")
    p.add_argument("--on-low-agreement", default="warn",
                   choices=["warn", "fallback", "error"],
                   help="below the floor: warn and proceed, fall back to "
                        "the heuristic engine, or abort")
    p.set_defaults(fn=cmd_oie)

    p = sub.add_parser(
        "oie-train",
        help="bootstrap the neural OIE tagger from the heuristic teacher")
    p.add_argument("-i", "--input", required=True,
                   help="TSV whose text column provides the silver corpus")
    p.add_argument("-o", "--output", required=True,
                   help="checkpoint directory for the trained tagger")
    p.add_argument("--text-column", default="chunk_text")
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--hidden-dim", type=int, default=128)
    p.add_argument("--num-layers", type=int, default=2)
    p.add_argument("--num-heads", type=int, default=4)
    p.add_argument("--bpe-vocab", type=int, default=2048)
    p.set_defaults(fn=cmd_oie_train)

    p = sub.add_parser("validate", help="validate/clean a labeled TSV")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output")
    p.set_defaults(fn=cmd_validate)

    p = sub.add_parser("folds", help="build CV folds")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output-dir", required=True)
    p.add_argument("--num-folds", type=int, default=5)
    p.add_argument("--seed", type=int, default=42)
    p.set_defaults(fn=cmd_folds)

    p = sub.add_parser("train", help="train+evaluate rerankers over CV folds")
    p.add_argument("--models", default="knrm")
    p.add_argument("--presets", action="store_true",
                   help="use the per-model reference hyperparameter presets")
    p.add_argument("--folds-dir", required=True)
    p.add_argument("--num-folds", type=int, default=5)
    p.add_argument("--output-dir")
    p.add_argument("--csv")
    _add_config_args(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("evaluate",
                       help="evaluate SAVED reranker checkpoints per fold "
                            "(no retraining)")
    p.add_argument("--model-dirs", nargs="+", required=True,
                   help="checkpoint roots containing fold_k/ subdirs")
    p.add_argument("--folds-dir", required=True)
    p.add_argument("--num-folds", type=int, default=5)
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("train-encoder",
                       help="contrastive (InfoNCE) encoder training on a "
                            "labeled TSV; writes a checkpoint usable via "
                            "--encoder-ckpt on rank/index/search")
    p.add_argument("-i", "--input", required=True,
                   help="labeled TSV (query_id/query_text/chunk_text/label)")
    p.add_argument("-o", "--output-dir", required=True)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--mlm-epochs", type=int, default=0,
                   help="unsupervised MLM pretraining epochs on the input's "
                        "chunk texts before the contrastive stage "
                        "(train/mlm_pretrain.py; the zero-egress analog of "
                        "hub-pretrained weights)")
    p.add_argument("--mine-rounds", type=int, default=1,
                   help=">1: split the contrastive epochs into this many "
                        "stages, re-mining each pair's hard negative as the "
                        "CURRENT encoder's top-scoring non-relevant chunk "
                        "between stages (ANCE-style self-mining, "
                        "train/encoder_train.py::fit_with_mining)")
    p.add_argument("--mine-rank-floor", type=int, default=0,
                   help="skip the top-N non-relevant hits when re-mining — "
                        "the false-negative guard for incompletely labeled "
                        "corpora where the very top hits may be unlabeled "
                        "positives")
    _add_config_args(p)
    p.set_defaults(fn=cmd_train_encoder)

    p = sub.add_parser("train-tokenizer",
                       help="fit a BPE subword vocabulary on a corpus")
    p.add_argument("-i", "--input", required=True, help="corpus TSV")
    p.add_argument("-o", "--output", required=True,
                   help="output tokenizer.json")
    p.add_argument("--column", default="document",
                   help="text column (falls back to document/chunk_text)")
    p.add_argument("--vocab-size", type=int, default=8192)
    p.add_argument("--min-pair-freq", type=int, default=2)
    p.add_argument("--max-len", type=int, default=256)
    p.add_argument("--limit", type=int)
    p.set_defaults(fn=cmd_train_tokenizer)

    p = sub.add_parser("analyze", help="corpus/chunk statistics")
    p.add_argument("kind", choices=["documents", "chunks"])
    p.add_argument("-i", "--input", required=True, nargs="+",
                   help="input TSV(s); several chunk files -> comparison")
    p.add_argument("-o", "--output")
    p.add_argument("--limit", type=int)
    p.add_argument("--per-row-output",
                   help="documents: write rows + word/sentence-count columns")
    p.set_defaults(fn=cmd_analyze)

    p = sub.add_parser("mapping", help="query_id -> query_text rewrite")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("--original", required=True)
    p.add_argument("-o", "--output")
    p.set_defaults(fn=cmd_mapping)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
