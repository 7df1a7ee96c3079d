"""semanticsearch_tpu_torch imports neither JAX nor the JAX package.

Every module of the port is imported in a fresh interpreter in which
``import jax``, ``import semanticsearch_tpu``, ``import ml_dtypes``,
``import orbax``, ``import optax`` or ``import flax`` (the card's machine
has none of them) fail, so a stray
import anywhere in the port is an error here. The native library is built
and called there too, a reranker is built, converted and run, and one is
trained, checkpointed and resumed, an encoder saved and loaded, a neural
OIE tagger trained, saved and loaded, and the CLI run."""
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import semanticsearch_tpu_torch

_ROOT = Path(__file__).resolve().parent.parent


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        semanticsearch_tpu_torch.__path__, "semanticsearch_tpu_torch."))


def test_port_has_the_slice_modules():
    mods = set(_port_modules())
    for name in ("core.config", "core.logging", "data.tsv", "data.synth",
                 "models.tokenizer", "models.encoder", "models.convert",
                 "ops._build", "ops.topk", "ops.flash_attention",
                 "index.engine", "index.bm25", "index.rrf", "index.builder",
                 "index.query_engine", "index.delta", "train.metrics",
                 "train.fusion", "ops.similarity", "chunking.cleaning",
                 "chunking.segmenter", "chunking.naive", "chunking.dp_segment",
                 "chunking.splitter", "chunking.grouping",
                 "chunking.pipeline", "native", "models.subword",
                 "index.bm25_tpu", "core.checkpoint", "train.vocab",
                 "train.presets", "ops.matching", "models.rerankers",
                 "models.rerankers.base", "models.rerankers.knrm",
                 "models.rerankers.conv2d_models",
                 "models.rerankers.recurrent",
                 "models.rerankers.cross_encoder",
                 "index.rerank_service", "train.optim", "train.pairs",
                 "train.embeddings", "train.encoder_train",
                 "train.mlm_pretrain", "train.trainer", "train.evaluate",
                 "data.validate", "data.folds", "index.ranker",
                 "oie.heuristic", "oie.client", "oie.neural", "cli.main",
                 "index.server", "data.integrate", "data.mapping",
                 "data.analyze", "core.profiling", "chunking.visualize",
                 "core.mesh", "core.distributed", "parallel",
                 "parallel.sharding", "parallel.tensor",
                 "parallel.ring_similarity"):
        assert f"semanticsearch_tpu_torch.{name}" in mods


@pytest.mark.parametrize("blocked", [("jax",), ("semanticsearch_tpu",),
                                     ("ml_dtypes",), ("orbax",), ("optax",),
                                     ("flax",),
                                     ("jax", "semanticsearch_tpu",
                                      "ml_dtypes", "orbax", "optax",
                                      "flax")])
def test_port_imports_without(blocked):
    code = "\n".join([
        "import sys",
        *(f"sys.modules[{b!r}] = None" for b in blocked),
        "import importlib",
        *(f"importlib.import_module({m!r})" for m in _port_modules()),
        # the native library and the device BM25 leg run without them too
        "from semanticsearch_tpu_torch.index.bm25 import BM25Okapi",
        "from semanticsearch_tpu_torch.index.bm25_tpu import DeviceBM25",
        "bm = BM25Okapi([['a', 'b'], ['b', 'c'], ['c']])",
        "for w in ('bf16', 'int8'):",
        "    DeviceBM25(bm, weights=w, device='cpu').get_topk_batch("
        "[['b', 'c']], 2)",
        # a reranker through the converter both ways and the service
        "from semanticsearch_tpu_torch.models.convert import ("
        "reranker_flax_tree, reranker_state_dict)",
        "from semanticsearch_tpu_torch.models.rerankers import make_model",
        "from semanticsearch_tpu_torch.index.rerank_service import "
        "RerankService",
        "from semanticsearch_tpu_torch.train.vocab import Preprocessor",
        "pp = Preprocessor(filter_low_freq=1).fit(['a b', 'b c'])",
        "tree = reranker_flax_tree(make_model('esim', pp.vocab_size, 8, "
        "hidden_size=4))",
        "from semanticsearch_tpu_torch.core.config import TrainConfig",
        "svc = RerankService('esim', reranker_state_dict('esim', tree, "
        "hidden_size=4), pp, cfg=TrainConfig(model='esim', embedding_dim=8),"
        " model_kwargs={'hidden_size': 4}, device='cpu')",
        "assert svc.score_pairs(['a'], ['b c']).shape == (1,)",
        # a reranker trained, checkpointed and resumed, an encoder saved
        "import json, numpy as np, tempfile",
        "from semanticsearch_tpu_torch.train.pairs import PairDataset",
        "from semanticsearch_tpu_torch.train.trainer import RerankTrainer",
        "ds = PairDataset(left=np.array([[1, 2]] * 4, np.int32), "
        "right=np.array([[2, 3, 4]] * 4, np.int32), labels=np.array("
        "[1, 0, 1, 0], np.float32), query_ids=np.array([0, 0, 1, 1]))",
        "d = tempfile.mkdtemp()",
        "cfg = TrainConfig(model='knrm', epochs=2, batch_size=2, "
        "embedding_dim=4)",
        "RerankTrainer('knrm', 8, cfg, device='cpu').fit(ds, "
        "checkpoint_dir=d, checkpoint_every=1)",
        "RerankTrainer('knrm', 8, cfg, device='cpu').fit(ds, "
        "resume_from=d + '/epoch_0')",
        "from semanticsearch_tpu_torch.core.config import EncoderConfig",
        "from semanticsearch_tpu_torch.models.encoder import "
        "SentenceEncoder",
        "from semanticsearch_tpu_torch.train.encoder_train import ("
        "load_encoder, save_encoder)",
        "enc = SentenceEncoder(EncoderConfig(vocab_size=32, hidden_dim=8, "
        "num_layers=1, num_heads=2, mlp_dim=8, max_len=16), device='cpu')",
        "save_encoder(enc, d + '/enc')",
        "assert load_encoder(d + '/enc', device='cpu').encode(['a']).shape "
        "== (1, 8)",
        # the sharding layer: a 2-shard search, the ring, a TP encoder
        "import torch",
        "from semanticsearch_tpu_torch.core.mesh import MeshSpec, make_mesh",
        "from semanticsearch_tpu_torch.parallel.sharding import ("
        "shard_corpus, sharded_topk)",
        "from semanticsearch_tpu_torch.parallel.ring_similarity import "
        "sharded_doc_similarity",
        "m2 = make_mesh(MeshSpec(data=2), ['cpu'] * 2)",
        "e = torch.eye(4)",
        "assert sharded_topk(e, shard_corpus(e, m2), m2, k=1)[1][:, 0]"
        ".tolist() == [0, 1, 2, 3]",
        "assert sharded_doc_similarity(e.numpy(), m2).shape == (4, 4)",
        "tp = load_encoder(d + '/enc', device='cpu', mesh=make_mesh("
        "MeshSpec(data=1, model=2), ['cpu'] * 2))",
        "assert tp._tp == 2 and tp.encode(['a']).shape == (1, 8)",
        # a neural OIE tagger trained, saved and loaded; the CLI's parser
        "from semanticsearch_tpu_torch.oie.neural import NeuralOIE, "
        "NeuralOIEConfig",
        "oie = NeuralOIE(NeuralOIEConfig(hidden_dim=8, num_layers=1, "
        "num_heads=2, mlp_dim=8, max_len=16, epochs=1), device='cpu')",
        "oie.fit_silver(['The old engineer carried the bridge.'])",
        "oie.save(d + '/oie')",
        "assert NeuralOIE.load(d + '/oie', device='cpu').extract(['The "
        "mayor signed the letter.'])[0] == oie.extract(['The mayor signed "
        "the letter.'])[0]",
        "from semanticsearch_tpu_torch.cli.main import main",
        "open(d + '/v.tsv', 'w').write('query_id\\tchunk_text\\tlabel\\n"
        "q\\tt\\t1\\n')",
        "import contextlib, io",
        "with contextlib.redirect_stdout(io.StringIO()) as buf:",
        "    assert main(['--device', 'cpu', 'validate', '-i', d + '/v.tsv'])"
        " == 0",
        "assert json.loads(buf.getvalue())['rows_kept'] == 1",
        "assert not any(m == 'jax' or m.startswith(('jax.', 'flax', "
        "'semanticsearch_tpu.', 'ml_dtypes', 'orbax')) for m in sys.modules "
        "if sys.modules[m])",
        "assert not any(m.split('.')[0] in ('optax', 'flax') "
        "for m in sys.modules if sys.modules[m])",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
