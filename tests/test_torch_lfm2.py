"""The LFM2-MoE encoder (``models/lfm2_moe.py``) and what it brought into
the port, on the CPU at a small size: the packed forward against the
float64 reference of ``tests/_lfm2_reference.py``, texts of different
lengths in one forward; the plain causal grouped-K/V packed attention; the
wide pass A's plan and its plain version's ids and tie order; the index
built from row blocks; and the BERT encoder's outputs at the default
config, as they were before the second architecture came."""
import copy
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from semanticsearch_tpu_torch.core import profiling
from semanticsearch_tpu_torch.core.config import (EncoderConfig, IndexConfig,
                                                  LFM2MoEConfig)
from semanticsearch_tpu_torch.index import engine
from semanticsearch_tpu_torch.index.engine import EmbeddingIndex
from semanticsearch_tpu_torch.models import encoder as encoder_mod
from semanticsearch_tpu_torch.models import lfm2_moe
from semanticsearch_tpu_torch.models.encoder import (
    SentenceEncoder, SentenceTransformerModel)
from semanticsearch_tpu_torch.ops import flash_attention as fa
from semanticsearch_tpu_torch.ops import topk

import _lfm2_reference as ref

TINY = dict(vocab_size=500, hidden_dim=64, num_layers=4, num_heads=4,
            num_kv_heads=2, mlp_dim=96,
            layer_types=("conv", "full_attention", "conv", "full_attention"),
            num_dense_layers=1, num_experts=8, experts_per_token=2,
            expert_dim=32, max_len=48, dtype="float32")
TEXTS = ["one", "two words", "a text of seven words in it",
         " ".join(f"w{i}" for i in range(40)), "x y", "z " * 20]


def _ref_cfg(cfg: LFM2MoEConfig) -> dict:
    return {"norm_eps": cfg.norm_eps, "hidden": cfg.hidden_dim,
            "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
            "rope_theta": cfg.rope_theta, "layer_types": cfg.layer_types,
            "num_dense_layers": cfg.num_dense_layers,
            "top_k": cfg.experts_per_token}


def _encoder(seed=7, **kw):
    enc = SentenceEncoder(LFM2MoEConfig(**dict(TINY, **kw)), device="cpu",
                          seed=seed)
    with torch.no_grad():  # expert biases large enough to move choices
        for m in enc.model.moe_layers():
            m.expert_bias.normal_(0.0, 0.1, generator=torch.Generator()
                                  .manual_seed(seed))
    return enc


def _ids(enc, text):
    return list(enc.tokenizer.encode(text, max_len=enc.cfg.max_len))


def _routed(enc, texts):
    """The program's embeddings of ``texts`` in one packed forward and each
    text's chosen experts, a (tokens, k) tensor a MoE layer."""
    capture = []
    enc.model.set_capture(capture)
    try:
        emb = enc.encode_device(texts, batch_size=len(texts))
    finally:
        enc.model.set_capture(None)
    lens = [len(_ids(enc, t)) for t in texts]
    starts = np.concatenate([[0], np.cumsum(lens)])
    return emb, [[c[starts[i]: starts[i + 1]] for c in capture]
                 for i in range(len(texts))]


def _norm_weights(enc, seed):
    """Every RMSNorm weight of ``enc`` to 1 + N(0, 0.2^2), so that a norm
    given another's weight shows."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in enc.model.named_parameters():
            if name.endswith("norm.weight"):
                p.copy_(1.0 + 0.2 * torch.randn(p.shape, generator=g))


@pytest.mark.parametrize("norms", ["ones", "random"])
def test_packed_forward_matches_the_reference(norms):
    """Texts of 2-41 tokens in one packed forward: each embedding is its
    own text's last token, as the reference computes the text alone with
    the program's choice of experts (float32 against float64), and every
    choice is the reference's own; with the seeded norm weights (all 1)
    and with each norm's weight its own."""
    enc = _encoder()
    if norms == "random":
        _norm_weights(enc, 11)
    emb, chosen = _routed(enc, TEXTS)
    w = dict(enc.model.state_dict())
    for text, e, ch in zip(TEXTS, emb, chosen):
        want, _, gap = ref.embed(_ref_cfg(enc.cfg), w, _ids(enc, text), ch)
        assert float((e.double() - want).norm()) < 2e-5, text
        assert gap < 1e-6, text


def test_texts_do_not_reach_each_other():
    """The conv and the attention stay inside each packed text: a text's
    embedding is the same alone, beside others, and moved to another
    offset."""
    enc = _encoder()
    together = enc.encode_device(TEXTS, batch_size=len(TEXTS))
    alone = torch.cat([enc.encode_device([t]) for t in TEXTS])
    moved = enc.encode_device(TEXTS[::-1], batch_size=len(TEXTS)).flip(0)
    assert float((together - alone).abs().max()) < 1e-5
    assert float((together - moved).abs().max()) < 1e-5


def test_a_prefix_pools_the_state_at_its_last_token():
    """Causal and pooled at the last token: a text's embedding is the
    longer text's final state at the prefix's last place."""
    enc = _encoder()
    full = "alpha beta gamma delta epsilon zeta"
    states, _, _ = ref.text_states(_ref_cfg(enc.cfg),
                                   dict(enc.model.state_dict()),
                                   _ids(enc, full))
    for words in (1, 3, 6):
        prefix = " ".join(full.split()[:words])
        want = states[words]  # the first id is the BOS
        got = enc.encode_device([prefix])[0].double()
        assert float((got - want / want.norm()).norm()) < 2e-5


def test_the_bias_chooses_and_the_scores_weigh():
    """The expert bias moves the choice (here toward expert 0 for every
    token) and not the weights, which normalize the sigmoid scores of the
    chosen experts."""
    enc = _encoder()
    moe = enc.model.moe_layers()[0]
    x = torch.randn(50, TINY["hidden_dim"],
                    generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        moe.expert_bias.zero_()
        free, _ = moe.route(x)
        moe.expert_bias[0] = 10.0
        chosen, g = moe.route(x)
    s = torch.sigmoid(x @ moe.gate.weight.T)
    assert not bool((free == 0).any(dim=1).all())
    assert bool((chosen == 0).any(dim=1).all())
    want = s.gather(1, chosen)
    torch.testing.assert_close(g, want / (want.sum(1, keepdim=True) + 1e-6))
    # the other chosen expert is the best by score alone, not expert 0
    assert torch.equal(chosen[:, 1], torch.topk(
        s.scatter(1, torch.zeros(50, 1, dtype=torch.int64), -1.0), 1).indices[:, 0])


def test_moe_counters_and_spans():
    enc = _encoder()
    before = profiling.counters()
    prev = profiling.enable(True)
    try:
        profiling.reset()
        enc.encode_device(TEXTS, batch_size=3)
        spans = profiling.span_totals()
    finally:
        profiling.enable(prev)
    after = profiling.counters()
    tokens = sum(len(_ids(enc, t)) for t in TEXTS)
    assert after["encoder.moe_layers"] - before["encoder.moe_layers"] == 2 * 3
    assert (after["encoder.moe_pairs"] - before["encoder.moe_pairs"]
            == 3 * 2 * tokens)
    assert spans["encoder.moe"][1] == 3 * 2
    assert spans["encoder.conv"][1] == spans["encoder.attention"][1] == 2 * 2


def test_bf16_and_seeded_builds():
    """A bf16 build keeps bf16 weights alone (no float32 master), takes a
    state dict's own tensors without a copy, and stays near float32."""
    enc32 = _encoder(seed=2)
    enc16 = SentenceEncoder(dataclasses.replace(enc32.cfg, dtype="bfloat16"),
                            device="cpu", state_dict={
                                k: v.to(torch.bfloat16) for k, v in
                                enc32.model.state_dict().items()})
    assert enc16.master is None
    assert {p.dtype for p in enc16.model.parameters()} == {torch.bfloat16}
    sd = dict(enc16.model.state_dict())
    again = SentenceEncoder(enc16.cfg, device="cpu", state_dict=sd)
    assert again.model.embed.weight.data_ptr() == sd["embed.weight"].data_ptr()
    a, b = enc32.encode_device(TEXTS), enc16.encode_device(TEXTS)
    assert float((a * b).sum(1).min()) > 0.97


def test_inference_only_and_config_checks():
    enc = _encoder()
    with pytest.raises(NotImplementedError, match="inference only"):
        enc.train_forward(torch.zeros(1, 4, dtype=torch.int64),
                          torch.ones(1, 4), {})
    with pytest.raises(NotImplementedError, match="inference only"):
        enc.sync()
    with pytest.raises(NotImplementedError, match="mesh"):
        SentenceEncoder(enc.cfg, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="layer_types"):
        LFM2MoEConfig(**dict(TINY, layer_types=("conv",)))
    with pytest.raises(ValueError, match="K/V heads"):
        LFM2MoEConfig(**dict(TINY, num_kv_heads=3))
    with pytest.raises(ValueError, match="pools"):
        LFM2MoEConfig(**dict(TINY, pooling="mean"))
    # heads only matter where a layer attends
    LFM2MoEConfig(**dict(TINY, num_kv_heads=8, layer_types=("conv",) * 4))
    assert EncoderConfig.arch == "bert" and LFM2MoEConfig.arch == "lfm2_moe"
    assert "arch" not in dataclasses.asdict(EncoderConfig())


def _attention_per_text(q, k, v, lens):
    """Causal grouped-query attention one text at a time, float64."""
    out, s0 = [], 0
    group = q.shape[1] // k.shape[1]
    for n in lens:
        for t in range(s0, s0 + n):
            rows = []
            for hd in range(q.shape[1]):
                kk, vv = k[s0: t + 1, hd // group], v[s0: t + 1, hd // group]
                p = torch.softmax(kk @ q[t, hd] / q.shape[2] ** 0.5, 0)
                rows.append(p @ vv)
            out.append(torch.stack(rows))
        s0 += n
    return torch.stack(out)


@pytest.mark.parametrize("h,kv", [(4, 2), (4, 4), (8, 1)])
def test_plain_causal_grouped_packed_attention(h, kv):
    lens = np.array([1, 5, 64, 65, 3, 130])
    layout = fa.varlen_layout(lens)
    n, dh = int(lens.sum()), 16
    g = torch.Generator().manual_seed(4)
    q = torch.randn(n, h, dh, generator=g)
    k, v = (torch.randn(n, kv, dh, generator=g) for _ in range(2))
    got = fa.flash_attention_varlen(q, k, v, layout, causal=True)
    want = _attention_per_text(q.double(), k.double(), v.double(), lens)
    assert float((got.double() - want).abs().max()) < 1e-5
    if kv != h:
        with pytest.raises(ValueError, match="shapes"):
            fa.flash_attention_varlen(q, k[:, :1].expand(n, 3, dh)
                                      .contiguous(), v, layout, causal=True)


def test_wide_pass_a_plan():
    """Past pass_a_max_d the bf16 pass A takes the wide schedule, whose
    shared memory does not grow with the width and fits at every k_sel."""
    for k_sel in (1, 11, 41, 128):
        widest = topk.pass_a_max_d(k_sel)
        assert topk.pass_a_schedule(widest, k_sel) == "bf16"
        assert topk.pass_a_schedule(widest + 8, k_sel) == "wide"
        for q in (1, 64, 65, 256):
            plans = [topk.pass_a_wide_plan(q, d, k_sel, 1000, 32)
                     for d in (2048, 4096, 8192)]
            assert plans[0] == plans[1] == plans[2]
            plan = plans[0]
            assert plan["smem"] <= topk.SMEM_LIMIT
            assert plan["bq"] == (64 if q <= 64 else 128)
            assert plan["smem"] == topk.pass_a_wide_smem_bytes(
                plan["bq"], plan["stages"], k_sel)
    assert topk.pass_a_wide_plan(256, 2048, 11, 312500, 32)["stages"] == 6


@pytest.mark.parametrize("d,seg_rows,k_sel", [(2048, 32, 11), (1544, 1, 41),
                                              (4096, 128, 128)])
def test_wide_pass_a_ids_and_ties(d, seg_rows, k_sel):
    """pass A at widths past pass_a_max_d on the CPU (the plain version the
    wide schedule is held to on the card): the k_sel best segments by
    maximum score, ties to the lower segment, against a direct
    computation; every second query repeats rows, so segments tie."""
    g = torch.Generator().manual_seed(5)
    n = 3000
    corpus = torch.randint(-3, 4, (n, d), generator=g).to(torch.bfloat16)
    corpus[n // 2:] = corpus[: n - n // 2]  # equal rows: equal maxima
    queries = torch.randint(-3, 4, (9, d), generator=g).to(torch.bfloat16)
    v, ids = topk.segtopk_pass_a(queries, corpus, n, seg_rows, k_sel)
    scores = queries.double() @ corpus.double().T
    n_segs = -(-n // seg_rows)
    pad = torch.zeros(9, n_segs * seg_rows - n, dtype=torch.float64)
    segmax = torch.cat([scores, pad], 1).view(9, n_segs, seg_rows).amax(2)
    order = sorted(range(n_segs), key=lambda s: s)
    for qi in range(9):
        ranked = sorted(order, key=lambda s: -float(segmax[qi, s]))
        want = ranked[:k_sel]
        assert ids[qi, : len(want)].tolist() == want
        assert v[qi, : len(want)].double().tolist() == [
            float(segmax[qi, s]) for s in want]


def _blocks(x, cuts):
    return [x[a:b] for a, b in zip([0] + cuts, cuts + [x.shape[0]])]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_index_build_from_row_blocks_is_bit_equal(monkeypatch, dtype):
    """The index from row blocks (a list, a generator with ``rows``, numpy
    blocks) holds the same bits as from one tensor, whatever the blocks'
    cut and the normalize step's."""
    cfg = IndexConfig(embed_dim=24, dtype=dtype)
    x = torch.randn(1000, 24, generator=torch.Generator().manual_seed(6))
    whole = EmbeddingIndex.build(x, cfg=cfg, device="cpu")._corpus
    monkeypatch.setattr(engine, "NORMALIZE_ROWS", 100)
    small = EmbeddingIndex.build(x, cfg=cfg, device="cpu")._corpus
    cuts = [1, 250, 251, 999]
    listed = EmbeddingIndex.build(_blocks(x, cuts), cfg=cfg,
                                  device="cpu")._corpus
    lazy = EmbeddingIndex.build((b for b in _blocks(x, cuts)), cfg=cfg,
                                device="cpu", rows=1000)._corpus
    host = EmbeddingIndex.build([b.numpy() for b in _blocks(x, [500])],
                                cfg=cfg, device="cpu")._corpus
    for other in (small, listed, lazy, host):
        assert other.dtype == getattr(torch, dtype)
        assert torch.equal(whole.view(torch.int16 if dtype == "bfloat16"
                                      else torch.int32),
                           other.view(torch.int16 if dtype == "bfloat16"
                                      else torch.int32))
    with pytest.raises(ValueError, match="rows"):
        EmbeddingIndex.build(iter(_blocks(x, cuts)), cfg=cfg, device="cpu",
                             rows=999)
    q = torch.randn(5, 24, generator=torch.Generator().manual_seed(7))
    a = EmbeddingIndex.build(x, cfg=cfg, device="cpu").search(q, k=7)
    b = EmbeddingIndex.build(_blocks(x, cuts), cfg=cfg,
                             device="cpu").search(q, k=7)
    assert np.array_equal(a.indices, b.indices)
    assert np.array_equal(a.scores, b.scores)


# the encoder's outputs at seed 0 on these texts before the second
# architecture came: the first four columns, float32 (stock attention)
# through ``encode`` and bfloat16 through ``encode_device``
BERT_TEXTS = ["the quick brown fox", "a",
              "semantic search over chunks of text " * 5]
BERT_F32 = [[-0.01986190304160118, 0.03400884568691254,
             0.010212776251137257, 0.0446053147315979],
            [0.02797470986843109, 0.08744558691978455,
             0.00045939622214064, -0.07015188783407211],
            [0.06875955313444138, 0.029296398162841797,
             -0.09123362600803375, -0.0226089246571064]]
BERT_BF16 = [[-0.020173830911517143, 0.03458371013402939,
              0.009523050859570503, 0.044607974588871],
             [0.02767583355307579, 0.08771110326051712,
              0.0011043722042813897, -0.06982825696468353],
             [0.06852445006370544, 0.029685210436582565,
              -0.0910172089934349, -0.022361986339092255]]


def test_the_bert_encoder_is_unchanged():
    enc = SentenceEncoder(EncoderConfig(dtype="float32", attention="stock"),
                          device="cpu", seed=0)
    assert enc.master is not None and enc.cfg.arch == "bert"
    np.testing.assert_allclose(enc.encode(BERT_TEXTS)[:, :4], BERT_F32,
                               rtol=0, atol=1e-6)
    enc = SentenceEncoder(EncoderConfig(), device="cpu", seed=0)
    np.testing.assert_allclose(enc.encode_device(BERT_TEXTS)[:, :4].numpy(),
                               BERT_BF16, rtol=0, atol=1e-6)
    assert lfm2_moe.MOE_PAIRS >= 0


BUILD_BERT = dict(vocab_size=500, hidden_dim=32, num_layers=2, num_heads=4,
                  mlp_dim=64, max_len=64)


def _build_cfg(family):
    if family == "lfm2":
        return LFM2MoEConfig(**dict(TINY, dtype="bfloat16"))
    return EncoderConfig(**BUILD_BERT, dtype=family)


def _build_state_dict(cfg):
    """Seeded weights in the shapes of ``cfg``'s model: float32 on the CPU
    for BERT (the device the masters live on, so a master that shared them
    would show), ``cfg.dtype`` for LFM2-MoE."""
    model_cls = (lfm2_moe.LFM2MoEModel if isinstance(cfg, LFM2MoEConfig)
                 else SentenceTransformerModel)
    shapes = encoder_mod.on_meta(model_cls, cfg).state_dict()
    dtype = (getattr(torch, cfg.dtype) if isinstance(cfg, LFM2MoEConfig)
             else torch.float32)
    g = torch.Generator().manual_seed(11)
    return {k: torch.randn(v.shape, generator=g).to(dtype)
            for k, v in shapes.items()}


def _earlier_build(cfg, seed, state_dict):
    """The serving module and masters as the encoder built them before it
    built each module once: BERT on the host with torch's default init,
    then the seeded init or ``load_state_dict``'s copy, moved to float32
    and deep-copied into ``cfg.dtype``; LFM2-MoE seeded or loaded in
    float32 on the CPU and cast."""
    dtype = getattr(torch, cfg.dtype)
    torch.manual_seed(0)  # the default init draws from the global stream
    if isinstance(cfg, LFM2MoEConfig):
        model = lfm2_moe.LFM2MoEModel(cfg)
        if state_dict is None:
            model.reset_parameters(torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(state_dict)
        return model.to(dtype).eval(), None
    master = SentenceTransformerModel(cfg)
    if state_dict is None:
        master.reset_parameters(torch.Generator().manual_seed(seed))
    else:
        master.load_state_dict(state_dict)
    master = master.to(torch.float32).eval()
    return (master if dtype == torch.float32
            else copy.deepcopy(master).to(dtype)), master


def test_the_build_imports_no_dynamo():
    """Building either family on the meta device skips the default init,
    whose meta kernels would import ``torch._dynamo``: seconds of every
    run's set-up."""
    code = ("import sys, torch\n"
            "from semanticsearch_tpu_torch.core.config import (\n"
            "    EncoderConfig, LFM2MoEConfig)\n"
            "from semanticsearch_tpu_torch.models.encoder import "
            "SentenceEncoder\n"
            f"cfg = LFM2MoEConfig(**{TINY!r})\n"
            "sd = SentenceEncoder(cfg, device='cpu').model.state_dict()\n"
            "SentenceEncoder(cfg, device='cpu', state_dict=sd)\n"
            "SentenceEncoder(EncoderConfig(), device='cpu', state_dict={\n"
            "    k: v.float() for k, v in SentenceEncoder(\n"
            "        EncoderConfig(), device='cpu').model.state_dict()"
            ".items()})\n"
            "print('torch._dynamo' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False"]


def _storages(module):
    return {p.untyped_storage().data_ptr() for p in module.parameters()}


@pytest.mark.parametrize("weights", ["seed", "state_dict"])
@pytest.mark.parametrize("family", ["float32", "bfloat16", "lfm2"])
def test_encoder_builds_once(family, weights):
    """Each family builds its modules once, on the meta device: the serving
    weights (and BERT's float32 masters) equal the earlier build's bit for
    bit, BERT's masters own their storage apart from the caller's state
    dict, LFM2-MoE takes the state dict's bf16 tensors themselves, and an
    encode of packed texts is bit-equal to the earlier build's."""
    cfg = _build_cfg(family)
    sd = None if weights == "seed" else _build_state_dict(cfg)
    enc = SentenceEncoder(cfg, device="cpu", seed=5, state_dict=sd)
    want_model, want_master = _earlier_build(cfg, 5, sd)
    got, want = enc.model.state_dict(), want_model.state_dict()
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
    assert not enc.model.training
    if want_master is None:
        assert enc.master is None
        if sd is not None:  # no copy
            assert all(got[k].data_ptr() == sd[k].data_ptr() for k in sd)
    else:
        for k, v in want_master.state_dict().items():
            assert torch.equal(enc.master.state_dict()[k], v)
        assert {p.dtype for p in enc.master.parameters()} == {torch.float32}
        assert (enc.model is enc.master) == (family == "float32")
        if sd is not None:
            assert not _storages(enc.master) & {
                v.untyped_storage().data_ptr() for v in sd.values()}
        if enc.model is not enc.master:
            assert not _storages(enc.master) & _storages(enc.model)
    before = encoder_mod.PACKED_FORWARDS
    emb = enc.encode(TEXTS)
    assert encoder_mod.PACKED_FORWARDS == before + 1
    enc.model = want_model
    np.testing.assert_array_equal(enc.encode(TEXTS), emb)


def _inline_conv(bcx, weight, pos):
    """``ShortConv``'s elementwise chain as the forward held it inline, kept
    here as the record its plain version is held to."""
    back = [(pos >= j).float()[:, None] for j in range(1, weight.shape[-1])]
    b, c, xx = bcx.chunk(3, dim=-1)
    u = (b * xx).float()
    w = weight[:, 0, :].float()  # (hidden, taps), last = now
    taps = w.shape[1]
    v = u * w[:, taps - 1]
    for j, keep in enumerate(back, start=1):
        prev = torch.nn.functional.pad(u[:-j], (0, 0, j, 0)) * keep
        v = v + prev * w[:, taps - 1 - j]
    return c * v.to(c.dtype)


def _bits(x):
    return x.view({2: torch.int16, 4: torch.int32}[x.element_size()])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("taps", [2, 3, 4])
@pytest.mark.parametrize("h", [8, 13])
def test_gated_short_conv_on_the_cpu_is_the_inline_chain(dtype, taps, h):
    """On CPU tensors the wrapper runs the plain version, launches nothing,
    and gives the bits of the chain the forward held inline, on packed
    texts of 1-70 tokens (1, 2 and 3 among them)."""
    from semanticsearch_tpu_torch.ops import short_conv as sc

    rng = np.random.default_rng(taps * 100 + h)
    lens = np.concatenate([[1, 2, 3, 1], rng.integers(1, 71, 9), [1]])
    pos = fa.varlen_layout(lens).pos
    g = torch.Generator().manual_seed(h)
    bcx = torch.randn(int(lens.sum()), 3 * h, generator=g).to(dtype)
    bcx[::7, :h] = 0.0
    bcx[3::11, 2 * h:] = -0.0
    weight = torch.randn(h, 1, taps, generator=g).to(dtype)
    before = sc.SHORT_CONV_LAUNCHES
    got = sc.gated_short_conv(bcx, weight, pos)
    assert sc.SHORT_CONV_LAUNCHES == before
    assert got.dtype == dtype and got.shape == (bcx.shape[0], h)
    assert torch.equal(_bits(got), _bits(sc.gated_short_conv_plain(
        bcx, weight, pos)))
    assert torch.equal(_bits(got), _bits(_inline_conv(bcx, weight, pos)))


def test_gated_short_conv_plain_stays_inside_each_text():
    """Each packed token's output is its own text's taps alone (float64,
    one token at a time; the plain version sums in float32), however few
    tokens the batch holds."""
    from semanticsearch_tpu_torch.ops import short_conv as sc

    h, taps = 6, 3
    g = torch.Generator().manual_seed(9)
    weight = torch.randn(h, 1, taps, generator=g)
    for lens in ([1], [2], [1, 1], [5, 1, 3]):
        layout = fa.varlen_layout(lens)
        bcx = torch.randn(sum(lens), 3 * h, generator=g)
        got = sc.gated_short_conv(bcx, weight, layout.pos).double()
        b, c, x = bcx.double().chunk(3, dim=-1)
        u, w = b * x, weight[:, 0].double()
        for t, p in enumerate(layout.pos.tolist()):
            v = sum(w[:, taps - 1 - j] * u[t - j]
                    for j in range(taps) if p >= j)
            torch.testing.assert_close(got[t], c[t] * v, rtol=1e-5,
                                       atol=1e-6)


def test_short_conv_vector_width():
    """The kernel's channels a thread: 16 bytes' worth where the width and
    the base address allow, halves down to one where they do not (rows of
    3h elements then keep every vector aligned)."""
    from semanticsearch_tpu_torch.ops import short_conv as sc

    assert sc.short_conv_vec(2048, 2, 0) == 8
    assert sc.short_conv_vec(2048, 4, 0) == 4
    assert sc.short_conv_vec(100, 2, 0) == 4
    assert sc.short_conv_vec(1003, 2, 0) == 1
    assert sc.short_conv_vec(1003, 4, 16) == 1
    assert sc.short_conv_vec(2048, 2, 2) == 1
    assert sc.short_conv_vec(2048, 2, 4) == 2
    assert sc.short_conv_vec(2050, 4, 0) == 2


def _inline_norm(x, weight, eps):
    """``RMSNorm.forward`` as the model held it inline, kept here as the
    record its plain version is held to."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return y.to(x.dtype) * weight


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("h", [64, 2048, 13])
@pytest.mark.parametrize("add", [True, False])
def test_rms_norm_on_the_cpu_is_the_inline_chain(dtype, h, add):
    """On CPU tensors the wrappers run the plain chain, launch nothing, and
    give the bits of the add and norm the forward held inline, over rows of
    (tokens, heads, h) as the q/k norms see them and (tokens, h)."""
    from semanticsearch_tpu_torch.ops import rms_norm as rn

    g = torch.Generator().manual_seed(h)
    shape = (37, 3, h) if h == 64 else (37, h)
    x = (torch.randn(shape, generator=g) * 3.0).to(dtype)
    d = torch.randn(shape, generator=g).to(dtype)
    x[5] = 0.0  # a row of zeros: eps alone under the root
    w = (1.0 + 0.2 * torch.randn(h, generator=g)).to(dtype)
    eps = 1e-5
    before = rn.RMS_NORM_LAUNCHES
    if add:
        s, out = rn.add_rms_norm(x, d, w, eps)
        ps, pout = rn.add_rms_norm_plain(x, d, w, eps)
        want_s = x + d
        assert torch.equal(_bits(s), _bits(want_s))
        assert torch.equal(_bits(ps), _bits(want_s))
    else:
        out, pout, want_s = rn.rms_norm(x, w, eps), rn.rms_norm_plain(
            x, w, eps), x
    assert rn.RMS_NORM_LAUNCHES == before
    assert out.dtype == dtype and out.shape == shape
    want = _inline_norm(want_s, w, eps)
    assert torch.equal(_bits(out), _bits(want))
    assert torch.equal(_bits(pout), _bits(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_rms_norm_agrees_tells_a_shifted_statistic_from_a_wrong_output(
        dtype):
    """The card's check of the kernel against the plain chain: the plain
    output agrees whole; each row's 1/rms a float32 unit in the last place
    off passes within two units and fails within none in float32; a
    normalized value two units in the last place off, a weight left out
    or taken from another norm fail."""
    from semanticsearch_tpu_torch.ops import rms_norm as rn

    g = torch.Generator().manual_seed(31)
    s = (torch.randn((64, 256), generator=g) * 3.0).to(dtype)
    w = (1.0 + 0.2 * torch.randn(256, generator=g)).to(dtype)
    other = (1.0 + 0.2 * torch.randn(256, generator=g)).to(dtype)
    eps = 1e-5
    assert rn.rms_norm_agrees(rn.rms_norm_plain(s, w, eps), s, w, eps) == (
        True, True, 1.0)
    sf = s.float()
    r = torch.rsqrt(sf.pow(2).mean(-1, keepdim=True) + eps)
    r = torch.nextafter(r, torch.full_like(r, float("inf")))
    shifted = (sf * r).to(dtype) * w
    rows, near, same = rn.rms_norm_agrees(shifted, s, w, eps)
    assert rows
    if dtype == torch.float32:  # the shift reaches most elements
        assert not rn.rms_norm_agrees(shifted, s, w, eps, shifts=0)[0]
    else:  # and few of a 16-bit dtype's
        assert near and same > 0.9
    y = _bits((sf * torch.rsqrt(sf.pow(2).mean(-1, keepdim=True) + eps))
              .to(dtype))
    y[3, 7] += 2
    rows, near, _ = rn.rms_norm_agrees(y.view(dtype) * w, s, w, eps)
    assert not rows and not near
    for wrong in (torch.ones_like(w), other):
        rows, near, same = rn.rms_norm_agrees(rn.rms_norm_plain(s, wrong, eps),
                                              s, w, eps)
        assert not rows and not near and same < 0.5


def _parent_forward(model, ids, layout):
    """``LFM2MoEModel.forward`` in the block order it had before its adds
    and norms were fused: every norm the inline chain, every residual add
    its own, the final norm after the last layer."""
    def norm(mod, x):
        return _inline_norm(x, mod.weight, mod.eps)

    x = model.embed(ids)
    packed = model._packed(layout, x.dtype)
    for b in model.layers:
        h = norm(b.op_norm, x)
        if b.is_conv:
            x = x + b.conv(h, packed)
        else:
            a, dh = b.attn, b.attn.head_dim
            q = norm(a.q_norm, a.q_proj(h).unflatten(-1, (a.heads, dh)))
            k = norm(a.k_norm, a.k_proj(h).unflatten(-1, (a.kv_heads, dh)))
            v = a.v_proj(h).unflatten(-1, (a.kv_heads, dh))
            q, k = (lfm2_moe._rope(t, packed.cos, packed.sin) for t in (q, k))
            o = fa.flash_attention_varlen(q, k, v, layout, causal=True)
            x = x + a.out_proj(o.flatten(1))
        x = x + b.ffn(norm(b.ffn_norm, x))
    x = norm(model.norm, x)
    last = (layout.cu_seqlens[1:] - 1).long()
    return encoder_mod.l2_head(model.cfg, x.index_select(0, last).float())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_norms_keep_the_parents_block_order(dtype):
    """The forward with each residual add and the norm after it as one call
    (the next layer's ``op_norm``, the final norm last) gives the bits of
    the block order it replaced, each norm with a weight of its own, and
    launches no kernel on the CPU."""
    from semanticsearch_tpu_torch.ops import rms_norm as rn

    enc = _encoder(dtype=dtype)
    _norm_weights(enc, 12)
    lens = np.asarray([len(_ids(enc, t)) for t in TEXTS])
    layout = fa.varlen_layout(lens)
    ids = torch.from_numpy(np.concatenate(
        [_ids(enc, t) for t in TEXTS])).long()
    before = rn.RMS_NORM_LAUNCHES
    with torch.no_grad():
        got = enc.model(ids, layout)
        want = _parent_forward(enc.model, ids, layout)
    assert rn.RMS_NORM_LAUNCHES == before
    assert got.shape == (len(TEXTS), TINY["hidden_dim"])
    assert torch.equal(got, want)


def test_rms_norm_plan():
    """The kernel's vector, lanes a row and vectors a lane: 16 bytes' worth
    where the width and every address allow, halves down to one where they
    do not; the fewest lanes that leave a lane one vector, else 32 lanes
    and 8 vectors each (those past the row's end left out), past which the
    loop path (0) takes the row."""
    from semanticsearch_tpu_torch.ops import rms_norm as rn

    assert rn.rms_norm_plan(2048, 2, [0, 4096]) == (8, 32, 8)  # hidden
    assert rn.rms_norm_plan(64, 2, [0]) == (8, 8, 1)  # a head
    assert rn.rms_norm_plan(64, 4, [0]) == (4, 16, 1)
    assert rn.rms_norm_plan(2048, 4, [0]) == (4, 32, 0)
    assert rn.rms_norm_plan(4096, 2, [0]) == (8, 32, 0)
    assert rn.rms_norm_plan(384, 2, [0]) == (8, 32, 8)
    assert rn.rms_norm_plan(264, 2, [0]) == (8, 32, 8)
    assert rn.rms_norm_plan(100, 2, [0]) == (4, 32, 1)
    assert rn.rms_norm_plan(13, 2, [0]) == (1, 16, 1)
    assert rn.rms_norm_plan(1, 4, [0]) == (1, 1, 1)
    assert rn.rms_norm_plan(1003, 2, [0]) == (1, 32, 0)
    assert rn.rms_norm_plan(2048, 2, [0, 2]) == (1, 32, 0)
    assert rn.rms_norm_plan(2048, 2, [0, 4]) == (2, 32, 0)
    assert rn.rms_norm_plan(1024, 2, [8, 16]) == (4, 32, 8)
    assert rn.rms_norm_plan(2050, 4, [0]) == (2, 32, 0)
