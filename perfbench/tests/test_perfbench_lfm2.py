"""The LLM embedder's cell (``lfm2-8b-a1b-bf16.mine_b256``, kind
``search_lfm2``) at a small size on the CPU, through ``tiny.py``'s root:
the configuration cut further to four narrow layers (two attention, one
dense, eight experts, two a token) so that every kind of layer runs; sound
runs pass, the fp8 control fails, and a run whose path is broken
underneath fails, a planted wrong choice of experts by ``route_gap`` and
a router that ignores the expert bias by ``route_flips``; the MoE layer's
roofline reader on a synthetic trace."""
import json

import pytest
import torch

from perfbench import control, spans
from perfbench.harness import Benchmark
from perfbench.tests import tiny
from perfbench.trace import Summary

CELL = "lfm2-8b-a1b-bf16.mine_b256"
LAYERS = dict(num_hidden_layers=4, num_key_value_heads=2,
              layer_types=["conv", "full_attention", "conv",
                           "full_attention"],
              num_dense_layers=1, num_experts=8, num_experts_per_tok=2,
              moe_intermediate_size=48)
# at this width (32) bf16 reads far coarser than at 2,048: the program's
# readings here were emb_gap 0.018-0.024, route_gap 0.0-0.014 and
# route_flips 0.009-0.016, the fp8 control's 0.24-0.34, 0.15-0.26 and
# 0.11-0.13, a router that ignores the expert bias route_flips 0.037-0.064
# (three and two seeds), so the cell's own limits are not for this size
LIMITS = {"emb_gap": 0.1, "topk_gap": 5e-05, "route_gap": 0.05,
          "route_flips": 0.025}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny.make_root(tmp_path_factory.mktemp("bench"))
    path = root / "perfbench" / "configs" / "lfm2-8b-a1b-bf16.json"
    cfg = json.loads(path.read_text())
    cfg.update(LAYERS)
    cfg["index"]["corpus_block_rows"] = 1500  # four blocks of the corpus
    path.write_text(json.dumps(cfg))
    (root / "perfbench" / "limits" / f"{CELL}.json").write_text(
        json.dumps(LIMITS))
    return root


@pytest.mark.parametrize("trace", [0, 1])
def test_sound_runs_pass(root, trace, capsys):
    rc, line = tiny.run_cell(root, CELL, seed=2 ** 33 + 9, trace=trace,
                             seconds=3.0, capsys=capsys)
    assert rc == 0 and line["correct"], line
    assert set(line["checks"]) == {"emb_gap", "topk_gap", "route_gap",
                                   "route_flips"}
    assert line["failed"] == 0 and line["attempted"] > 0
    if not trace:
        assert set(line["metrics"]) == {"setup_s", "search_qps",
                                        "search_p95_ms"}
    elif "window_s" in line["device"]:  # a batch was traced (a loaded
        # machine may end the window first): the packed forward pads nothing
        assert line["metrics"]["encoder_padding.search"]["value"] == 0


def test_the_control_fails(root, capsys):
    assert control.main(["--workload", CELL, "--seeds", "1", "2"],
                        device="cpu", root=root) == 0
    for row in capsys.readouterr().out.strip().splitlines():
        assert not json.loads(row)["passes"]


def _answer_altered(monkeypatch):
    from semanticsearch_tpu_torch.index.engine import EmbeddingIndex

    search = EmbeddingIndex.search_device

    def altered(self, q, k=None):
        v, i = search(self, q, k)
        i = i.clone()
        i[:, 0] = (i[:, 0] + 1) % self.size
        return v, i
    monkeypatch.setattr(EmbeddingIndex, "search_device", altered)


def _half_batch_left_out(monkeypatch):
    from semanticsearch_tpu_torch.models.encoder import SentenceEncoder

    encode = SentenceEncoder.encode_device

    def half(self, texts, *a, **kw):
        n = len(texts) // 2
        q = encode(self, list(texts[:n]), *a, **kw)
        return torch.cat([q, q[: len(texts) - n]])
    monkeypatch.setattr(SentenceEncoder, "encode_device", half)


def _worst_expert_chosen(monkeypatch):
    """Each token's last chosen expert swapped for its worst-scoring one:
    the program runs on that choice throughout, so only route_gap sees
    it."""
    from semanticsearch_tpu_torch.models.lfm2_moe import MoE

    route = MoE.route

    def wrong(self, x):
        chosen, _ = route(self, x)
        s = torch.sigmoid(torch.nn.functional.linear(
            x.float(), self.gate.weight.float()))
        worst = torch.argmin(s + self.expert_bias.float(), dim=-1)
        chosen = chosen.clone()
        chosen[:, -1] = worst
        g = s.gather(1, chosen)
        return chosen, g / (g.sum(-1, keepdim=True) + 1e-6)
    monkeypatch.setattr(MoE, "route", wrong)


def _expert_bias_ignored(monkeypatch):
    """The experts chosen by the router's scores alone: only choices
    near a tie move, so only route_flips sees it."""
    from semanticsearch_tpu_torch.models.lfm2_moe import MoE

    def ignored(self, x):
        s = torch.sigmoid(torch.nn.functional.linear(
            x.float(), self.gate.weight.float()))
        _, chosen = torch.topk(s, self.top_k, dim=-1)
        g = s.gather(1, chosen)
        return chosen, g / (g.sum(-1, keepdim=True) + 1e-6)
    monkeypatch.setattr(MoE, "route", ignored)


@pytest.mark.parametrize("fault", [_answer_altered, _half_batch_left_out,
                                   _worst_expert_chosen,
                                   _expert_bias_ignored],
                         ids=lambda f: f.__name__)
def test_a_broken_path_is_not_correct(root, fault, monkeypatch, capsys):
    fault(monkeypatch)
    rc, line = tiny.run_cell(root, CELL, seed=77, capsys=capsys)
    assert rc == 0 and line["correct"] is False, line["checks"]
    if fault is _worst_expert_chosen:
        assert line["checks"]["route_gap"]["value"] > LIMITS["route_gap"]
    if fault is _expert_bias_ignored:
        assert line["checks"]["route_flips"]["value"] > LIMITS[
            "route_flips"]


def test_moe_roofline_reader(monkeypatch):
    cfg = json.loads((tiny.REPO / "perfbench" / "configs" /
                      "lfm2-8b-a1b-bf16.json").read_text())
    read = Benchmark(tiny.REPO).reader("moe_roofline.mine")
    pairs, layers = 48000 * 4 * 22, 22
    monkeypatch.setattr(spans, "window", lambda: {
        "spans": {}, "counters": {"encoder.moe_pairs": pairs,
                                  "encoder.moe_layers": layers}})
    summary = Summary(window_s=1.0, busy_s=0.9, span_device_s={
        "encoder.moe layer=2 tokens=48000": 0.05,
        "encoder.moe layer=3 tokens=48000": 0.05, "encode": 0.5},
        device_ops=[], idle_gaps=[])
    run = {"trace": summary, "config": cfg, "peak": "bf16"}
    ops = 2.0 * pairs * 3 * 2048 * 1792
    nbytes = 2 * (layers * 32 * 3.0 * 2048 * 1792 + 2.0 * pairs * 2048)
    want = 100.0 * max(ops / 989e12, nbytes / 3.35e12) / 0.1
    assert read(run) == pytest.approx(want)
    assert read({"trace": None, "config": cfg, "peak": "bf16"}) is None
    monkeypatch.setattr(spans, "window", lambda: None)
    assert read(run) is None
