"""The yardstick's arithmetic against counts made by hand."""
import pytest

from perfbench import flops

CFG = {"hidden_size": 4, "intermediate_size": 8, "num_hidden_layers": 2}


def test_peaks_are_the_published_ones():
    assert flops.PEAKS["bf16"] == 989e12
    assert flops.PEAKS["tf32"] == 495e12  # not a third of it
    assert flops.PEAK_BYTES_PER_S == 3.35e12


def test_encoder_ops_by_hand():
    # a token: 4 projections of 4x4 and two MLP layers of 4x8, as
    # multiply-adds (16 * 4 + 32 * 2 = 128), so 256 operations a layer;
    # attention: 4 n^2 h a sequence
    assert flops.encoder_layer_macs_per_token(4, 8) == 128
    ops = flops.encoder_forward_ops(CFG, [3, 1])
    per_layer = 256 * 4 + 4 * 9 * 4 + 4 * 1 * 4
    assert ops == 2 * per_layer
    assert flops.train_step_ops(CFG, [3, 1]) == 3 * ops


def test_minilm_token():
    cfg = {"hidden_size": 384, "intermediate_size": 1536,
           "num_hidden_layers": 6}
    # 21.2 MFLOP a token in the dense layers, before attention
    assert flops.encoder_forward_ops(cfg, [1]) == 6 * (2 * 1769472 + 4 * 384)


def test_topk_ops_and_bytes():
    ops, nbytes = flops.topk_ops_bytes(q=2, n=10, d=3, k=5,
                                       corpus_itemsize=2)
    assert ops == 2 * 2 * 10 * 3
    assert nbytes == 10 * 3 * 2 + 2 * 3 * 4 + 8 * 2 * 5


@pytest.mark.parametrize("ops,nbytes,peak,by", [
    (989e12, 1.0, "bf16", "operations"),
    (1.0, 3.35e12, "bf16", "bytes"),
    (495e12, 1.0, "tf32", "operations"),
])
def test_bound(ops, nbytes, peak, by):
    t, what = flops.bound_s(ops, nbytes, peak)
    assert t == pytest.approx(1.0) and what == by


def test_bf16_shard_bound():
    # a 16,384-query top-10 over 1.25M x 384 bf16 is bound by its products
    ops, nbytes = flops.topk_ops_bytes(16384, 1_250_000, 384, 10, 2)
    t, by = flops.bound_s(ops, nbytes, "bf16")
    assert by == "operations" and t == pytest.approx(15.9e-3, rel=1e-2)
