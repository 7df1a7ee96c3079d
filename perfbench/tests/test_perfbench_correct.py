"""What decides ``correct``: sound runs of the program pass, the control
(the reference one precision step below the configuration's, in the
program's place) fails, and so does a run whose timed path is broken
underneath, once for each fault a cell can have. All at a small size on
the CPU, through the whole of a run but the look for a card."""
import json

import pytest
import torch

from perfbench import control
from perfbench.tests import tiny

CELLS = tiny.cells()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def _kind(cell):
    return json.loads((tiny.REPO / "perfbench" / "traffic" /
                       f"{cell.split('.', 1)[1]}.json").read_text())["kind"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_pass(root, cell, capsys):
    rc, line = tiny.run_cell(root, cell, seed=2 ** 33 + 5, capsys=capsys)
    assert rc == 0 and line["correct"], line
    assert list(line)[-1] == "checks"
    assert line["failed"] == 0 and line["attempted"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(root, cell, capsys):
    assert control.main(["--workload", cell, "--seeds", "1", "2", "3"],
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


def _state_unchanged(monkeypatch):
    from semanticsearch_tpu_torch.train.optim import Optimizer

    monkeypatch.setattr(Optimizer, "step", lambda self: None)


def _train_half_batch(monkeypatch):
    from semanticsearch_tpu_torch.train.encoder_train import (
        ContrastiveEncoderTrainer)

    loss = ContrastiveEncoderTrainer._loss

    def half(self, params, q_ids, q_mask, c_ids, c_mask, gen):
        b = q_ids.shape[0]
        h = b // 2
        keep = torch.cat([torch.arange(h), b + torch.arange(h)])
        return loss(self, params, q_ids[:h], q_mask[:h], c_ids[keep],
                    c_mask[keep], gen)
    monkeypatch.setattr(ContrastiveEncoderTrainer, "_loss", half)


FAULTS = {"search": [_answer_altered, _half_batch_left_out],
          "train": [_state_unchanged, _train_half_batch]}


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in CELLS for f in FAULTS[_kind(c)]],
    ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_a_broken_path_is_not_correct(root, cell, fault, monkeypatch,
                                      capsys):
    fault(monkeypatch)
    rc, line = tiny.run_cell(root, cell, seed=77, capsys=capsys)
    assert rc == 0 and line["correct"] is False, line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_runs_on_the_card(cell):
    """On the card: one short run of each cell of ``BENCHMARK.json`` at
    its full size."""
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         "5", "--seconds", "3", "--trace", "0"], cwd=tiny.REPO,
        capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
