"""The port's rule-based OIE extractor and OpenIE5 client against the JAX
package's.

The heuristic extractor gives the JAX package's triples, triple for triple
and in order, over the hand-labeled gold set
(``tests/fixtures/oie_gold.jsonl``) and over seeded text built to reach its
rules (auxiliary chains, particles, relative clauses, pronoun subjects,
lead trims, the 12-token subject and 20-token object caps). The client's
conversion and formatting are equal, extraction degrades to [] without a
server, the port-kill helpers act as the JAX package's tests require, and
``enrich_chunk_tsv(extractor="heuristic")`` writes byte-equal TSVs and
sidecars."""
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest

from semanticsearch_tpu.oie import client as jc
from semanticsearch_tpu.oie import heuristic as jh
from semanticsearch_tpu_torch.data.tsv import write_tsv
from semanticsearch_tpu_torch.oie import client as tc
from semanticsearch_tpu_torch.oie import heuristic as th

_GOLD = os.path.join(os.path.dirname(__file__), "fixtures", "oie_gold.jsonl")

_SUBJ = ["The committee", "Solar panels", "It", "They", "The old mayor of "
         "the small northern river town near the coast with many boats",
         "However the board", "Yesterday the farmers", "Bees", "There",
         "The analysis", "The united species"]
_VERB = ["approved", "was reduced", "has been building", "will not sign",
         "carried", "is", "runs", "convert", "visited", "found", "walking",
         "trains", "must have been", "organized", "thinks"]
_TAIL = ["the new budget on Tuesday", "into electricity", "up the hill",
         "with the engineers", "the bridge", "out", "to the Roman city "
         "with water and stone and timber and rope and iron and salt and "
         "grain and wine and oil for the long winter season ahead of them",
         "honey in the hive", "", "about the series of famous viruses"]


def _seeded_texts(seed, n=40):
    rng = np.random.default_rng(seed)
    texts = []
    for _ in range(n):
        sents = []
        for _ in range(int(rng.integers(1, 4))):
            s = f"{rng.choice(_SUBJ)} {rng.choice(_VERB)} {rng.choice(_TAIL)}"
            r = rng.random()
            if r < 0.3:  # a relative clause
                s = (f"{rng.choice(_SUBJ)}, {rng.choice(['which', 'who', 'that'])}"
                     f" {rng.choice(_VERB)} {rng.choice(_TAIL)}, "
                     f"{rng.choice(_VERB)} {rng.choice(_TAIL)}")
            elif r < 0.4:
                s = s + ", which " + str(rng.choice(_VERB))
            sents.append(s.strip() + ".")
        texts.append(" ".join(sents))
    return texts + ["", "   ", "word", "IBM acquired the startup. IBM "
                    "acquired the startup."]


def _gold_texts():
    with open(_GOLD) as f:
        return [json.loads(line)["text"] for line in f]


def test_heuristic_triples_equal_jax_on_gold():
    texts = _gold_texts()
    assert len(texts) > 100
    got = [th.extract_triples_heuristic(t) for t in texts]
    assert got == [jh.extract_triples_heuristic(t) for t in texts]
    assert sum(map(len, got)) > 80


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_heuristic_triples_equal_jax_seeded(seed):
    texts = _seeded_texts(seed)
    got = [th.extract_triples_heuristic(t) for t in texts]
    assert got == [jh.extract_triples_heuristic(t) for t in texts]
    assert sum(map(len, got)) > 10
    for text in texts:
        words = th._tokens(text)
        assert th._clause_spans(words) == jh._clause_spans(words)
        assert th._find_verb_group(words) == jh._find_verb_group(words)


def test_convert_and_format_equal():
    blobs = [
        {"extraction": {"arg1": {"text": " Barack Obama "},
                        "rel": {"text": "was born in"},
                        "arg2s": [{"text": "Hawaii"}, {"text": " 1961 "}]}},
        {"arg1": {"text": "A"}, "rel": {"text": "likes"}},
        {"extraction": {}},
        {"extraction": {"arg1": {"text": ""}, "rel": {"text": "r"}}},
        {"extraction": {"arg1": {"text": "s"}, "rel": None}},
        {"extraction": {"arg1": {"text": "s"}, "rel": {"text": "r"},
                        "arg2s": [{"nope": 1}]}},
    ]
    got = [tc._convert_extraction(b) for b in blobs]
    assert got == [jc._convert_extraction(b) for b in blobs]
    assert got[0] == {"subject": "Barack Obama", "relation": "was born in",
                      "object": "Hawaii 1961"}
    triples = [t for t in got if t] + [
        {"subject": "C", "relation": "is", "object": ""},
        {"subject": "", "relation": "", "object": ""},
        {"subject": "D", "relation": "ends", "object": "here..."}]
    assert tc.format_oie_triples_to_string(triples) == \
        jc.format_oie_triples_to_string(triples)
    assert tc.format_oie_triples_to_string([]) == ""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_extraction_degrades_without_server():
    port = _free_port()
    assert not tc.is_port_open(port)
    assert tc.extract_relations_from_paragraph("some text", port=port) == []
    assert tc.extract_relations_from_paragraph("  ", port=port) == []
    # no jar configured: nothing is launched
    assert tc.start_openie_server(jar_path="/nonexistent.jar",
                                  port=port) is None


def test_kill_processes_on_port():
    """A process listening on the target port is terminated."""
    port = _free_port()
    squatter = subprocess.Popen([
        sys.executable, "-c",
        f"import socket,time;s=socket.socket();"
        f"s.bind(('127.0.0.1',{port}));s.listen();time.sleep(60)",
    ])
    try:
        deadline = time.time() + 10
        while not tc.is_port_open(port) and time.time() < deadline:
            time.sleep(0.1)
        assert tc.is_port_open(port)
        assert tc.kill_processes_on_port(port) >= 1
        deadline = time.time() + 5
        while tc.is_port_open(port) and time.time() < deadline:
            time.sleep(0.1)
        assert not tc.is_port_open(port)
        squatter.wait(timeout=5)
        assert squatter.poll() is not None
        assert tc.kill_processes_on_port(port) == 0
    finally:
        if squatter.poll() is None:
            squatter.kill()


def test_terminate_openie_processes():
    """Processes whose executable is java and whose command line mentions
    an openie jar are terminated; others survive."""
    d = tempfile.mkdtemp()
    java = os.path.join(d, "java")
    os.symlink(sys.executable, java)
    fake = subprocess.Popen(
        [java, "-c", "import time; time.sleep(60)", "openie-assembly-5.0.jar"])
    bystander = subprocess.Popen(
        [sys.executable, "-c", "import time; time.sleep(20)", "openie"])
    try:
        time.sleep(0.5)
        assert tc.terminate_openie_processes() >= 1
        fake.wait(timeout=5)
        assert fake.poll() is not None
        assert bystander.poll() is None
    finally:
        for p in (fake, bystander):
            if p.poll() is None:
                p.kill()
                p.wait(timeout=5)
        os.unlink(java)
        os.rmdir(d)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_enrich_heuristic_byte_equal(tmp_path):
    texts = _gold_texts()[:30] + _seeded_texts(5, n=20)
    rows = [{"chunk_id": f"c{i}", "query_id": f"q{i % 3}", "chunk_text": t}
            for i, t in enumerate(texts)]
    src = tmp_path / "chunks.tsv"
    write_tsv(str(src), rows, ["chunk_id", "query_id", "chunk_text"])
    for name, mod in (("j", jc), ("t", tc)):
        n = mod.enrich_chunk_tsv(str(src), str(tmp_path / f"{name}.tsv"),
                                 extractor="heuristic",
                                 json_sidecar=str(tmp_path / f"{name}.json"))
        assert n == len(rows)
    assert _read(tmp_path / "t.tsv") == _read(tmp_path / "j.tsv")
    assert _read(tmp_path / "t.json") == _read(tmp_path / "j.json")
    # "auto" with no server resolves to the heuristic
    port = _free_port()
    tc.enrich_chunk_tsv(str(src), str(tmp_path / "auto.tsv"), port=port)
    assert _read(tmp_path / "auto.tsv") == _read(tmp_path / "j.tsv")
    # the server extractor degrades to empty columns, as the JAX one does
    for name, mod in (("js", jc), ("ts", tc)):
        mod.enrich_chunk_tsv(str(src), str(tmp_path / f"{name}.tsv"),
                             extractor="server", port=port)
    assert _read(tmp_path / "ts.tsv") == _read(tmp_path / "js.tsv")
    # an empty input writes nothing
    empty = tmp_path / "empty.tsv"
    empty.write_text("")
    assert tc.enrich_chunk_tsv(str(empty), str(tmp_path / "e.tsv"),
                               extractor="heuristic") == 0


def test_enrich_refuses_bad_arguments(tmp_path):
    src = tmp_path / "chunks.tsv"
    write_tsv(str(src), [{"chunk_id": "c", "chunk_text": "A b c."}],
              ["chunk_id", "chunk_text"])
    out = str(tmp_path / "o.tsv")
    with pytest.raises(ValueError, match="on_low_agreement"):
        tc.enrich_chunk_tsv(str(src), out, on_low_agreement="ignore")
    with pytest.raises(ValueError, match="would ignore it"):
        tc.enrich_chunk_tsv(str(src), out, extractor="heuristic",
                            model_dir=str(tmp_path))
    with pytest.raises(ValueError, match="model_dir"):
        tc.enrich_chunk_tsv(str(src), out, extractor="neural")
