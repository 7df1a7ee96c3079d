"""Open Information Extraction enrichment client (optional sidecar).

The port's own copy of ``semanticsearch_tpu/oie/client.py``. Its one piece
of device work is the neural extractor's batched tagging
(``oie/neural.py``), which runs on ``device``; the rest is host code.

Rebuild of ``Tool/OIE.py`` / ``Tool/OIE_ubuntu.py``: the reference launches an
OpenIE5 standalone Java server (8-16GB JVM heap) and converts its extractions
into ``{subject, relation, object}`` triples over HTTP. This module keeps the
same triple contract as a thin sidecar-service client (plus the in-repo
fallbacks: the rule-based extractor in ``oie/heuristic.py`` and the
device-batched neural tagger in ``oie/neural.py``):

- ``extract_relations_from_paragraph(text, port)`` with per-call timeout and
  exact-duplicate filtering (reference ``OIE.py:200-260``),
- server lifecycle helpers gated on a configured jar path
  (``OPENIE_JAR_PATH`` / ``OPENIE_XMS_GB`` env vars, ``OIE_ubuntu.py:41-50``),
- TSV batch enrichment adding ``raw_oie_data`` and
  ``raw_oie_data_plus_chunk_text`` columns (``OIE.py:285-390``),
- ``format_oie_triples_to_string`` ("s r o." concatenation,
  ``Method/semantic_common.py:195-208``).
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import time
import urllib.request
from typing import Dict, List, Optional

from ..core.logging import get_logger
from ..data.tsv import read_tsv, write_tsv

logger = get_logger("oie")

DEFAULT_PORT = 9000
EXTRACT_TIMEOUT_S = 8.0  # per-paragraph timeout (OIE_ubuntu.py:212-229)

Triple = Dict[str, str]


def is_port_open(port: int, host: str = "127.0.0.1") -> bool:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.settimeout(0.5)
        return s.connect_ex((host, port)) == 0


def kill_processes_on_port(port: int, timeout_s: float = 5.0) -> int:
    """Terminate (then kill) any process LISTENING on ``port``.

    Server-restart hygiene from the reference (``OIE_ubuntu.py:58-85``): a
    crashed or foreign squatter on the OIE port would otherwise make every
    relaunch silently reuse the wrong server. Returns the number of
    processes terminated; 0 when the port is free or psutil is unavailable.
    """
    try:
        import psutil
    except ImportError:
        return 0
    victims = []
    for proc in psutil.process_iter(["pid"]):
        try:
            # psutil >= 6 renamed connections() -> net_connections()
            conns_fn = getattr(proc, "net_connections", None) or proc.connections
            conns = conns_fn(kind="inet")
        except (psutil.AccessDenied, psutil.NoSuchProcess):
            continue
        for c in conns:
            if c.laddr and c.laddr.port == port and c.status == psutil.CONN_LISTEN:
                victims.append(proc)
                break
    for proc in victims:
        try:
            proc.terminate()
        except psutil.NoSuchProcess:
            pass
    _, alive = psutil.wait_procs(victims, timeout=timeout_s)
    for proc in alive:
        try:
            proc.kill()
        except psutil.NoSuchProcess:
            pass
    if victims:
        logger.info("killed %d process(es) on port %d", len(victims), port)
    return len(victims)


def terminate_openie_processes(timeout_s: float = 5.0) -> int:
    """Terminate every process whose command line references an OpenIE jar
    (reference ``OIE.py:119-156`` / ``OIE_ubuntu.py:96-101``). Returns the
    count terminated."""
    try:
        import psutil
    except ImportError:
        return 0
    victims = []
    me = os.getpid()
    for proc in psutil.process_iter(["pid", "name", "cmdline"]):
        try:
            argv = proc.info.get("cmdline") or []
            name = (proc.info.get("name") or "").lower()
        except (psutil.AccessDenied, psutil.NoSuchProcess):
            continue
        # The EXECUTABLE must be java — matching 'openie' anywhere in the
        # cmdline alone would also kill shells whose command text merely
        # mentions the jar (e.g. the launcher that started it).
        exe_is_java = name == "java" or (
            argv and os.path.basename(argv[0]).lower() == "java"
        )
        cmd = " ".join(argv).lower()
        if proc.pid != me and exe_is_java and "openie" in cmd:
            victims.append(proc)
    for proc in victims:
        try:
            proc.terminate()
        except psutil.NoSuchProcess:
            pass
    _, alive = psutil.wait_procs(victims, timeout=timeout_s)
    for proc in alive:
        try:
            proc.kill()
        except psutil.NoSuchProcess:
            pass
    if victims:
        logger.info("terminated %d OpenIE process(es)", len(victims))
    return len(victims)


def start_openie_server(
    jar_path: Optional[str] = None,
    port: int = DEFAULT_PORT,
    xms_gb: Optional[int] = None,
    wait_s: float = 120.0,
    kill_squatters: bool = False,
) -> Optional[subprocess.Popen]:
    """Launch the OpenIE5 jar if configured; None when unavailable.

    Env contract matches the reference: ``OPENIE_JAR_PATH``, ``OPENIE_XMS_GB``.
    ``kill_squatters`` frees the port first (``OIE_ubuntu.py:58-85``).
    """
    jar_path = jar_path or os.environ.get("OPENIE_JAR_PATH")
    if not jar_path or not os.path.exists(jar_path):
        return None
    if is_port_open(port):
        if not kill_squatters:
            return None  # already serving
        kill_processes_on_port(port)
        if is_port_open(port):
            return None
    xms = int(xms_gb or os.environ.get("OPENIE_XMS_GB", 10))
    cmd = [
        "java", f"-Xms{xms}g", f"-Xmx{max(xms, 16)}g",
        "-jar", jar_path, "--httpPort", str(port),
    ]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL
    )
    deadline = time.time() + wait_s
    while time.time() < deadline:
        if is_port_open(port):
            return proc
        if proc.poll() is not None:
            return None
        time.sleep(2.0)
    proc.terminate()
    return None


def _convert_extraction(blob: Dict) -> Optional[Triple]:
    """OpenIE5 JSON extraction -> {subject, relation, object}."""
    ext = blob.get("extraction", blob)
    try:
        subject = ext["arg1"]["text"].strip()
        relation = ext["rel"]["text"].strip()
        args2 = ext.get("arg2s") or []
        obj = " ".join(a.get("text", "").strip() for a in args2).strip()
    except (KeyError, TypeError, AttributeError):
        return None
    if not subject or not relation:
        return None
    return {"subject": subject, "relation": relation, "object": obj}


def extract_relations_from_paragraph(
    text: str,
    port: int = DEFAULT_PORT,
    timeout_s: float = EXTRACT_TIMEOUT_S,
) -> List[Triple]:
    """Extract triples for one paragraph; [] on any failure (degrade-don't-die)."""
    if not text or not text.strip():
        return []
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/getExtraction",
            data=text.encode("utf-8"),
            headers={"Content-Type": "text/plain"},
        )
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            payload = json.loads(resp.read().decode("utf-8"))
    except Exception as exc:
        logger.debug("OIE extraction failed: %s", exc)
        return []
    triples: List[Triple] = []
    seen = set()
    for blob in payload if isinstance(payload, list) else []:
        triple = _convert_extraction(blob)
        if triple is None:
            continue
        key = (triple["subject"], triple["relation"], triple["object"])
        if key in seen:  # exact-duplicate filter (OIE.py:251-260)
            continue
        seen.add(key)
        triples.append(triple)
    return triples


def format_oie_triples_to_string(triples: List[Triple]) -> str:
    """Concatenate triples as "subject relation object." sentences."""
    parts = []
    for t in triples:
        sent = " ".join(x for x in (t["subject"], t["relation"], t["object"]) if x)
        if sent:
            parts.append(sent.rstrip(".") + ".")
    return " ".join(parts)


def enrich_chunk_tsv(
    input_path: str,
    output_path: str,
    port: int = DEFAULT_PORT,
    text_column: str = "chunk_text",
    json_sidecar: Optional[str] = None,
    extractor: str = "auto",
    model_dir: Optional[str] = None,
    batch_size: int = 256,
    self_check: float = 0.5,
    on_low_agreement: str = "warn",
    device="cuda",
) -> int:
    """Add raw_oie_data + raw_oie_data_plus_chunk_text columns to a chunk TSV.

    ``extractor``: "server" uses the OpenIE5 sidecar (reference behavior —
    empty triples when it is down); "heuristic" uses the in-repo rule-based
    SVO extractor (``oie/heuristic.py`` — functional with zero external
    dependencies, lower extraction quality than OpenIE5); "neural" uses a
    trained device-batched BIO tagger (``oie/neural.py``, requires
    ``model_dir`` — every ``batch_size`` rows become ONE batched forward
    on ``device`` instead of a per-paragraph call); "auto" (default) picks
    the server when its port answers, else the heuristic.

    ``self_check`` (neural only): teacher-agreement floor. The tagger does
    NOT transfer across domains (cross-domain gold F1 0.171 vs in-domain
    0.933 — BASELINE.md), so before enriching, a sample of the input is
    scored against the heuristic teacher (``NeuralOIE.teacher_agreement``);
    below the floor the in-domain contract is considered violated.
    ``on_low_agreement``: "warn" (default — enrich anyway, loudly),
    "fallback" (switch the run to the heuristic engine: degrades to the
    F1-0.953 teacher instead of producing near-empty triples), or "error"
    (raise). 0 disables the check.
    """
    sidecar: List[Dict] = []
    if on_low_agreement not in ("warn", "fallback", "error"):
        raise ValueError(
            f"on_low_agreement must be warn|fallback|error, "
            f"got {on_low_agreement!r}")
    if extractor == "auto":
        # a provided model checkpoint is an explicit ask for the tagger —
        # resolving past it would silently enrich with the wrong engine
        if model_dir:
            extractor = "neural"
        else:
            extractor = "server" if is_port_open(port) else "heuristic"
        logger.info("OIE extractor resolved to %r", extractor)
    elif extractor != "neural" and model_dir:
        raise ValueError(
            f"model_dir={model_dir!r} was given but extractor={extractor!r} "
            "would ignore it — pass extractor='neural' (or 'auto')")
    if extractor == "neural":
        if not model_dir:
            raise ValueError(
                "extractor='neural' needs model_dir (a NeuralOIE checkpoint "
                "from `semsearch oie-train` / oie.neural.train_neural_oie)")
        from .neural import NeuralOIE

        neural = NeuralOIE.load(model_dir, device=device)
        if self_check > 0:
            probe = []
            for row in read_tsv(input_path):
                probe.append(row.get(text_column, ""))
                if len(probe) >= 256:
                    break
            rep = neural.teacher_agreement(probe)
            logger.info("neural OIE self-check: %s", rep)
            if (rep["n_teacher_sentences"] > 0
                    and rep["agreement"] < self_check):
                msg = (
                    f"neural OIE teacher-agreement {rep['agreement']:.2f} "
                    f"on {rep['n_teacher_sentences']} sampled sentences is "
                    f"below the {self_check:.2f} floor — the tagger looks "
                    "OFF-DOMAIN for this corpus (cross-domain F1 collapses "
                    "to ~0.17, BASELINE.md). Retrain with `semsearch "
                    "oie-train` on THIS corpus, or pass "
                    "on_low_agreement='fallback' to use the heuristic."
                )
                if on_low_agreement == "error":
                    raise RuntimeError(msg)
                if on_low_agreement == "fallback":
                    logger.warning("%s Falling back to the heuristic "
                                   "engine for this run.", msg)
                    extractor = "heuristic"
                else:
                    logger.warning(msg)

    def extract(text: str) -> List[Triple]:
        if extractor == "heuristic":
            from .heuristic import extract_triples_heuristic

            return extract_triples_heuristic(text)
        return extract_relations_from_paragraph(text, port=port)

    def emit(row: Dict, triples: List[Triple]) -> Dict:
        text = row.get(text_column, "")
        formatted = format_oie_triples_to_string(triples)
        out = dict(row)
        out["raw_oie_data"] = formatted
        out["raw_oie_data_plus_chunk_text"] = (
            (formatted + " " + text).strip() if formatted else text
        )
        if json_sidecar is not None:
            sidecar.append({
                "chunk_id": row.get("chunk_id", ""),
                "triples": triples,
            })
        return out

    def rows():
        if extractor == "neural":
            # device-batched: many rows per forward, not one call per row
            block: List[Dict] = []
            for row in read_tsv(input_path):
                block.append(row)
                if len(block) >= batch_size:
                    for r, t in zip(block, neural.extract(
                            [b.get(text_column, "") for b in block])):
                        yield emit(r, t)
                    block = []
            if block:
                for r, t in zip(block, neural.extract(
                        [b.get(text_column, "") for b in block])):
                    yield emit(r, t)
            return
        for row in read_tsv(input_path):
            yield emit(row, extract(row.get(text_column, "")))

    first = next(read_tsv(input_path), None)
    if first is None:
        return 0
    columns = list(first.keys()) + ["raw_oie_data", "raw_oie_data_plus_chunk_text"]
    n = write_tsv(output_path, rows(), columns)
    if json_sidecar is not None:
        with open(json_sidecar, "w") as f:
            json.dump(sidecar, f, ensure_ascii=False, indent=2)
    return n
