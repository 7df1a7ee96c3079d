"""Namespaced loggers under one ``semsearch`` root, configured once."""
from __future__ import annotations

import logging

_NAMESPACE = "semsearch"
_configured = False


def _ensure_configured() -> None:
    global _configured
    if _configured:
        return
    logger = logging.getLogger(_NAMESPACE)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
        )
        logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    _configured = True


def get_logger(channel: str = "core") -> logging.Logger:
    _ensure_configured()
    return logging.getLogger(f"{_NAMESPACE}.{channel}")
