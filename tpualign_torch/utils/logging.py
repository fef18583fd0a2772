"""Structured logging honoring LOG_LEVEL, under the ``tpualign_torch``
logger tree (the port's copy of ``tpualign.utils.logging``)."""

from __future__ import annotations

import logging
import os
import sys

_ROOT = "tpualign_torch"
_CONFIGURED = False


def configure(level: str | None = None) -> None:
    global _CONFIGURED
    if _CONFIGURED:
        return
    level = level or os.environ.get("LOG_LEVEL", "INFO")
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(levelname)-7s %(name)s: %(message)s", "%H:%M:%S")
    )
    root = logging.getLogger(_ROOT)
    root.setLevel(getattr(logging, str(level).upper(), logging.INFO))
    root.addHandler(handler)
    root.propagate = False
    _CONFIGURED = True


def get_logger(name: str) -> logging.Logger:
    configure()
    if not name.startswith(_ROOT):
        name = f"{_ROOT}.{name}"
    return logging.getLogger(name)
