"""Minimal structured logger (stdlib logging with a consistent format; port
of ``repro/utils/logging.py``)."""
from __future__ import annotations

import logging
import sys

_FORMAT = "%(asctime)s %(levelname).1s %(name)s :: %(message)s"
_configured = False


def get_logger(name: str) -> logging.Logger:
    """A logger under ``repro_torch``, writing to stderr at INFO."""
    global _configured
    if not _configured:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        root = logging.getLogger("repro_torch")
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False
        _configured = True
    if not name.startswith("repro_torch"):
        name = f"repro_torch.{name}"
    return logging.getLogger(name)
