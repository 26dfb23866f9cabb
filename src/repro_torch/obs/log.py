"""Structured stderr logging with stable ``key=value`` context prefixes.

Multi-process runs interleave server and worker stderr; a bare line is
unattributable.  ``get_logger("worker", client=3)`` returns an adapter
that prefixes every line with ``[worker client=3]``; ``bind(round=12)``
derives a child with extra context, so the worker loop can rebind the
round number once per round and every subsequent line carries it.
"""
from __future__ import annotations

import logging
import sys
from typing import Any, Dict

_FORMAT = "%(asctime)s %(levelname).1s %(message)s"
_configured = False


def _ensure_handler() -> None:
    global _configured
    if _configured:
        return
    root = logging.getLogger("repro_torch")
    if not root.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        root.addHandler(h)
        root.setLevel(logging.INFO)
        root.propagate = False
    _configured = True


class ContextLogger(logging.LoggerAdapter):
    """LoggerAdapter whose extra dict renders as a ``[k=v ...]`` prefix."""

    def process(self, msg, kwargs):
        ctx = " ".join(f"{k}={v}" for k, v in self.extra.items()
                       if v is not None)
        return (f"[{ctx}] {msg}" if ctx else msg), kwargs

    def bind(self, **context: Any) -> "ContextLogger":
        merged: Dict[str, Any] = dict(self.extra)
        merged.update(context)
        return ContextLogger(self.logger, merged)


def get_logger(name: str, **context: Any) -> ContextLogger:
    """Structured logger under the ``repro_torch`` namespace with bound context."""
    _ensure_handler()
    return ContextLogger(logging.getLogger(f"repro_torch.{name}"), dict(context))
