"""One namespaced ``logging`` setup for the stack's ad-hoc diagnostics.

Everything that used to go through bare ``warnings.warn`` or silenced
``http.server`` handlers now routes through loggers under the ``repro``
namespace (``repro.runstore``, ``repro.service.scheduler``,
``repro.service.access``, ...):

* :func:`get_logger` returns the namespaced logger and lazily installs a
  single stderr handler on the ``repro`` root (once per process, format
  ``repro[pid] LEVEL name: message``), honouring ``REPRO_LOG_LEVEL``
  (default ``WARNING``) — so corrupt-artifact warnings and worker
  respawn notices surface by default, while INFO-level chatter stays
  opt-in;
* the HTTP access log is a normal logger too (``repro.service.access``)
  but is **opt-in**: it only emits when ``REPRO_SERVICE_LOG=1`` (the
  server is used heavily in tests and benchmarks where per-request lines
  are pure noise).

Applications embedding the library can attach their own handlers to
``logging.getLogger("repro")`` before first use; the default handler is
only installed when nothing else is configured.

The port keeps the JAX package's ``repro`` logger namespace and format,
so logging configurations written for one package serve the other; a
process that imports both installs the one handler once.
"""
from __future__ import annotations

import logging
import os
import sys
import threading
from typing import Optional

__all__ = ["get_logger", "access_log_enabled", "LOG_LEVEL_ENV", "SERVICE_LOG_ENV"]

LOG_LEVEL_ENV = "REPRO_LOG_LEVEL"
SERVICE_LOG_ENV = "REPRO_SERVICE_LOG"

_ROOT = "repro"
_setup_lock = threading.Lock()
_setup_done = False


class _Formatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        record.pid = os.getpid()
        return super().format(record)


def _ensure_setup() -> None:
    global _setup_done
    if _setup_done:
        return
    with _setup_lock:
        if _setup_done:
            return
        root = logging.getLogger(_ROOT)
        if not root.handlers:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(
                _Formatter("repro[%(pid)s] %(levelname)s %(name)s: %(message)s")
            )
            root.addHandler(handler)
            # propagate stays True: records still reach root-level
            # handlers (pytest's caplog, an application's own logging
            # config); root has no handlers by default so nothing
            # double-prints out of the box.
        level = os.environ.get(LOG_LEVEL_ENV, "").upper()
        root.setLevel(getattr(logging, level, logging.WARNING))
        _setup_done = True


def get_logger(name: Optional[str] = None) -> logging.Logger:
    """The ``repro``-namespaced logger for ``name`` (e.g. ``"runstore"``
    → ``repro.runstore``), with the shared handler installed."""
    _ensure_setup()
    return logging.getLogger(f"{_ROOT}.{name}" if name else _ROOT)


def access_log_enabled() -> bool:
    """Whether the opt-in HTTP access log should emit
    (``REPRO_SERVICE_LOG=1``)."""
    return os.environ.get(SERVICE_LOG_ENV, "") not in ("", "0")
