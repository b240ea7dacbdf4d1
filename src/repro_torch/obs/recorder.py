"""Structured span/counter recorder — the telemetry core.

Zero dependencies, two states:

* **disabled** (default, ``REPRO_OBS`` unset): :func:`span`,
  :func:`event` and :func:`counter_add` each cost one module-global read
  and an ``if`` — no allocation, no lock, no clock read.  The shared
  :data:`_NULL_SPAN` singleton makes ``with span(...):`` a no-op pair of
  attribute calls.  The disabled-overhead guard in ``tests/test_obs.py``
  pins this.
* **enabled** (``REPRO_OBS=1`` or ``REPRO_OBS=<dir>``): every record is a
  small tuple appended under a lock and flushed as JSON lines to a
  per-process sink ``<dir>/<session>-<host>-<pid>.jsonl`` (default dir
  ``runs/obs/``, override with ``REPRO_OBS_DIR``).  One file per process
  means workers never contend on a shared descriptor and a crashed
  process loses at most its unflushed tail — the exporter
  (:mod:`repro_torch.obs.trace`) merges files post hoc.

Clocks: span timestamps are ``time.perf_counter_ns()`` (monotonic,
immune to NTP steps); each sink's header line carries
``epoch_ns = time.time_ns() - perf_counter_ns()`` so the exporter can
place every process's spans on one wall-clock timeline.

Span names are dot-namespaced (``engine.decode``, ``service.cell``); the
first component is the record's *category* (subsystem), which the trace
tooling uses for grouping and the CI smoke uses to assert coverage.
"""
from __future__ import annotations

import atexit
import json
import os
import socket
import sys
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

__all__ = [
    "enabled",
    "span",
    "event",
    "counter_add",
    "set_process_name",
    "configure",
    "shutdown",
    "flush",
    "default_obs_dir",
    "OBS_ENV",
    "OBS_DIR_ENV",
]

OBS_ENV = "REPRO_OBS"
OBS_DIR_ENV = "REPRO_OBS_DIR"
DEFAULT_OBS_DIR = os.path.join("runs", "obs")

_FLUSH_EVERY = 512  # records buffered before an automatic flush


def default_obs_dir() -> str:
    """The sink directory the current environment selects."""
    raw = os.environ.get(OBS_ENV, "")
    if raw and raw not in ("0", "1", "true", "yes"):
        return raw
    return os.environ.get(OBS_DIR_ENV) or DEFAULT_OBS_DIR


def _env_enabled() -> bool:
    return os.environ.get(OBS_ENV, "") not in ("", "0")


# --------------------------------------------------------------- recorder
class Recorder:
    """Buffered JSON-lines sink for one process.  Thread-safe; fork-safe
    by construction (each process lazily opens its own file keyed by
    pid — a forked child never inherits the parent's buffer usefully,
    so :func:`_get` re-checks the pid)."""

    def __init__(self, obs_dir: str) -> None:
        self.obs_dir = obs_dir
        self.pid = os.getpid()
        self.host = socket.gethostname()
        # perf_counter epoch: wall ns at perf_counter zero, letting the
        # exporter map monotonic span times onto one shared timeline.
        self.epoch_ns = time.time_ns() - time.perf_counter_ns()
        self._lock = threading.Lock()
        self._buf: List[Dict[str, Any]] = []
        self._path = os.path.join(
            obs_dir, f"obs-{self.host}-{self.pid}-{time.time_ns() // 1_000_000}.jsonl"
        )
        self._wrote_meta = False
        self.proc_name = os.path.basename(sys.argv[0]) if sys.argv and sys.argv[0] else "python"

    def _meta(self) -> Dict[str, Any]:
        return {
            "t": "meta",
            "pid": self.pid,
            "host": self.host,
            "proc": self.proc_name,
            "epoch_ns": self.epoch_ns,
            "argv": sys.argv[:4],
        }

    def record(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            self._buf.append(rec)
            if len(self._buf) >= _FLUSH_EVERY:
                self._flush_locked()

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        if not self._buf and self._wrote_meta:
            return
        os.makedirs(self.obs_dir, exist_ok=True)
        lines = []
        if not self._wrote_meta:
            lines.append(json.dumps(self._meta(), separators=(",", ":")))
            self._wrote_meta = True
        lines.extend(
            json.dumps(r, separators=(",", ":"), default=str) for r in self._buf
        )
        self._buf.clear()
        if lines:
            with open(self._path, "a") as f:
                f.write("\n".join(lines) + "\n")


_RECORDER: Optional[Recorder] = None
_INIT_LOCK = threading.Lock()
_CONFIGURED: Optional[bool] = None  # tri-state: None = follow the env
# Cached on/off flag: the disabled hot path must not touch os.environ
# (a missing-key ``environ.get`` costs ~1µs via internal KeyError).
# ``None`` means "not yet computed"; :func:`configure` resets it.
_ON: Optional[bool] = None


def configure(on: Optional[bool] = None, obs_dir: Optional[str] = None) -> None:
    """Programmatic override of the ``REPRO_OBS`` gate (tests, drivers).
    ``configure(True, dir)`` enables into ``dir``; ``configure(False)``
    disables; ``configure(None)`` re-follows the environment."""
    global _RECORDER, _CONFIGURED, _ON
    with _INIT_LOCK:
        flush()
        _CONFIGURED = on
        _RECORDER = None
        _ON = None
        if obs_dir is not None:
            os.environ[OBS_DIR_ENV] = obs_dir


def enabled() -> bool:
    global _ON
    on = _ON
    if on is None:
        on = _CONFIGURED if _CONFIGURED is not None else _env_enabled()
        _ON = on
    return on


def _get() -> Optional[Recorder]:
    """The live per-process recorder, or None when telemetry is off."""
    global _RECORDER
    rec = _RECORDER
    if rec is not None and rec.pid == os.getpid():
        return rec
    if not enabled():
        return None
    with _INIT_LOCK:
        rec = _RECORDER
        if rec is None or rec.pid != os.getpid():
            rec = Recorder(default_obs_dir())
            _RECORDER = rec
    return rec


def flush() -> None:
    rec = _RECORDER
    if rec is not None and rec.pid == os.getpid():
        rec.flush()


def shutdown() -> None:
    """Flush and drop the process recorder (atexit hook; also lets tests
    reconfigure cleanly)."""
    global _RECORDER
    flush()
    _RECORDER = None


atexit.register(shutdown)


def set_process_name(name: str) -> None:
    """Name this process on the merged timeline (e.g. ``worker-0``)."""
    rec = _get()
    if rec is not None:
        rec.proc_name = name
        # The meta line may already be on disk; append an update record.
        rec.record({"t": "proc_name", "pid": rec.pid, "proc": name})


# ------------------------------------------------------------------ spans
class _NullSpan:
    """Shared no-op span: the entire disabled-path cost of ``with
    span(...):`` is one global read, one ``if``, and two method calls."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def set(self, **attrs: Any) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Span:
    __slots__ = ("_rec", "name", "attrs", "_t0")

    def __init__(self, rec: Recorder, name: str, attrs: Dict[str, Any]) -> None:
        self._rec = rec
        self.name = name
        self.attrs = attrs
        self._t0 = 0

    def __enter__(self) -> "Span":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type: Any, *exc: Any) -> bool:
        dur = time.perf_counter_ns() - self._t0
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self._rec.record(
            {
                "t": "span",
                "name": self.name,
                "cat": self.name.split(".", 1)[0],
                "ts": self._t0,
                "dur": dur,
                "tid": threading.get_native_id(),
                "attrs": self.attrs,
            }
        )
        return False

    def set(self, **attrs: Any) -> None:
        """Attach attributes discovered mid-span."""
        self.attrs.update(attrs)


def span(name: str, **attrs: Any):
    """Time a block::

        with obs.span("engine.decode", decoder="caps_hms") as sp:
            ...
            sp.set(feasible=True)

    Returns the shared no-op span when telemetry is disabled."""
    if _ON is False:
        return _NULL_SPAN
    rec = _get()
    if rec is None:
        return _NULL_SPAN
    return Span(rec, name, attrs)


def event(name: str, **attrs: Any) -> None:
    """An instant marker (claim contention, backend resolution, retry)."""
    if _ON is False:
        return
    rec = _get()
    if rec is None:
        return
    rec.record(
        {
            "t": "event",
            "name": name,
            "cat": name.split(".", 1)[0],
            "ts": time.perf_counter_ns(),
            "tid": threading.get_native_id(),
            "attrs": attrs,
        }
    )


def counter_add(name: str, value: float = 1, **attrs: Any) -> None:
    """Add to a named monotonic counter (cache hits, recompiles, ...).
    The trace keeps the increments; readers integrate."""
    if _ON is False:
        return
    rec = _get()
    if rec is None:
        return
    rec.record(
        {
            "t": "counter",
            "name": name,
            "cat": name.split(".", 1)[0],
            "ts": time.perf_counter_ns(),
            "tid": threading.get_native_id(),
            "value": value,
            "attrs": attrs,
        }
    )


def iter_records(obs_dir: Optional[str] = None) -> Iterator[Dict[str, Any]]:
    """Yield every record from every sink file under ``obs_dir`` (helper
    for the exporter and tests; skips unparseable tails from crashed
    writers)."""
    d = obs_dir or default_obs_dir()
    try:
        names = sorted(os.listdir(d))
    except OSError:
        return
    for name in names:
        if not name.endswith(".jsonl"):
            continue
        try:
            with open(os.path.join(d, name)) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue  # torn tail of a crashed writer
                    rec.setdefault("file", name)
                    yield rec
        except OSError:
            continue
