"""Post-hoc trace tooling: merge per-process JSONL sinks into one
Chrome-trace-event / Perfetto timeline, and aggregate spans into a
self-time table.

The recorder (:mod:`repro_torch.obs.recorder`) writes one JSON-lines file per
process; each file's header carries the process's ``epoch_ns`` (wall ns
at ``perf_counter`` zero).  :func:`export_chrome_trace` maps every span
onto the shared wall-clock axis, so scheduler workers, the service
process, and a local runner all land on one timeline —

    python -m repro_torch trace export --out runs/obs/trace.json

then open the file in https://ui.perfetto.dev (or chrome://tracing).
Span ``attrs`` become Chrome ``args`` (visible on click); counters are
emitted as running-total ``ph: "C"`` tracks; instant events as ``ph:
"i"`` markers.

:func:`summarize` computes per-name totals and *self time* (duration
minus time spent in child spans on the same thread), which is what
actually answers "where did decode time go".
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

from .recorder import default_obs_dir, iter_records

__all__ = [
    "export_chrome_trace",
    "validate_chrome_trace",
    "summarize",
    "format_summary",
]


def _load_by_file(obs_dir: Optional[str]) -> Dict[str, Dict[str, Any]]:
    """Group records per sink file: ``{file: {"meta": ..., "records": [...]}}``."""
    files: Dict[str, Dict[str, Any]] = {}
    for rec in iter_records(obs_dir):
        entry = files.setdefault(rec["file"], {"meta": None, "records": [], "proc": None})
        if rec.get("t") == "meta":
            entry["meta"] = rec
        elif rec.get("t") == "proc_name":
            entry["proc"] = rec.get("proc")
        else:
            entry["records"].append(rec)
    return files


def export_chrome_trace(
    obs_dir: Optional[str] = None, out_path: Optional[str] = None
) -> Dict[str, Any]:
    """Merge every sink under ``obs_dir`` into one Chrome-trace JSON
    object (written to ``out_path`` when given).  Timestamps are
    microseconds relative to the earliest record across all processes."""
    files = _load_by_file(obs_dir)
    # Global zero: earliest wall-clock instant seen anywhere.
    t0_ns = None
    for entry in files.values():
        meta = entry["meta"] or {}
        epoch = meta.get("epoch_ns", 0)
        for rec in entry["records"]:
            wall = epoch + rec.get("ts", 0)
            if t0_ns is None or wall < t0_ns:
                t0_ns = wall
    t0_ns = t0_ns or 0

    events: List[Dict[str, Any]] = []
    counter_totals: Dict[Tuple[int, str], float] = {}
    for fname in sorted(files):
        entry = files[fname]
        meta = entry["meta"] or {}
        pid = meta.get("pid", 0)
        epoch = meta.get("epoch_ns", 0)
        proc = entry["proc"] or meta.get("proc") or "python"
        host = meta.get("host", "?")
        events.append(
            {
                "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": f"{proc} ({host}:{pid})"},
            }
        )
        for rec in entry["records"]:
            kind = rec.get("t")
            ts_us = (epoch + rec.get("ts", 0) - t0_ns) / 1000.0
            tid = rec.get("tid", 0)
            if kind == "span":
                events.append(
                    {
                        "ph": "X",
                        "name": rec["name"],
                        "cat": rec.get("cat", ""),
                        "ts": ts_us,
                        "dur": rec.get("dur", 0) / 1000.0,
                        "pid": pid,
                        "tid": tid,
                        "args": rec.get("attrs") or {},
                    }
                )
            elif kind == "event":
                events.append(
                    {
                        "ph": "i",
                        "s": "t",
                        "name": rec["name"],
                        "cat": rec.get("cat", ""),
                        "ts": ts_us,
                        "pid": pid,
                        "tid": tid,
                        "args": rec.get("attrs") or {},
                    }
                )
            elif kind == "counter":
                key = (pid, rec["name"])
                counter_totals[key] = counter_totals.get(key, 0) + rec.get("value", 0)
                leaf = rec["name"].split(".")[-1]
                events.append(
                    {
                        "ph": "C",
                        "name": rec["name"],
                        "cat": rec.get("cat", ""),
                        "ts": ts_us,
                        "pid": pid,
                        "args": {leaf: counter_totals[key]},
                    }
                )
    events.sort(key=lambda e: (e.get("ts", 0), e.get("pid", 0)))
    trace = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {
            # The JAX package's name: trace tooling reads one format.
            "source": "repro.obs",
            "obs_dir": obs_dir or default_obs_dir(),
            "n_processes": len(files),
        },
    }
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(trace, f, separators=(",", ":"))
            f.write("\n")
    return trace


def validate_chrome_trace(trace: Dict[str, Any]) -> Dict[str, Any]:
    """Structural validation of a Chrome-trace object.  Returns
    ``{"events", "spans", "cats", "pids"}``; raises ``ValueError`` on a
    malformed trace (the CI smoke treats that as failure)."""
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("traceEvents must be a list")
    spans = 0
    cats = set()
    pids = set()
    for e in events:
        ph = e.get("ph")
        if ph not in ("X", "i", "C", "M"):
            raise ValueError(f"unknown event phase {ph!r}")
        if ph == "M":
            continue
        if not isinstance(e.get("ts"), (int, float)):
            raise ValueError(f"event {e.get('name')!r} missing numeric ts")
        if "pid" not in e:
            raise ValueError(f"event {e.get('name')!r} missing pid")
        pids.add(e["pid"])
        if ph == "X":
            if not isinstance(e.get("dur"), (int, float)) or e["dur"] < 0:
                raise ValueError(f"span {e.get('name')!r} missing/negative dur")
            spans += 1
            cats.add(e.get("cat") or e.get("name", "").split(".", 1)[0])
        elif ph == "i":
            cats.add(e.get("cat") or e.get("name", "").split(".", 1)[0])
    return {
        "events": len(events),
        "spans": spans,
        "cats": sorted(cats),
        "pids": sorted(pids),
    }


# ------------------------------------------------------------------ summary
def summarize(obs_dir: Optional[str] = None) -> Dict[str, Any]:
    """Aggregate spans into per-name rows with *self time*: a span's
    duration minus the durations of spans nested inside it on the same
    (process, thread).  Also totals every counter."""
    files = _load_by_file(obs_dir)
    agg: Dict[str, Dict[str, float]] = {}
    counters: Dict[str, float] = {}
    events: Dict[str, int] = {}

    for entry in files.values():
        by_thread: Dict[int, List[Dict[str, Any]]] = {}
        for rec in entry["records"]:
            kind = rec.get("t")
            if kind == "span":
                by_thread.setdefault(rec.get("tid", 0), []).append(rec)
            elif kind == "counter":
                counters[rec["name"]] = counters.get(rec["name"], 0) + rec.get("value", 0)
            elif kind == "event":
                events[rec["name"]] = events.get(rec["name"], 0) + 1
        for spans in by_thread.values():
            spans.sort(key=lambda r: (r["ts"], -r.get("dur", 0)))
            stack: List[Dict[str, Any]] = []  # each: {end, child, rec}
            def close(fr: Dict[str, Any]) -> None:
                rec = fr["rec"]
                dur = rec.get("dur", 0)
                row = agg.setdefault(
                    rec["name"],
                    {"count": 0, "total_ns": 0.0, "self_ns": 0.0, "max_ns": 0.0},
                )
                row["count"] += 1
                row["total_ns"] += dur
                row["self_ns"] += max(0, dur - fr["child"])
                row["max_ns"] = max(row["max_ns"], dur)
            for rec in spans:
                ts, dur = rec["ts"], rec.get("dur", 0)
                while stack and stack[-1]["end"] <= ts:
                    close(stack.pop())
                if stack:
                    stack[-1]["child"] += dur
                stack.append({"end": ts + dur, "child": 0, "rec": rec})
            while stack:
                close(stack.pop())

    rows = [
        {
            "name": name,
            "count": int(r["count"]),
            "total_ms": r["total_ns"] / 1e6,
            "self_ms": r["self_ns"] / 1e6,
            "mean_ms": r["total_ns"] / 1e6 / max(1, r["count"]),
            "max_ms": r["max_ns"] / 1e6,
        }
        for name, r in agg.items()
    ]
    rows.sort(key=lambda r: (-r["total_ms"], -r["self_ms"]))
    return {
        "spans": rows,
        "counters": dict(sorted(counters.items())),
        "events": dict(sorted(events.items())),
        "n_processes": len(files),
    }


def format_summary(summary: Dict[str, Any], top: int = 0) -> str:
    """Human-readable self-time table."""
    lines = [
        f"{'span':40s} {'count':>7s} {'total_ms':>10s} {'self_ms':>10s} "
        f"{'mean_ms':>9s} {'max_ms':>9s}"
    ]
    rows = summary["spans"]
    if top:
        rows = rows[:top]
    for r in rows:
        lines.append(
            f"{r['name']:40s} {r['count']:7d} {r['total_ms']:10.2f} "
            f"{r['self_ms']:10.2f} {r['mean_ms']:9.3f} {r['max_ms']:9.2f}"
        )
    if summary["counters"]:
        lines.append("")
        lines.append(f"{'counter':40s} {'total':>12s}")
        for name, v in summary["counters"].items():
            lines.append(f"{name:40s} {v:12g}")
    if summary["events"]:
        lines.append("")
        lines.append(f"{'event':40s} {'count':>12s}")
        for name, n in summary["events"].items():
            lines.append(f"{name:40s} {n:12d}")
    lines.append("")
    lines.append(f"processes merged: {summary['n_processes']}")
    return "\n".join(lines)
