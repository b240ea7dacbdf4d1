"""Prometheus text exposition (version 0.0.4) for the service metrics.

The service's ``/metrics`` endpoint keeps its JSON shape (the dashboard
and tests consume it) and *additionally* serves this format when the
client sends ``Accept: text/plain`` — one flat scrape target per host,
so a fleet-level Prometheus can aggregate schedulers before the
multi-host PR lands.  Zero dependencies: the format is plain text and
the mapping below is deliberately mechanical so the two surfaces cannot
drift (the cross-check test in ``tests/test_service.py`` parses this
output and compares every sample against the JSON endpoint).

Mapping from ``CampaignService.metrics()``:

* scalars → ``repro_uptime_seconds``, ``repro_queue_depth``,
  ``repro_inflight``, ``repro_dedup_hit_rate``, ``repro_workers_alive``
* ``counters.<name>`` → ``repro_<name>_total`` (monotonic counters)
* ``store.*`` → ``repro_store_<key>``
* ``tenants.<tenant>.*`` → ``repro_tenant_<key>{tenant="..."}``
* ``backend_timing.<backend>.{cells,wall_s_total}`` →
  ``repro_backend_cells_total{backend=...}`` /
  ``repro_backend_wall_seconds_total{backend=...}``
"""
from __future__ import annotations

from typing import Any, Dict, List

__all__ = ["prometheus_text", "PROM_CONTENT_TYPE"]

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_PREFIX = "repro"  # metric names shared with the JAX package


def _escape_label(value: Any) -> str:
    return str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _num(value: Any) -> Any:
    """Prometheus samples must be numbers; booleans become 0/1."""
    if isinstance(value, bool):
        return int(value)
    if isinstance(value, (int, float)):
        return value
    return None


class _Lines:
    def __init__(self) -> None:
        self.out: List[str] = []
        self._typed: set = set()

    def add(self, name: str, value: Any, labels: Dict[str, Any] = None,
            kind: str = "gauge", help_text: str = "") -> None:
        v = _num(value)
        if v is None:
            return
        if name not in self._typed:
            if help_text:
                self.out.append(f"# HELP {name} {help_text}")
            self.out.append(f"# TYPE {name} {kind}")
            self._typed.add(name)
        if labels:
            label_s = ",".join(
                f'{k}="{_escape_label(v2)}"' for k, v2 in sorted(labels.items())
            )
            self.out.append(f"{name}{{{label_s}}} {v}")
        else:
            self.out.append(f"{name} {v}")


def prometheus_text(metrics: Dict[str, Any]) -> str:
    """Render the service metrics dict as Prometheus exposition text."""
    L = _Lines()
    L.add(f"{_PREFIX}_uptime_seconds", metrics.get("uptime_s"),
          help_text="Service uptime in seconds")
    L.add(f"{_PREFIX}_queue_depth", metrics.get("queue_depth"),
          help_text="Work units waiting for a worker")
    L.add(f"{_PREFIX}_inflight", metrics.get("inflight"),
          help_text="Work units currently executing")
    L.add(f"{_PREFIX}_dedup_hit_rate", metrics.get("dedup_hit_rate"),
          help_text="Fraction of cells served from the shared store")
    camps = metrics.get("campaigns")
    L.add(f"{_PREFIX}_campaigns",
          len(camps) if isinstance(camps, dict) else camps,
          help_text="Campaigns tracked by the scheduler")

    for name, value in sorted((metrics.get("counters") or {}).items()):
        L.add(f"{_PREFIX}_{name}_total", value, kind="counter",
              help_text=f"Scheduler counter {name}")

    for key, value in sorted((metrics.get("store") or {}).items()):
        L.add(f"{_PREFIX}_store_{key}", value,
              help_text=f"Global store {key}")

    for tenant, stats in sorted((metrics.get("tenants") or {}).items()):
        if not isinstance(stats, dict):
            continue
        for key, value in sorted(stats.items()):
            L.add(f"{_PREFIX}_tenant_{key}", value, labels={"tenant": tenant},
                  kind="counter" if key.endswith(("_done", "_failed", "submitted")) else "gauge",
                  help_text=f"Per-tenant {key}")

    for backend, stats in sorted((metrics.get("backend_timing") or {}).items()):
        if not isinstance(stats, dict):
            continue
        L.add(f"{_PREFIX}_backend_cells_total", stats.get("cells"),
              labels={"backend": backend}, kind="counter",
              help_text="Cells executed per sim backend")
        L.add(f"{_PREFIX}_backend_wall_seconds_total", stats.get("wall_s_total"),
              labels={"backend": backend}, kind="counter",
              help_text="Cell wall time per sim backend")

    workers = metrics.get("workers") or []
    alive = sum(1 for w in workers if isinstance(w, dict) and w.get("alive"))
    L.add(f"{_PREFIX}_workers_alive", alive,
          help_text="Worker processes currently alive")
    L.add(f"{_PREFIX}_workers_total", len(workers),
          help_text="Worker slots configured")

    return "\n".join(L.out) + "\n"
