"""Campaign service: a long-running, multi-tenant HTTP front end over the
work-stealing scheduler and the shared dedup store.

Stdlib only (``http.server.ThreadingHTTPServer`` — no new dependencies).
Endpoints (all JSON):

* ``POST /campaigns`` — body ``{"campaign": <Campaign JSON>, "tenant":
  "alice", "priority": 0}``; expands the spec, writes the submission's
  manifest, enqueues the not-yet-stored cells and returns
  ``{"submission_id", "n_cells", "n_pending", "n_resumed", ...}``.
  Submissions are idempotent per ``(tenant, campaign_id)``: re-posting a
  spec resumes it (completed cells are never re-executed — content
  addressing makes resume and cross-tenant dedup the same mechanism).
* ``GET /campaigns`` — submission ids.
* ``GET /campaigns/<sid>`` — incremental report: the standard
  ``build_report`` over whatever cells exist right now, plus scheduler
  state (pending units, errors, done flag).
* ``GET /campaigns/<sid>/events?since=N`` — streaming per-cell progress:
  one JSON object per line (``unit_queued`` / ``cell_started`` /
  ``cell_done`` / ``cell_dedup`` / ``unit_retry`` / ...), held open until
  the campaign finishes, then a final ``{"type": "stream_end"}`` line.
* ``GET /metrics`` — queue depth, dedup hit rate, per-tenant throughput,
  per-backend decode/sim timing, worker health, retry counters.  With
  ``Accept: text/plain`` the same values are served in Prometheus text
  exposition format (a fleet scrape target).

Served campaigns are bit-identical to local ``CampaignRunner`` runs of
the same specs: the manifest, cell artifacts, and report formats are the
same files, produced by the same cell-execution path.

The service runs every cell's engine on one server-wide ``device``
(``"cuda"``, the default, or ``"cpu"``), resolved when the service is
built, so a service asked for the card fails at start-up on a machine
without one.  The device reaches the cells as a perf-only engine override
(as ``CampaignRunner(engine_overrides=...)`` takes it): it never enters a
submission id, a cell's spec hash or the manifest, and a client cannot
choose it — the request body is the JAX package's.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from .. import faults, obs
from ..core.campaign import Campaign, build_report
from ..device import resolve_device
from .scheduler import Scheduler, SchedulerConfig
from .store import DEFAULT_SERVICE_ROOT, GlobalStore

__all__ = ["CampaignService", "QueueSaturated", "serve", "make_server"]

_access_log = obs.get_logger("service.access")


class QueueSaturated(RuntimeError):
    """Raised by :meth:`CampaignService.submit` when the scheduler queue
    is past the high-water mark; the HTTP layer maps it to ``429`` with
    a ``Retry-After`` hint."""

    def __init__(self, depth: int, high_water: int, retry_after_s: float) -> None:
        super().__init__(
            f"queue saturated: {depth} units queued "
            f"(high-water {high_water}); retry in {retry_after_s:g}s"
        )
        self.depth = depth
        self.high_water = high_water
        self.retry_after_s = retry_after_s


class CampaignService:
    """The service object behind the HTTP handler (usable directly in
    tests and benchmarks without sockets)."""

    def __init__(
        self,
        root: str = DEFAULT_SERVICE_ROOT,
        *,
        workers: int = 2,
        config: Optional[SchedulerConfig] = None,
        tenant_quotas: Optional[Dict[str, int]] = None,
        queue_high_water: Optional[int] = None,
        device: str = "cuda",
    ) -> None:
        resolve_device(device)  # fail at start-up, not in the first unit
        self.device = str(device)
        self.queue_high_water = queue_high_water
        self.store = GlobalStore(root)
        self.scheduler = Scheduler(
            self.store.cells,
            workers=workers,
            config=config,
            on_event=self._on_event,
            tenant_quotas=tenant_quotas,
        ).start()
        self._lock = threading.Lock()
        self._events_cv = threading.Condition(self._lock)
        # submission_id -> {"tenant", "priority", "n_cells", "events": [...]}
        self._submissions: Dict[str, Dict[str, Any]] = {}
        self.started_at = time.time()

    # -------------------------------------------------------------- submit
    def submit(
        self,
        campaign_spec: Dict[str, Any],
        *,
        tenant: str = "default",
        priority: int = 0,
    ) -> Dict[str, Any]:
        # Backpressure before any expensive work: past the high-water
        # mark the caller gets 429 + Retry-After instead of deepening an
        # already-saturated queue.  Resubmitting later is free
        # (idempotent), so shedding is always safe.
        if self.queue_high_water is not None:
            depth = self.scheduler.queue_depth()
            if depth >= self.queue_high_water:
                obs.event(
                    "service.queue_saturated", depth=depth,
                    high_water=self.queue_high_water, tenant=tenant,
                )
                raise QueueSaturated(depth, self.queue_high_water,
                                     retry_after_s=1.0)
        campaign = Campaign.from_json(campaign_spec)
        cells = campaign.expand()
        submission_id = f"{tenant}--{campaign.campaign_id()}"
        view = self.store.view(submission_id)
        view.write_manifest(campaign.manifest())
        pending = [c for c in cells if view.try_load_cell(c.spec_hash()) is None]
        with self._events_cv:
            sub = self._submissions.setdefault(
                submission_id,
                {"tenant": tenant, "priority": priority,
                 "n_cells": len(cells), "events": []},
            )
            sub["events"].append(
                {"type": "submitted", "campaign_id": submission_id,
                 "tenant": tenant, "n_cells": len(cells),
                 "n_pending": len(pending)}
            )
            self._events_cv.notify_all()
        shards: Dict[str, List[Any]] = {}
        for i, cell in enumerate(pending):
            key = cell.engine_key() if campaign.share_engines else f"#{i}"
            shards.setdefault(key, []).append(cell)
        n_units = self.scheduler.submit(
            submission_id, tenant, list(shards.values()), priority=priority,
            engine_overrides={"device": self.device},
        )
        return {
            "submission_id": submission_id,
            "campaign_id": campaign.campaign_id(),
            "tenant": tenant,
            "n_cells": len(cells),
            "n_pending": len(pending),
            "n_resumed": len(cells) - len(pending),
            "n_units": n_units,
        }

    # -------------------------------------------------------------- status
    def submissions(self) -> List[str]:
        on_disk = self.store.submissions()
        with self._lock:
            live = set(self._submissions)
        return sorted(set(on_disk) | live)

    def status(self, submission_id: str) -> Dict[str, Any]:
        view = self.store.view(submission_id)
        manifest = view.read_manifest()
        if manifest is None:
            raise KeyError(f"unknown submission {submission_id!r}")
        campaign = Campaign.from_json(manifest["campaign"])
        cells = campaign.expand()
        report = build_report(cells, view)
        state = self.scheduler.campaign_state(submission_id)
        done = state is None or state["done"]
        with self._lock:
            sub = self._submissions.get(submission_id, {})
            n_events = len(sub.get("events", []))
        return {
            "submission_id": submission_id,
            "tenant": sub.get("tenant"),
            "done": bool(done and report["n_completed"] == report["n_cells"]),
            "scheduler": state,
            "n_events": n_events,
            "report": report,
        }

    def metrics(self) -> Dict[str, Any]:
        return {
            "uptime_s": time.time() - self.started_at,
            "store": self.store.stats(),
            **self.scheduler.metrics(),
        }

    # -------------------------------------------------------------- events
    def _on_event(self, event: Dict[str, Any]) -> None:
        sid = event.get("campaign_id")
        with self._events_cv:
            sub = self._submissions.get(sid)
            if sub is None:
                sub = self._submissions.setdefault(
                    sid, {"tenant": event.get("tenant"), "priority": 0,
                          "n_cells": 0, "events": []}
                )
            sub["events"].append(event)
            self._events_cv.notify_all()

    def events_since(
        self, submission_id: str, index: int, timeout_s: float = 1.0
    ) -> Tuple[List[Dict[str, Any]], int, bool]:
        """Events ``[index:]`` for a submission (blocking up to
        ``timeout_s`` for new ones), the next index, and whether the
        campaign is finished."""
        deadline = time.monotonic() + timeout_s
        with self._events_cv:
            while True:
                events = self._submissions.get(submission_id, {}).get("events", [])
                if len(events) > index:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._events_cv.wait(timeout=remaining)
            out = list(events[index:])
        state = self.scheduler.campaign_state(submission_id)
        done = state is None or state["done"]
        return out, index + len(out), done

    def close(self) -> None:
        self.scheduler.close()


# ==========================================================================
class _Handler(BaseHTTPRequestHandler):
    # Close-delimited bodies keep the streaming endpoint trivial; every
    # response sets Connection: close.
    protocol_version = "HTTP/1.0"
    service: CampaignService = None  # patched in by make_server

    # ------------------------------------------------------------- plumbing
    def log_message(self, fmt, *args):
        # Quiet by default (tests, CI); REPRO_SERVICE_LOG=1 routes the
        # access log through the repro.service.access logger (the JAX
        # package's logger name, kept).
        if obs.access_log_enabled():
            _access_log.info("%s %s", self.address_string(), fmt % args)

    def _send_json(
        self, payload: Any, code: int = 200,
        headers: Optional[Dict[str, str]] = None,
    ) -> None:
        body = (json.dumps(payload, sort_keys=True) + "\n").encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, text: str, content_type: str, code: int = 200) -> None:
        body = text.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, message: str) -> None:
        self._send_json({"error": message}, code=code)

    def _injected_fault(self) -> bool:
        """Evaluate the ``http.request`` injection site; True when the
        fault consumed the request (connection reset or 5xx).  Generic
        ``slow`` rules (stalled responses) sleep inside ``fire`` and fall
        through to normal handling."""
        kind = faults.fire("http.request", path=self.path)
        if kind == "reset":
            # Abrupt connection loss: no status line, no body.  finish()
            # tolerates the closed files.
            self.close_connection = True
            try:
                self.connection.close()
            except OSError:
                pass
            return True
        if kind == "error_5xx":
            self._error(503, "injected server error")
            return True
        return False

    # --------------------------------------------------------------- routes
    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        if self._injected_fault():
            return
        url = urlparse(self.path)
        parts = [p for p in url.path.split("/") if p]
        try:
            if parts == ["healthz"]:
                self._send_json({"ok": True})
            elif parts == ["metrics"]:
                # Content negotiation: JSON by default (dashboards,
                # existing clients); Prometheus text exposition when the
                # scraper asks for text/plain (same values, one source).
                accept = self.headers.get("Accept", "")
                if "text/plain" in accept and "application/json" not in accept:
                    self._send_text(
                        obs.prometheus_text(self.service.metrics()),
                        obs.PROM_CONTENT_TYPE,
                    )
                else:
                    self._send_json(self.service.metrics())
            elif parts == ["campaigns"]:
                self._send_json({"submissions": self.service.submissions()})
            elif len(parts) == 2 and parts[0] == "campaigns":
                self._send_json(self.service.status(parts[1]))
            elif len(parts) == 3 and parts[0] == "campaigns" and parts[2] == "events":
                since = int(parse_qs(url.query).get("since", ["0"])[0])
                self._stream_events(parts[1], since)
            else:
                self._error(404, f"no route {url.path!r}")
        except KeyError as e:
            self._error(404, str(e.args[0]) if e.args else "not found")
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception as e:  # noqa: BLE001 — report to the client
            self._error(500, f"{type(e).__name__}: {e}")

    def do_POST(self) -> None:  # noqa: N802
        if self._injected_fault():
            return
        url = urlparse(self.path)
        parts = [p for p in url.path.split("/") if p]
        try:
            length = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(length) if length else b""
            body = json.loads(raw.decode() or "{}")
        except (ValueError, UnicodeDecodeError) as e:
            self._error(400, f"malformed JSON body: {e}")
            return
        try:
            if parts == ["campaigns"]:
                spec = body.get("campaign")
                if not isinstance(spec, dict):
                    self._error(400, "body must carry a 'campaign' spec object")
                    return
                out = self.service.submit(
                    spec,
                    tenant=str(body.get("tenant", "default")),
                    priority=int(body.get("priority", 0)),
                )
                self._send_json(out, code=201)
            else:
                self._error(404, f"no route POST {url.path!r}")
        except QueueSaturated as e:
            self._send_json(
                {"error": str(e), "retry_after_s": e.retry_after_s},
                code=429,
                headers={"Retry-After": f"{e.retry_after_s:g}"},
            )
        except (ValueError, KeyError) as e:
            self._error(400, f"{type(e).__name__}: {e}")
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception as e:  # noqa: BLE001
            self._error(500, f"{type(e).__name__}: {e}")

    # ------------------------------------------------------------ streaming
    def _stream_events(self, submission_id: str, since: int) -> None:
        # Existence check up front so unknown ids 404 instead of hanging.
        self.service.status(submission_id)
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.end_headers()
        index = since
        while True:
            events, index, done = self.service.events_since(
                submission_id, index, timeout_s=0.5
            )
            for event in events:
                self.wfile.write((json.dumps(event, sort_keys=True) + "\n").encode())
            self.wfile.flush()
            if done and not events:
                self.wfile.write(
                    (json.dumps({"type": "stream_end", "done": True,
                                 "next": index}) + "\n").encode()
                )
                self.wfile.flush()
                return


def make_server(
    root: str = DEFAULT_SERVICE_ROOT,
    *,
    host: str = "127.0.0.1",
    port: int = 0,
    workers: int = 2,
    config: Optional[SchedulerConfig] = None,
    tenant_quotas: Optional[Dict[str, int]] = None,
    queue_high_water: Optional[int] = None,
    device: str = "cuda",
) -> Tuple[ThreadingHTTPServer, CampaignService]:
    """Build (but don't run) the HTTP server; ``port=0`` picks an
    ephemeral port (``server.server_address``)."""
    service = CampaignService(
        root, workers=workers, config=config, tenant_quotas=tenant_quotas,
        queue_high_water=queue_high_water, device=device,
    )
    handler = type("BoundHandler", (_Handler,), {"service": service})
    server = ThreadingHTTPServer((host, port), handler)
    server.daemon_threads = True
    return server, service


def serve(
    root: str = DEFAULT_SERVICE_ROOT,
    *,
    host: str = "127.0.0.1",
    port: int = 8321,
    workers: int = 2,
    config: Optional[SchedulerConfig] = None,
    queue_high_water: Optional[int] = None,
    device: str = "cuda",
) -> None:
    """Run the campaign service until interrupted (the CLI entrypoint)."""
    server, service = make_server(
        root, host=host, port=port, workers=workers, config=config,
        queue_high_water=queue_high_water, device=device,
    )
    h, p = server.server_address[:2]
    print(f"campaign service on http://{h}:{p} "
          f"(store {root}, {workers} workers, device {device})", flush=True)
    try:
        server.serve_forever(poll_interval=0.2)
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.close()
