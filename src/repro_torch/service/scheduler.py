"""Work-stealing scheduler for campaign cells.

One shared queue of :class:`WorkUnit`\\ s (an engine-sharing group of
cells — the same sharding unit the local ``CampaignRunner`` always used,
so in-group decode caches stay warm) drained by a supervised pool of
worker processes:

* **ordering** — idle workers steal the *best* eligible unit, scored as
  ``tenant_priority · priority_weight + n_cells · size_weight +
  wait_seconds · aging_rate``: big engine-shared groups first (they
  amortize the most cache warmth), higher-priority tenants first, and
  starvation aging so a small low-priority unit can never be postponed
  forever;
* **fairness** — per-tenant fair share: while several tenants have work
  queued, a tenant already running ≥ ``workers / active_tenants`` units
  (or its explicit ``quota``) is passed over, so one user's thousand-cell
  campaign cannot monopolize the pool;
* **dedup** — before executing a cell the worker checks the shared store
  and takes a ``O_CREAT|O_EXCL`` claim
  (:meth:`~repro_torch.core.runstore.RunStore.claim`): an artifact hit is a
  dedup, a lost claim means another worker is decoding the same hash and
  this worker parks the cell and polls for the artifact (taking over the
  claim only if it goes stale — dead owner);
* **supervision** — workers heartbeat (and refresh their held claims)
  from a side thread; a missed heartbeat or dead process (SIGKILL) gets
  the worker respawned, its claims released, and its in-flight unit
  requeued with exponential backoff, at most ``max_retries`` times.
  Each worker incarnation reports on a pipe of its own, so a worker
  killed in the middle of a message can tear or wedge only its own
  channel, which is dropped with it — never the pool's.
  Unit *exceptions* (e.g. an unknown decoder) are deterministic and fail
  immediately — only worker death is retried.

Workers are ``spawn``-started processes (a forked child cannot use its
parent's CUDA context), so each pays one interpreter and torch import.

``workers=0`` is inline mode: the same unit-execution code runs in the
calling process (this is what the local ``CampaignRunner`` uses for
serial and in-memory runs), so served and local campaigns execute cells
through literally one code path — which is why their results are
bit-identical.
"""
from __future__ import annotations

import multiprocessing
import multiprocessing.connection
import os
import signal
import socket
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from .. import faults, obs
from ..core.runstore import RunStore

__all__ = ["SchedulerConfig", "WorkUnit", "Scheduler", "run_groups_local"]

_log = obs.get_logger("service.scheduler")

# Test-only hook: sleep this many seconds inside the worker after a cell
# is claimed and announced, before decoding — gives kill/retry tests a
# deterministic in-flight window.  Unset (the default) costs nothing.
CELL_DELAY_ENV = "REPRO_SERVICE_CELL_DELAY_S"


@dataclass
class SchedulerConfig:
    heartbeat_interval_s: float = 0.5
    heartbeat_timeout_s: float = 30.0
    claim_ttl_s: float = 60.0        # stale-claim takeover threshold
    unit_deadline_s: Optional[float] = None  # wall cap per unit attempt
    max_retries: int = 2             # per unit, on worker death only
    backoff_base_s: float = 0.25     # retry n waits base * 2**(n-1)
    priority_weight: float = 1000.0  # tenant priority dominates...
    size_weight: float = 1.0         # ...then group size (big first)...
    aging_rate: float = 2.0          # ...and waiting units gain score/s
    fair_share: bool = True
    claim_poll_s: float = 0.05       # artifact poll while parked on a claim


@dataclass
class WorkUnit:
    """One schedulable chunk: an engine-sharing group of cell specs."""

    unit_id: str
    campaign_id: str
    tenant: str
    cells: List[Dict[str, Any]]      # CampaignCell.to_json() dicts
    priority: int = 0
    engine_overrides: Dict[str, Any] = field(default_factory=dict)
    enqueued_at: float = field(default_factory=time.monotonic)
    attempts: int = 0
    not_before: float = 0.0

    @property
    def size(self) -> int:
        return len(self.cells)


# ==========================================================================
# Unit execution — one code path for worker processes AND inline mode.
# ==========================================================================
def _execute_unit(
    cells: Sequence[Any],
    store: RunStore,
    *,
    owner: str,
    engine_overrides: Optional[Dict[str, Any]] = None,
    claim_ttl_s: Optional[float] = None,
    emit: Optional[Callable[[Dict[str, Any]], None]] = None,
    on_claim: Optional[Callable[[str, bool], None]] = None,
    poll_s: float = 0.05,
    attrs: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Execute one engine-sharing group of :class:`CampaignCell`\\ s
    against ``store`` with the claim/dedup protocol.  Returns
    ``{"executed": [hash...], "deduped": [hash...], "cells": [stats...]}``.
    ``on_claim(hash, held)`` tells the caller's heartbeat thread which
    claims to keep refreshed.  ``attrs`` (unit/campaign/tenant identity)
    is stamped onto every telemetry span and event this unit records."""
    from ..core.campaign import run_cell
    from ..core.problem import ExplorationProblem

    emit = emit or (lambda e: None)
    on_claim = on_claim or (lambda h, held: None)
    attrs = dict(attrs or {})
    delay = float(os.environ.get(CELL_DELAY_ENV, "0") or 0.0)
    engine = None
    executed: List[str] = []
    deduped: List[str] = []
    parked: List[Any] = []
    stats: List[Dict[str, Any]] = []

    def run_one(cell, h) -> None:
        nonlocal engine
        emit({"type": "cell_started", "spec_hash": h, "tag": cell.tag})
        if delay:
            time.sleep(delay)
        t0 = time.monotonic()
        published = False
        try:
            with obs.span(
                "service.cell", spec=h[:12], tag=cell.tag, **attrs
            ):
                faults.fire("sched.mid_decode", spec=h[:12])
                if engine is None:
                    problem = ExplorationProblem.from_json(cell.problem)
                    engine = problem.make_engine(
                        **{**cell.engine, **(engine_overrides or {})}
                    )
                # The group shares the engine, not its decode cache: an
                # artifact records the cell's decode counters, which must
                # not depend on which cells this engine ran before (a
                # resumed, deduplicated or crash-recovered group runs a
                # different subset in a different order).
                engine.clear_cache()
                art = run_cell(cell, engine=engine)
                faults.fire("sched.pre_publish", spec=h[:12])
                published = store.publish_cell(h, art, owner)
        finally:
            store.release_claim(h, owner=owner)
            on_claim(h, False)
        wall = time.monotonic() - t0
        if not published:
            # The claim was inherited (stale takeover while this worker
            # hung) or a racing publisher won: the artifact is — or will
            # be — durable exactly once, and this decode is discarded.
            deduped.append(h)
            obs.counter_add("service.cells_deduped", **attrs)
            emit({"type": "cell_dedup", "spec_hash": h, "tag": cell.tag})
            return
        executed.append(h)
        stats.append(
            {
                "spec_hash": h,
                "wall_s": wall,
                "sim_backend": cell.engine.get("sim_backend"),
            }
        )
        emit(
            {
                "type": "cell_done",
                "spec_hash": h,
                "tag": cell.tag,
                "wall_s": wall,
                "sim_backend": cell.engine.get("sim_backend"),
            }
        )

    try:
        with obs.span("service.unit", n_cells=len(cells), **attrs) as usp:
            for cell in cells:
                h = cell.spec_hash()
                if store.try_load_cell(h) is not None:
                    deduped.append(h)
                    obs.counter_add("service.cells_deduped", **attrs)
                    emit({"type": "cell_dedup", "spec_hash": h, "tag": cell.tag})
                    continue
                faults.fire("sched.pre_claim", spec=h[:12])
                if not store.claim(h, owner, ttl_s=claim_ttl_s):
                    # Another worker is decoding this hash right now — park
                    # the cell and come back once the rest of the group ran.
                    parked.append(cell)
                    obs.event(
                        "service.claim_contention", spec=h[:12], **attrs
                    )
                    emit({"type": "cell_wait", "spec_hash": h, "tag": cell.tag})
                    continue
                on_claim(h, True)
                run_one(cell, h)
            for cell in parked:
                h = cell.spec_hash()
                wait_s = poll_s
                with obs.span(
                    "service.claim_wait", spec=h[:12], **attrs
                ) as wsp:
                    while True:
                        if store.try_load_cell(h) is not None:
                            deduped.append(h)
                            obs.counter_add("service.cells_deduped", **attrs)
                            wsp.set(outcome="dedup")
                            emit({"type": "cell_dedup", "spec_hash": h,
                                  "tag": cell.tag})
                            break
                        if store.claim(h, owner, ttl_s=claim_ttl_s):
                            # The original claimant died; its stale claim
                            # timed out and we inherit the work.
                            obs.event(
                                "service.stale_takeover", spec=h[:12], **attrs
                            )
                            wsp.set(outcome="stale_takeover")
                            on_claim(h, True)
                            run_one(cell, h)
                            break
                        time.sleep(wait_s)
                        wait_s = min(wait_s * 2, 0.5)
            usp.set(executed=len(executed), deduped=len(deduped))
    finally:
        if engine is not None:
            engine.close()
    return {"executed": executed, "deduped": deduped, "cells": stats}


# ==========================================================================
# Worker process
# ==========================================================================
def _worker_main(wid: int, owner: str, task_q, results, cell_root: Optional[str],
                 hb_interval_s: float) -> None:
    """Worker loop: announce readiness, execute assigned units, heartbeat
    (and refresh held claims) from a side thread so a long decode never
    looks dead.  ``results`` is this incarnation's own pipe to the
    supervisor; both threads write to it, one whole message at a time."""
    store = RunStore(cell_root)
    send_lock = threading.Lock()

    def send(msg: tuple) -> None:
        with send_lock:
            results.send(msg)

    obs.set_process_name(f"worker-{wid}")
    held: set = set()
    held_lock = threading.Lock()
    stop = threading.Event()

    # SIGTERM (supervisor terminate(), clean shutdown) must unwind the
    # Python stack so the claim-releasing ``finally`` below runs — the
    # default handler would exit without it and leave claims for the TTL.
    def _on_sigterm(signum, frame):  # pragma: no cover — signal path
        raise SystemExit(128 + signum)

    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except (ValueError, OSError):  # pragma: no cover — non-main thread
        pass

    def heartbeat() -> None:
        while not stop.is_set():
            # Injected heartbeat loss (clock skew / GC pause model): skip
            # this beat *and* the claim refreshes it carries.
            if faults.fire("sched.heartbeat", worker=wid) != "skip":
                try:
                    send(("heartbeat", wid, time.time()))
                except Exception:
                    return
                with held_lock:
                    for h in list(held):
                        store.refresh_claim(h, owner)
            stop.wait(hb_interval_s)

    threading.Thread(target=heartbeat, daemon=True).start()

    def on_claim(h: str, holding: bool) -> None:
        with held_lock:
            (held.add if holding else held.discard)(h)

    from ..core.campaign import CampaignCell

    send(("ready", wid))
    try:
        while True:
            msg = task_q.get()
            if msg[0] == "stop":
                break
            _, payload = msg
            unit_id = payload["unit_id"]

            def emit(event: Dict[str, Any], _uid=unit_id, _p=payload) -> None:
                send(
                    ("event", wid,
                     {**event, "unit_id": _uid,
                      "campaign_id": _p["campaign_id"], "tenant": _p["tenant"]})
                )

            try:
                out = _execute_unit(
                    [CampaignCell.from_json(d) for d in payload["cells"]],
                    store,
                    owner=owner,
                    engine_overrides=payload.get("engine_overrides") or {},
                    claim_ttl_s=payload.get("claim_ttl_s"),
                    emit=emit,
                    on_claim=on_claim,
                    poll_s=payload.get("claim_poll_s", 0.05),
                    attrs={"unit": unit_id, "campaign": payload["campaign_id"],
                           "tenant": payload["tenant"], "worker": wid},
                )
                send(("unit_done", wid, unit_id, out))
            except (SystemExit, KeyboardInterrupt):
                raise  # shutdown signals unwind to the claim release below
            except BaseException as e:  # noqa: BLE001 — report, don't die
                send(
                    ("unit_error", wid, unit_id,
                     "".join(traceback.format_exception_only(type(e), e)).strip())
                )
            # Flush per unit: the parent may terminate() this process on
            # shutdown, which skips atexit — unflushed spans would be lost.
            obs.flush()
            send(("ready", wid))
    finally:
        stop.set()
        # A cleanly stopped (or SIGTERMed) worker never leaves claims for
        # the TTL to reap — only SIGKILL can skip this.
        try:
            store.release_claims_of(owner)
        except Exception:  # pragma: no cover — best-effort on teardown
            pass
        obs.flush()


class _WorkerHandle:
    def __init__(self, wid: int, generation: int, ctx,
                 cell_root: Optional[str], hb_interval_s: float) -> None:
        self.wid = wid
        self.generation = generation
        self.owner = f"{socket.gethostname()}:w{wid}g{generation}"
        self.task_q = ctx.Queue()
        # A pipe of this incarnation's own, not a queue shared by the
        # pool: a SIGKILL that lands while a worker holds a shared
        # queue's write lock, or has written half a message, stalls
        # every other worker or the collector for good.
        self.results, writer = ctx.Pipe(duplex=False)
        self.proc = ctx.Process(
            target=_worker_main,
            args=(wid, self.owner, self.task_q, writer, cell_root, hb_interval_s),
            daemon=True,
        )
        self.last_heartbeat = time.time()
        self.current: Optional[WorkUnit] = None
        self.unit_started_at = 0.0
        self.proc.start()
        # Only the worker holds the write end now, so its death reads as
        # end-of-file here, torn message or not.
        writer.close()

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid

    def alive(self) -> bool:
        return self.proc.is_alive()


# ==========================================================================
# Scheduler
# ==========================================================================
class Scheduler:
    """Shared-queue work-stealing scheduler over a supervised worker pool.

    ``cell_store`` is where artifacts and claims live — the global cell
    store in service mode, a campaign's own store in local mode (any
    :class:`RunStore`, including in-memory for ``workers=0``).
    ``on_event`` receives every progress event (dict) from the collector
    thread — the server streams these to clients.
    """

    def __init__(
        self,
        cell_store: RunStore,
        *,
        workers: int = 2,
        config: Optional[SchedulerConfig] = None,
        on_event: Optional[Callable[[Dict[str, Any]], None]] = None,
        tenant_quotas: Optional[Dict[str, int]] = None,
    ) -> None:
        self.store = cell_store
        self.workers = max(0, workers)
        self.cfg = config or SchedulerConfig()
        self.on_event = on_event
        self.tenant_quotas = dict(tenant_quotas or {})
        # ``spawn``, not the platform's ``fork``: a parent that holds a
        # CUDA context cannot hand it to forked children.  Each spawned
        # worker sets up CUDA itself and finds the kernels already built
        # (the digest-named libraries of kernels/_build.py are published
        # with os.replace, so concurrent builders are safe).
        self._ctx = multiprocessing.get_context("spawn")
        self._lock = threading.RLock()
        self._done_cv = threading.Condition(self._lock)
        self._queue: List[WorkUnit] = []
        self._workers: Dict[int, _WorkerHandle] = {}
        self._idle: List[int] = []
        self._unit_seq = 0
        self._collector: Optional[threading.Thread] = None
        self._stopping = False
        # Accounting (all under self._lock).
        self._campaigns: Dict[str, Dict[str, Any]] = {}
        self._tenants: Dict[str, Dict[str, Any]] = {}
        self._backend_timing: Dict[str, Dict[str, Any]] = {}
        self._counters = {
            "units_submitted": 0, "units_done": 0, "units_failed": 0,
            "retries": 0, "worker_restarts": 0, "deadline_cancels": 0,
            "cells_executed": 0, "cells_deduped": 0,
        }

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "Scheduler":
        if self.workers and self._collector is None:
            for wid in range(self.workers):
                self._workers[wid] = _WorkerHandle(
                    wid, 0, self._ctx, self.store.root,
                    self.cfg.heartbeat_interval_s,
                )
            self._collector = threading.Thread(target=self._collect, daemon=True)
            self._collector.start()
        return self

    def close(self, timeout_s: float = 5.0) -> None:
        with self._lock:
            self._stopping = True
        for h in self._workers.values():
            try:
                h.task_q.put(("stop",))
            except Exception:
                pass
        for h in self._workers.values():
            h.proc.join(timeout=timeout_s)
            if h.proc.is_alive():
                h.proc.terminate()
                h.proc.join(timeout=1.0)
        if self._collector is not None:
            self._collector.join(timeout=timeout_s)
            self._collector = None
        for h in self._workers.values():
            h.results.close()
        # Claim hygiene on shutdown: workers release their own claims in
        # their ``finally``, but a worker that had to be terminate()d and
        # outran the join may not have — release by owner here, then GC
        # any artifact-backed orphans (lost-release faults, crashes
        # between publish and unlink).  A cleanly stopped scheduler
        # leaves zero claims of its own behind.
        for h in self._workers.values():
            try:
                self.store.release_claims_of(h.owner)
            except Exception:  # pragma: no cover — best-effort teardown
                pass
        try:
            self.store.sweep_stale_claims()
        except Exception:  # pragma: no cover
            pass
        obs.flush()

    # ------------------------------------------------------------- submit
    def submit(
        self,
        campaign_id: str,
        tenant: str,
        groups: Sequence[Sequence[Any]],
        *,
        priority: int = 0,
        engine_overrides: Optional[Dict[str, Any]] = None,
    ) -> int:
        """Enqueue one unit per (non-empty) engine-sharing group of
        :class:`CampaignCell`\\ s.  Returns the number of units queued."""
        units = []
        with self._lock:
            for group in groups:
                cells = list(group)
                if not cells:
                    continue
                self._unit_seq += 1
                unit = WorkUnit(
                    unit_id=f"u{self._unit_seq}",
                    campaign_id=campaign_id,
                    tenant=tenant,
                    cells=[c.to_json() for c in cells],
                    priority=priority,
                    engine_overrides=dict(engine_overrides or {}),
                )
                units.append(unit)
            state = self._campaigns.setdefault(
                campaign_id,
                {"tenant": tenant, "pending_units": 0, "executed": [],
                 "deduped": [], "errors": [], "n_cells": 0},
            )
            t = self._tenant(tenant)
            for unit in units:
                self._queue.append(unit)
                state["pending_units"] += 1
                state["n_cells"] += unit.size
                t["queued_units"] += 1
                t["submitted_cells"] += unit.size
                self._counters["units_submitted"] += 1
                self._event(
                    {"type": "unit_queued", "unit_id": unit.unit_id,
                     "campaign_id": campaign_id, "tenant": tenant,
                     "n_cells": unit.size, "priority": priority}
                )
            self._dispatch_locked()
        return len(units)

    def _tenant(self, tenant: str) -> Dict[str, Any]:
        return self._tenants.setdefault(
            tenant,
            {"queued_units": 0, "running_units": 0, "submitted_cells": 0,
             "executed_cells": 0, "deduped_cells": 0, "wall_s": 0.0},
        )

    # ---------------------------------------------------------- scheduling
    def _score(self, unit: WorkUnit, now: float) -> float:
        return (
            unit.priority * self.cfg.priority_weight
            + unit.size * self.cfg.size_weight
            + (now - unit.enqueued_at) * self.cfg.aging_rate
        )

    def _pick_unit_locked(self) -> Optional[WorkUnit]:
        """Best eligible unit under fair share, or None."""
        now = time.monotonic()
        ready = [u for u in self._queue if u.not_before <= now]
        if not ready:
            return None
        if self.cfg.fair_share and self.workers:
            running = {
                t: s["running_units"] for t, s in self._tenants.items()
            }
            active = {u.tenant for u in ready}
            default_quota = max(1, self.workers // max(1, len(active)))
            under = [
                u for u in ready
                if running.get(u.tenant, 0)
                < self.tenant_quotas.get(u.tenant, default_quota)
            ]
            # Everyone over quota (single tenant saturating the pool is
            # fine when nobody else waits): fall back to the full list.
            if under:
                ready = under
        best = max(ready, key=lambda u: self._score(u, now))
        self._queue.remove(best)
        return best

    def _dispatch_locked(self) -> None:
        while self._idle and not self._stopping:
            unit = self._pick_unit_locked()
            if unit is None:
                return
            wid = self._idle.pop(0)
            handle = self._workers[wid]
            handle.current = unit
            handle.unit_started_at = time.time()
            t = self._tenant(unit.tenant)
            t["queued_units"] -= 1
            t["running_units"] += 1
            obs.event(
                "service.queue_wait",
                unit=unit.unit_id, campaign=unit.campaign_id,
                tenant=unit.tenant, worker=wid,
                wait_s=round(time.monotonic() - unit.enqueued_at, 6),
                attempt=unit.attempts,
            )
            handle.task_q.put(
                ("unit",
                 {"unit_id": unit.unit_id, "campaign_id": unit.campaign_id,
                  "tenant": unit.tenant, "cells": unit.cells,
                  "engine_overrides": unit.engine_overrides,
                  "claim_ttl_s": self.cfg.claim_ttl_s,
                  "claim_poll_s": self.cfg.claim_poll_s})
            )

    # ------------------------------------------------------------ collector
    def _collect(self) -> None:
        # Maintenance (supervision checks + dispatch of backoff-delayed
        # units) must run on a clock, not only when the result pipes go
        # quiet: a busy pool heartbeating faster than the wait() timeout
        # would otherwise starve it — requeued units whose backoff hadn't
        # elapsed at "ready"-time were never dispatched again (livelock
        # found by the chaos harness, plan000/seed 0).
        last_maintenance = time.monotonic()
        while True:
            with self._lock:
                if self._stopping:
                    return
                handles = {h.results: h for h in self._workers.values()
                           if not h.results.closed}
            try:
                ready = multiprocessing.connection.wait(list(handles), timeout=0.2)
            except (OSError, ValueError):  # a pipe closed under us: shutdown
                ready = []
            msgs = []
            for conn in ready:
                try:
                    msgs.append((handles[conn], conn.recv()))
                except (EOFError, OSError):
                    # The worker is gone, maybe mid-message; supervision
                    # respawns it on a fresh pipe.
                    conn.close()
            now = time.monotonic()
            if not msgs or now - last_maintenance > 0.2:
                last_maintenance = now
                self._check_workers()
                with self._lock:
                    self._dispatch_locked()
            for handle, msg in msgs:
                if self._workers.get(handle.wid) is handle:
                    self._handle_message(msg)

    def _handle_message(self, msg: tuple) -> None:
        kind = msg[0]
        if kind == "heartbeat":
            _, wid, ts = msg
            h = self._workers.get(wid)
            if h is not None:
                h.last_heartbeat = ts
        elif kind == "ready":
            _, wid = msg
            with self._lock:
                h = self._workers.get(wid)
                # Guard against a replaced worker's stale "ready":
                # only a live, unassigned incarnation may go idle.
                if h is not None and h.current is None and wid not in self._idle:
                    self._idle.append(wid)
                self._dispatch_locked()
        elif kind == "event":
            _, wid, event = msg
            with self._lock:
                self._event(event)
        elif kind == "unit_done":
            _, wid, unit_id, out = msg
            self._finish_unit(wid, unit_id, out=out)
        elif kind == "unit_error":
            _, wid, unit_id, err = msg
            self._finish_unit(wid, unit_id, error=err)

    def _finish_unit(
        self, wid: int, unit_id: str,
        *, out: Optional[Dict[str, Any]] = None, error: Optional[str] = None,
    ) -> None:
        with self._lock:
            handle = self._workers.get(wid)
            unit = handle.current if handle is not None else None
            if unit is None or unit.unit_id != unit_id:
                return  # stale message from a replaced worker
            handle.current = None
            self._account_finished_locked(unit, out=out, error=error)

    def _account_finished_locked(
        self, unit: WorkUnit,
        *, out: Optional[Dict[str, Any]] = None, error: Optional[str] = None,
        was_running: bool = True,
    ) -> None:
        state = self._campaigns[unit.campaign_id]
        t = self._tenant(unit.tenant)
        if was_running:
            t["running_units"] -= 1
        if error is None and out is not None:
            state["executed"].extend(out["executed"])
            state["deduped"].extend(out["deduped"])
            t["executed_cells"] += len(out["executed"])
            t["deduped_cells"] += len(out["deduped"])
            self._counters["cells_executed"] += len(out["executed"])
            self._counters["cells_deduped"] += len(out["deduped"])
            self._counters["units_done"] += 1
            for cs in out["cells"]:
                t["wall_s"] += cs["wall_s"]
                agg = self._backend_timing.setdefault(
                    str(cs["sim_backend"]), {"cells": 0, "wall_s_total": 0.0}
                )
                agg["cells"] += 1
                agg["wall_s_total"] += cs["wall_s"]
            self._event(
                {"type": "unit_done", "unit_id": unit.unit_id,
                 "campaign_id": unit.campaign_id, "tenant": unit.tenant,
                 "executed": len(out["executed"]),
                 "deduped": len(out["deduped"])}
            )
        else:
            state["errors"].append(error or "unknown error")
            self._counters["units_failed"] += 1
            self._event(
                {"type": "unit_failed", "unit_id": unit.unit_id,
                 "campaign_id": unit.campaign_id, "tenant": unit.tenant,
                 "error": error}
            )
        state["pending_units"] -= 1
        if state["pending_units"] <= 0:
            self._done_cv.notify_all()
        self._dispatch_locked()

    # ----------------------------------------------------------- supervision
    def _check_workers(self) -> None:
        now = time.time()
        for wid, handle in list(self._workers.items()):
            dead = not handle.alive()
            hung = (
                handle.current is not None
                and now - handle.last_heartbeat > self.cfg.heartbeat_timeout_s
            )
            # Per-unit execution deadline: a unit that heartbeats happily
            # but never finishes (wedged decode, injected hang) is
            # cancelled by replacing its worker — same recovery path as a
            # death, but separately counted and announced.
            expired = (
                not dead and not hung
                and handle.current is not None
                and self.cfg.unit_deadline_s is not None
                and now - handle.unit_started_at > self.cfg.unit_deadline_s
            )
            if not dead and not hung and not expired:
                continue
            with self._lock:
                if self._stopping:
                    return
                unit = handle.current
                # Replace the worker before requeueing so the unit can't
                # land back on the corpse.
                if handle.alive():
                    handle.proc.terminate()
                old_owner = handle.owner
                handle.results.close()
                self._workers[wid] = _WorkerHandle(
                    wid, handle.generation + 1, self._ctx,
                    self.store.root, self.cfg.heartbeat_interval_s,
                )
                if wid in self._idle:
                    self._idle.remove(wid)
                self._counters["worker_restarts"] += 1
                reason = ("dead" if dead
                          else "heartbeat_timeout" if hung else "unit_deadline")
                if expired:
                    self._counters["deadline_cancels"] += 1
                    obs.event(
                        "service.unit_deadline", worker=wid,
                        unit=unit.unit_id if unit is not None else None,
                        deadline_s=self.cfg.unit_deadline_s,
                    )
                _log.warning(
                    "worker %d (%s) replaced: %s", wid, old_owner, reason
                )
                obs.event("service.worker_restart", worker=wid, reason=reason)
                self._event(
                    {"type": "worker_restart", "worker": wid, "reason": reason}
                )
                # The dead worker's claims would otherwise block everyone
                # until the TTL; release them now.
                self.store.release_claims_of(old_owner)
                if unit is not None:
                    self._tenant(unit.tenant)["running_units"] -= 1
                    unit.attempts += 1
                    if unit.attempts > self.cfg.max_retries:
                        self._account_finished_locked(
                            unit,
                            error=(f"worker died {unit.attempts} times "
                                   f"(max_retries={self.cfg.max_retries})"),
                            was_running=False,
                        )
                    else:
                        self._counters["retries"] += 1
                        obs.event(
                            "service.unit_retry", unit=unit.unit_id,
                            campaign=unit.campaign_id, tenant=unit.tenant,
                            attempt=unit.attempts,
                        )
                        unit.not_before = (
                            time.monotonic()
                            + self.cfg.backoff_base_s * 2 ** (unit.attempts - 1)
                        )
                        self._tenant(unit.tenant)["queued_units"] += 1
                        self._queue.append(unit)
                        self._event(
                            {"type": "unit_retry", "unit_id": unit.unit_id,
                             "campaign_id": unit.campaign_id,
                             "tenant": unit.tenant, "attempt": unit.attempts}
                        )
                self._dispatch_locked()

    # ---------------------------------------------------------------- events
    def _event(self, event: Dict[str, Any]) -> None:
        if self.on_event is not None:
            try:
                self.on_event(dict(event))
            except Exception:
                pass

    # ------------------------------------------------------------- waiting
    def wait(self, campaign_id: str, timeout_s: Optional[float] = None) -> bool:
        """Block until every unit of ``campaign_id`` finished (or failed).
        Inline mode (``workers=0``) executes the queue here.  Returns
        False on timeout."""
        if not self.workers:
            self._run_inline(campaign_id)
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        with self._done_cv:
            while True:
                state = self._campaigns.get(campaign_id)
                if state is None or state["pending_units"] <= 0:
                    return True
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._done_cv.wait(timeout=0.2 if remaining is None
                                   else min(0.2, remaining))

    def drain(self, timeout_s: Optional[float] = None) -> bool:
        """Wait for every submitted campaign."""
        for cid in list(self._campaigns):
            if not self.wait(cid, timeout_s=timeout_s):
                return False
        return True

    def _run_inline(self, campaign_id: str) -> None:
        """Inline execution of the queued units (workers=0): same scoring
        order, same claim/dedup code, no processes.  Exceptions propagate
        to the caller — inline mode has no supervisor to retry into."""
        owner = f"{socket.gethostname()}:inline:{os.getpid()}"
        from ..core.campaign import CampaignCell

        while True:
            with self._lock:
                unit = self._pick_unit_locked()
                if unit is None:
                    return
                t = self._tenant(unit.tenant)
                t["queued_units"] -= 1
                t["running_units"] += 1

            def emit(event, _u=unit):
                with self._lock:
                    self._event(
                        {**event, "unit_id": _u.unit_id,
                         "campaign_id": _u.campaign_id, "tenant": _u.tenant}
                    )

            try:
                out = _execute_unit(
                    [CampaignCell.from_json(d) for d in unit.cells],
                    self.store,
                    owner=owner,
                    engine_overrides=unit.engine_overrides,
                    claim_ttl_s=self.cfg.claim_ttl_s,
                    emit=emit,
                    poll_s=self.cfg.claim_poll_s,
                    attrs={"unit": unit.unit_id, "campaign": unit.campaign_id,
                           "tenant": unit.tenant, "inline": True},
                )
            except BaseException:
                with self._lock:
                    self._account_finished_locked(unit, error="inline failure")
                raise
            with self._lock:
                self._account_finished_locked(unit, out=out)

    # ------------------------------------------------------------- inspection
    def campaign_state(self, campaign_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            state = self._campaigns.get(campaign_id)
            if state is None:
                return None
            return {
                **{k: (list(v) if isinstance(v, list) else v)
                   for k, v in state.items()},
                "done": state["pending_units"] <= 0,
            }

    def worker_pids(self) -> Dict[int, Optional[int]]:
        return {wid: h.pid for wid, h in self._workers.items()}

    def queue_depth(self) -> int:
        """Units queued but not yet dispatched (the backpressure gauge)."""
        with self._lock:
            return len(self._queue)

    def metrics(self) -> Dict[str, Any]:
        with self._lock:
            now = time.time()
            executed = self._counters["cells_executed"]
            deduped = self._counters["cells_deduped"]
            total = executed + deduped
            timing = {
                k: {**v, "wall_s_mean": v["wall_s_total"] / max(v["cells"], 1)}
                for k, v in self._backend_timing.items()
            }
            return {
                "queue_depth": len(self._queue),
                "inflight": sum(
                    1 for h in self._workers.values() if h.current is not None
                ),
                "counters": dict(self._counters),
                "dedup_hit_rate": (deduped / total) if total else 0.0,
                "tenants": {t: dict(s) for t, s in self._tenants.items()},
                "backend_timing": timing,
                "workers": [
                    {
                        "worker": wid,
                        "pid": h.pid,
                        "alive": h.alive(),
                        "busy": h.current is not None,
                        "generation": h.generation,
                        "heartbeat_age_s": now - h.last_heartbeat,
                    }
                    for wid, h in sorted(self._workers.items())
                ],
                "campaigns": {
                    cid: {"pending_units": s["pending_units"],
                          "tenant": s["tenant"],
                          "executed": len(s["executed"]),
                          "deduped": len(s["deduped"]),
                          "errors": len(s["errors"])}
                    for cid, s in self._campaigns.items()
                },
            }


# ==========================================================================
def run_groups_local(
    groups: Sequence[Sequence[Any]],
    store: RunStore,
    *,
    jobs: int = 1,
    engine_overrides: Optional[Dict[str, Any]] = None,
) -> List[str]:
    """Local-mode entry used by :class:`~repro_torch.core.campaign.CampaignRunner`:
    drain one single-tenant campaign's groups through the scheduler and
    return the executed hashes.  ``jobs <= 1``, a single group, or an
    in-memory store run inline (no processes, no pickling); anything else
    gets a worker pool of ``jobs``.  Unit failures surface as a
    RuntimeError carrying the first worker error."""
    groups = [list(g) for g in groups if g]
    if not groups:
        return []
    workers = jobs if (jobs > 1 and store.root is not None and len(groups) > 1) else 0
    sched = Scheduler(store, workers=workers).start()
    try:
        sched.submit("local", "local", groups,
                     engine_overrides=engine_overrides)
        sched.wait("local")
        state = sched.campaign_state("local")
    finally:
        sched.close()
    if state["errors"]:
        raise RuntimeError(
            f"{len(state['errors'])} unit(s) failed; first error: "
            f"{state['errors'][0]}"
        )
    return list(state["executed"])
