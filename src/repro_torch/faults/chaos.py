"""Chaos harness: seeded fault plans + the convergence checker.

``python -m repro_torch chaos run`` drives N seeded :class:`FaultPlan`\\ s
over a reference campaign through the *served* stack (HTTP server, worker
pool, shared store — all three injection-site classes in one run), every
server's cells on one ``device`` (the card unless the caller passes
``"cpu"``):

1. **reference** — one fault-free served run (two tenants submitting the
   same campaign, exercising cross-tenant dedup) pins the expected
   manifest bytes and wall-stripped reports;
2. per plan, a **faulty phase** — the plan armed via ``REPRO_FAULTS``
   (worker processes inherit the environment), submissions best-effort:
   crashes, hangs, torn writes, lost releases, resets are the point;
3. a **heal phase** — faults disarmed, a fresh server over the *same*
   store, idempotent resubmission of both tenants; resume must finish
   every missing cell;
4. the **convergence check** — byte-identical manifests, reports
   identical to the reference after stripping physical wall times,
   every unique cell hash exactly once in the success log, zero claims
   left in the store, and (across the sweep) at least one fired fault
   per site class (``store``, ``sched``, ``http``).

Everything is derived from ``--seed``: the same seed generates the same
plans (serialised byte for byte as the JAX package's), making any
convergence failure replayable with ``--plans`` narrowed to the offending
index.  The supervision timings of :func:`_chaos_scheduler_config` are the
JAX package's; they are part of what a sweep proves.
"""
from __future__ import annotations

import json
import os
import random
import shutil
import threading
import time
from typing import Any, Dict, List, Sequence, Tuple

from .injector import FAULTS_ENV, FaultPlan, FaultRule, read_fired_log
from . import injector

__all__ = ["generate_plans", "chaos_run", "SITE_CLASSES", "DEFAULT_SPEC"]

#: The port's default campaign: the JAX package's CI smoke spec with the
#: device explorer ``torch_nsga2`` in place of ``jax_nsga2``.
DEFAULT_SPEC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "specs", "campaign_smoke.json",
)

#: Site-class coverage the sweep must prove (prefix of the site name).
SITE_CLASSES = ("store", "sched", "http")

#: Fault catalog: (site, kind, rule overrides).  Split by the process
#: context the site runs in — crash/hang kinds are only safe where the
#: caller is a supervised worker; server/driver-context sites get
#: survivable kinds only (the harness must outlive its own faults).
WORKER_STORE_FAULTS: List[Tuple[str, str, Dict[str, Any]]] = [
    ("store.save_cell", "torn", {}),
    ("store.save_cell", "lost", {}),
    ("store.save_cell", "crash", {}),
    ("store.save_cell", "slow", {"delay_s": 0.2}),
    ("store.load_cell", "slow", {"delay_s": 0.1, "max_fires": 3}),
    ("store.release_claim", "lost", {"max_fires": 2}),
]
SCHED_FAULTS: List[Tuple[str, str, Dict[str, Any]]] = [
    ("sched.pre_claim", "crash", {}),
    ("sched.mid_decode", "crash", {}),
    ("sched.mid_decode", "hang", {"delay_s": 30.0}),
    ("sched.pre_publish", "crash", {}),
    ("sched.pre_publish", "hang", {"delay_s": 30.0}),
    ("sched.heartbeat", "skip", {"max_fires": 40}),
]
HTTP_FAULTS: List[Tuple[str, str, Dict[str, Any]]] = [
    ("http.request", "reset", {"max_fires": 2}),
    ("http.request", "error_5xx", {"max_fires": 2}),
    ("http.request", "slow", {"delay_s": 0.3, "max_fires": 2}),
    ("http.client", "reset", {"max_fires": 2}),
]
SERVER_STORE_FAULTS: List[Tuple[str, str, Dict[str, Any]]] = [
    ("store.write_manifest", "corrupt", {"max_fires": 1}),
]

#: Keys stripped before report comparison: wall-clock measurements are
#: physically nondeterministic; everything else must match bit-for-bit.
_WALL_KEYS = frozenset({"wall_s", "wall_s_total", "wall_s_mean"})


# ==========================================================================
# Plan generation
# ==========================================================================
def _make_rule(entry: Tuple[str, str, Dict[str, Any]], rng: random.Random) -> FaultRule:
    site, kind, over = entry
    return FaultRule(
        site=site,
        kind=kind,
        p=over.get("p", rng.choice([1.0, 1.0, 0.75])),
        max_fires=over.get("max_fires", 1),
        delay_s=over.get("delay_s", 0.05),
    )


def generate_plans(n: int, seed: int) -> List[FaultPlan]:
    """``n`` deterministic plans.  Every plan carries at least one rule
    per site class (store/sched/http), so any single plan already
    exercises all three layers; extras add variety."""
    plans: List[FaultPlan] = []
    for i in range(n):
        rng = random.Random(f"chaos:{seed}:{i}")
        entries = [
            rng.choice(WORKER_STORE_FAULTS + SERVER_STORE_FAULTS),
            rng.choice(SCHED_FAULTS),
            rng.choice(HTTP_FAULTS),
        ]
        pool = (WORKER_STORE_FAULTS + SCHED_FAULTS + HTTP_FAULTS
                + SERVER_STORE_FAULTS)
        for _ in range(rng.randint(0, 2)):
            extra = rng.choice(pool)
            if extra not in entries:
                entries.append(extra)
        plans.append(
            FaultPlan(
                seed=seed * 10_000 + i,
                name=f"plan{i:03d}",
                rules=[_make_rule(e, rng) for e in entries],
            )
        )
    return plans


# ==========================================================================
# Served phases
# ==========================================================================
def _chaos_scheduler_config():
    from ..service.scheduler import SchedulerConfig

    # Tight supervision so injected crashes/hangs recover in seconds:
    # heartbeats at 10Hz, dead workers noticed within 3s, hung units
    # cancelled at 6s, stale claims taken over after 2s.
    return SchedulerConfig(
        heartbeat_interval_s=0.1,
        heartbeat_timeout_s=3.0,
        claim_ttl_s=2.0,
        unit_deadline_s=6.0,
        max_retries=4,
        backoff_base_s=0.05,
        claim_poll_s=0.02,
    )


def _run_served(
    spec: Dict[str, Any],
    root: str,
    *,
    workers: int,
    tenants: Sequence[str],
    best_effort: bool,
    wait_timeout_s: float,
    device: str = "cuda",
) -> Dict[str, Any]:
    """One served pass: start a server over ``root``, submit the spec as
    every tenant, wait for completion.  ``best_effort`` swallows
    per-tenant failures (the faulty phase *should* break things) and
    records them instead."""
    from ..service.client import ServiceClient, ServiceError
    from ..service.server import make_server

    server, service = make_server(
        root, workers=workers, config=_chaos_scheduler_config(), device=device
    )
    threading.Thread(
        target=server.serve_forever, kwargs={"poll_interval": 0.05}, daemon=True
    ).start()
    host, port = server.server_address[:2]
    client = ServiceClient(
        f"http://{host}:{port}",
        timeout_s=15.0, retries=5, backoff_base_s=0.1, backoff_max_s=1.0,
    )
    out: Dict[str, Any] = {"submitted": {}, "errors": [], "done": {},
                           "worker_restarts": 0}
    try:
        for tenant in tenants:
            try:
                sub = client.submit(spec, tenant=tenant)
                out["submitted"][tenant] = sub["submission_id"]
            except (ServiceError, TimeoutError) as e:
                out["errors"].append(f"{tenant}: submit failed: {e}")
                if not best_effort:
                    raise
        for tenant, sid in out["submitted"].items():
            try:
                status = client.wait(sid, timeout_s=wait_timeout_s)
                out["done"][tenant] = bool(status["done"])
                if not status["done"]:
                    sched = status.get("scheduler") or {}
                    out["errors"].append(
                        f"{tenant}: incomplete "
                        f"(errors={ (sched.get('errors') or [''])[:1] })"
                    )
            except (ServiceError, TimeoutError) as e:
                out["errors"].append(f"{tenant}: wait failed: {e}")
                if not best_effort:
                    raise
    finally:
        server.shutdown()
        server.server_close()
        service.close()
    out["worker_restarts"] = service.metrics()["counters"]["worker_restarts"]
    return out


def _strip_walls(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _strip_walls(v) for k, v in obj.items() if k not in _WALL_KEYS}
    if isinstance(obj, list):
        return [_strip_walls(v) for v in obj]
    return obj


def _collect_outputs(
    spec: Dict[str, Any], root: str, tenants: Sequence[str]
) -> Dict[str, Any]:
    """Post-run ground truth straight from the store files: per-tenant
    manifest bytes and the canonical wall-stripped report."""
    from ..core.campaign import Campaign, build_report
    from ..core.runstore import canonical_json
    from ..service.store import GlobalStore

    campaign = Campaign.from_json(spec)
    cells = campaign.expand()
    store = GlobalStore(root)
    out: Dict[str, Any] = {"manifests": {}, "reports": {}}
    for tenant in tenants:
        sid = f"{tenant}--{campaign.campaign_id()}"
        view = store.view(sid)
        try:
            with open(os.path.join(view.root, "manifest.json"), "rb") as f:
                out["manifests"][tenant] = f.read()
        except OSError:
            out["manifests"][tenant] = b""
        report = build_report(cells, view)
        out["reports"][tenant] = canonical_json(_strip_walls(report))
    out["cell_hashes"] = sorted({c.spec_hash() for c in cells})
    return out


# ==========================================================================
# Convergence checking
# ==========================================================================
def _check_plan(
    reference: Dict[str, Any],
    healed: Dict[str, Any],
    heal_outcome: Dict[str, Any],
    root: str,
    tenants: Sequence[str],
) -> List[str]:
    """Invariant violations for one plan (empty list == converged)."""
    from ..service.store import GLOBAL_DIR
    from ..core.runstore import CLAIM_DIR, RunStore

    violations: List[str] = []
    if heal_outcome["errors"]:
        violations.extend(f"heal: {e}" for e in heal_outcome["errors"])
    for tenant in tenants:
        ref_m = reference["manifests"].get(tenant)
        got_m = healed["manifests"].get(tenant)
        if got_m != ref_m:
            violations.append(
                f"{tenant}: manifest differs from fault-free run "
                f"({len(got_m or b'')}B vs {len(ref_m or b'')}B)"
            )
        if healed["reports"].get(tenant) != reference["reports"].get(tenant):
            violations.append(
                f"{tenant}: report differs from fault-free run"
            )
    # Exactly-once decode: every unique cell hash has exactly one
    # success-log line (publish_cell appends under the store lock; a
    # crash before publish leaves no line, a discarded duplicate decode
    # never appends).
    cells_store = RunStore(os.path.join(root, GLOBAL_DIR))
    counts: Dict[str, int] = {}
    for rec in cells_store.success_log():
        counts[rec.get("spec", "?")] = counts.get(rec.get("spec", "?"), 0) + 1
    for h in healed["cell_hashes"]:
        n = counts.get(h, 0)
        if n != 1:
            violations.append(f"cell {h[:12]} decoded {n} times (expected 1)")
    for h, n in counts.items():
        if h not in healed["cell_hashes"]:
            violations.append(f"success log names unknown cell {h[:12]}")
    # Zero orphan claims.
    claims_dir = os.path.join(root, GLOBAL_DIR, CLAIM_DIR)
    try:
        leftovers = [n for n in os.listdir(claims_dir) if n.endswith(".claim")]
    except OSError:
        leftovers = []
    if leftovers:
        violations.append(f"{len(leftovers)} orphan claim(s): {leftovers[:4]}")
    return violations


# ==========================================================================
# Driver
# ==========================================================================
def chaos_run(
    spec_path: str,
    *,
    plans: int = 20,
    seed: int = 0,
    out_root: str = os.path.join("runs", "chaos"),
    workers: int = 2,
    tenants: Sequence[str] = ("alice", "bob"),
    wait_timeout_s: float = 120.0,
    log=print,
    device: str = "cuda",
) -> Dict[str, Any]:
    """Run the full sweep; returns the convergence report (also written
    to ``<out_root>/chaos_report.json``).  ``report["ok"]`` is the gate.
    Every server of the sweep runs its cells on ``device``; the report
    records it, with each plan's faulty and heal seconds and the worker
    respawns the faults caused."""
    with open(spec_path) as f:
        spec = json.load(f)

    _prepare_out_root(out_root)
    os.environ.pop(FAULTS_ENV, None)
    injector.reset()

    t0 = time.monotonic()
    log(f"chaos: reference run (fault-free, tenants={','.join(tenants)})")
    ref_root = os.path.join(out_root, "reference")
    ref_outcome = _run_served(
        spec, ref_root, workers=workers, tenants=tenants,
        best_effort=False, wait_timeout_s=wait_timeout_s, device=device,
    )
    if ref_outcome["errors"]:
        raise RuntimeError(
            f"fault-free reference run failed: {ref_outcome['errors'][0]}"
        )
    reference = _collect_outputs(spec, ref_root, tenants)

    plan_objs = generate_plans(plans, seed)
    results: List[Dict[str, Any]] = []
    fired_sites_all: List[str] = []
    for i, plan in enumerate(plan_objs):
        plan_root = os.path.join(out_root, plan.name)
        store_root = os.path.join(plan_root, "store")
        plan.fired_log = os.path.join(plan_root, "faults_fired.jsonl")
        plan_path = plan.save(os.path.join(plan_root, "fault_plan.json"))

        os.environ[FAULTS_ENV] = plan_path
        injector.reset()
        t_plan = time.monotonic()
        try:
            faulty = _run_served(
                spec, store_root, workers=workers, tenants=tenants,
                best_effort=True, wait_timeout_s=wait_timeout_s, device=device,
            )
        finally:
            os.environ.pop(FAULTS_ENV, None)
            injector.reset()
        t_faulty = time.monotonic() - t_plan

        t_heal0 = time.monotonic()
        heal = _run_served(
            spec, store_root, workers=workers, tenants=tenants,
            best_effort=True, wait_timeout_s=wait_timeout_s, device=device,
        )
        t_heal = time.monotonic() - t_heal0
        healed = _collect_outputs(spec, store_root, tenants)
        violations = _check_plan(reference, healed, heal, store_root, tenants)
        fired = read_fired_log(plan.fired_log)
        fired_sites = sorted({r["site"] for r in fired})
        fired_sites_all.extend(fired_sites)
        results.append(
            {
                "plan": plan.name,
                "seed": plan.seed,
                "rules": [r.to_json() for r in plan.rules],
                "n_fired": len(fired),
                "fired_sites": fired_sites,
                "faulty_errors": faulty["errors"],
                "violations": violations,
                "faulty_s": t_faulty,
                "heal_s": t_heal,
                "worker_restarts": {"faulty": faulty["worker_restarts"],
                                    "heal": heal["worker_restarts"]},
            }
        )
        status = "CONVERGED" if not violations else "VIOLATED"
        log(
            f"chaos: {plan.name}: {len(fired)} fault(s) fired "
            f"[{', '.join(fired_sites) or 'none'}] -> {status} "
            f"(faulty {t_faulty:.1f}s, heal {t_heal:.1f}s, "
            f"worker respawns {faulty['worker_restarts']}+{heal['worker_restarts']})"
        )
        for v in violations:
            log(f"chaos:   violation: {v}")

    coverage = {
        cls: any(s.startswith(cls + ".") for s in fired_sites_all)
        for cls in SITE_CLASSES
    }
    coverage_gaps = [cls for cls, hit in coverage.items() if not hit]
    n_violations = sum(len(r["violations"]) for r in results)
    report = {
        "spec": spec_path,
        "seed": seed,
        "plans": len(plan_objs),
        "tenants": list(tenants),
        "workers": workers,
        "device": device,
        "results": results,
        "site_class_coverage": coverage,
        "n_violations": n_violations,
        "ok": n_violations == 0 and not coverage_gaps,
        "wall_s": round(time.monotonic() - t0, 3),
    }
    report_path = os.path.join(out_root, "chaos_report.json")
    with open(report_path, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
        f.write("\n")
    log(
        f"chaos: {len(plan_objs)} plan(s), {n_violations} violation(s), "
        f"coverage={{{', '.join(f'{k}:{v}' for k, v in coverage.items())}}} "
        f"in {report['wall_s']:.1f}s -> {report_path}"
    )
    if coverage_gaps:
        log(f"chaos: NO faults fired for site class(es): {coverage_gaps}")
    return report


def _prepare_out_root(out_root: str) -> None:
    """Chaos output roots are scratch: reuse would make resumed artifacts
    mask real decodes.  Wipe only a directory we recognize as chaos
    output (or an empty one); anything else is refused, not deleted."""
    if not os.path.exists(out_root):
        os.makedirs(out_root, exist_ok=True)
        return
    entries = os.listdir(out_root)
    recognized = (
        not entries
        or "chaos_report.json" in entries
        or "reference" in entries
    )
    if not recognized:
        raise RuntimeError(
            f"chaos out root {out_root!r} exists and does not look like "
            f"chaos output — refusing to wipe it; pass a fresh --out"
        )
    for name in entries:
        path = os.path.join(out_root, name)
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        else:
            try:
                os.unlink(path)
            except OSError:
                pass
