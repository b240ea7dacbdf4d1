"""`python -m repro_torch` — the port's one entrypoint for launching,
resuming and inspecting experiments (see README "Campaign API"), with the
JAX package's subcommands, options and output.

    python -m repro_torch campaign run SPEC.json [--jobs N] [--root DIR] [--device D]
    python -m repro_torch campaign resume ID_OR_DIR [--jobs N] [--root DIR] [--device D]
    python -m repro_torch campaign report ID_OR_DIR [--root DIR] [--verify]
    python -m repro_torch campaign list [--root DIR]
    python -m repro_torch campaign serve [--host H] [--port P] [--workers N]
                                   [--service-root DIR] [--device D]
    python -m repro_torch campaign submit SPEC.json --url http://H:P
                                   [--tenant T] [--priority N]
                                   [--stream] [--no-wait]
    python -m repro_torch campaign status SUBMISSION_ID --url http://H:P
    python -m repro_torch campaign metrics --url http://H:P
    python -m repro_torch chaos run [--spec SPEC.json] [--plans N] [--seed S]
                              [--out DIR] [--workers N] [--device D]
    python -m repro_torch problem validate SPEC.json
    python -m repro_torch problem explore SPEC.json [--explorer nsga2|torch_nsga2|random_search]
                                    [--strategy Reference|MRB_Always|MRB_Explore]
                                    [--params '{"generations": 8, ...}'] [--device D]
    python -m repro_torch sim info
    python -m repro_torch sim parity [--family stencil_chain] [--batch 8] [--seed 0]
                                     [--device D]
    python -m repro_torch sim verify [--families a,b] [--sizes standard] [--decoders ...]
                               [--per-family 1] [--samples 3] [--seed 0]
                               [--harmonic] [--out report.json]
    python -m repro_torch trace export [--obs-dir DIR] [--out trace.json]
                                 [--min-cats N]
    python -m repro_torch trace summary [--obs-dir DIR] [--top N]

``--device`` (``cuda``, the default, or ``cpu``) is where every engine a
subcommand builds runs; it reaches a campaign's engines as an
``engine_overrides`` entry, outside the cells, their hashes and the
manifest, so one spec names one store on either device.  On ``campaign
serve`` and ``chaos run`` it is the server's, for every cell it runs; a
client submitting to a service cannot choose it.  ``chaos run``'s
default spec is the JAX package's CI smoke spec with ``torch_nsga2`` for
``jax_nsga2`` (``repro_torch/specs/campaign_smoke.json``).

Campaign specs are :class:`repro_torch.core.campaign.Campaign` JSON; the store
layout under ``--root`` (default ``runs/campaigns/``) is documented in
:mod:`repro_torch.core.runstore`.  ``resume``/``report`` accept either a
campaign id (directory name under the root) or a path to a store
directory, and reconstruct the campaign from its manifest — the spec file
is not needed again.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from .core.campaign import (
    Campaign,
    CampaignRunner,
    DEFAULT_CAMPAIGN_ROOT,
    build_report,
)
from .core.runstore import MANIFEST, RunStore, list_campaign_dirs

__all__ = ["main"]


# ------------------------------------------------------------------ helpers
def _resolve_store_dir(id_or_dir: str, root: str) -> str:
    if os.path.isfile(os.path.join(id_or_dir, MANIFEST)):
        return id_or_dir
    candidate = os.path.join(root, id_or_dir)
    if os.path.isfile(os.path.join(candidate, MANIFEST)):
        return candidate
    raise SystemExit(
        f"no campaign manifest under {id_or_dir!r} or {candidate!r} "
        f"(run `python -m repro_torch campaign list --root {root}`)"
    )


def _load_campaign_from_store(store_dir: str) -> Campaign:
    manifest = RunStore(store_dir).read_manifest()
    if manifest is None:
        raise SystemExit(f"unreadable manifest in {store_dir!r}")
    return Campaign.from_json(manifest["campaign"])


def _print_report_summary(report: dict) -> None:
    print(f"cells: {report['n_completed']}/{report['n_cells']} completed")
    for label, grp in sorted(report["groups"].items()):
        print(f"  group {label}: union front {len(grp['union_front'])} pts")
        for tag, hv in sorted(grp["rel_hv"].items()):
            wall = report["cells"][tag]["wall_s"]
            print(f"    {tag:48s} relHV={hv:.3f} wall={wall:.1f}s")
    for backend, agg in sorted(report["backend_timing"].items()):
        print(
            f"  backend {backend}: {agg['cells']} cells "
            f"mean={agg['wall_s_mean']:.2f}s total={agg['wall_s_total']:.2f}s"
        )
    if report["missing"]:
        print(f"  missing: {', '.join(report['missing'])}")


# ----------------------------------------------------------------- campaign
def _cmd_campaign_run(args) -> int:
    campaign = Campaign.load(args.spec)
    runner = CampaignRunner(
        campaign, root=args.root, jobs=args.jobs,
        engine_overrides={"device": args.device},
    )
    result = runner.run()
    print(
        f"campaign {campaign.campaign_id()}: "
        f"{len(result.executed)} cells executed, "
        f"{len(result.skipped)} resumed from store, "
        f"wall={result.wall_s:.1f}s"
    )
    print(f"store: {runner.store.root}")
    _print_report_summary(result.report)
    return 0


def _cmd_campaign_resume(args) -> int:
    store_dir = _resolve_store_dir(args.id, args.root)
    campaign = _load_campaign_from_store(store_dir)
    runner = CampaignRunner(
        campaign, store=RunStore(store_dir), jobs=args.jobs,
        engine_overrides={"device": args.device},
    )
    result = runner.run()
    print(
        f"campaign {campaign.campaign_id()}: "
        f"{len(result.executed)} cells executed, "
        f"{len(result.skipped)} already complete"
    )
    _print_report_summary(result.report)
    return 0


def _cmd_campaign_report(args) -> int:
    store_dir = _resolve_store_dir(args.id, args.root)
    campaign = _load_campaign_from_store(store_dir)
    store = RunStore(store_dir)
    report = build_report(
        campaign.expand(), store,
        verify=args.verify, verify_limit=args.verify_limit,
    )
    store.write_report(report)
    print(f"report: {os.path.join(store_dir, 'report.json')}")
    _print_report_summary(report)
    if args.verify:
        bad = 0
        for tag, row in sorted(report["cells"].items()):
            v = row.get("verify") or {}
            flag = "OK" if v.get("ok", True) else "VIOLATED"
            bad += 0 if v.get("ok", True) else 1
            print(
                f"  verify {tag:48s} checked={v.get('checked', 0)} "
                f"violations={v.get('violations', 0)} {flag}"
            )
        return 0 if bad == 0 else 1
    return 0


def _cmd_campaign_list(args) -> int:
    dirs = list_campaign_dirs(args.root)
    if not dirs:
        print(f"no campaigns under {args.root}")
        return 0
    for d in dirs:
        store = RunStore(d)
        manifest = store.read_manifest()
        if manifest is None:
            continue
        total = len(manifest.get("cells", []))
        done = len(store.completed())
        print(
            f"{os.path.basename(d):48s} "
            f"{manifest['campaign'].get('name', '?'):24s} {done}/{total} cells"
        )
    return 0


# ------------------------------------------------------------------ service
def _cmd_campaign_serve(args) -> int:
    from .service import DEFAULT_SERVICE_ROOT, serve
    from .service.scheduler import SchedulerConfig

    serve(
        args.service_root or DEFAULT_SERVICE_ROOT,
        host=args.host,
        port=args.port,
        workers=args.workers,
        config=SchedulerConfig(
            max_retries=args.max_retries,
            unit_deadline_s=args.unit_deadline,
        ),
        queue_high_water=args.queue_high_water,
        device=args.device,
    )
    return 0


def _cmd_campaign_submit(args) -> int:
    from .service import ServiceClient

    campaign = Campaign.load(args.spec)
    client = ServiceClient(
        args.url,
        timeout_s=args.timeout if args.timeout is not None else 30.0,
    )
    sub = client.submit(
        campaign.to_json(), tenant=args.tenant, priority=args.priority
    )
    print(
        f"submitted {sub['submission_id']}: {sub['n_cells']} cells "
        f"({sub['n_pending']} pending, {sub['n_resumed']} already stored)"
    )
    if args.stream:
        for event in client.events(sub["submission_id"]):
            bits = [event["type"]]
            if event.get("tag"):
                bits.append(event["tag"])
            if event.get("wall_s") is not None:
                bits.append(f"{event['wall_s']:.2f}s")
            print("  " + " ".join(str(b) for b in bits), flush=True)
    if args.wait or args.stream:
        status = client.wait(sub["submission_id"], timeout_s=args.timeout)
        report = status["report"]
        sched = status.get("scheduler") or {}
        if sched.get("errors"):
            print(f"FAILED: {sched['errors'][0]}", file=sys.stderr)
            return 1
        print(f"done: {report['n_completed']}/{report['n_cells']} cells")
        _print_report_summary(report)
        return 0
    return 0


def _cmd_campaign_status(args) -> int:
    from .service import ServiceClient

    status = ServiceClient(args.url).status(args.id)
    report = status["report"]
    print(
        f"{status['submission_id']}: "
        f"{'done' if status['done'] else 'running'} "
        f"({report['n_completed']}/{report['n_cells']} cells)"
    )
    _print_report_summary(report)
    return 0


def _cmd_campaign_metrics(args) -> int:
    from .service import ServiceClient

    m = ServiceClient(args.url).metrics()
    print(json.dumps(m, indent=2, sort_keys=True))
    return 0


# -------------------------------------------------------------------- chaos
def _cmd_chaos_run(args) -> int:
    from .faults.chaos import chaos_run

    report = chaos_run(
        args.spec,
        plans=args.plans,
        seed=args.seed,
        out_root=args.out,
        workers=args.workers,
        wait_timeout_s=args.timeout,
        device=args.device,
    )
    return 0 if report["ok"] else 1


# ------------------------------------------------------------------ problem
def _cmd_problem_validate(args) -> int:
    import hashlib

    from .core.problem import ExplorationProblem
    from .core.runstore import canonical_json

    with open(args.spec) as f:
        d = json.load(f)
    problem = ExplorationProblem.from_json(d)
    rt = ExplorationProblem.from_json(problem.to_json())
    ok = rt.to_json() == problem.to_json()
    digest = hashlib.sha256(canonical_json(problem.to_json()).encode()).hexdigest()
    print(f"problem: {problem.name}")
    print(f"objectives: {', '.join(problem.objectives)}")
    print(f"actors={len(problem.graph.actors)} channels={len(problem.graph.channels)} "
          f"cores={len(problem.arch.cores)}")
    print(f"canonical hash: {digest}")
    print(f"round-trip: {'OK' if ok else 'MISMATCH'}")
    return 0 if ok else 1


def _cmd_problem_explore(args) -> int:
    from .core.explorers import get_explorer
    from .core.problem import ExplorationProblem

    with open(args.spec) as f:
        spec = json.load(f)
    if getattr(args, "strategy", ""):
        spec["strategy"] = args.strategy
    problem = ExplorationProblem.from_json(spec)
    params = json.loads(args.params) if args.params else {}
    explorer = get_explorer(args.explorer, **params)
    with problem.make_engine(device=args.device) as engine:
        run = explorer.explore(problem, engine=engine)
    path = run.save(out_dir=args.out)
    print(
        f"{problem.name}: front={len(run.front)} pts "
        f"decodes={run.evaluations} wall={run.wall_s:.1f}s"
    )
    for p in run.front:
        print("  " + " ".join(f"{v:g}" for v in p))
    print(f"saved -> {path}")
    return 0


# ---------------------------------------------------------------------- sim
def _cmd_sim_info(args) -> int:
    import torch

    from . import sim
    from .core.engine import AUTO_MIN_BATCH, SIM_BACKENDS

    print(f"simulation enabled: {sim.simulation_enabled()}")
    print(f"engine sim_backend values: {SIM_BACKENDS}")
    print(f"batched backends: {sim.BATCH_BACKENDS}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            major, minor = torch.cuda.get_device_capability(i)
            print(
                f"cuda:{i}: {torch.cuda.get_device_name(i)}, "
                f"capability {major}.{minor}"
            )
    else:
        print("cuda: no device (pass --device cpu to the engine commands)")
    print(
        f"auto selection: events below batch {AUTO_MIN_BATCH}; "
        f"cuda on a CUDA engine, torch on a CPU engine"
    )
    return 0


def _cmd_sim_parity(args) -> int:
    """Tiny doctor command: decode a seeded batch on a generated scenario
    and assert the event simulator, the plain torch program and the CUDA
    kernel (its plain version on ``--device cpu``) measure identical
    periods."""
    import random
    import time

    from .core.dse import GenotypeSpace, evaluate_genotype
    from .core.problem import ExplorationProblem
    from .scenarios import sample_scenarios
    from .sim import SimConfig, batch_simulate_periods, simulate_period

    sc = sample_scenarios(seed=args.seed, n=1, families=[args.family])[0]
    problem = ExplorationProblem.from_scenario(sc, strategy="MRB_Always")
    space = GenotypeSpace(problem.graph, problem.arch)
    rng = random.Random(args.seed)
    scheds = []
    tries = 0
    while len(scheds) < args.batch and tries < args.batch * 50:
        tries += 1
        ind = evaluate_genotype(space, space.force_xi(space.random(rng), 1))
        if ind.feasible and ind.schedule is not None:
            scheds.append(ind.schedule)
    if not scheds:
        raise SystemExit(f"no feasible phenotypes drawn for {sc.name}")
    from .core.dse import transformed_graph

    gt = transformed_graph(space, tuple(1 for _ in space.mcast), True)
    cfg = SimConfig(trace=False)
    timings = {}
    t0 = time.monotonic()
    ev = [simulate_period(gt, problem.arch, s, cfg) for s in scheds]
    timings["events"] = time.monotonic() - t0
    periods = {"events": ev}
    for backend in ("torch", "cuda"):
        t0 = time.monotonic()
        periods[backend] = batch_simulate_periods(
            gt, problem.arch, scheds, cfg, backend=backend, device=args.device
        )
        timings[backend] = time.monotonic() - t0
    ok = periods["events"] == periods["torch"] == periods["cuda"]
    print(f"scenario {sc.name}: {len(scheds)} phenotypes on {args.device}")
    for backend, wall in timings.items():
        print(f"  {backend:12s} wall={wall:.3f}s")
    print(f"periods identical across backends: {'OK' if ok else 'DIVERGED'}")
    return 0 if ok else 1


def _cmd_sim_verify(args) -> int:
    """Decoder conformance sweep: decode random genotypes per scenario and
    run every feasible schedule through the independent verifier; exit 1 on
    any violation (see README "Schedule verification")."""
    from .verify import differential_sweep

    families = [f for f in (args.families or "").split(",") if f] or None
    sizes = tuple(s for s in args.sizes.split(",") if s)
    decoders = tuple(d for d in args.decoders.split(",") if d)
    report = differential_sweep(
        seed=args.seed,
        families=families,
        sizes=sizes,
        per_family=args.per_family,
        samples=args.samples,
        decoders=decoders,
        ilp_budget_s=args.ilp_budget_s,
        harmonic=args.harmonic,
    )
    for row in report["rows"]:
        flag = "OK" if row["n_violations"] == 0 else "VIOLATED"
        print(
            f"  {row['scenario']:40s} {row['decoder']:10s} "
            f"checked={row['checked']} feasible={row['feasible']} "
            f"violations={row['n_violations']} {flag}"
        )
    print(
        f"sweep: {report['n_checked']} schedules checked, "
        f"{report['n_violations']} violations -> "
        f"{'OK' if report['ok'] else 'FAILED'}"
    )
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
        print(f"report -> {args.out}")
    return 0 if report["ok"] else 1


# -------------------------------------------------------------------- trace
def _cmd_trace_export(args) -> int:
    """Merge the REPRO_OBS sinks into one Chrome-trace/Perfetto JSON."""
    from . import obs

    obs_dir = args.obs_dir or obs.default_obs_dir()
    out = args.out or os.path.join(obs_dir, "trace.json")
    trace = obs.export_chrome_trace(obs_dir, out)
    info = obs.validate_chrome_trace(trace)
    if not info["events"]:
        raise RuntimeError(
            f"no telemetry records under {obs_dir!r} "
            f"(run with REPRO_OBS=1, or pass --obs-dir)"
        )
    print(
        f"trace -> {out}: {info['events']} events, {info['spans']} spans, "
        f"{len(info['pids'])} process(es), "
        f"subsystems: {', '.join(info['cats'])}"
    )
    if args.min_cats and len(info["cats"]) < args.min_cats:
        print(
            f"repro_torch: trace export: only {len(info['cats'])} subsystem(s) "
            f"({', '.join(info['cats'])}), expected >= {args.min_cats}",
            file=sys.stderr,
        )
        return 1
    return 0


def _cmd_trace_summary(args) -> int:
    """Aggregate recorded spans into a per-name self-time table."""
    from . import obs

    obs_dir = args.obs_dir or obs.default_obs_dir()
    summary = obs.summarize(obs_dir)
    if not summary["spans"] and not summary["counters"]:
        raise RuntimeError(
            f"no telemetry records under {obs_dir!r} "
            f"(run with REPRO_OBS=1, or pass --obs-dir)"
        )
    print(obs.format_summary(summary, top=args.top))
    return 0


# --------------------------------------------------------------------- main
def main(argv: Optional[List[str]] = None) -> int:
    from .faults.chaos import DEFAULT_SPEC

    ap = argparse.ArgumentParser(prog="repro_torch", description=__doc__)

    def device_arg(p) -> None:
        p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                       help="where the engines run (default: the card)")

    sub = ap.add_subparsers(dest="cmd", required=True)

    camp = sub.add_parser("campaign", help="declarative multi-problem DSE sweeps")
    csub = camp.add_subparsers(dest="action", required=True)
    p = csub.add_parser("run", help="execute a campaign spec (resumes a matching store)")
    p.add_argument("spec", help="Campaign JSON file")
    p.add_argument("--jobs", type=int, default=1, help="process-pool width over cell groups")
    p.add_argument("--root", default=DEFAULT_CAMPAIGN_ROOT)
    device_arg(p)
    p.set_defaults(fn=_cmd_campaign_run)
    p = csub.add_parser("resume", help="finish a killed campaign from its store")
    p.add_argument("id", help="campaign id under --root, or a store directory path")
    p.add_argument("--jobs", type=int, default=1)
    p.add_argument("--root", default=DEFAULT_CAMPAIGN_ROOT)
    device_arg(p)
    p.set_defaults(fn=_cmd_campaign_resume)
    p = csub.add_parser("report", help="rebuild and print the cross-cell report")
    p.add_argument("id")
    p.add_argument("--root", default=DEFAULT_CAMPAIGN_ROOT)
    p.add_argument("--verify", action="store_true",
                   help="re-decode archived genotypes through the schedule verifier")
    p.add_argument("--verify-limit", type=int, default=3, dest="verify_limit",
                   help="archived genotypes re-checked per cell")
    p.set_defaults(fn=_cmd_campaign_report)
    p = csub.add_parser("list", help="list campaign stores")
    p.add_argument("--root", default=DEFAULT_CAMPAIGN_ROOT)
    p.set_defaults(fn=_cmd_campaign_list)
    p = csub.add_parser("serve", help="run the multi-tenant campaign service")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8321)
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--max-retries", type=int, default=2, dest="max_retries",
                   help="per-unit retries after worker death")
    p.add_argument("--unit-deadline", type=float, default=None,
                   dest="unit_deadline",
                   help="cancel any unit attempt running longer than this "
                        "many seconds (default: no deadline)")
    p.add_argument("--queue-high-water", type=int, default=None,
                   dest="queue_high_water",
                   help="reject submissions with 429 + Retry-After while "
                        "this many units are queued (default: unbounded)")
    p.add_argument("--service-root", default=None, dest="service_root",
                   help="service store root (default runs/service)")
    device_arg(p)
    p.set_defaults(fn=_cmd_campaign_serve)
    p = csub.add_parser("submit", help="submit a campaign spec to a served instance")
    p.add_argument("spec", help="Campaign JSON file")
    p.add_argument("--url", required=True, help="service base URL")
    p.add_argument("--tenant", default="default")
    p.add_argument("--priority", type=int, default=0)
    p.add_argument("--stream", action="store_true",
                   help="stream per-cell progress events")
    p.add_argument("--no-wait", dest="wait", action="store_false",
                   help="return right after submission")
    p.add_argument("--timeout", type=float, default=None,
                   help="max seconds to wait for completion")
    p.set_defaults(fn=_cmd_campaign_submit, wait=True)
    p = csub.add_parser("status", help="incremental report of a served submission")
    p.add_argument("id", help="submission id (tenant--campaign_id)")
    p.add_argument("--url", required=True)
    p.set_defaults(fn=_cmd_campaign_status)
    p = csub.add_parser("metrics", help="live service metrics (queue, dedup, tenants)")
    p.add_argument("--url", required=True)
    p.set_defaults(fn=_cmd_campaign_metrics)

    ch = sub.add_parser("chaos", help="deterministic fault-injection sweeps")
    chsub = ch.add_subparsers(dest="action", required=True)
    p = chsub.add_parser(
        "run",
        help="N seeded fault plans over a campaign + convergence checker",
    )
    p.add_argument("--spec", default=DEFAULT_SPEC,
                   help="campaign spec to chaos-test (default: the CI smoke "
                        "spec with torch_nsga2)")
    p.add_argument("--plans", type=int, default=20, help="fault plans to sweep")
    p.add_argument("--seed", type=int, default=0,
                   help="plan-generation seed (same seed, same plans)")
    p.add_argument("--out", default=os.path.join("runs", "chaos"),
                   help="scratch root for stores + the convergence report")
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--timeout", type=float, default=120.0,
                   help="per-phase wait timeout in seconds")
    device_arg(p)
    p.set_defaults(fn=_cmd_chaos_run)

    prob = sub.add_parser("problem", help="single ExplorationProblem utilities")
    psub = prob.add_subparsers(dest="action", required=True)
    p = psub.add_parser("validate", help="round-trip + canonical-hash a problem spec")
    p.add_argument("spec")
    p.set_defaults(fn=_cmd_problem_validate)
    p = psub.add_parser("explore", help="run one exploration, save the run JSON")
    p.add_argument("spec")
    p.add_argument("--explorer", default="nsga2")
    p.add_argument(
        "--strategy",
        default="",
        help="override the spec's MRB strategy (Reference/MRB_Always/MRB_Explore)",
    )
    p.add_argument("--params", default="", help="explorer kwargs as JSON")
    p.add_argument("--out", default="runs")
    device_arg(p)
    p.set_defaults(fn=_cmd_problem_explore)

    simp = sub.add_parser("sim", help="simulator utilities")
    ssub = simp.add_subparsers(dest="action", required=True)
    p = ssub.add_parser("info", help="backends, platform, auto-selection thresholds")
    p.set_defaults(fn=_cmd_sim_info)
    p = ssub.add_parser("parity", help="assert backend parity on a seeded batch")
    p.add_argument("--family", default="stencil_chain")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    device_arg(p)
    p.set_defaults(fn=_cmd_sim_parity)
    p = ssub.add_parser(
        "verify", help="decoder conformance sweep through the schedule verifier"
    )
    p.add_argument("--families", default="", help="comma list; default: all")
    p.add_argument("--sizes", default="standard", help="comma list of size tiers")
    p.add_argument("--decoders", default="caps_hms,ilp", help="comma list")
    p.add_argument("--per-family", type=int, default=1, dest="per_family")
    p.add_argument("--samples", type=int, default=3, help="genotypes per scenario")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ilp-budget-s", type=float, default=1.0, dest="ilp_budget_s")
    p.add_argument("--harmonic", action="store_true",
                   help="harmonize scenarios (pow2 times, uniform tokens)")
    p.add_argument("--out", default="", help="write the JSON report here")
    p.set_defaults(fn=_cmd_sim_verify)

    tr = sub.add_parser("trace", help="telemetry (REPRO_OBS) trace tooling")
    tsub = tr.add_subparsers(dest="action", required=True)
    p = tsub.add_parser(
        "export", help="merge obs sinks into one Chrome-trace/Perfetto JSON"
    )
    p.add_argument("--obs-dir", default="", dest="obs_dir",
                   help="sink directory (default: the REPRO_OBS selection)")
    p.add_argument("--out", default="", help="output path (default: <obs-dir>/trace.json)")
    p.add_argument("--min-cats", type=int, default=0, dest="min_cats",
                   help="fail unless spans from at least N subsystems are present")
    p.set_defaults(fn=_cmd_trace_export)
    p = tsub.add_parser("summary", help="aggregate spans into a self-time table")
    p.add_argument("--obs-dir", default="", dest="obs_dir")
    p.add_argument("--top", type=int, default=0, help="show only the top N spans")
    p.set_defaults(fn=_cmd_trace_summary)

    args = ap.parse_args(argv)
    from .service.client import ServiceError

    try:
        return args.fn(args)
    except KeyboardInterrupt:
        return 130
    except ServiceError as e:
        # Retryable service failures (queue saturation 429, connection
        # loss, 5xx after exhausted retries) get their own exit code so
        # schedulers/scripts know a later resubmission can succeed.
        print(f"repro_torch: error: {e}", file=sys.stderr)
        return 3 if e.retryable else 2
    except TimeoutError as e:
        print(f"repro_torch: error: {e}", file=sys.stderr)
        return 3
    except (OSError, ValueError, KeyError, RuntimeError) as e:
        # Expected operational failures (bad spec file, malformed JSON,
        # unknown registry name, unreachable service) get a one-line
        # diagnostic instead of a traceback; genuine bugs still raise.
        msg = e.args[0] if isinstance(e, KeyError) and e.args else e
        print(f"repro_torch: error: {msg}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
