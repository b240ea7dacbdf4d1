"""The port's telemetry layer against the JAX package's
(``tests/test_obs.py``): the record format, the Perfetto export and the
self-time summary of the same sinks through both packages' ``trace.py``,
the Prometheus text of the same metrics, the trace CLI, and the spans and
counters the port's engine, explorers, device explorer and simulator
record under the reference's names.

Recording is turned on only through the port's ``obs.configure(True, dir)``
inside a test, and off again after it; only the port runs while it is on.
"""
import json
import time

import pytest
import torch

from conftest import tiny_campaign
from repro import obs as ref_obs
from repro_torch import obs
from repro_torch.cli import main as cli_main
from repro_torch.core import (
    Campaign,
    ExplorationProblem,
    RunStore,
    get_explorer,
    paper_architecture,
    sobel,
)
from repro_torch.service import Scheduler, SchedulerConfig


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def rec(tmp_path, monkeypatch):
    """Port recording on, into a per-test sink directory; off after."""
    d = str(tmp_path / "obs")
    monkeypatch.delenv(obs.OBS_ENV, raising=False)
    monkeypatch.setenv(obs.OBS_DIR_ENV, d)  # restored by monkeypatch
    obs.configure(True, d)
    yield d
    obs.shutdown()
    obs.configure(None)


def _spans(summary):
    return {row["name"]: row for row in summary["spans"]}


def _records(d):
    out = {}
    for r in obs.iter_records(d):
        out.setdefault(r["t"], []).append(r)
    return out


# ================================================================= recorder
def test_recorder_roundtrip_spans_events_counters(rec):
    assert obs.enabled()
    with obs.span("outer.work", label="a") as sp:
        with obs.span("outer.inner"):
            time.sleep(0.01)
        sp.set(extra=7)
    obs.event("outer.marker", k="v")
    obs.counter_add("outer.hits", 2)
    obs.counter_add("outer.hits", 3)
    obs.flush()

    by_kind = _records(rec)
    (meta,) = by_kind["meta"]
    assert set(meta) == {"t", "pid", "host", "proc", "epoch_ns", "argv", "file"}
    assert meta["pid"] > 0 and meta["epoch_ns"] > 0 and meta["host"]
    spans = {r["name"]: r for r in by_kind["span"]}
    assert set(spans["outer.work"]) == {"t", "name", "cat", "ts", "dur", "tid", "attrs", "file"}
    assert spans["outer.work"]["attrs"] == {"label": "a", "extra": 7}
    assert spans["outer.work"]["cat"] == "outer"
    assert spans["outer.inner"]["dur"] >= 5_000_000
    assert (
        spans["outer.work"]["ts"]
        <= spans["outer.inner"]["ts"]
        <= spans["outer.work"]["ts"] + spans["outer.work"]["dur"]
    )
    (ev,) = by_kind["event"]
    assert ev["name"] == "outer.marker" and ev["attrs"] == {"k": "v"}
    assert sum(r["value"] for r in by_kind["counter"]) == 5
    # The reference's reader parses the port's sink record for record.
    assert list(ref_obs.iter_records(rec)) == list(obs.iter_records(rec))


def test_span_records_exception_and_reraises(rec):
    with pytest.raises(ValueError):
        with obs.span("outer.boom"):
            raise ValueError("nope")
    obs.flush()
    (r,) = _records(rec)["span"]
    assert r["attrs"]["error"] == "ValueError"


def test_configure_beats_environment_and_disabled_is_a_noop(tmp_path, monkeypatch):
    monkeypatch.setenv(obs.OBS_ENV, "1")
    monkeypatch.setenv(obs.OBS_DIR_ENV, str(tmp_path / "never"))
    obs.configure(False)
    try:
        assert not obs.enabled()
        s1 = obs.span("a.b", k=1)
        assert s1 is obs.span("c.d")  # the shared no-op singleton
        with s1 as sp:
            sp.set(anything="ignored")
        obs.event("a.e", k=1)
        obs.counter_add("a.c")
        assert not (tmp_path / "never").exists()
    finally:
        obs.configure(None)


# ============================================================ trace export
def _write_sink(obs_dir, pid, epoch_ns, records, proc="python"):
    obs_dir.mkdir(parents=True, exist_ok=True)
    meta = {"t": "meta", "pid": pid, "host": "testhost", "proc": proc,
            "epoch_ns": epoch_ns, "argv": ["x"]}
    with open(obs_dir / f"obs-testhost-{pid}-0.jsonl", "w") as f:
        for r in [meta] + records:
            f.write(json.dumps(r) + "\n")


MS = 1_000_000
TWO_PROCESSES = {
    100: (0, "scheduler", [
        {"t": "span", "name": "service.unit", "cat": "service",
         "ts": 0, "dur": 50 * MS, "tid": 1, "attrs": {"tenant": "alice"}},
        {"t": "counter", "name": "service.cells_deduped", "cat": "service",
         "ts": 10 * MS, "tid": 1, "value": 1, "attrs": {}},
        {"t": "counter", "name": "service.cells_deduped", "cat": "service",
         "ts": 20 * MS, "tid": 1, "value": 2, "attrs": {}},
    ]),
    200: (100 * MS, "worker-0", [
        {"t": "span", "name": "engine.decode", "cat": "engine",
         "ts": 5 * MS, "dur": 10 * MS, "tid": 2, "attrs": {}},
        {"t": "span", "name": "sim.execute", "cat": "sim",
         "ts": 6 * MS, "dur": 2 * MS, "tid": 2, "attrs": {"backend": "cuda"}},
        {"t": "event", "name": "service.claim_contention", "cat": "service",
         "ts": 6 * MS, "tid": 2, "attrs": {"tenant": "bob"}},
        {"t": "proc_name", "pid": 200, "proc": "worker-0b"},
    ]),
}


def test_export_equals_reference_and_merges_on_wall_clock(tmp_path):
    d = tmp_path / "obs"
    for pid, (epoch, proc, records) in TWO_PROCESSES.items():
        _write_sink(d, pid, epoch, records, proc)
    mine = obs.export_chrome_trace(str(d), str(tmp_path / "mine.json"))
    theirs = ref_obs.export_chrome_trace(str(d), str(tmp_path / "theirs.json"))
    assert mine == theirs
    assert (tmp_path / "mine.json").read_text() == (tmp_path / "theirs.json").read_text()
    info = obs.validate_chrome_trace(mine)
    assert info == ref_obs.validate_chrome_trace(theirs)
    assert info["spans"] == 3 and info["pids"] == [100, 200]
    (decode,) = [e for e in mine["traceEvents"] if e["name"] == "engine.decode"]
    assert decode["ts"] == pytest.approx(105_000)
    totals = [e["args"]["cells_deduped"] for e in mine["traceEvents"]
              if e["name"] == "service.cells_deduped"]
    assert totals == [1, 3]


def test_validate_rejects_malformed_traces():
    with pytest.raises(ValueError, match="traceEvents"):
        obs.validate_chrome_trace({})
    with pytest.raises(ValueError, match="phase"):
        obs.validate_chrome_trace({"traceEvents": [{"ph": "Z"}]})
    with pytest.raises(ValueError, match="dur"):
        obs.validate_chrome_trace(
            {"traceEvents": [{"ph": "X", "name": "s", "ts": 0, "pid": 1}]}
        )


def test_summary_self_time_equals_reference(tmp_path):
    d = tmp_path / "obs"
    _write_sink(d, 1, epoch_ns=0, records=[
        {"t": "span", "name": "service.cell", "cat": "service",
         "ts": 0, "dur": 100 * MS, "tid": 1, "attrs": {}},
        {"t": "span", "name": "engine.decode", "cat": "engine",
         "ts": 10 * MS, "dur": 60 * MS, "tid": 1, "attrs": {}},
        {"t": "span", "name": "engine.decode", "cat": "engine",
         "ts": 0, "dur": 30 * MS, "tid": 2, "attrs": {}},
        {"t": "counter", "name": "engine.cache_hits", "cat": "engine",
         "ts": 0, "tid": 1, "value": 4, "attrs": {}},
        {"t": "event", "name": "service.queue_wait", "cat": "service",
         "ts": 0, "tid": 1, "attrs": {}},
    ])
    summary = obs.summarize(str(d))
    assert summary == ref_obs.summarize(str(d))
    rows = _spans(summary)
    assert rows["service.cell"]["self_ms"] == pytest.approx(40.0)
    assert rows["engine.decode"]["total_ms"] == pytest.approx(90.0)
    for top in (0, 1):
        assert obs.format_summary(summary, top=top) == ref_obs.format_summary(summary, top=top)


def test_prometheus_text_equals_reference(tmp_path):
    """Metrics of an inline scheduler run render as the reference renders
    them (metric names, types, labels and values)."""
    cells = Campaign.from_json(tiny_campaign().to_json()).expand()
    sched = Scheduler(RunStore(None), workers=0).start()
    try:
        sched.submit("c", "alice", [cells[:1]], engine_overrides={"device": "cpu"})
        sched.submit("c", "bob", [cells], engine_overrides={"device": "cpu"})
        assert sched.wait("c")
        metrics = sched.metrics()
    finally:
        sched.close()
    metrics["uptime_s"] = 1.5
    text = obs.prometheus_text(metrics)
    assert text == ref_obs.prometheus_text(metrics)
    assert obs.PROM_CONTENT_TYPE == ref_obs.PROM_CONTENT_TYPE
    assert "repro_cells_executed_total 2" in text
    assert "repro_cells_deduped_total 1" in text
    assert 'repro_tenant_submitted_cells{tenant="alice"} 1' in text


# ================================================================ trace CLI
def test_trace_cli_export_summary_and_min_cats(tmp_path, capsys):
    d = tmp_path / "obs"
    _write_sink(d, 1, epoch_ns=0, records=[
        {"t": "span", "name": "engine.decode", "cat": "engine",
         "ts": 0, "dur": MS, "tid": 1, "attrs": {}},
    ])
    out = tmp_path / "t.json"
    assert cli_main(["trace", "export", "--obs-dir", str(d), "--out", str(out)]) == 0
    assert "1 spans" in capsys.readouterr().out
    obs.validate_chrome_trace(json.loads(out.read_text()))
    assert cli_main(["trace", "summary", "--obs-dir", str(d)]) == 0
    assert "engine.decode" in capsys.readouterr().out
    rc = cli_main(["trace", "export", "--obs-dir", str(d), "--out", str(out),
                   "--min-cats", "3"])
    captured = capsys.readouterr()
    assert rc == 1 and "engine" in captured.err
    rc = cli_main(["trace", "export", "--obs-dir", str(tmp_path / "empty")])
    captured = capsys.readouterr()
    assert rc == 2
    assert captured.err.startswith("repro_torch: error: ")
    assert len(captured.err.strip().splitlines()) == 1


# ======================================================= the port's spans
OBJS = ("sim_period", "memory", "core_cost")


def _sobel_problem(strategy="MRB_Explore"):
    return ExplorationProblem(graph=sobel(), arch=paper_architecture(),
                              strategy=strategy, objectives=OBJS)


def test_engine_explorer_and_sim_spans(rec):
    """Host nsga2 under ``sim_backend="auto"`` on a CPU engine: the
    engine's, the explorer's and the simulator's spans, events and
    counters under the reference's names; ``sim.execute`` carries the
    backend auto chose."""
    problem = _sobel_problem()
    with problem.make_engine(sim_backend="auto", device="cpu") as eng:
        run = get_explorer("nsga2", population=8, offspring=4, generations=2,
                           seed=1).explore(problem, engine=eng)
    obs.flush()
    summary = obs.summarize(rec)
    rows = _spans(summary)
    for name in ("engine.transform", "engine.decode", "engine.sim_patch",
                 "explorer.generation", "sim.compile", "sim.execute"):
        assert rows[name]["count"] >= 1, name
    assert rows["explorer.generation"]["count"] == 2
    assert summary["counters"]["engine.cache_misses"] == run.cache_misses
    assert summary["counters"].get("engine.cache_hits", 0) == run.cache_hits
    assert summary["counters"]["sim.cache_builds"] == rows["sim.compile"]["count"]
    recs = _records(rec)
    resolved = [r for r in recs["event"] if r["name"] == "engine.backend_resolved"]
    assert sum(run.meta["sim_backend_choices"].values()) == len(resolved)
    assert {r["attrs"]["backend"] for r in resolved} <= {"events", "torch"}
    executes = [r for r in recs["span"] if r["name"] == "sim.execute"]
    assert {r["attrs"]["backend"] for r in executes} == {"torch"}
    assert "explorer.hypervolume" in summary["events"]


def test_events_simulator_span(rec):
    problem = _sobel_problem("MRB_Always")
    with problem.make_engine(sim_backend="events", device="cpu") as eng:
        get_explorer("random_search", samples=4, batch=4, seed=0).explore(
            problem, engine=eng)
    obs.flush()
    rows = _spans(obs.summarize(rec))
    assert rows["sim.events"]["count"] >= 1
    assert "sim.execute" not in rows


@pytest.mark.parametrize("evaluation", ["exact", "relaxed"])
def test_device_explorer_spans(rec, evaluation):
    """``torch_nsga2``: one generation span each, device steps as
    ``evo.compile`` on their first shape and ``evo.execute`` after, the
    ``evo.retraces`` counter equal to the compile spans, decode tables
    as ``evo.tables`` (relaxed)."""
    problem = ExplorationProblem(graph=sobel(), arch=paper_architecture(),
                                 strategy="MRB_Always", objectives=("memory", "core_cost"))
    with problem.make_engine(device="cpu") as eng:
        get_explorer("torch_nsga2", evaluation=evaluation, population=8, offspring=4,
                     generations=3, seed=0).explore(problem, engine=eng)
    obs.flush()
    summary = obs.summarize(rec)
    rows = _spans(summary)
    assert rows["explorer.generation"]["count"] == 3
    assert summary["counters"]["evo.retraces"] == rows["evo.compile"]["count"]
    assert rows["evo.execute"]["count"] >= 1
    kinds = {r["attrs"]["kind"] for r in _records(rec)["span"]
             if r["name"] in ("evo.compile", "evo.execute")}
    if evaluation == "exact":
        assert kinds == {"rank_parity"}
    else:
        assert kinds == {"eval", "vary", "rank"}
        assert rows["evo.tables"]["count"] == 1


def test_scheduler_claim_contention_trace(rec, tmp_path):
    """As the reference's two-tenant contention trace, inline: a ghost
    owner holds every cell's claim, so the first tenant's unit parks on
    each cell and takes it over once the claim goes stale; the second
    tenant's unit then finds every artifact and dedups."""
    store = RunStore(str(tmp_path / "cells"))
    cells = Campaign.from_json(tiny_campaign().to_json()).expand()
    for c in cells:
        assert store.claim(c.spec_hash(), "ghost")
    sched = Scheduler(store, workers=0, config=SchedulerConfig(claim_ttl_s=0.3)).start()
    try:
        sched.submit("a", "alice", [cells], engine_overrides={"device": "cpu"})
        sched.submit("b", "bob", [cells], engine_overrides={"device": "cpu"})
        assert sched.wait("a") and sched.wait("b")
    finally:
        sched.close()
    trace = obs.export_chrome_trace(rec, str(tmp_path / "trace.json"))
    info = obs.validate_chrome_trace(trace)
    assert {"service", "engine", "explorer", "runstore"} <= set(info["cats"])
    events = trace["traceEvents"]
    names = {e["name"] for e in events}
    assert {"service.unit", "service.cell", "service.claim_wait", "engine.decode",
            "runstore.claim_stale_break"} <= names
    contention = [e for e in events if e["name"] == "service.claim_contention"]
    assert {e["args"]["tenant"] for e in contention} == {"alice"}
    takeovers = [e for e in events if e["name"] == "service.stale_takeover"]
    assert len(takeovers) == len(cells)
    cell_spans = [e for e in events if e["name"] == "service.cell"]
    assert len(cell_spans) == len(cells)
    assert obs.summarize(rec)["counters"]["service.cells_deduped"] == len(cells)
