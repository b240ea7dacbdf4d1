"""The port's campaign service (``repro_torch.service``: the global store,
the HTTP server, its client and the service CLI) against the JAX package's
(``tests/test_service.py``): the store view, concurrent tenants deduplicated
with reports equal to the reference's local ``CampaignRunner`` run once wall
times are stripped, idempotent resubmission, event replay and pagination,
error paths, the ``/metrics`` keys and the Prometheus text cross-checked,
the CLI, backpressure, client retries, stream reconnection, the unit
deadline, and the server-wide device kept out of every identity.

Served reports may differ from the reference's only where the port's run
meta differs by design (``sim_backend``, ``device``) and in wall times.
Every service runs on the CPU (``device="cpu"``); ``workers=0`` (cells run
inline in ``scheduler.drain()``) wherever a worker pool is not the point.
"""
import json
import os
import re
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

import repro.core as ref
from conftest import tiny_campaign
from repro.service import GlobalStore as RefGlobalStore
from repro.service import make_server as ref_make_server
from repro_torch import faults
from repro_torch import service as service_mod
from repro_torch.cli import main as cli_main
from repro_torch.core import Campaign, CampaignRunner, RunStore
from repro_torch.core.campaign import CampaignCell
from repro_torch.core.runstore import canonical_json
from repro_torch.faults import FaultPlan, FaultRule
from repro_torch.service import (
    CampaignView,
    GlobalStore,
    QueueSaturated,
    Scheduler,
    SchedulerConfig,
    ServiceClient,
    ServiceError,
    make_server,
)
from repro_torch.service.scheduler import CELL_DELAY_ENV

CPU = "cpu"
DIFFERS_BY_DESIGN = ("sim_backend", "device")
WALL_KEYS = ("wall_s", "wall_s_total", "wall_s_mean")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def clean_faults():
    faults.reset()
    yield
    faults.reset()


def _wait_for(predicate, timeout_s=60.0, interval_s=0.05):
    deadline = time.monotonic() + timeout_s
    while not predicate():
        assert time.monotonic() < deadline, "timed out waiting for condition"
        time.sleep(interval_s)


def _strip(obj):
    """A report or artifact without wall times and without the run-meta
    fields in which the port differs from the reference by design."""
    if isinstance(obj, dict):
        return {k: (({m: v for m, v in _strip(val).items() if m not in DIFFERS_BY_DESIGN})
                    if k == "meta" else _strip(val))
                for k, val in obj.items() if k not in WALL_KEYS}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _reference_report(spec):
    return ref.CampaignRunner(ref.Campaign.from_json(spec), store=ref.RunStore(None)).run().report


def _start(server):
    threading.Thread(target=server.serve_forever, daemon=True).start()
    host, port = server.server_address[:2]
    return f"http://{host}:{port}"


def _stop(server, service):
    server.shutdown()
    server.server_close()
    service.close()


@pytest.fixture()
def served_inline(tmp_path):
    """A CPU service in inline mode: submissions queue until
    ``service.scheduler.drain()`` runs them in this process."""
    server, service = make_server(str(tmp_path / "svc"), workers=0, device=CPU)
    client = ServiceClient(_start(server))
    try:
        yield client, service
    finally:
        _stop(server, service)


# ============================================================= global store
def test_campaign_view_shares_cells_isolates_manifests_like_reference(tmp_path):
    mine, theirs = GlobalStore(str(tmp_path / "mine")), RefGlobalStore(str(tmp_path / "ref"))
    for gs in (mine, theirs):
        a, b = gs.view("alice--camp"), gs.view("bob--camp")
        a.save_cell("a" * 64, {"x": 1})
        assert b.try_load_cell("a" * 64) == {"x": 1}  # cells are shared
        a.write_manifest({"campaign": {"name": "A"}, "cells": [{"spec_hash": "a" * 64}]})
        b.write_manifest({"campaign": {"name": "B"}, "cells": []})
        assert a.read_manifest()["campaign"]["name"] == "A"  # manifests are not
        assert b.read_manifest()["campaign"]["name"] == "B"
        assert a.completed() == ["a" * 64] and b.completed() == []
    assert isinstance(mine.view("x"), CampaignView)
    assert mine.stats() == theirs.stats() == {"unique_cells": 1, "submissions": 2}
    assert mine.submissions() == theirs.submissions() == ["alice--camp", "bob--camp"]
    for rel in ("global/cells/" + "a" * 64 + ".json", "campaigns/alice--camp/manifest.json",
                "campaigns/bob--camp/manifest.json"):
        with open(tmp_path / "mine" / rel, "rb") as f, open(tmp_path / "ref" / rel, "rb") as g:
            assert f.read() == g.read(), rel


# ================================================================= HTTP API
def test_http_concurrent_tenants_dedup_and_reports_equal_reference(tmp_path):
    """Two clients submit the same campaign at once to a service with a
    pool of two ``spawn`` workers: each unique hash is decoded once, and
    both served reports equal the reference's local run."""
    spec = tiny_campaign().to_json()
    server, service = make_server(str(tmp_path / "svc"), workers=2, device=CPU)
    client = ServiceClient(_start(server))
    results = {}

    def submit(tenant):
        sub = client.submit(spec, tenant=tenant)
        results[tenant] = client.wait(sub["submission_id"], timeout_s=300)

    try:
        threads = [threading.Thread(target=submit, args=(t,)) for t in ("alice", "bob")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        m = client.metrics()
        success = GlobalStore(str(tmp_path / "svc")).cells.success_log()
    finally:
        _stop(server, service)
    theirs = _strip(_reference_report(spec))
    for tenant in ("alice", "bob"):
        assert results[tenant]["done"]
        report = results[tenant]["report"]
        assert report["n_completed"] == report["n_cells"] == 2
        assert _strip(report) == theirs, tenant
    assert m["counters"]["cells_executed"] == 2  # one decode per unique hash
    assert m["counters"]["cells_deduped"] == 2
    assert m["dedup_hit_rate"] == pytest.approx(0.5)
    assert set(m["tenants"]) == {"alice", "bob"} and m["queue_depth"] == 0
    assert m["store"]["unique_cells"] == 2 and len(m["workers"]) == 2
    assert sorted(r["spec"] for r in success) == sorted(
        c.spec_hash() for c in Campaign.from_json(spec).expand())
    assert os.listdir(tmp_path / "svc" / "global" / "claims") == []


def test_http_submit_is_idempotent_resume(served_inline):
    client, service = served_inline
    spec = tiny_campaign().to_json()
    first = client.submit(spec, tenant="alice")
    service.scheduler.drain()
    again = client.submit(spec, tenant="alice")
    assert again["submission_id"] == first["submission_id"]
    assert again["n_pending"] == 0 and again["n_resumed"] == 2 and again["n_units"] == 0
    status = client.status(first["submission_id"])
    assert status["done"] and status["report"]["missing"] == []


def test_http_event_stream_replays_and_terminates(served_inline):
    client, service = served_inline
    sub = client.submit(tiny_campaign().to_json(), tenant="alice")
    service.scheduler.drain()
    events = list(client.events(sub["submission_id"]))
    types = [e["type"] for e in events]
    assert types[0] == "submitted"
    assert types.count("cell_done") + types.count("cell_dedup") == 2
    assert all(e["campaign_id"] == sub["submission_id"] for e in events[1:])
    started = [e for e in events if e["type"] == "cell_started"]
    assert all("tag" in e and "spec_hash" in e for e in started)


def test_http_error_paths(served_inline):
    client, _ = served_inline
    with pytest.raises(ServiceError) as e:
        client.status("nope--missing")
    assert e.value.code == 404 and not e.value.retryable
    with pytest.raises(ServiceError) as e:
        client.submit({"name": "broken"})  # no problems -> invalid spec
    assert e.value.code == 400
    with pytest.raises(ServiceError) as e:
        client._request("/campaigns", {"campaign": "not-a-dict"})
    assert e.value.code == 400
    with pytest.raises(ServiceError) as e:
        client._request("/nowhere")
    assert e.value.code == 404
    assert client.healthz() == {"ok": True}
    assert client.submissions() == []


# ==================================================== observability surface
def _key_tree(obj):
    if isinstance(obj, dict):
        return {k: _key_tree(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_key_tree(v) for v in obj]
    return type(obj).__name__ if not isinstance(obj, (int, float)) else "number"


def test_metrics_json_keys_equal_reference(tmp_path, served_inline):
    """The /metrics JSON shape is an API (dashboards, the Prometheus
    mapping): the port's keys, down to every nested one, are the
    reference's after the same campaign."""
    client, service = served_inline
    spec = tiny_campaign().to_json()
    sub = client.submit(spec, tenant="alice")
    service.scheduler.drain()
    mine = client.metrics()
    server, theirs_service = ref_make_server(str(tmp_path / "ref"), workers=0)
    try:
        other = ServiceClient(_start(server))
        theirs_sub = other.submit(spec, tenant="alice")
        theirs_service.scheduler.drain()
        theirs = other.metrics()
    finally:
        _stop(server, theirs_service)
    assert sub["submission_id"] == theirs_sub["submission_id"]
    assert _key_tree(mine) == _key_tree(theirs)
    assert set(mine) == {
        "uptime_s", "store", "queue_depth", "inflight", "counters",
        "dedup_hit_rate", "tenants", "backend_timing", "workers", "campaigns",
    }
    assert mine["counters"] == theirs["counters"]
    assert mine["store"] == theirs["store"] and mine["workers"] == [] == theirs["workers"]
    assert set(mine["backend_timing"]) == set(theirs["backend_timing"])
    for stats in mine["backend_timing"].values():
        assert set(stats) == {"cells", "wall_s_total", "wall_s_mean"}


_PROM_LINE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)$")


def _parse_prom(text):
    samples, types = {}, {}
    for line in text.rstrip("\n").split("\n"):
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ")
            assert name not in types, f"duplicate TYPE for {name}"
            types[name] = kind
            continue
        if line.startswith("#"):
            continue
        match = _PROM_LINE.match(line)
        assert match, f"malformed sample line: {line!r}"
        name, labels_s, value = match.groups()
        labels = ()
        if labels_s:
            labels = tuple(sorted(
                (kv.split("=", 1)[0], kv.split("=", 1)[1].strip('"'))
                for kv in labels_s.split(",")
            ))
        assert name in types, f"sample {name} missing TYPE declaration"
        key = (name, labels)
        assert key not in samples, f"duplicate sample {key}"
        samples[key] = float(value)
    return samples, types


def test_prometheus_exposition_cross_checks_json(served_inline):
    client, service = served_inline
    spec = tiny_campaign().to_json()
    client.submit(spec, tenant="alice")
    client.submit(spec, tenant="bob")  # dedups against alice
    service.scheduler.drain()
    m = client.metrics()
    samples, types = _parse_prom(client.metrics_text())
    assert samples[("repro_queue_depth", ())] == m["queue_depth"]
    assert samples[("repro_inflight", ())] == m["inflight"]
    assert samples[("repro_dedup_hit_rate", ())] == pytest.approx(m["dedup_hit_rate"])
    assert m["dedup_hit_rate"] == pytest.approx(0.5)
    assert samples[("repro_campaigns", ())] == len(m["campaigns"]) == 2
    assert samples[("repro_uptime_seconds", ())] >= m["uptime_s"]
    for name, v in m["counters"].items():
        assert samples[(f"repro_{name}_total", ())] == v
        assert types[f"repro_{name}_total"] == "counter"
    for key, v in m["store"].items():
        assert samples[(f"repro_store_{key}", ())] == v
    for tenant, stats in m["tenants"].items():
        for key, v in stats.items():
            assert samples[(f"repro_tenant_{key}", (("tenant", tenant),))] == pytest.approx(v)
    for backend, stats in m["backend_timing"].items():
        lbl = (("backend", backend),)
        assert samples[("repro_backend_cells_total", lbl)] == stats["cells"]
        assert samples[("repro_backend_wall_seconds_total", lbl)] == pytest.approx(
            stats["wall_s_total"])
    assert samples[("repro_workers_alive", ())] == 0 == samples[("repro_workers_total", ())]
    req = urllib.request.Request(client.base_url + "/metrics", headers={"Accept": "text/plain"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        assert resp.headers["Content-Type"].startswith("text/plain; version=0.0.4")
    req = urllib.request.Request(client.base_url + "/metrics",
                                 headers={"Accept": "text/plain, application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        assert resp.headers["Content-Type"].startswith("application/json")
        json.loads(resp.read().decode())


def test_events_since_pagination_boundaries(served_inline):
    client, service = served_inline
    sid = client.submit(tiny_campaign().to_json(), tenant="alice")["submission_id"]
    service.scheduler.drain()
    full, end, done = service.events_since(sid, 0, timeout_s=0)
    assert done and end == len(full) and len(full) >= 3
    assert full[0]["type"] == "submitted"
    page, nxt, done = service.events_since(sid, 2, timeout_s=0)
    assert page == full[2:] and nxt == end and done
    page, nxt, done = service.events_since(sid, end, timeout_s=0)
    assert page == [] and nxt == end and done
    page, nxt, done = service.events_since(sid, end + 5, timeout_s=0)
    assert page == [] and nxt == end + 5 and done
    page, nxt, done = service.events_since("ghost--none", 0, timeout_s=0)
    assert page == [] and nxt == 0 and done
    assert list(client.events(sid, since=1)) == full[1:]
    assert list(client.events(sid, since=end)) == []


# ================================================================ CLI seam
def test_cli_submit_status_metrics_against_served_instance(tmp_path, capsys):
    server, service = make_server(str(tmp_path / "svc"), workers=0, device=CPU)
    url = _start(server)
    drain = threading.Thread(target=service.scheduler.drain, daemon=True)
    spec = tmp_path / "spec.json"
    spec.write_text(tiny_campaign().dumps())
    try:
        rc = cli_main(["campaign", "submit", str(spec), "--url", url, "--no-wait",
                       "--tenant", "cli"])
        out = capsys.readouterr().out
        assert rc == 0 and "submitted cli--" in out
        drain.start()
        drain.join(timeout=300)
        sid = out.split("submitted ")[1].split(":")[0]
        assert cli_main(["campaign", "status", sid, "--url", url]) == 0
        out = capsys.readouterr().out
        assert f"{sid}: done (2/2 cells)" in out and "relHV" in out
        assert cli_main(["campaign", "metrics", "--url", url]) == 0
        assert json.loads(capsys.readouterr().out)["counters"]["cells_executed"] == 2
        # a finished submission resubmitted with --stream: no cell left
        rc = cli_main(["campaign", "submit", str(spec), "--url", url, "--tenant", "cli",
                       "--stream"])
        out = capsys.readouterr().out
        assert rc == 0 and "(0 pending, 2 already stored)" in out and "done: 2/2 cells" in out
    finally:
        _stop(server, service)


@pytest.mark.parametrize("argv,code", [
    (["campaign", "status", "t--c", "--url", "http://127.0.0.1:1"], 3),
    (["campaign", "metrics", "--url", "http://127.0.0.1:1"], 3),
    (["campaign", "submit", "{spec}", "--url", "http://127.0.0.1:1", "--no-wait"], 3),
    (["campaign", "submit", "{missing}", "--url", "http://127.0.0.1:1"], 2),
])
def test_cli_service_errors_in_one_line(argv, code, tmp_path, capsys):
    """Unreachable is transient (the client already retried): exit 3;
    a missing spec file is permanent: exit 2; one line, no traceback."""
    spec = tmp_path / "spec.json"
    spec.write_text(tiny_campaign().dumps())
    argv = [a.format(spec=spec, missing=tmp_path / "missing.json") for a in argv]
    assert cli_main(argv) == code
    captured = capsys.readouterr()
    assert captured.err.startswith("repro_torch: error: ")
    assert captured.err.strip().count("\n") == 0
    assert "Traceback" not in captured.err + captured.out


# ========================================================== device identity
def test_served_artifacts_equal_local_runs_of_both_packages(tmp_path):
    """A cell artifact produced by the served scheduler equals the port's
    local ``CampaignRunner`` artifact byte for byte once its wall time is
    dropped, and the reference's local artifact once the by-design meta
    fields are dropped too."""
    spec = tiny_campaign().to_json()
    camp = Campaign.from_json(spec)
    local = RunStore(str(tmp_path / "local"))
    CampaignRunner(camp, store=local, engine_overrides={"device": CPU}).run()
    theirs = ref.RunStore(str(tmp_path / "ref"))
    ref.CampaignRunner(ref.Campaign.from_json(spec), store=theirs).run()
    service = service_mod.CampaignService(str(tmp_path / "svc"), workers=0, device=CPU)
    try:
        sid = service.submit(spec, tenant="t")["submission_id"]
        service.scheduler.drain()
        view = service.store.view(sid)
        for cell in camp.expand():
            h = cell.spec_hash()
            served = json.loads(canonical_json(view.load_cell(h)))
            mine = json.loads(canonical_json(local.load_cell(h)))
            served["run"].pop("wall_s")
            mine["run"].pop("wall_s")
            assert canonical_json(served) == canonical_json(mine), cell.tag
            assert _strip(served) == _strip(theirs.load_cell(h)), cell.tag
        with open(os.path.join(view.root, "manifest.json"), "rb") as f:
            served_manifest = f.read()
    finally:
        service.close()
    with open(os.path.join(local.root, "manifest.json"), "rb") as f:
        assert f.read() == served_manifest
    with open(os.path.join(theirs.root, "manifest.json"), "rb") as f:
        assert f.read() == served_manifest


def test_device_stays_out_of_submission_identity(tmp_path, monkeypatch):
    """A service configured for the card and one for the CPU give the same
    submission id, manifest bytes and cell hashes; the device reaches the
    units only as a perf-only engine override, and a client cannot choose
    it (a ``device`` in the request body is ignored)."""
    spec = tiny_campaign().to_json()
    out = {}
    for device in ("cpu", "cuda"):
        if device == "cuda":  # a card-configured service, built on the CPU
            monkeypatch.setattr(service_mod.server, "resolve_device",
                                lambda d: torch.device("cpu"))
        server, service = make_server(str(tmp_path / device), workers=0, device=device)
        try:
            client = ServiceClient(_start(server))
            sub = client._request("/campaigns", {"campaign": spec, "tenant": "t",
                                                 "device": "elsewhere"})
            units = list(service.scheduler._queue)
        finally:
            _stop(server, service)
        manifest = tmp_path / device / "campaigns" / sub["submission_id"] / "manifest.json"
        hashes = sorted(CampaignCell.from_json(d).spec_hash() for u in units for d in u.cells)
        out[device] = (sub["submission_id"], manifest.read_bytes(), hashes)
        assert [u.engine_overrides for u in units] == [{"device": device}] * len(units)
        assert all("device" not in d["engine"] for u in units for d in u.cells)
    assert out["cpu"] == out["cuda"]
    camp = Campaign.from_json(spec)
    assert out["cpu"][0] == f"t--{camp.campaign_id()}"
    assert out["cpu"][2] == sorted(c.spec_hash() for c in camp.expand())


def test_default_device_is_the_card(tmp_path):
    """Without ``device`` a service runs on the card; without one it
    fails at start-up, in one line through the CLI."""
    if torch.cuda.is_available():
        service_mod.CampaignService(str(tmp_path / "svc"), workers=0).close()
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        make_server(str(tmp_path / "svc"), workers=0)


# ====================================================== resilience
def test_submit_backpressure_429_retry_after_and_cli_exit_3(tmp_path, capsys, clean_faults):
    server, service = make_server(str(tmp_path / "svc"), workers=0, queue_high_water=0,
                                  device=CPU)
    url = _start(server)
    spec = tmp_path / "spec.json"
    spec.write_text(tiny_campaign().dumps())
    try:
        with pytest.raises(QueueSaturated):
            service.submit(tiny_campaign().to_json(), tenant="direct")
        body = json.dumps({"campaign": tiny_campaign().to_json(), "tenant": "raw"}).encode()
        req = urllib.request.Request(url + "/campaigns", data=body,
                                     headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as raw:
            urllib.request.urlopen(req, timeout=30)
        assert raw.value.code == 429
        assert float(raw.value.headers["Retry-After"]) > 0
        client = ServiceClient(url, retries=1, backoff_base_s=0.01)
        with pytest.raises(ServiceError) as e:
            client.submit(tiny_campaign().to_json(), tenant="alice")
        assert e.value.code == 429 and e.value.retryable
        rc = cli_main(["campaign", "submit", str(spec), "--url", url, "--no-wait",
                       "--timeout", "5"])
        captured = capsys.readouterr()
        assert rc == 3
        assert captured.err.startswith("repro_torch: error: HTTP 429")
        assert captured.err.strip().count("\n") == 0
        assert "Traceback" not in captured.err + captured.out
    finally:
        _stop(server, service)


def test_client_retries_through_injected_5xx_and_reset(served_inline, clean_faults, tmp_path):
    client, _ = served_inline
    fired = str(tmp_path / "fired.jsonl")
    faults.configure(FaultPlan(rules=[
        FaultRule("http.request", "error_5xx", max_fires=1),
        FaultRule("http.client", "reset", max_fires=1),
    ], fired_log=fired))
    retrying = ServiceClient(client.base_url, retries=3, backoff_base_s=0.01,
                             backoff_max_s=0.05)
    assert retrying.healthz() == {"ok": True}
    assert sorted(r["site"] for r in faults.read_fired_log(fired)) == [
        "http.client", "http.request"]
    faults.configure(False)
    assert retrying.healthz() == {"ok": True}


def test_client_does_not_retry_permanent_4xx(served_inline, clean_faults):
    client, _ = served_inline
    t0 = time.monotonic()
    slow = ServiceClient(client.base_url, retries=3, backoff_base_s=0.5)
    with pytest.raises(ServiceError) as e:
        slow.status("nope--missing")
    assert e.value.code == 404 and not e.value.retryable
    assert time.monotonic() - t0 < 0.5  # no backoff sleeps: failed fast


def test_events_stream_reconnects_after_injected_reset(served_inline, clean_faults):
    client, service = served_inline
    sub = client.submit(tiny_campaign().to_json(), tenant="alice")
    service.scheduler.drain()
    clean = list(client.events(sub["submission_id"]))
    assert clean
    retrying = ServiceClient(client.base_url, retries=3, backoff_base_s=0.01,
                             backoff_max_s=0.05)
    faults.configure(FaultPlan(rules=[FaultRule("http.request", "reset", max_fires=2)]))
    assert list(retrying.events(sub["submission_id"])) == clean


def test_unit_deadline_cancels_wedged_unit(tmp_path, monkeypatch):
    """A spawned worker that heartbeats but never finishes its unit is
    replaced at ``unit_deadline_s``, counted, and announced."""
    monkeypatch.setenv(CELL_DELAY_ENV, "30.0")
    camp = Campaign.from_json(tiny_campaign().to_json())
    store = RunStore(str(tmp_path / "cells"))
    events = []
    cfg = SchedulerConfig(heartbeat_timeout_s=60.0, unit_deadline_s=1.0, max_retries=0)
    sched = Scheduler(store, workers=1, config=cfg, on_event=events.append).start()
    try:
        sched.submit("c1", "alice", [camp.expand()], engine_overrides={"device": CPU})
        _wait_for(lambda: any(e["type"] == "cell_started" for e in events), timeout_s=120)
        assert sched.wait("c1", timeout_s=120)
        state = sched.campaign_state("c1")
        m = sched.metrics()
    finally:
        sched.close()
    assert state["done"] and len(state["errors"]) == 1
    assert m["counters"]["deadline_cancels"] >= 1
    restarts = [e for e in events if e["type"] == "worker_restart"]
    assert any(e["reason"] == "unit_deadline" for e in restarts)
    assert os.listdir(os.path.join(store.root, "claims")) == []
