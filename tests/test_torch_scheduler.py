"""The port's campaign scheduler: the inline path (what the local runner
uses for serial and in-memory runs) and one supervised pool of two
``spawn`` workers, each giving the reference scheduler's results for the
same cell groups.  The pool's workers pay one torch import each, so this
file keeps to one pool run of each kind."""
import os
import signal
import time

import pytest
import torch

import repro.core as ref
from conftest import tiny_campaign
from repro.service import run_groups_local as ref_run_groups_local
from repro_torch import faults
from repro_torch.core import Campaign, RunStore
from repro_torch.service import Scheduler, SchedulerConfig, run_groups_local

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _groups(camp):
    """One group per strategy: two units, so a pool really spreads."""
    return [[c] for c in camp.expand()]


def _fronts(store, cells):
    return {c.tag: store.load_cell(c.spec_hash())["run"]["front"] for c in cells}


def test_inline_scheduler_accounting_and_reference_results(tmp_path):
    spec = tiny_campaign().to_json()
    camp = Campaign.from_json(spec)
    cells = camp.expand()
    store = RunStore(str(tmp_path / "mine"))
    events = []
    sched = Scheduler(store, workers=0, on_event=events.append).start()
    try:
        assert sched.submit("c", "alice", _groups(camp), engine_overrides=CPU) == 2
        assert sched.queue_depth() == 2
        assert sched.wait("c")
        state = sched.campaign_state("c")
        metrics = sched.metrics()
    finally:
        sched.close()
    assert state["done"] and not state["errors"]
    assert sorted(state["executed"]) == sorted(c.spec_hash() for c in cells)
    assert metrics["counters"]["cells_executed"] == 2
    assert metrics["counters"]["units_done"] == 2
    assert metrics["tenants"]["alice"]["executed_cells"] == 2
    types = [e["type"] for e in events]
    assert types.count("unit_queued") == 2 and types.count("cell_done") == 2
    assert not os.listdir(os.path.join(store.root, "claims"))  # no claim left
    # Resubmitting dedups every cell against the store.
    again = run_groups_local(_groups(camp), store, jobs=1, engine_overrides=CPU)
    assert again == []
    theirs = ref.RunStore(str(tmp_path / "theirs"))
    ref_cells = ref.Campaign.from_json(spec).expand()
    ref_run_groups_local([[c] for c in ref_cells], theirs, jobs=1)
    assert _fronts(store, cells) == _fronts(theirs, ref_cells)
    assert [(r["spec"]) for r in store.success_log()] == [
        r["spec"] for r in theirs.success_log()]


def test_inline_unit_failure_propagates():
    """A deterministic unit error fails immediately inline (no retry) and
    propagates out of ``run_groups_local`` as it was raised."""
    bad = Campaign.from_json(tiny_campaign().to_json()).expand()[0]
    bad = type(bad).from_json({**bad.to_json(), "engine": {"cache_mode": "bogus"}})
    with pytest.raises(ValueError, match="cache_mode"):
        run_groups_local([[bad]], RunStore(None), jobs=1, engine_overrides=CPU)


def test_spawn_pool_two_workers_equals_inline(tmp_path):
    """``jobs=2`` on a real store: two spawned workers drain the two
    units; artifacts equal the inline run's and no claim is left."""
    camp = Campaign.from_json(tiny_campaign().to_json())
    cells = camp.expand()
    pooled = RunStore(str(tmp_path / "pool"))
    executed = run_groups_local(_groups(camp), pooled, jobs=2, engine_overrides=CPU)
    assert sorted(executed) == sorted(c.spec_hash() for c in cells)
    inline = RunStore(str(tmp_path / "inline"))
    run_groups_local(_groups(camp), inline, jobs=1, engine_overrides=CPU)
    assert _fronts(pooled, cells) == _fronts(inline, cells)
    assert not os.listdir(os.path.join(pooled.root, "claims"))
    owners = {r["owner"] for r in pooled.success_log()}
    assert owners and all(":w" in o for o in owners)  # decoded in the workers


def _wait_for(predicate, timeout_s=60.0, interval_s=0.05):
    deadline = time.monotonic() + timeout_s
    while not predicate():
        assert time.monotonic() < deadline, "timed out waiting for condition"
        time.sleep(interval_s)


def test_worker_killed_mid_message_leaves_the_pool_working(tmp_path):
    """Both workers heartbeat as fast as they can, so a SIGKILL lands in
    the middle of a message. Worker 0 dies so three times; worker 1 and
    each new incarnation of worker 0 still get through, and the campaign
    submitted afterwards completes on them with the inline run's fronts."""
    camp = Campaign.from_json(tiny_campaign().to_json())
    cells = camp.expand()
    store = RunStore(str(tmp_path / "cells"))
    cfg = SchedulerConfig(heartbeat_interval_s=1e-4, heartbeat_timeout_s=60.0)
    sched = Scheduler(store, workers=2, config=cfg).start()

    def worker(wid):
        return sched.metrics()["workers"][wid]

    def flooding(wid, generation):
        _wait_for(lambda: worker(wid)["generation"] == generation, timeout_s=120)
        time.sleep(1.0)  # longer than a beat: a young age now means beats arrive
        _wait_for(lambda: worker(wid)["heartbeat_age_s"] < 0.2, timeout_s=120)

    try:
        flooding(1, 0)
        for generation in range(3):
            flooding(0, generation)
            os.kill(worker(0)["pid"], signal.SIGKILL)
        flooding(0, 3)
        flooding(1, 0)
        sched.submit("c", "alice", _groups(camp), engine_overrides=CPU)
        assert sched.wait("c", timeout_s=120)
        state = sched.campaign_state("c")
        m = sched.metrics()
    finally:
        sched.close()
    assert state["done"] and not state["errors"]
    assert m["counters"]["worker_restarts"] == 3
    assert sorted(state["executed"]) == sorted(c.spec_hash() for c in cells)
    inline = RunStore(str(tmp_path / "inline"))
    run_groups_local(_groups(camp), inline, jobs=1, engine_overrides=CPU)
    assert _fronts(store, cells) == _fronts(inline, cells)


def test_workers_crashing_right_after_a_message_leave_the_pool_working(tmp_path,
                                                                       monkeypatch):
    """A worker SIGKILLs itself at ``sched.mid_decode``, just after it sent
    its ``cell_started`` event, six times over. The pool still drains both
    units, every crash costs one respawn, and the fronts equal the inline
    run's."""
    plan = faults.FaultPlan(seed=0, name="crash-after-send", rules=[
        faults.FaultRule("sched.mid_decode", "crash", max_fires=6)])
    plan.fired_log = str(tmp_path / "fired.jsonl")
    monkeypatch.setenv(faults.FAULTS_ENV, plan.save(str(tmp_path / "plan.json")))
    camp = Campaign.from_json(tiny_campaign().to_json())
    cells = camp.expand()
    store = RunStore(str(tmp_path / "cells"))
    cfg = SchedulerConfig(heartbeat_interval_s=0.05, max_retries=8, backoff_base_s=0.01)
    sched = Scheduler(store, workers=2, config=cfg).start()
    try:
        sched.submit("c", "alice", _groups(camp), engine_overrides=CPU)
        assert sched.wait("c", timeout_s=180)
        state = sched.campaign_state("c")
        m = sched.metrics()
    finally:
        sched.close()
        faults.reset()
    assert state["done"] and not state["errors"]
    assert len(faults.read_fired_log(plan.fired_log)) == 6
    assert m["counters"]["worker_restarts"] == 6
    assert sorted(state["executed"]) == sorted(c.spec_hash() for c in cells)
    inline = RunStore(str(tmp_path / "inline"))
    run_groups_local(_groups(camp), inline, jobs=1, engine_overrides=CPU)
    assert _fronts(store, cells) == _fronts(inline, cells)
