"""The port's fault-injection layer against the JAX package's
(``tests/test_faults.py``): plan model and JSON, fire semantics (budgets,
seeded probabilities, generic vs site-specific kinds, fnmatch sites), the
global budget across processes, the environment gate, and the fired-log.
The same plan and seed fire the same sequence in both packages.  The one
deliberate difference: a fault at ``engine.sim_batch`` raises out of the
port's engine, where the reference degrades to its event simulator.
"""
import json
import multiprocessing
import time

import pytest

from repro import faults as ref_faults
from repro.core import ExplorationProblem as RefProblem
from repro.core import paper_architecture as ref_arch
from repro.core import sobel as ref_sobel
from repro_torch import faults
from repro_torch.core import (
    ExplorationProblem,
    NSGA2Explorer,
    RunStore,
    paper_architecture,
    sobel,
)
from repro_torch.faults import FaultInjected, FaultPlan, FaultRule


@pytest.fixture(autouse=True)
def _isolated_gate(monkeypatch):
    """Both packages start env-unset and cache-dropped, and leave no armed
    plan behind."""
    monkeypatch.delenv(faults.FAULTS_ENV, raising=False)
    faults.reset()
    ref_faults.reset()
    yield
    faults.reset()
    ref_faults.reset()


def _plan(log=None, seed=0):
    return FaultPlan(
        seed=seed, name="p", fired_log=log,
        rules=[
            FaultRule("a.error", "error", max_fires=1),
            FaultRule("store.*", "torn", p=0.5, max_fires=3, note="n"),
            FaultRule("sched.heartbeat", "skip", p=0.3, max_fires=0),
            FaultRule("a.slow", "slow", delay_s=0.01, max_fires=2),
        ],
    )


# ------------------------------------------------------------- plan model
def test_plan_json_roundtrip_and_reference_format(tmp_path):
    plan = _plan("/tmp/x.jsonl", seed=7)
    assert FaultPlan.from_json(plan.to_json()) == plan
    path = str(tmp_path / "plan.json")
    plan.save(path)
    assert FaultPlan.load(path) == plan
    theirs = ref_faults.FaultPlan.from_json(plan.to_json())
    assert theirs.to_json() == plan.to_json()
    theirs.save(str(tmp_path / "ref.json"))
    assert (tmp_path / "ref.json").read_text() == open(path).read()
    sparse = FaultRule.from_json({"site": "x", "kind": "error"})
    assert (sparse.p, sparse.max_fires) == (1.0, 1)


# ------------------------------------------------------- fire() semantics
def test_fire_kinds_and_budget(tmp_path):
    log = str(tmp_path / "fired.jsonl")
    faults.configure(FaultPlan(
        seed=0, fired_log=log,
        rules=[
            FaultRule("a.error", "error", max_fires=1),
            FaultRule("a.slow", "slow", delay_s=0.05, max_fires=1),
            FaultRule("a.site_specific", "torn", max_fires=2),
        ],
    ))
    assert faults.enabled()
    with pytest.raises(FaultInjected):
        faults.fire("a.error", tag="t")
    assert faults.fire("a.error") is None
    t0 = time.perf_counter()
    assert faults.fire("a.slow") is None
    assert time.perf_counter() - t0 >= 0.04
    assert faults.fire("a.site_specific") == "torn"
    assert faults.fire("a.site_specific") == "torn"
    assert faults.fire("a.site_specific") is None
    assert faults.fire("a.unmatched") is None
    records = faults.read_fired_log(log)
    assert [r["site"] for r in records] == \
        ["a.error", "a.slow", "a.site_specific", "a.site_specific"]
    assert records[0]["tag"] == "t"


SITES = (["store.save_cell", "sched.heartbeat", "a.slow", "store.load_cell",
          "a.error", "other.site", "sched.heartbeat"] * 6)


def _fire_all(pkg, log, seed):
    pkg.configure(pkg.FaultPlan.from_json(_plan(log, seed).to_json()))
    out = []
    for i, site in enumerate(SITES):
        try:
            out.append(pkg.fire(site, step=i))
        except pkg.FaultInjected:
            out.append("raised")
    return out, [{k: v for k, v in r.items() if k != "pid"}
                 for r in pkg.read_fired_log(log)]


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_same_plan_same_fired_sequence_in_both_packages(tmp_path, seed):
    mine = _fire_all(faults, str(tmp_path / "mine.jsonl"), seed)
    theirs = _fire_all(ref_faults, str(tmp_path / "theirs.jsonl"), seed)
    assert mine == theirs
    assert {"raised", "torn", "skip", None} <= set(mine[0])


def test_fire_probability_is_seeded_and_fnmatch():
    def draws(seed):
        faults.configure(FaultPlan(seed=seed, rules=[
            FaultRule("s", "torn", p=0.5, max_fires=0),
        ]))
        return [faults.fire("s") for _ in range(32)]

    a = draws(1)
    assert a == draws(1) and a != draws(2)
    assert set(a) == {None, "torn"}
    faults.configure(FaultPlan(rules=[FaultRule("sched.*", "skip", max_fires=0)]))
    assert faults.fire("sched.heartbeat") == "skip"
    assert faults.fire("sched.pre_claim") == "skip"
    assert faults.fire("store.save_cell") is None


def _child_fire(plan_json, out_q):
    faults.configure(FaultPlan.from_json(json.loads(plan_json)))
    out_q.put(faults.fire("s"))


def test_max_fires_budget_is_global_across_processes(tmp_path):
    """Ticket files next to the fired log make ``max_fires`` a run budget:
    of four processes, exactly one fires.  The children touch no CUDA, so
    they are forked (quick) rather than spawned."""
    log = str(tmp_path / "fired.jsonl")
    plan = FaultPlan(fired_log=log, rules=[FaultRule("s", "torn", max_fires=1)])
    ctx = multiprocessing.get_context("fork")
    out_q = ctx.Queue()
    procs = [ctx.Process(target=_child_fire, args=(json.dumps(plan.to_json()), out_q))
             for _ in range(4)]
    for p in procs:
        p.start()
    results = [out_q.get(timeout=30) for _ in procs]
    for p in procs:
        p.join(timeout=30)
    assert sorted(r or "-" for r in results) == ["-", "-", "-", "torn"]
    assert len(faults.read_fired_log(log)) == 1


# ------------------------------------------------------------- the gate
def test_env_plan_inline_file_and_configure(tmp_path, monkeypatch):
    plan = FaultPlan(rules=[FaultRule("s", "torn")])
    monkeypatch.setenv(faults.FAULTS_ENV, json.dumps(plan.to_json()))
    faults.reset()
    assert faults.enabled() and faults.fire("s") == "torn"
    path = plan.save(str(tmp_path / "plan.json"))
    monkeypatch.setenv(faults.FAULTS_ENV, path)
    faults.reset()
    assert faults.enabled() and faults.fire("s") == "torn"
    faults.configure(False)
    assert not faults.enabled()
    faults.configure(FaultPlan(rules=[FaultRule("s", "lost")]))
    assert faults.fire("s") == "lost"
    monkeypatch.setenv(faults.FAULTS_ENV, str(tmp_path / "missing.json"))
    faults.reset()
    assert not faults.enabled() and faults.fire("s") is None


def test_read_fired_log_skips_torn_lines(tmp_path):
    log = str(tmp_path / "fired.jsonl")
    with open(log, "w") as f:
        f.write('{"site": "a", "kind": "torn"}\n{"site": "b", "ki')
    assert [r["site"] for r in faults.read_fired_log(log)] == ["a"]
    assert faults.read_fired_log(str(tmp_path / "none.jsonl")) == []


# --------------------------------------------------------------- the sites
def test_store_sites_act_as_in_the_reference(tmp_path):
    """``store.write_manifest`` corrupt → unreadable manifest, healed by
    the next write; ``store.release_claim`` lost → the claim stays."""
    from repro.core import RunStore as RefStore

    for pkg, Store, root in ((faults, RunStore, "mine"), (ref_faults, RefStore, "theirs")):
        pkg.configure(pkg.FaultPlan(rules=[
            pkg.FaultRule("store.write_manifest", "corrupt"),
            pkg.FaultRule("store.release_claim", "lost"),
        ]))
        store = Store(str(tmp_path / root))
        store.write_manifest({"a": 1})
        assert store.read_manifest() is None
        store.write_manifest({"a": 1})
        assert store.read_manifest() == {"a": 1}
        assert store.claim("h" * 64, "me")
        store.release_claim("h" * 64, owner="me")
        assert store.claim_info("h" * 64)["owner"] == "me"
        store.release_claim("h" * 64, owner="me")
        assert store.claim_info("h" * 64) is None
        pkg.reset()
    assert (tmp_path / "mine" / "manifest.json").read_text() == \
        (tmp_path / "theirs" / "manifest.json").read_text()


OBJS = ("sim_period", "memory", "core_cost")


@pytest.mark.parametrize("backend", ["torch", "auto"])
def test_sim_batch_fault_raises_in_the_port(backend):
    """No breaker in the port: an ``error`` fault at ``engine.sim_batch``
    propagates out of ``evaluate_batch``, once per fire budget."""
    faults.configure(FaultPlan(rules=[FaultRule("engine.sim_batch", "error")]))
    problem = ExplorationProblem(graph=sobel(), arch=paper_architecture(),
                                 strategy="MRB_Always", objectives=OBJS)
    explorer = NSGA2Explorer(population=8, offspring=4, generations=1, seed=0)
    with problem.make_engine(sim_backend=backend, device="cpu") as eng:
        with pytest.raises(FaultInjected, match="engine.sim_batch"):
            explorer.explore(problem, engine=eng)
        assert not hasattr(eng, "sim_degraded")


def test_sim_batch_fault_degrades_in_the_reference():
    """The same plan in the reference: its breaker opens and the ξ group
    degrades to the event simulator, with the front of a clean run."""
    ref_faults.configure(ref_faults.FaultPlan(
        rules=[ref_faults.FaultRule("engine.sim_batch", "error")]))
    problem = RefProblem(graph=ref_sobel(), arch=ref_arch(),
                         strategy="MRB_Always", objectives=OBJS)
    with problem.make_engine(sim_backend="vectorized") as eng:
        from repro.core import NSGA2Explorer as RefNSGA2

        run = RefNSGA2(population=8, offspring=4, generations=1, seed=0).explore(
            problem, engine=eng)
        assert eng.sim_degraded["vectorized"] >= 1
    ref_faults.reset()
    with problem.make_engine(sim_backend=None) as eng:
        clean = RefNSGA2(population=8, offspring=4, generations=1, seed=0).explore(
            problem, engine=eng)
    assert run.front == clean.front
