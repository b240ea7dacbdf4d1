"""The port's schedule verifier (``repro_torch.verify``), simulator
invariants and Gantt renderers against the JAX package's on the CPU:

* ``verify_schedule`` reports (``to_json()``) equal to the reference's on
  known-good caps_hms and ILP schedules and on every mutation class of
  ``verify/mutations.py``;
* ``differential_sweep`` reports equal to the reference's, row for row,
  over two families and both decoders;
* ``check_sim_invariants`` returning the reference's list, on the event
  simulator and on the plain batched program's result, including the
  known lower-bound violations of the reference at seeds 9030, 9046, 9182,
  7686 and 9770;
* ``ascii_gantt`` / ``svg_gantt`` of a port trace equal to the reference's,
  and the trace's ``save``/``load`` round trip.

Schedules are decoded on both sides from one round-tripped graph dict,
whose actor and channel order fix the decoders' tie-breaks.
"""
import os

os.environ.setdefault("REPRO_SIM_CACHE_DIR", "0")

import json
import random
from dataclasses import asdict

import jax  # noqa: F401  (both frameworks live in one test process)
import pytest
import torch

import repro.core as ref
import repro.sim as rsim
import repro.verify as rver
import repro_torch.core as port
import repro_torch.sim as psim
import repro_torch.verify as pver
from conftest import make_pipelined_sobel, random_decode
from repro.scenarios import sample_scenario
from repro_torch.bridge import arch_from_dict, graph_from_dict, schedule_from_json

BUDGET_S = 60.0
NO_TRACE = rsim.SimConfig(trace=False)
# (rng key, hypothesis seed) of tests/test_sim.py's properties; the first
# five are the reference's known lower-bound exceptions (ROADMAP §3).
KNOWN_DEFECTS = {
    ("sim-prop", 9030): "random_dag#339429@2x3",
    ("sim-parity", 9046): "random_dag#357598@1x3",
    ("sim-parity", 9182): "random_dag#827879@2x2",
    ("sim-prop", 7686): "random_dag#811290@1x3",
    ("sim-parity", 9770): "random_dag#29945@1x2",
}
INVARIANT_CASES = list(KNOWN_DEFECTS) + [
    ("sim-parity", 9030), ("sim-prop", 9046), ("sim-prop", 9182),
    ("sim-parity", 7686), ("sim-prop", 9770), ("sim-parity", 12),
]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _carry(gt, arch):
    d = gt.to_dict()
    return ref.ApplicationGraph.from_dict(d), graph_from_dict(d), arch_from_dict(arch.to_dict())


def _sobel():
    gt, arch = make_pipelined_sobel()
    return _carry(gt, arch) + (arch,)


def _single_core(g, arch, decode):
    core = sorted(arch.cores)[0]
    res = decode(g, arch, {c: "PROD" for c in g.channels}, {a: core for a in g.actors})
    assert res.feasible
    return res.schedule


def _both_reports(rg, arch, rs, pg, pa, ps):
    theirs = rver.verify_schedule(rg, arch, rs)
    mine = pver.verify_schedule(pg, pa, ps)
    assert mine.to_json() == theirs.to_json()
    assert mine.dumps() == theirs.dumps()
    return mine


# ------------------------------------------------------------- verifier
def test_known_good_schedules_verify_as_reference():
    rg, pg, pa, arch = _sobel()
    rs = _single_core(rg, arch, ref.decode_via_heuristic)
    ps = _single_core(pg, pa, port.decode_via_heuristic)
    assert ps.to_json() == rs.to_json()
    assert _both_reports(rg, arch, rs, pg, pa, ps).ok
    rng = random.Random(17)
    h = random_decode(rg, arch, rng)
    assert _both_reports(rg, arch, h.schedule, pg, pa, schedule_from_json(h.schedule.to_json())).ok
    cores = sorted(arch.cores)
    for _ in range(40):  # tests/conftest.py::random_decode's draws, longer budget
        ba = {a: rng.choice([p for p in cores if rg.actors[a].can_run_on(arch.cores[p].ctype)])
              for a in rg.actors}
        cd = {c: rng.choice(ref.CHANNEL_DECISIONS) for c in rg.channels}
        theirs = ref.decode_via_ilp(rg, arch, cd, ba, time_budget_s=BUDGET_S)
        mine = port.decode_via_ilp(pg, pa, cd, ba, time_budget_s=BUDGET_S)
        assert theirs.proven_optimal and mine.proven_optimal
        assert mine.to_json() == theirs.to_json()
        if theirs.feasible:
            break
    assert _both_reports(rg, arch, theirs.schedule, pg, pa, mine.schedule).ok


def test_mutation_registry_matches_reference():
    assert pver.mutation_names() == rver.mutation_names()
    assert {k: v[1] for k, v in pver.MUTATIONS.items()} == \
        {k: v[1] for k, v in rver.MUTATIONS.items()}
    assert pver.VIOLATION_KINDS == rver.VIOLATION_KINDS


@pytest.mark.parametrize("name", sorted(rver.MUTATIONS))
def test_each_mutation_class_reports_as_reference(name):
    rg, pg, pa, arch = _sobel()
    rs = _single_core(rg, arch, ref.decode_via_heuristic)
    ps = _single_core(pg, pa, port.decode_via_heuristic)
    rm = rver.apply_mutation(name, rg, arch, rs, random.Random(f"mutate:{name}"))
    pm = pver.apply_mutation(name, pg, pa, ps, random.Random(f"mutate:{name}"))
    assert rm is not None and pm.to_json() == rm.to_json()
    report = _both_reports(rg, arch, rm, pg, pa, pm)
    assert not report.ok
    assert pver.MUTATIONS[name][1] in report.kinds()


def test_mutations_across_random_schedules_report_as_reference():
    rg, pg, pa, arch = _sobel()
    rs = random_decode(rg, arch, random.Random(23)).schedule
    ps = schedule_from_json(rs.to_json())
    r_rng, p_rng = random.Random(23), random.Random(23)
    applied = 0
    for name in sorted(rver.MUTATIONS):
        rm = rver.apply_mutation(name, rg, arch, rs, r_rng)
        pm = pver.apply_mutation(name, pg, pa, ps, p_rng)
        assert (rm is None) == (pm is None), name
        if rm is None:
            continue
        applied += 1
        assert pm.to_json() == rm.to_json()
        assert pver.MUTATIONS[name][1] in _both_reports(rg, arch, rm, pg, pa, pm).kinds()
    assert applied >= 3


def test_verify_decode_result_vacuous_pass_on_infeasible():
    rg, pg, pa, arch = _sobel()
    core = sorted(arch.cores)[0]
    args = ({c: "GLOBAL" for c in pg.channels}, {a: core for a in pg.actors})
    bad = port.decode_via_heuristic(pg, pa, *args, max_period=1)
    theirs = rver.verify_decode_result(rg, arch, ref.decode_via_heuristic(rg, arch, *args, max_period=1))
    mine = pver.verify_decode_result(pg, pa, bad)
    assert not bad.feasible and mine.ok and not mine.feasible
    assert mine.to_json() == theirs.to_json()
    assert mine.summary() == theirs.summary()


def test_report_json_round_trip():
    v = pver.Violation("resource_overlap", "core:c0", "two windows overlap",
                       {"a": "A", "b": "B", "overlap": 3})
    assert pver.Violation.from_json(json.loads(json.dumps(v.to_json()))) == v
    report = pver.VerificationReport(period=42, violations=[v])
    assert report.to_json() == rver.VerificationReport(
        period=42, violations=[rver.Violation(**asdict(v))]).to_json()
    rt = pver.VerificationReport.from_json(json.loads(report.dumps()))
    assert rt.period == 42 and rt.violations == [v] and not rt.ok
    assert rt.counts() == {"resource_overlap": 1}


@pytest.mark.parametrize("kw", [
    dict(seed=0, families=["stencil_chain", "split_join"]),
    dict(seed=0, families=["random_dag", "camera_pipeline"]),
    dict(seed=4, families=["stencil_chain"], harmonic=True),
], ids=["stencil-split", "dag-camera", "harmonic"])
def test_differential_sweep_matches_reference(kw):
    args = dict(per_family=1, samples=2, decoders=("caps_hms", "ilp"), ilp_budget_s=BUDGET_S, **kw)
    theirs = rver.differential_sweep(**args)
    mine = pver.differential_sweep(**args)
    assert mine["rows"] == theirs["rows"]
    assert mine == theirs
    assert mine["ok"] and mine["n_checked"] >= 4
    assert {r["decoder"] for r in mine["rows"]} == {"caps_hms", "ilp"}
    with pytest.raises(KeyError):
        pver.differential_sweep(sizes=("enormous",), families=["stencil_chain"])


# ------------------------------------------------------------ invariants
@pytest.mark.parametrize("case", INVARIANT_CASES, ids=[f"{k}:{s}" for k, s in INVARIANT_CASES])
def test_sim_invariants_match_reference(case):
    """The reference's list as it is: at the known defects it holds the
    lower-bound violation, so the port must report it too."""
    key, seed = case
    rng = random.Random(f"{key}:{seed}")
    sc = sample_scenario(rng)
    if case in KNOWN_DEFECTS:
        assert sc.name == KNOWN_DEFECTS[case]
    g, arch = sc.build()
    gt = ref.pipeline_delays(
        ref.substitute_mrbs(g, {a: rng.randint(0, 1) for a in ref.multicast_actors(g)})
    )
    res = random_decode(gt, arch, rng)
    theirs = rsim.check_sim_invariants(gt, arch, res.schedule)
    if case in KNOWN_DEFECTS:
        assert len(theirs) == 1 and "beats the resource lower bound" in theirs[0]
    rg, pg, pa = _carry(gt, arch)
    ps = schedule_from_json(res.schedule.to_json())
    assert rsim.check_sim_invariants(rg, arch, res.schedule) == theirs
    assert psim.check_sim_invariants(pg, pa, ps) == theirs
    cfg = psim.SimConfig(**asdict(NO_TRACE))
    (pb,) = psim.batch_simulate(pg, pa, [ps], cfg, backend="torch", device="cpu")
    assert psim.check_sim_invariants(pg, pa, ps, result=pb) == theirs
    assert psim.check_sim_invariants(pg, pa, ps, result=pb, include_static=False) == \
        rsim.check_sim_invariants(rg, arch, res.schedule, include_static=False)


# ----------------------------------------------------------------- gantt
@pytest.mark.parametrize("seed", (11, 12))
def test_gantt_of_port_trace_equals_reference(seed, tmp_path):
    rg, pg, pa, arch = _sobel()
    rs = random_decode(rg, arch, random.Random(seed)).schedule
    ps = schedule_from_json(rs.to_json())
    theirs = rsim.simulate(rg, arch, rs).trace
    mine = psim.simulate(pg, pa, ps).trace
    assert mine.to_json() == theirs.to_json()
    assert psim.ascii_gantt(mine) == rsim.ascii_gantt(theirs)
    assert psim.ascii_gantt(mine, width=60, start=100, end=5000) == \
        rsim.ascii_gantt(theirs, width=60, start=100, end=5000)
    assert psim.svg_gantt(mine) == rsim.svg_gantt(theirs)
    path = psim.save_svg(mine, str(tmp_path / "g" / "trace.svg"))
    with open(path) as f:
        assert f.read() == rsim.svg_gantt(theirs)
    back = psim.SimTrace.load(mine.save(str(tmp_path / "trace.json")))
    assert back.to_json() == mine.to_json()
    assert theirs.save(str(tmp_path / "ref.json"))
    with open(tmp_path / "ref.json") as f, open(tmp_path / "trace.json") as g:
        assert f.read() == g.read()
