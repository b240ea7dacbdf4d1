"""The port's exact decoders (``repro_torch.core.ilp``, the ``cpsat`` gate)
against the JAX package's on the CPU:

* ``ExactResult.to_json()`` equal to the reference's ``decode_via_ilp`` on
  Sobel and the three generated scenarios of ``tests/test_torch_core.py``,
  and at seed 5414 of ``tests/test_engine.py``'s differential property,
  where the reference proves 47 optimal against caps_hms's 46;
* the ILP half of the reference's parity sweep (``tests/test_sim.py``, odd
  seeds): the port's schedules simulate, on the event simulator and the
  plain batched program, to the reference's firing times;
* host ``nsga2`` with ``decoder="ilp"`` reproducing the golden Sobel fronts
  of ``tests/test_explorers.py``, and ``torch_nsga2`` in exact mode
  reproducing the host front;
* the decoder registry and the CP-SAT import gate.

The ILP is anytime: past its wall-clock deadline it falls back to caps_hms,
so a loaded machine could change a result.  Every comparison therefore
first asserts ``proven_optimal`` on both sides, under a budget the case
never comes near.  Sobel4 and Multicamera are left out: there the search
never proves a period within seconds, so their results depend on the clock.
The golden fronts were captured with a 2.0 s budget; every decode of those
runs proves optimal at 2.0 s, so a longer budget gives the same fronts
without the clock deciding them.
"""
import os

os.environ.setdefault("REPRO_SIM_CACHE_DIR", "0")

import random
from dataclasses import asdict

import jax  # noqa: F401  (both frameworks live in one test process)
import pytest
import torch

import repro.core as ref
import repro.sim as rsim
import repro_torch.core as port
import repro_torch.sim as psim
from repro.core.ilp import decode_via_ilp as ref_ilp
from repro.scenarios import sample_scenario, sample_scenarios
from repro_torch.bridge import arch_from_dict, graph_from_dict, problem_from_json
from repro_torch.core.cpsat import HAVE_ORTOOLS, decode_via_cpsat
from repro_torch.core.decoders import decoder_names, get_decoder
from repro_torch.core.ilp import ExactResult, decode_via_ilp

BUDGET_S = 120.0
NO_TRACE = rsim.SimConfig(trace=False)
# tests/test_explorers.py:88,105-113 (captured at ilp_budget_s=2.0)
ILP_CFG = dict(population=8, offspring=4, generations=2, seed=7)
GOLDEN_FRONTS = {
    "MRB_Always": [(14920.0, 58017000.0, 4.5)],
    "MRB_Explore": [
        (15658.0, 58017000.0, 6.5), (15864.0, 58017000.0, 5.0),
        (17796.0, 66311400.0, 4.5),
    ],
}
# Odd hypothesis seeds of tests/test_sim.py's parity sweep whose ILP decode
# proves optimal within milliseconds on a CPU.
SWEEP_SEEDS = (1, 3, 5, 7, 9, 15, 17, 19, 21, 23, 25, 27, 29, 31, 33, 35,
               37, 39, 45, 47, 49, 51, 53, 55)
# Sobel mappings (rng keys) whose decode proves optimal in well under a
# second; keys 7-23 cover both ξ patterns.
SOBEL_KEYS = (7, 10, 11, 12, 14, 21, 22, 23)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _carry(g, arch):
    """(reference graph, port graph, port arch) from one round-tripped dict:
    actor and channel order fix the ILP's tie-breaks."""
    d = g.to_dict()
    return ref.ApplicationGraph.from_dict(d), graph_from_dict(d), arch_from_dict(arch.to_dict())


def _random_mapping(gt, arch, rng):
    cores = sorted(arch.cores)
    ba = {
        a: rng.choice([p for p in cores if gt.actors[a].can_run_on(arch.cores[p].ctype)])
        for a in sorted(gt.actors)
    }
    cd = {c: rng.choice(ref.CHANNEL_DECISIONS) for c in sorted(gt.channels)}
    return ba, cd


def _assert_same_exact(rgt, arch, pgt, pa, cd, ba):
    """Both ILPs prove optimal and agree on the whole ``to_json()``."""
    r = ref_ilp(rgt, arch, cd, ba, time_budget_s=BUDGET_S)
    p = decode_via_ilp(pgt, pa, cd, ba, time_budget_s=BUDGET_S)
    assert r.proven_optimal and p.proven_optimal
    assert p.to_json() == r.to_json()
    assert ExactResult.from_json(r.to_json()).to_json() == r.to_json()
    return r, p


def _core_cases():
    """(name, reference graph, arch, rng streams): Sobel draws one mapping
    per key, a generated scenario six from one stream."""
    out = [("Sobel", ref.sobel(), ref.paper_architecture(),
            [(f"torch-ilp:sobel:{k}", 1) for k in SOBEL_KEYS])]
    for sc in sample_scenarios(seed=0, n=3):
        g, arch = sc.build()
        out.append((g.name, g, arch, [(f"torch-ilp:{g.name}", 6)]))
    return out


CORE_CASES = _core_cases()


def _draws(rg, pg, arch, rng):
    """One seeded (ξ, β_A, C_d) draw on both packages' transformed graphs."""
    xi = {a: rng.randint(0, 1) for a in sorted(ref.multicast_actors(rg))}
    rgt = ref.pipeline_delays(ref.substitute_mrbs(rg, xi))
    pgt = port.pipeline_delays(port.substitute_mrbs(pg, xi))
    assert pgt.to_dict() == rgt.to_dict()
    ba, cd = _random_mapping(rgt, arch, rng)
    return rgt, pgt, cd, ba


@pytest.mark.parametrize("case", range(len(CORE_CASES)), ids=[c[0] for c in CORE_CASES])
def test_ilp_decode_matches_reference(case):
    _name, g, arch, streams = CORE_CASES[case]
    rg, pg, pa = _carry(g, arch)
    decoded = 0
    for key, n in streams:
        rng = random.Random(key)
        for _ in range(n):
            rgt, pgt, cd, ba = _draws(rg, pg, arch, rng)
            r, _ = _assert_same_exact(rgt, arch, pgt, pa, cd, ba)
            decoded += r.feasible
    assert decoded > 0


def test_seed_5414_proven_optimal_above_caps_hms():
    """``tests/test_engine.py``'s differential property at seed 5414
    (``random_dag#528795@3x4``): caps_hms finds 46, the ILP proves 47
    optimal.  The port reproduces both, as they are."""
    rng = random.Random("parity:5414")
    sc = sample_scenario(rng, family="random_dag")
    assert sc.name == "random_dag#528795@3x4"
    g, arch = sc.build()
    assert len(g.actors) <= 8
    cores = sorted(arch.cores)
    ba = {a: rng.choice([p for p in cores if g.actors[a].can_run_on(arch.cores[p].ctype)])
          for a in g.actors}
    cd = {c: rng.choice(ref.CHANNEL_DECISIONS) for c in g.channels}
    rg, pg, pa = _carry(g, arch)
    r, p = _assert_same_exact(rg, arch, pg, pa, cd, ba)
    assert (p.period, p.proven_optimal, p.periods_tried) == (47, True, 10)
    h = port.decode_via_heuristic(pg, pa, cd, ba)
    assert h.schedule.period == ref.decode_via_heuristic(rg, arch, cd, ba).schedule.period == 46


@pytest.mark.parametrize("seed", SWEEP_SEEDS)
def test_ilp_parity_sweep_simulates_to_reference_fire_times(seed):
    """As ``tests/test_sim.py::test_parity_sweep_families_and_decoders`` at
    an odd seed: an ILP schedule of a generated scenario, decoded by both
    packages, simulated by the reference's event simulator and by the
    port's event simulator and plain batched program."""
    rng = random.Random(f"sim-parity:{seed}")
    sc = sample_scenario(rng)
    g, arch = sc.build()
    gt = ref.pipeline_delays(
        ref.substitute_mrbs(g, {a: rng.randint(0, 1) for a in ref.multicast_actors(g)})
    )
    rgt, pgt, pa = _carry(gt, arch)
    cores = sorted(arch.cores)
    for _ in range(40):  # tests/conftest.py::random_decode's draws
        ba = {a: rng.choice([p for p in cores if gt.actors[a].can_run_on(arch.cores[p].ctype)])
              for a in gt.actors}
        cd = {c: rng.choice(ref.CHANNEL_DECISIONS) for c in gt.channels}
        r, p = _assert_same_exact(rgt, arch, pgt, pa, cd, ba)
        if r.feasible:
            break
    assert p.feasible, sc.name
    e = rsim.simulate(rgt, arch, r.schedule, NO_TRACE)
    cfg = psim.SimConfig(**asdict(NO_TRACE))
    pe = psim.simulate(pgt, pa, p.schedule, cfg)
    (pb,) = psim.batch_simulate(pgt, pa, [p.schedule], cfg, backend="torch", device="cpu")
    for mine in (pe, pb):
        assert mine.fire_times == e.fire_times, sc.name
        assert mine.period == e.period
        assert mine.deadlocked == e.deadlocked
    assert psim.check_sim_invariants(pgt, pa, p.schedule, result=pb) == \
        rsim.check_sim_invariants(rgt, arch, r.schedule, result=e)


# ------------------------------------------------------------ golden fronts
def _sobel_ilp(strategy):
    rp = ref.ExplorationProblem(graph=ref.sobel(), arch=ref.paper_architecture(),
                                strategy=strategy, decoder="ilp", ilp_budget_s=BUDGET_S)
    return problem_from_json(rp.to_json())


@pytest.fixture(scope="module")
def explore_host_ilp():
    runs = {}

    def run(strategy):
        if strategy not in runs:
            pp = _sobel_ilp(strategy)
            with pp.make_engine(sim_backend="torch", device="cpu") as eng:
                runs[strategy] = port.get_explorer("nsga2", **ILP_CFG).explore(pp, engine=eng)
        return runs[strategy]

    return run


@pytest.mark.parametrize("strategy", sorted(GOLDEN_FRONTS))
def test_host_nsga2_reproduces_golden_ilp_front(strategy, explore_host_ilp):
    run = explore_host_ilp(strategy)
    assert run.front == GOLDEN_FRONTS[strategy]


def test_torch_nsga2_exact_mode_with_ilp_matches_host(explore_host_ilp):
    """``tests/test_evo.py::test_exact_parity_sobel_ilp``'s case (Sobel,
    MRB_Explore, population 8 / offspring 4 / generations 2): the exact
    mode's front, history and evaluations equal the host loop's, with
    decodes of its own engine."""
    host = explore_host_ilp("MRB_Explore")
    pp = _sobel_ilp("MRB_Explore")
    with pp.make_engine(sim_backend="torch", device="cpu") as eng:
        dev = port.get_explorer("torch_nsga2", evaluation="exact", **ILP_CFG).explore(pp, engine=eng)
    assert dev.front == host.front == GOLDEN_FRONTS["MRB_Explore"]
    assert dev.history == host.history
    assert dev.evaluations == host.evaluations
    assert dev.meta["evaluation"] == "exact"


# ----------------------------------------------------------------- registry
def test_registry_lists_ilp_and_gates_cpsat():
    """As ``tests/test_verify.py::test_cpsat_gated_when_ortools_absent``."""
    from repro.core.cpsat import HAVE_ORTOOLS as REF_HAVE_ORTOOLS

    assert HAVE_ORTOOLS == REF_HAVE_ORTOOLS
    if HAVE_ORTOOLS:
        assert decoder_names() == ["caps_hms", "cpsat", "ilp"]
    else:
        assert decoder_names() == ["caps_hms", "ilp"] == [
            n for n in ref.decoder_names() if n != "cpsat"]
        with pytest.raises(RuntimeError, match="ortools"):
            decode_via_cpsat(None, None, {}, {})
    with pytest.raises(KeyError, match="unknown decoder"):
        get_decoder("no_such_decoder")


def test_registered_ilp_takes_the_budget():
    """The registry's ``ilp`` entry passes ``time_budget_s`` through (3 s
    when None), as the reference's does."""
    rg, pg, pa = _carry(ref.sobel(), ref.paper_architecture())
    rgt, pgt, cd, ba = _draws(rg, pg, ref.paper_architecture(),
                              random.Random(f"torch-ilp:sobel:{SOBEL_KEYS[1]}"))
    mine = get_decoder("ilp")(pgt, pa, cd, ba, time_budget_s=None)
    theirs = ref.get_decoder("ilp")(rgt, ref.paper_architecture(), cd, ba, time_budget_s=None)
    assert mine.proven_optimal and theirs.proven_optimal
    assert mine.to_json() == theirs.to_json()
