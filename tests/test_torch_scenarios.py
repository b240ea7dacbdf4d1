"""The port's scenario generator (``repro_torch.scenarios``) against the JAX
package's on the CPU:

* for seeded draws of every family in both size tiers, the spec's
  ``to_json()`` and the built graph's and architecture's ``to_dict()``
  (insertion order included) equal the reference's;
* a reference ``Scenario.to_json()`` loads through the port's
  ``scenario_from_json`` and builds the same graph and architecture;
* ``ExplorationProblem.from_scenario`` and its JSON round trip equal the
  reference's;
* the property tests of ``tests/test_scenarios.py``, run through the port's
  own ``proptest`` driver on the port's graphs and decoders.
"""
import random
from dataclasses import asdict

import pytest

import repro.core as ref
import repro.scenarios as rsc
import repro_torch.core as port
import repro_torch.scenarios as psc
from repro_torch.bridge import problem_from_json
from repro_torch.core.binding import CHANNEL_DECISIONS
from repro_torch.core.schedule import (
    attach_binding,
    comm_times,
    period_lower_bound,
    validate_schedule,
)
from repro_torch.scenarios import (
    FAMILIES,
    LARGE_PARAM_RANGES,
    PARAM_RANGES,
    SIZE_TIERS,
    ArchParams,
    generate_architecture,
    harmonized,
    sample_scenario,
    sample_scenarios,
    scenario_from_json,
    validate_scenario,
)
from repro_torch.scenarios.proptest import given, settings, st

SEEDS = (0, 1, 7)
OBJS = ("sim_period", "memory", "core_cost")


def _assert_same_build(mine, theirs):
    g, arch = mine.build()
    rg, rarch = theirs.build()
    assert g.to_dict() == rg.to_dict()
    assert arch.to_dict() == rarch.to_dict()
    assert list(g.actors) == list(rg.actors)
    assert list(g.channels) == list(rg.channels)
    assert g.signature() == rg.signature()
    assert arch.signature() == rarch.signature()
    assert sorted(port.multicast_actors(g)) == sorted(ref.multicast_actors(rg))
    return g, arch


def test_registries_match_reference():
    assert sorted(FAMILIES) == sorted(rsc.FAMILIES)
    assert PARAM_RANGES == rsc.PARAM_RANGES
    assert LARGE_PARAM_RANGES == rsc.LARGE_PARAM_RANGES
    assert sorted(SIZE_TIERS) == sorted(rsc.SIZE_TIERS)
    assert psc.__all__ == rsc.__all__


@pytest.mark.parametrize("size", ("standard", "large"))
@pytest.mark.parametrize("family", sorted(rsc.FAMILIES))
def test_sampled_scenarios_build_the_reference_graphs(family, size):
    for seed in SEEDS:
        mine = sample_scenarios(seed=seed, n=2, families=[family], size=size)
        theirs = rsc.sample_scenarios(seed=seed, n=2, families=[family], size=size)
        assert [s.to_json() for s in mine] == [s.to_json() for s in theirs]
        assert [s.name for s in mine] == [s.name for s in theirs]
        for m, t in zip(mine, theirs):
            g, arch = _assert_same_build(m, t)
            validate_scenario(g, arch)


@pytest.mark.parametrize("size", ("standard", "large"))
def test_mixed_family_draws_match_reference(size):
    mine = sample_scenarios(seed=11, n=len(FAMILIES) + 2, size=size)
    theirs = rsc.sample_scenarios(seed=11, n=len(FAMILIES) + 2, size=size)
    assert [s.dumps() for s in mine] == [s.dumps() for s in theirs]
    rng_m, rng_t = random.Random("torch-scenarios"), random.Random("torch-scenarios")
    for _ in range(6):
        assert sample_scenario(rng_m, size=size).to_json() == \
            rsc.sample_scenario(rng_t, size=size).to_json()


def test_reference_spec_loads_through_the_port():
    """The bridge needs nothing for scenarios: a reference spec is plain
    JSON, and the port's generator rebuilds the reference's graphs."""
    for size in ("standard", "large"):
        for theirs in rsc.sample_scenarios(seed=5, n=5, size=size):
            mine = scenario_from_json(theirs.dumps())
            assert mine.to_json() == theirs.to_json()
            _assert_same_build(mine, theirs)
            assert scenario_from_json(theirs.to_json()).to_json() == theirs.to_json()


def test_harmonized_matches_reference():
    for theirs in rsc.sample_scenarios(seed=2, n=5):
        mine = harmonized(scenario_from_json(theirs.to_json()))
        _assert_same_build(mine, rsc.harmonized(theirs))


@pytest.mark.parametrize("family", sorted(rsc.FAMILIES))
def test_problem_from_scenario_matches_reference(family):
    theirs_sc = rsc.sample_scenarios(seed=3, n=1, families=[family])[0]
    mine_sc = scenario_from_json(theirs_sc.to_json())
    rp = ref.ExplorationProblem.from_scenario(theirs_sc, objectives=OBJS, strategy="MRB_Always")
    pp = port.ExplorationProblem.from_scenario(mine_sc, objectives=OBJS, strategy="MRB_Always")
    assert pp.to_json() == rp.to_json()
    assert "scenario" in pp.to_json() and "graph" not in pp.to_json()
    assert pp.graph.to_dict() == rp.graph.to_dict()
    assert pp.arch.to_dict() == rp.arch.to_dict()
    back = problem_from_json(rp.dumps())
    assert back.to_json() == rp.to_json()
    assert back.graph.to_dict() == rp.graph.to_dict()
    assert back.space().actors == rp.space().actors
    assert back.space().allowed == rp.space().allowed
    assert port.ExplorationProblem.from_json(pp.dumps()).dumps() == pp.dumps()


# ------------------------------------------------ tests/test_scenarios.py
@pytest.mark.parametrize("family", sorted(rsc.FAMILIES))
def test_family_generates_valid_graphs(family):
    for sc in sample_scenarios(seed=7, n=6, families=[family]):
        g, arch = sc.build()
        validate_scenario(g, arch)
        assert len(g.actors) >= 2 and len(g.channels) >= 1


def test_families_reach_multicast_actors():
    for family in sorted(FAMILIES):
        total_mc = sum(
            len(port.multicast_actors(sc.build()[0]))
            for sc in sample_scenarios(seed=1, n=8, families=[family])
        )
        assert total_mc > 0, family


def test_scenario_json_roundtrip():
    for sc in sample_scenarios(seed=3, n=5):
        sc2 = scenario_from_json(sc.dumps())
        assert sc2 == sc
        assert sc2.build()[0].signature() == sc.build()[0].signature()


def test_generated_arch_matches_reference():
    for params in (
        ArchParams(tiles=2, cores_per_tile=3, type_mix="hetero", noc_profile="thin_noc"),
        ArchParams(tiles=3, cores_per_tile=4, noc_profile="irregular"),
    ):
        for seed in range(3):
            arch = generate_architecture(params, seed=seed)
            theirs = rsc.generate_architecture(rsc.ArchParams(**asdict(params)), seed=seed)
            assert arch.to_dict() == theirs.to_dict()
    arch = generate_architecture(ArchParams(tiles=3, cores_per_tile=4, noc_profile="irregular"), seed=2)
    a2 = port.ArchitectureGraph.from_dict(arch.to_dict())
    assert a2.route("p_T2_1", "q_global") == arch.route("p_T2_1", "q_global")


def _random_binding(g, arch, rng):
    cores = sorted(arch.cores)
    ba = {
        a: rng.choice([p for p in cores if g.actors[a].can_run_on(arch.cores[p].ctype)])
        for a in g.actors
    }
    cd = {c: rng.choice(CHANNEL_DECISIONS) for c in g.channels}
    return ba, cd


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_caps_hms_valid_on_generated_scenarios(seed):
    """``tests/test_scenarios.py``'s property on the port: every paper
    feasibility condition holds and P is at least the resource lower bound;
    the schedule equals the reference's on the same draw."""
    rng = random.Random(f"sched-prop:{seed}")
    sc = sample_scenario(rng)
    g, arch = sc.build()
    ba, cd = _random_binding(g, arch, rng)
    res = port.decode_via_heuristic(g, arch, cd, ba)
    assert res.feasible, sc.name
    sched = res.schedule
    assert validate_schedule(g, arch, sched) == []
    attach_binding(g, sched.channel_binding)
    read_tau, write_tau = comm_times(g, arch, sched.actor_binding, sched.channel_binding)
    lb = period_lower_bound(g, arch, sched.actor_binding, read_tau, write_tau)
    assert sched.period >= lb
    for a in g.actors:
        ctype = arch.cores[sched.actor_binding[a]].ctype
        t_in = sum(read_tau[(c, a)] for c in g.in_channels(a))
        t_out = sum(write_tau[(a, c)] for c in g.out_channels(a))
        assert t_in + g.actors[a].exec_times[ctype] + t_out <= sched.period
    rg, rarch = rsc.sample_scenario(random.Random(f"sched-prop:{seed}")).build()
    theirs = ref.decode_via_heuristic(rg, rarch, cd, ba)
    assert sched.to_json() == theirs.schedule.to_json()


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_pipelined_mrb_decode_valid_on_generated_scenarios(seed):
    rng = random.Random(f"sched-mrb-prop:{seed}")
    sc = sample_scenario(rng)
    g, arch = sc.build()
    gt = port.pipeline_delays(port.substitute_mrbs(g, {a: 1 for a in port.multicast_actors(g)}))
    ba, cd = _random_binding(gt, arch, rng)
    res = port.decode_via_heuristic(gt, arch, cd, ba)
    assert res.feasible, sc.name
    assert validate_schedule(gt, arch, res.schedule) == []


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 10_000), partial=st.booleans())
def test_mrb_substitution_never_increases_buffering(seed, partial):
    rng = random.Random(f"mrb-prop:{seed}")
    sc = sample_scenario(rng)
    g, _ = sc.build()
    mcs = port.multicast_actors(g)
    xi = {a: (rng.randint(0, 1) if partial else 1) for a in mcs}
    gt = port.substitute_mrbs(g, xi)
    assert sum(ch.capacity for ch in gt.channels.values()) <= sum(
        ch.capacity for ch in g.channels.values())
    assert sum(ch.capacity * ch.token_bytes for ch in gt.channels.values()) <= sum(
        ch.capacity * ch.token_bytes for ch in g.channels.values())
    replaced = [a for a in mcs if xi[a]]
    assert sorted(port.multicast_actors(gt)) == sorted(a for a in mcs if not xi[a])
    assert len(gt.actors) == len(g.actors) - len(replaced)
    for a in replaced:
        outs = g.out_channels(a)
        ch = gt.channels["mrb{" + ",".join(sorted(g.in_channels(a) + outs)) + "}"]
        assert ch.is_mrb
        assert sorted(gt.consumers[ch.name]) == sorted(r for c in outs for r in g.consumers[c])
        cin, cout = g.channels[g.in_channels(a)[0]], g.channels[outs[0]]
        assert ch.capacity == cin.capacity + cout.capacity
        assert (ch.token_bytes, ch.delay) == (cin.token_bytes, cin.delay)
    rg, _ = rsc.sample_scenario(random.Random(f"mrb-prop:{seed}")).build()
    assert gt.to_dict() == ref.substitute_mrbs(rg, xi).to_dict()
