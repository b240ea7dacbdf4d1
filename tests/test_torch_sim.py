"""The port's batched simulator against the JAX package's three backends.

Schedules are decoded by the reference and carried across with the
bridge; both sides simulate the same round-tripped graph (``to_dict``
sorts actors and channels, and channel order fixes each window's task
order).  The port's plain batched program runs on the CPU and must give
firing tables, horizons, deadlock flags and periods exactly equal to the
Pallas kernel in interpret mode, to ``vectorized`` and to ``events``.
"""
import os

os.environ.setdefault("REPRO_SIM_CACHE_DIR", "0")

import random
from dataclasses import asdict

import jax  # noqa: F401  (both frameworks live in one test process)
import numpy as np
import pytest
import torch

import repro.core as ref
import repro.sim as rsim
import repro.sim.vectorized as rvec
from conftest import make_pipelined_sobel, random_decode
from repro.core.schedule import attach_binding, comm_times, period_lower_bound
from repro.scenarios import ArchParams, generate_architecture, sample_scenario, sample_scenarios

import repro_torch.sim as psim
import repro_torch.sim.batched as pbat
from repro_torch.bridge import arch_from_dict, graph_from_dict, schedule_from_json
from repro_torch.kernels import sim_step as psim_step

CPU = torch.device("cpu")


def _carry(gt, arch, scheds):
    """Reference and port copies of one batch, on the same graph order."""
    d = gt.to_dict()
    rg = ref.ApplicationGraph.from_dict(d)
    pg, pa = graph_from_dict(d), arch_from_dict(arch.to_dict())
    ps = [schedule_from_json(s.to_json()) for s in scheds]
    return rg, pg, pa, ps


def _port_cfg(cfg):
    return psim.SimConfig(**asdict(cfg))


def _assert_raw_equal(rg, arch, scheds, pg, pa, ps, cfg, backends):
    """The raw (fire, dead, horizon) arrays of one batched call."""
    iters = max(2, cfg.iterations)
    rprogs = [rsim.lower_phenotype(rg, arch, s) for s in scheds]
    pprogs = [psim.lower_phenotype(pg, pa, s) for s in ps]
    fire, dead, hor = pbat._run_batch(pprogs, iters, _port_cfg(cfg), "torch", CPU)
    for be in backends:
        rf, rd, rh = rvec._run_batch(rprogs, iters, cfg, be, False)
        assert np.array_equal(fire, rf), be
        assert np.array_equal(dead, rd), be
        assert np.array_equal(hor, rh), be


def _assert_parity(gt, arch, scheds, cfg, *, pallas=True, port_backend="torch"):
    rg, pg, pa, ps = _carry(gt, arch, scheds)
    backends = ("vectorized", "pallas") if pallas else ("vectorized",)
    _assert_raw_equal(rg, arch, scheds, pg, pa, ps, cfg, backends)
    mine = psim.batch_simulate(
        pg, pa, ps, _port_cfg(cfg), backend=port_backend, device="cpu"
    )
    ev = [rsim.simulate(rg, arch, s, cfg) for s in scheds]
    for be in backends:
        theirs = rsim.batch_simulate(rg, arch, scheds, cfg, backend=be)
        for m, t in zip(mine, theirs):
            assert m.fire_times == t.fire_times, be
            assert m.period == t.period, be
            assert m.deadlocked == t.deadlocked, be
            assert m.converged == t.converged, be
            assert m.horizon == t.horizon, be
            assert m.iterations == t.iterations, be
    for m, e in zip(mine, ev):
        assert m.fire_times == e.fire_times
        assert m.period == e.period
        assert m.deadlocked == e.deadlocked
    return mine


NO_TRACE = rsim.SimConfig(trace=False)


def test_lowering_matches_reference():
    """The port's dense lowering equals ``repro.sim.vectorized._lower_batch``
    on a Sobel batch and a multicast_tree batch, both with MRBs."""
    gt, arch = make_pipelined_sobel()
    rng = random.Random(3)
    batches = [(gt, arch, [random_decode(gt, arch, rng).schedule for _ in range(3)])]
    sc = sample_scenarios(seed=0, n=1, families=["multicast_tree"])[0]
    g, sarch = sc.build()
    sgt = ref.pipeline_delays(
        ref.substitute_mrbs(g, {a: 1 for a in ref.multicast_actors(g)})
    )
    batches.append((sgt, sarch, [random_decode(sgt, sarch, rng).schedule for _ in range(2)]))
    readers = []
    for bgt, barch, scheds in batches:
        rg, pg, pa, ps = _carry(bgt, barch, scheds)
        rs, rb = rvec._lower_batch([rsim.lower_phenotype(rg, barch, s) for s in scheds])
        progs = [psim.lower_phenotype(pg, pa, s) for s in ps]
        ms, mb = pbat._lower_batch(progs)
        assert rs.keys() == ms.keys() and rb.keys() == mb.keys()
        for k in rs:
            assert np.array_equal(np.asarray(rs[k]), np.asarray(ms[k])), k
        for k in rb:
            assert np.array_equal(rb[k], mb[k]), k
        tab = pbat.compact_tables(ms, mb, CPU)
        assert tab.B == len(scheds) and tab.A == ms["A"] and tab.C == ms["C"]
        readers.append(ms["R"])
    assert min(readers) > 1  # both batches hold multi-reader buffers


def test_plain_matches_reference_on_sobel_batch():
    """As ``tests/test_sim.py::test_vectorized_matches_events_on_sobel_batch``,
    against all three reference backends."""
    gt, arch = make_pipelined_sobel()
    rng = random.Random(3)
    scheds = [random_decode(gt, arch, rng).schedule for _ in range(4)]
    _assert_parity(gt, arch, scheds, NO_TRACE)


def test_plain_matches_reference_with_mrb_ports():
    """The ``mrb_ports`` branch, as ``test_vectorized_matches_events_with_mrb_ports``."""
    gt, arch = make_pipelined_sobel()
    rng = random.Random(4)
    scheds = [random_decode(gt, arch, rng).schedule for _ in range(2)]
    _assert_parity(gt, arch, scheds, rsim.SimConfig(trace=False, mrb_ports=1))


def test_kernel_wrapper_uses_plain_version_on_cpu_tensors():
    """``backend="cuda"`` on CPU tensors runs the plain program (no launch)."""
    gt, arch = make_pipelined_sobel()
    rng = random.Random(5)
    scheds = [random_decode(gt, arch, rng).schedule for _ in range(2)]
    before = psim_step.launches
    _assert_parity(gt, arch, scheds, NO_TRACE, pallas=False, port_backend="cuda")
    assert psim_step.launches == before


def _huge(exec_time):
    g = ref.ApplicationGraph("huge")
    g.add_actor("A", {"t1": exec_time})
    g.add_actor("B", {"t1": exec_time})
    g.add_channel("c", "A", "B", delay=1, capacity=2, token_bytes=64)
    arch = generate_architecture(
        ArchParams(tiles=1, cores_per_tile=2, type_mix="fast_only"), seed=0
    )
    cores = sorted(arch.cores)
    res = ref.decode_via_heuristic(g, arch, {"c": "PROD"}, {"A": cores[0], "B": cores[1]})
    assert res.feasible
    return g, arch, res.schedule


def test_predicted_overflow_routes_to_events(monkeypatch):
    """As ``test_int32_overflow_predicted_routes_to_events_backend``: the
    guard sends the phenotype to the exact events backend, counted."""
    g, arch, sched = _huge(2**24)
    rg, pg, pa, ps = _carry(g, arch, [sched])
    prog = psim.lower_phenotype(pg, pa, ps[0])
    assert psim.model.predict_horizon(prog, _port_cfg(NO_TRACE)) > pbat.INT32_SAFE_HORIZON

    def _boom(*a, **k):
        raise AssertionError("int32 path used despite overflow risk")

    monkeypatch.setattr(pbat, "_run_batch", _boom)
    before = pbat.int32_fallbacks
    (v,) = psim.batch_simulate(pg, pa, ps, _port_cfg(NO_TRACE), backend="torch", device="cpu")
    assert pbat.int32_fallbacks == before + 1
    e = rsim.simulate(rg, arch, sched, NO_TRACE)
    assert v.fire_times == e.fire_times and v.period == e.period


def test_plain_wraps_int32_like_reference():
    """Below the guard, a run whose event times pass 2**31 wraps exactly as
    the reference's int32 state does (the outputs the post-check reads)."""
    g, arch, sched = _huge(2**27)
    rg, pg, pa, ps = _carry(g, arch, [sched])
    _assert_raw_equal(rg, arch, [sched], pg, pa, ps, NO_TRACE, ("vectorized", "pallas"))
    iters = NO_TRACE.iterations
    prog = psim.lower_phenotype(pg, pa, ps[0])
    fire, _, hor = pbat._run_batch([prog], iters, _port_cfg(NO_TRACE), "torch", CPU)
    assert hor[0] < 0 or (fire < -1).any()


SCENARIOS = sample_scenarios(seed=0, n=4)


@pytest.mark.parametrize("idx", range(len(SCENARIOS)), ids=[s.name for s in SCENARIOS])
def test_plain_matches_reference_on_scenarios(idx):
    """Four sampled scenarios across families, random ξ and caps_hms."""
    sc = SCENARIOS[idx]
    g, arch = sc.build()
    rng = random.Random(f"torch-sim:{idx}")
    gt = ref.pipeline_delays(
        ref.substitute_mrbs(g, {a: rng.randint(0, 1) for a in ref.multicast_actors(g)})
    )
    scheds = [random_decode(gt, arch, rng).schedule for _ in range(2)]
    _assert_parity(gt, arch, scheds, NO_TRACE)


def test_known_lower_bound_exception_seed_9182():
    """Known exception to the period lower-bound invariant, not a port
    fault: at hypothesis seed 9182 of the reference's parity sweep
    (``random_dag#827879@2x2``, caps_hms) all reference backends simulate a
    period of 43.0 under the resource lower bound of 44.  The port must
    reproduce those firing times exactly."""
    rng = random.Random("sim-parity:9182")
    sc = sample_scenario(rng)
    assert sc.name == "random_dag#827879@2x2"
    g, arch = sc.build()
    gt = ref.pipeline_delays(
        ref.substitute_mrbs(g, {a: rng.randint(0, 1) for a in ref.multicast_actors(g)})
    )
    res = random_decode(gt, arch, rng, decoder="caps_hms")
    (mine,) = _assert_parity(gt, arch, [res.schedule], NO_TRACE)
    attach_binding(gt, res.schedule.channel_binding)
    rt, wt = comm_times(gt, arch, res.schedule.actor_binding, res.schedule.channel_binding)
    lb = period_lower_bound(gt, arch, res.schedule.actor_binding, rt, wt)
    assert (mine.period, lb) == (43.0, 44)
