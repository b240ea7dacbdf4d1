"""The port's host core against the JAX package: graph and architecture
round trips through the bridge, caps_hms decodes, the ξ transform, and the
torch MRB index mirror.  Every comparison is exact equality."""
import os

os.environ.setdefault("REPRO_SIM_CACHE_DIR", "0")

import random

import jax  # noqa: F401  (both frameworks live in one test process)
import numpy as np
import pytest
import torch

import repro.core as ref
from repro.core.mrb import (
    jax_mrb_available,
    jax_mrb_free,
    jax_mrb_init,
    jax_mrb_read,
    jax_mrb_write,
)
from repro.scenarios import sample_scenarios

import repro_torch.core as port
from repro_torch.bridge import arch_from_dict, graph_from_dict, schedule_from_json
from repro_torch.core.mrb import (
    torch_mrb_available,
    torch_mrb_free,
    torch_mrb_init,
    torch_mrb_read,
    torch_mrb_write,
)


def _cases():
    """(reference graph, reference arch, port graph, port arch).  The paper
    apps are built by each package's own constructors; a scenario is built
    by the reference and carried across.  Dict order feeds caps_hms's
    tie-breaks, so the reference side of a carried scenario is its own
    round trip (``to_dict`` sorts actors and channels)."""
    out = [
        (rf(), ref.paper_architecture(), pf(), port.paper_architecture())
        for rf, pf in ((ref.sobel, port.sobel), (ref.sobel4, port.sobel4),
                       (ref.multicamera, port.multicamera))
    ]
    for sc in sample_scenarios(seed=0, n=3):
        g, arch = sc.build()
        d = g.to_dict()
        out.append((ref.ApplicationGraph.from_dict(d), arch,
                    graph_from_dict(d), arch_from_dict(arch.to_dict())))
    return out


CASES = _cases()
CASE_IDS = [c[0].name for c in CASES]


def _random_inputs(gt, arch, rng):
    cores = sorted(arch.cores)
    ba = {
        a: rng.choice([p for p in cores if gt.actors[a].can_run_on(arch.cores[p].ctype)])
        for a in sorted(gt.actors)
    }
    cd = {c: rng.choice(ref.CHANNEL_DECISIONS) for c in sorted(gt.channels)}
    return ba, cd


@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_graph_and_arch_round_trip(case):
    g, arch, own_g, own_arch = CASES[case]
    assert own_g.to_dict() == g.to_dict()
    assert own_arch.to_dict() == arch.to_dict()
    pg, pa = graph_from_dict(g.to_dict()), arch_from_dict(arch.to_dict())
    assert pg.to_dict() == g.to_dict()
    assert pa.to_dict() == arch.to_dict()
    assert pg.signature() == g.signature()
    assert pa.signature() == arch.signature()
    assert sorted(port.multicast_actors(pg)) == sorted(ref.multicast_actors(g))


@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_caps_hms_decode_matches_reference(case):
    """The ξ transform and caps_hms decode of the port reproduce the
    reference's transformed graph and ``Schedule.to_json()`` exactly."""
    g, arch, pg, pa = CASES[case]
    rng = random.Random(f"torch-decode:{case}")
    decoded = 0
    for trial in range(6):
        xi = {a: rng.randint(0, 1) for a in sorted(ref.multicast_actors(g))}
        gt = ref.pipeline_delays(ref.substitute_mrbs(g, xi))
        pgt = port.pipeline_delays(port.substitute_mrbs(pg, xi))
        assert pgt.to_dict() == gt.to_dict()
        ba, cd = _random_inputs(gt, arch, rng)
        r = ref.decode_via_heuristic(gt, arch, cd, ba)
        p = port.decode_via_heuristic(pgt, pa, cd, ba)
        assert p.feasible == r.feasible
        if r.feasible:
            decoded += 1
            assert p.schedule.to_json() == r.schedule.to_json()
            back = schedule_from_json(r.schedule.to_json())
            assert back.to_json() == r.schedule.to_json()
    assert decoded > 0


def _mirror_ops(seed):
    rng = np.random.default_rng(seed)
    capacity = int(rng.integers(1, 7))
    n_readers = int(rng.integers(1, 4))
    ops = rng.integers(0, 4, size=int(rng.integers(0, 41))).tolist()
    return capacity, n_readers, ops


@pytest.mark.parametrize("seed", range(4))
def test_torch_mrb_mirror_matches_reference(seed):
    """The torch MRB index mirror matches the JAX mirror and both
    ``MRBState`` machines over seeded operation sequences (the property of
    ``tests/test_mrb.py::test_jax_mirror_matches_python``)."""
    for k in range(8):
        capacity, n_readers, ops = _mirror_ops(seed * 100 + k)
        readers = tuple(f"r{i}" for i in range(n_readers))
        m_ref = ref.MRBState(capacity, readers)
        m_port = port.MRBState(capacity, readers)
        jo, jr = jax_mrb_init(capacity, n_readers)
        to, tr = torch_mrb_init(capacity, n_readers)
        for op in ops:
            tav = torch_mrb_available(to, tr, capacity)
            assert tav.tolist() == np.asarray(jax_mrb_available(jo, jr, capacity)).tolist()
            assert tav.tolist() == [m_ref.available(r) for r in readers]
            assert int(torch_mrb_free(to, tr, capacity)) == int(jax_mrb_free(jo, jr, capacity))
            assert int(torch_mrb_free(to, tr, capacity)) == m_ref.free()
            if op == 0 and m_ref.can_write():
                m_ref.write()
                m_port.write()
                jo, jr = jax_mrb_write(jo, jr, capacity)
                to, tr = torch_mrb_write(to, tr, capacity)
            elif op > 0:
                i = (op - 1) % n_readers
                if m_ref.can_read(readers[i]):
                    m_ref.read(readers[i])
                    m_port.read(readers[i])
                    jr = jax_mrb_read(jo, jr, capacity, i)
                    tr = torch_mrb_read(to, tr, capacity, i)
            assert to.dtype == tr.dtype == torch.int32
            assert int(to) == int(jo) == m_ref.write_index
            assert tr.tolist() == np.asarray(jr).tolist()
            assert tr.tolist() == [m_ref.read_index[r] for r in readers]
            assert m_port.snapshot() == m_ref.snapshot()
