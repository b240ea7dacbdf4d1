"""The port's exploration path against the JAX package's: NSGA-II and
random search on Sobel with the ``sim_period`` objective, the plain batched
simulator on the CPU standing in for the kernel.  Fronts, archives and
trajectories must be exactly equal."""
import os

os.environ.setdefault("REPRO_SIM_CACHE_DIR", "0")

import jax  # noqa: F401  (both frameworks live in one test process)
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from repro_torch.bridge import problem_from_json, run_from_json

OBJS = ("sim_period", "memory", "core_cost")


def _problems(strategy="MRB_Explore"):
    rp = ref.ExplorationProblem(
        graph=ref.sobel(), arch=ref.paper_architecture(), strategy=strategy,
        objectives=OBJS,
    )
    pp = port.ExplorationProblem(
        graph=port.sobel(), arch=port.paper_architecture(), strategy=strategy,
        objectives=OBJS,
    )
    return rp, pp


def _assert_same_run(mine, theirs):
    carried = run_from_json(theirs.to_json())
    assert mine.front == theirs.front
    assert [(i.genotype, i.objectives) for i in mine.archive] == [
        (i.genotype, i.objectives) for i in carried.archive
    ]
    assert mine.history == carried.history
    assert mine.hv_history == carried.hv_history
    assert mine.evaluations == theirs.evaluations
    assert mine.problem.to_json() == carried.problem.to_json()


def test_nsga2_front_matches_reference():
    """As ``tests/test_sim.py::test_engine_batched_backends_are_bit_identical``:
    the reference with inline events vs the port's plain batched program."""
    rp, pp = _problems()
    explorer = dict(population=10, offspring=5, generations=2, seed=5)
    with rp.make_engine(sim_backend=None) as eng:
        theirs = ref.NSGA2Explorer(**explorer).explore(rp, engine=eng)
    with pp.make_engine(sim_backend="torch", device="cpu") as eng:
        mine = port.NSGA2Explorer(**explorer).explore(pp, engine=eng)
    assert mine.meta == {"sim_backend": "torch", "device": "cpu"}
    _assert_same_run(mine, theirs)


def test_random_search_matches_reference():
    rp, pp = _problems("MRB_Always")
    with rp.make_engine(sim_backend=None) as eng:
        theirs = ref.RandomSearchExplorer(samples=12, batch=6, seed=3).explore(rp, engine=eng)
    with pp.make_engine(sim_backend="cuda", device="cpu") as eng:
        mine = port.RandomSearchExplorer(samples=12, batch=6, seed=3).explore(pp, engine=eng)
    _assert_same_run(mine, theirs)


def test_events_backend_and_process_pool_match():
    """The port's inline events route, and decodes in a spawn-context
    process pool, give the reference's front."""
    rp, pp = _problems()
    explorer = dict(population=8, offspring=4, generations=1, seed=2)
    with rp.make_engine(sim_backend=None) as eng:
        theirs = ref.NSGA2Explorer(**explorer).explore(rp, engine=eng)
    with pp.make_engine(sim_backend="events", device="cpu") as eng:
        mine = port.NSGA2Explorer(**explorer).explore(pp, engine=eng)
    _assert_same_run(mine, theirs)
    with pp.make_engine(sim_backend="torch", device="cpu", n_workers=2) as eng:
        pooled = port.NSGA2Explorer(**explorer).explore(pp, engine=eng)
    _assert_same_run(pooled, theirs)


def test_problem_carries_across():
    rp, _ = _problems()
    pp = problem_from_json(rp.to_json())
    assert pp.to_json() == rp.to_json()
    assert pp.space().actors == rp.space().actors
    assert pp.space().allowed == rp.space().allowed


def test_default_device_is_the_card():
    """Entry points run on the card unless the caller asks for the CPU:
    without one, building an engine with the default device raises."""
    _, pp = _problems()
    if torch.cuda.is_available():
        with pp.make_engine() as eng:
            assert eng.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            pp.make_engine()
    with pytest.raises(KeyError, match="unknown decoder"):
        port.ExplorationProblem(graph=port.sobel(), arch=port.paper_architecture(),
                                decoder="no_such_decoder")


# ------------------------------------------------------- sim_backend="auto"
@pytest.mark.parametrize("device,want", [
    ("cpu", "torch"), (torch.device("cpu"), "torch"),
    ("cuda", "cuda"), (torch.device("cuda", 0), "cuda"),
])
def test_auto_backend_resolution_regimes(device, want):
    """The regimes of ``resolve_sim_backend``: groups below
    ``AUTO_MIN_BATCH`` to the event simulator, the rest to the kernel on a
    CUDA engine and to the plain program on a CPU one; the task count
    chooses nothing."""
    for n_tasks in (1, 10_000):
        for batch in range(port.AUTO_MIN_BATCH):
            assert port.resolve_sim_backend(batch, n_tasks, device) == "events"
        for batch in (port.AUTO_MIN_BATCH, port.AUTO_MIN_BATCH + 1, 256):
            assert port.resolve_sim_backend(batch, n_tasks, device) == want


def test_auto_backend_engine_matches_reference_and_records_choices():
    """``auto`` on a CPU engine: the reference's front (its inline events),
    the choices in ``run.meta`` as a per-run delta of the engine's counts,
    and the meta through the run JSON."""
    rp, pp = _problems("MRB_Always")
    explorer = dict(population=10, offspring=5, generations=1, seed=7)
    with rp.make_engine(sim_backend=None) as eng:
        theirs = ref.NSGA2Explorer(**explorer).explore(rp, engine=eng)
    with pp.make_engine(sim_backend="auto", device="cpu") as eng:
        mine = port.NSGA2Explorer(**explorer).explore(pp, engine=eng)
        again = port.NSGA2Explorer(**explorer).explore(pp, engine=eng)
        total = dict(eng.sim_backend_choices)
    _assert_same_run(mine, theirs)
    assert mine.meta["sim_backend"] == "auto" and mine.meta["device"] == "cpu"
    # The 10 initial phenotypes, one ξ group, go to the plain program.
    assert mine.meta["sim_backend_choices"]["torch"] >= 1
    assert set(mine.meta["sim_backend_choices"]) <= {"events", "torch"}
    merged = dict(mine.meta["sim_backend_choices"])
    for k, v in again.meta.get("sim_backend_choices", {}).items():
        merged[k] = merged.get(k, 0) + v
    assert merged == total
    assert port.ExplorationRun.from_json(mine.to_json()).meta == mine.meta


def test_auto_backend_singleton_groups_follow_the_threshold():
    """Single-genotype evaluations are ξ groups of one: they go where
    ``AUTO_MIN_BATCH`` sends a group of one."""
    want = "events" if port.AUTO_MIN_BATCH > 1 else "torch"
    _, pp = _problems("MRB_Always")
    space = pp.space()
    import random

    rng = random.Random(0)
    with pp.make_engine(sim_backend="auto", device="cpu") as eng:
        for _ in range(6):
            eng.evaluate(space.force_xi(space.random(rng), 1))
        assert eng.sim_backend_choices == {want: 6}
