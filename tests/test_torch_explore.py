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
