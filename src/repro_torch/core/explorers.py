"""Swappable search algorithms over :class:`ExplorationProblem`s.

An :class:`Explorer` consumes a declarative problem (graph + architecture +
objectives + strategy + decoder) and produces an :class:`ExplorationRun` —
archive, per-generation fronts, per-generation hypervolume, decode/cache
stats — with JSON save/load under ``runs/``.  Two implementations:

* :class:`NSGA2Explorer` — the paper's elitist μ+λ NSGA-II loop (Fig. 6);
  every RNG draw and its order follow the JAX package's loop, so fixed-seed
  fronts are bit-identical to it;
* :class:`RandomSearchExplorer` — a seeded random-search baseline that
  proves the seam: same problem, same engine, same result type, different
  search.

The device-resident ``torch_nsga2`` (:mod:`repro_torch.evo`) registers
itself when the registry is first asked.

Explorers are registered by name (``register_explorer``) so experiment
drivers can select them declaratively, mirroring the decoder and objective
registries.  Following De Matteis et al. (Streaming Task Graph Scheduling
for Dataflow Architectures), the problem interface is the stable seam:
adding a scheduler, an objective, or a search algorithm never edits the
MOEA core.
"""
from __future__ import annotations

import hashlib
import json
import os
import random
import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Protocol, Sequence, Type, Union

from .dse import Genotype, Individual, Objectives, xi_mode
from .pareto import (
    crowding_distance,
    fast_nondominated_sort,
    nondominated,
    relative_hypervolume,
)
from .problem import ExplorationProblem

__all__ = [
    "Explorer",
    "EXPLORERS",
    "register_explorer",
    "get_explorer",
    "explorer_names",
    "ExplorationRun",
    "NSGA2Explorer",
    "RandomSearchExplorer",
]


# ==========================================================================
@dataclass
class ExplorationRun:
    """The result of one exploration: archive + trajectory + provenance.

    ``history`` holds the archive's objective vectors after every
    generation (index 0 = after the initial population); ``hv_history``
    holds the matching relative hypervolume of each generation's front
    against the run's *final* front, so convergence is a single curve.
    Schedules are kept in memory on the archive's individuals but are not
    serialized — a run round-trips through JSON as genotypes + objectives.
    """

    problem: ExplorationProblem
    explorer: str
    params: Dict[str, Any] = field(default_factory=dict)
    archive: List[Individual] = field(default_factory=list)
    history: List[List[Objectives]] = field(default_factory=list)
    hv_history: List[float] = field(default_factory=list)
    evaluations: int = 0   # decodes actually performed (cache misses)
    cache_hits: int = 0
    cache_misses: int = 0
    wall_s: float = 0.0
    # Free-form provenance (serialized): e.g. the engine's sim_backend.
    meta: Dict[str, Any] = field(default_factory=dict)

    @property
    def front(self) -> List[Objectives]:
        return nondominated([i.objectives for i in self.archive if i.feasible])

    # ----------------------------------------------------------- serialize
    def to_json(self) -> Dict[str, Any]:
        return {
            "problem": self.problem.to_json(),
            "explorer": self.explorer,
            "params": dict(self.params),
            "archive": [
                {
                    "genotype": {
                        "xi": list(i.genotype.xi),
                        "cd": list(i.genotype.cd),
                        "ba": list(i.genotype.ba),
                    },
                    "objectives": list(i.objectives),
                }
                for i in self.archive
            ],
            "history": [[list(p) for p in gen] for gen in self.history],
            "hv_history": list(self.hv_history),
            "evaluations": self.evaluations,
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "wall_s": self.wall_s,
            "meta": dict(self.meta),
            "front": [list(p) for p in self.front],  # derived, for readers
        }

    def save(self, path: Optional[str] = None, *, out_dir: str = "runs") -> str:
        """Write the run as JSON; the default path is content-addressed
        under ``runs/`` over the run's *deterministic* content (problem,
        params, archive, trajectory — not wall time or cache stats), so
        repeated identical runs land on one file."""
        d = self.to_json()
        blob = json.dumps(d, sort_keys=True)
        if path is None:
            stable = {
                k: d[k]
                for k in ("problem", "explorer", "params", "archive", "history")
            }
            digest = hashlib.sha256(
                json.dumps(stable, sort_keys=True).encode()
            ).hexdigest()[:12]
            name = f"{self.explorer}_{self.problem.graph.name}_{digest}.json"
            path = os.path.join(out_dir, name)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(blob)
        return path

    @classmethod
    def from_json(cls, d: Union[str, Dict[str, Any]]) -> "ExplorationRun":
        if isinstance(d, str):
            d = json.loads(d)
        archive = [
            Individual(
                Genotype(
                    tuple(a["genotype"]["xi"]),
                    tuple(a["genotype"]["cd"]),
                    tuple(a["genotype"]["ba"]),
                ),
                tuple(float(v) for v in a["objectives"]),
                None,
            )
            for a in d.get("archive", [])
        ]
        return cls(
            problem=ExplorationProblem.from_json(d["problem"]),
            explorer=d["explorer"],
            params=dict(d.get("params", {})),
            archive=archive,
            history=[
                [tuple(float(v) for v in p) for p in gen]
                for gen in d.get("history", [])
            ],
            hv_history=[float(v) for v in d.get("hv_history", [])],
            evaluations=d.get("evaluations", 0),
            cache_hits=d.get("cache_hits", 0),
            cache_misses=d.get("cache_misses", 0),
            wall_s=d.get("wall_s", 0.0),
            meta=dict(d.get("meta", {})),
        )

    @classmethod
    def load(cls, path: str) -> "ExplorationRun":
        with open(path) as f:
            return cls.from_json(json.load(f))


# ==========================================================================
class Explorer(Protocol):
    """A search algorithm over an :class:`ExplorationProblem`."""

    name: str

    def explore(
        self,
        problem: ExplorationProblem,
        *,
        engine=None,
        on_generation: Optional[Callable[[int, ExplorationRun], None]] = None,
    ) -> ExplorationRun: ...


EXPLORERS: Dict[str, Type] = {}


def register_explorer(name: str) -> Callable[[Type], Type]:
    def deco(cls: Type) -> Type:
        cls.name = name
        EXPLORERS[name] = cls
        return cls

    return deco


def _load_plugin_explorers() -> None:
    """Explorers living outside this module register on import; the
    device-resident ``torch_nsga2`` (:mod:`repro_torch.evo`) is deferred
    because its subsystem is heavier than the registry itself."""
    from .. import evo  # noqa: F401  (import side effect: registration)


def get_explorer(name: str, **params) -> Explorer:
    """Instantiate a registered explorer by name."""
    _load_plugin_explorers()
    try:
        cls = EXPLORERS[name]
    except KeyError:
        raise KeyError(
            f"unknown explorer {name!r}; registered: {explorer_names()}"
        ) from None
    return cls(**params)


def explorer_names() -> List[str]:
    _load_plugin_explorers()
    return sorted(EXPLORERS)


# ------------------------------------------------------------------ shared
def _check_engine(engine, problem: ExplorationProblem) -> None:
    """A shared engine must have been built for this problem's graphs and
    objective layout.  Decoder settings intentionally follow the *engine*
    when it is shared across runs (its cache entries embed them), but an
    objective mismatch would silently change the meaning of every archived
    vector, so it is an error."""
    space = engine.space
    if space.g is not problem.graph and space.g.signature() != problem.graph.signature():
        raise ValueError(
            "engine was built for a different application graph "
            f"({space.g.name!r} vs {problem.graph.name!r})"
        )
    if (
        space.arch is not problem.arch
        and space.arch.signature() != problem.arch.signature()
    ):
        raise ValueError(
            "engine was built for a different architecture "
            f"({space.arch.name!r} vs {problem.arch.name!r})"
        )
    if engine.objective_names != tuple(problem.objectives):
        raise ValueError(
            "engine was built for different objectives "
            f"({engine.objective_names} vs {tuple(problem.objectives)})"
        )


def _xi_fixer(space, mode: str) -> Callable[[Genotype], Genotype]:
    """Strategy-forced ξ: Reference pins 0, MRB_Always pins 1,
    MRB_Explore leaves the bits free."""

    def fix(gt: Genotype) -> Genotype:
        if mode == "never":
            return space.force_xi(gt, 0)
        if mode == "always":
            return space.force_xi(gt, 1)
        return gt

    return fix


def _update_archive(run: ExplorationRun, pop: Sequence[Individual]) -> None:
    """Fold a population into the nondominated-so-far archive (objectives
    deduplicated, first-seen individual kept)."""
    pool = run.archive + [i for i in pop if i.feasible]
    objs = [i.objectives for i in pool]
    nd = set(nondominated(objs))
    seen = set()
    archive = []
    for i in pool:
        if i.objectives in nd and i.objectives not in seen:
            archive.append(i)
            seen.add(i.objectives)
    run.archive = archive


def _finalize_hypervolume(run: ExplorationRun) -> None:
    """Per-generation relative hypervolume against the run's final front."""
    final = run.front
    run.hv_history = [
        relative_hypervolume(nondominated(gen), final) if final else 0.0
        for gen in run.history
    ]


def _record_engine_meta(run: ExplorationRun, engine) -> None:
    """Provenance: which sim backend evaluated this run, on which device."""
    run.meta["sim_backend"] = engine.sim_backend
    run.meta["device"] = str(engine.device)


# ==========================================================================
@register_explorer("nsga2")
class NSGA2Explorer:
    """NSGA-II main loop (paper Fig. 6): creator → decode/evaluate →
    selector (rank + crowding tournament) → recombinator (crossover +
    mutation) → elitist μ+λ truncation.

    The loop body — including every RNG draw and its order — matches the
    JAX package's ``NSGA2Explorer`` exactly, so fixed-seed fronts are
    bit-identical to it.  A subclass swaps the ranking core by overriding
    :meth:`rank_crowd`, or the whole search by overriding ``_evolve``.
    """

    def __init__(
        self,
        *,
        population: int = 100,
        offspring: int = 25,
        generations: int = 2500,
        crossover_rate: float = 0.95,
        seed: int = 0,
        time_budget_s: Optional[float] = None,
        track_hypervolume: bool = True,
    ) -> None:
        self.population = population
        self.offspring = offspring
        self.generations = generations
        self.crossover_rate = crossover_rate
        self.seed = seed
        self.time_budget_s = time_budget_s
        self.track_hypervolume = track_hypervolume

    def params(self) -> Dict[str, Any]:
        return {
            "population": self.population,
            "offspring": self.offspring,
            "generations": self.generations,
            "crossover_rate": self.crossover_rate,
            "seed": self.seed,
            "time_budget_s": self.time_budget_s,
        }

    def rank_crowd(self, objs: List[Objectives], engine) -> tuple:
        """``(rank, crowd)`` dicts of ``objs`` by index: the front each
        point lies in and its crowding distance within that front."""
        fronts = fast_nondominated_sort(objs)
        rank = {}
        crowd = {}
        for fi, front in enumerate(fronts):
            rank.update({i: fi for i in front})
            crowd.update(crowding_distance(objs, front))
        return rank, crowd

    def explore(
        self,
        problem: ExplorationProblem,
        *,
        engine=None,
        on_generation: Optional[Callable[[int, ExplorationRun], None]] = None,
    ) -> ExplorationRun:
        t0 = time.monotonic()
        own_engine = engine is None
        if engine is None:
            engine = problem.make_engine()
        else:
            _check_engine(engine, problem)
        # Snapshot the problem: drivers may mutate e.g. problem.strategy
        # between explores, and the run's provenance must not drift.
        run = ExplorationRun(replace(problem), self.name, self.params())
        ev0, hit0, miss0 = engine.evaluations, engine.hits, engine.misses

        try:
            self._evolve(problem, engine, run, t0, on_generation)
            run.evaluations = engine.evaluations - ev0
            run.cache_hits = engine.hits - hit0
            run.cache_misses = engine.misses - miss0
            _record_engine_meta(run, engine)
        finally:
            if own_engine:
                engine.close()
        if self.track_hypervolume:
            _finalize_hypervolume(run)
        run.wall_s = time.monotonic() - t0
        return run

    def _evolve(self, problem, engine, run, t0, on_generation) -> None:
        """The generation loop, filling ``run``'s archive and history."""
        rng = random.Random(self.seed)
        mode = xi_mode(problem.strategy)
        space = engine.space
        fix = _xi_fixer(space, mode)
        pop = engine.evaluate_batch(
            [fix(space.random(rng, mode)) for _ in range(self.population)]
        )

        def rank_crowd(population: List[Individual]):
            return self.rank_crowd([i.objectives for i in population], engine)

        def tournament(rank, crowd) -> Individual:
            i, j = rng.randrange(len(pop)), rng.randrange(len(pop))
            if (rank[i], -crowd.get(i, 0.0)) <= (rank[j], -crowd.get(j, 0.0)):
                return pop[i]
            return pop[j]

        _update_archive(run, pop)
        run.history.append([i.objectives for i in run.archive])

        for gen in range(self.generations):
            if self.time_budget_s and time.monotonic() - t0 > self.time_budget_s:
                break
            rank, crowd = rank_crowd(pop)
            # Create the whole brood first (RNG order identical to
            # evaluating one-by-one — evaluation never draws from rng),
            # then decode as one memoized, possibly parallel batch.
            children: List[Genotype] = []
            for _ in range(self.offspring):
                p1, p2 = tournament(rank, crowd), tournament(rank, crowd)
                child = (
                    space.crossover(rng, p1.genotype, p2.genotype)
                    if rng.random() < self.crossover_rate
                    else p1.genotype
                )
                children.append(fix(space.mutate(rng, child, xi_mode=mode)))
            offspring = engine.evaluate_batch(children)
            merged = pop + offspring
            rank2, crowd2 = rank_crowd(merged)
            # elitist μ+λ truncation by (rank, -crowding)
            order = sorted(
                range(len(merged)),
                key=lambda i: (rank2[i], -crowd2.get(i, 0.0)),
            )
            pop = [merged[i] for i in order[: self.population]]
            _update_archive(run, pop)
            run.history.append([i.objectives for i in run.archive])
            if on_generation:
                run.wall_s = time.monotonic() - t0
                on_generation(gen, run)


# ==========================================================================
@register_explorer("random_search")
class RandomSearchExplorer:
    """Seeded random-search baseline: sample genotypes uniformly from the
    strategy-constrained space, evaluate in memoized batches, and keep the
    nondominated archive.  One "generation" = one batch, so the result's
    trajectory is directly comparable to NSGA-II's at equal decode budgets.
    """

    def __init__(
        self,
        *,
        samples: int = 400,
        batch: int = 50,
        seed: int = 0,
        time_budget_s: Optional[float] = None,
        track_hypervolume: bool = True,
    ) -> None:
        if samples < 1 or batch < 1:
            raise ValueError("samples and batch must be >= 1")
        self.samples = samples
        self.batch = batch
        self.seed = seed
        self.time_budget_s = time_budget_s
        self.track_hypervolume = track_hypervolume

    def params(self) -> Dict[str, Any]:
        return {
            "samples": self.samples,
            "batch": self.batch,
            "seed": self.seed,
            "time_budget_s": self.time_budget_s,
        }

    def explore(
        self,
        problem: ExplorationProblem,
        *,
        engine=None,
        on_generation: Optional[Callable[[int, ExplorationRun], None]] = None,
    ) -> ExplorationRun:
        t0 = time.monotonic()
        rng = random.Random(self.seed)
        mode = xi_mode(problem.strategy)
        own_engine = engine is None
        if engine is None:
            engine = problem.make_engine()
        else:
            _check_engine(engine, problem)
        space = engine.space
        # Snapshot: see NSGA2Explorer.explore.
        run = ExplorationRun(replace(problem), self.name, self.params())
        ev0, hit0, miss0 = engine.evaluations, engine.hits, engine.misses
        fix = _xi_fixer(space, mode)

        try:
            remaining = self.samples
            gen = 0
            while remaining > 0:
                if self.time_budget_s and time.monotonic() - t0 > self.time_budget_s:
                    break
                n = min(self.batch, remaining)
                batch = engine.evaluate_batch(
                    [fix(space.random(rng, mode)) for _ in range(n)]
                )
                remaining -= n
                _update_archive(run, batch)
                run.history.append([i.objectives for i in run.archive])
                if on_generation:
                    run.wall_s = time.monotonic() - t0
                    on_generation(gen, run)
                gen += 1

            run.evaluations = engine.evaluations - ev0
            run.cache_hits = engine.hits - hit0
            run.cache_misses = engine.misses - miss0
            _record_engine_meta(run, engine)
        finally:
            if own_engine:
                engine.close()
        if self.track_hypervolume:
            _finalize_hypervolume(run)
        run.wall_s = time.monotonic() - t0
        return run
