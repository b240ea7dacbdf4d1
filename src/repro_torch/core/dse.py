"""Hybrid design space exploration (paper §IV, Fig. 6).

The MOEA explores the genotype 𝒢 = (ξ, C_d, β_A):
  ξ    binary string: per multi-cast actor, replace by MRB or keep
  C_d  integer string: per channel, placement decision ∈ CHANNEL_DECISIONS
  β_A  integer string: per actor, index into its allowed-core list

Decoding (the paper's hybrid step): Algorithm 1 (substitute MRBs) produces
the transformed graph g̃_A; the chosen decoder (see
:mod:`repro_torch.core.decoders`) produces the phenotype (P, β, γ).
Objectives are pluggable (:mod:`repro_torch.core.problem`); the paper's are
(period P, memory footprint M_F, core cost K), minimized.

This module keeps the genotype machinery (:class:`GenotypeSpace`,
:func:`evaluate_genotype`) and the paper-configured `run_dse`/`DSEConfig`
entry point, a thin wrapper over
:class:`repro_torch.core.explorers.NSGA2Explorer` driving an
:class:`repro_torch.core.problem.ExplorationProblem`.

Paper experiment settings: population 100, 25 offspring per generation,
crossover rate 0.95, NSGA-II elitist selection.  Strategies:
  Reference    ξ ≡ 0 (never replace)
  MRB_Always   ξ ≡ 1 (always replace)
  MRB_Explore  ξ explored per multi-cast actor
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from .architecture import ArchitectureGraph
from .binding import CHANNEL_DECISIONS
from .decoders import get_decoder
from .graph import ApplicationGraph, multicast_actors
from .mrb import substitute_mrbs
from .pareto import nondominated
from .problem import Objective, STRATEGIES, EvalContext, resolve_objectives
from .schedule import Schedule

__all__ = [
    "DSEConfig",
    "DSEResult",
    "Genotype",
    "GenotypeSpace",
    "Individual",
    "Objectives",
    "pipeline_delays",
    "transformed_graph",
    "evaluate_genotype",
    "infeasible_objectives",
    "STRATEGIES",
    "xi_mode",
    "run_dse",
]

Objectives = Tuple[float, ...]  # ordered objective vector, all minimized

_INFEASIBLE: Objectives = (float("inf"), float("inf"), float("inf"))


def infeasible_objectives(k: int = 3) -> Objectives:
    """The all-∞ objective vector marking an infeasible decode."""
    return tuple(float("inf") for _ in range(k))


def pipeline_delays(g: ApplicationGraph, delay: int = 1) -> ApplicationGraph:
    """The paper's §VI transformation: the (acyclic) applications are given
    at least one initial token per channel so modulo scheduling can overlap
    iterations (applied *after* MRB substitution; A_M is detected on the
    original zero-delay graph)."""
    g2 = g.copy()
    for ch in g2.channels.values():
        ch.delay = max(ch.delay, delay)
    return g2


@dataclass(frozen=True)
class Genotype:
    xi: Tuple[int, ...]
    cd: Tuple[int, ...]
    ba: Tuple[int, ...]


class GenotypeSpace:
    """Fixed-length encodings over the *original* application graph."""

    def __init__(self, g: ApplicationGraph, arch: ArchitectureGraph) -> None:
        self.g = g
        self.arch = arch
        self.mcast = sorted(multicast_actors(g))
        self.channels = sorted(g.channels)
        self.actors = sorted(g.actors)
        # Allowed cores per actor (type must support the actor).
        self.allowed: Dict[str, List[str]] = {}
        for a in self.actors:
            cores = [
                p
                for p in sorted(arch.cores)
                if g.actors[a].can_run_on(arch.cores[p].ctype)
            ]
            if not cores:
                raise ValueError(f"actor {a} has no feasible core")
            self.allowed[a] = cores

    def random(self, rng: random.Random, xi_mode: str = "explore") -> Genotype:
        xi = tuple(
            (1 if xi_mode == "always" else 0)
            if xi_mode != "explore"
            else rng.randint(0, 1)
            for _ in self.mcast
        )
        cd = tuple(rng.randrange(len(CHANNEL_DECISIONS)) for _ in self.channels)
        ba = tuple(rng.randrange(len(self.allowed[a])) for a in self.actors)
        return Genotype(xi, cd, ba)

    def crossover(self, rng: random.Random, a: Genotype, b: Genotype) -> Genotype:
        """Uniform crossover per gene segment."""
        mix = lambda x, y: tuple(xi if rng.random() < 0.5 else yi for xi, yi in zip(x, y))
        return Genotype(mix(a.xi, b.xi), mix(a.cd, b.cd), mix(a.ba, b.ba))

    def mutate(self, rng: random.Random, g: Genotype, rate: Optional[float] = None,
               xi_mode: str = "explore") -> Genotype:
        n = max(1, len(g.xi) + len(g.cd) + len(g.ba))
        r = rate if rate is not None else 1.0 / n
        xi = tuple(
            (1 - v if rng.random() < r and xi_mode == "explore" else v) for v in g.xi
        )
        cd = tuple(
            rng.randrange(len(CHANNEL_DECISIONS)) if rng.random() < r else v
            for v in g.cd
        )
        ba = tuple(
            rng.randrange(len(self.allowed[a])) if rng.random() < r else v
            for a, v in zip(self.actors, g.ba)
        )
        return Genotype(xi, cd, ba)

    def force_xi(self, g: Genotype, value: int) -> Genotype:
        return Genotype(tuple(value for _ in g.xi), g.cd, g.ba)


@dataclass
class Individual:
    genotype: Genotype
    objectives: Objectives = _INFEASIBLE
    schedule: Optional[Schedule] = None

    @property
    def feasible(self) -> bool:
        return self.objectives[0] != float("inf")


def transformed_graph(
    space: GenotypeSpace, xi_bits: Tuple[int, ...], pipelined: bool = True
) -> ApplicationGraph:
    """Algorithm 1 (+ §VI pipeline delays) for one ξ pattern.  The result
    depends only on (ξ, pipelined) and is treated read-only by the
    decoders, so callers may cache it across genotypes (see
    ``EvaluationEngine``)."""
    xi = {a: v for a, v in zip(space.mcast, xi_bits)}
    gt = substitute_mrbs(space.g, xi)
    if pipelined:
        gt = pipeline_delays(gt)
    return gt


def evaluate_genotype(
    space: GenotypeSpace,
    genotype: Genotype,
    *,
    decoder: Union[str, Callable] = "caps_hms",
    ilp_budget_s: float = 3.0,
    pipelined: bool = True,
    transformed: Optional[ApplicationGraph] = None,
    objectives: Optional[Sequence[Union[str, Objective]]] = None,
) -> Individual:
    """Decode 𝒢 → phenotype → objective vector (Fig. 6's update step).

    ``decoder`` is a registry name (or callable) resolved through
    :func:`repro_torch.core.decoders.get_decoder`; ``objectives`` is an ordered
    spec resolved through :func:`repro_torch.core.problem.resolve_objectives`
    (default: the paper's (P, M_F, K)).  ``transformed`` short-circuits the
    ξ graph transform with a cached
    ``transformed_graph(space, genotype.xi, pipelined)`` result.
    """
    objs = resolve_objectives(objectives)
    g, arch = space.g, space.arch
    gt = (
        transformed
        if transformed is not None
        else transformed_graph(space, genotype.xi, pipelined)
    )

    # Channel decisions: original channels keep their gene; an MRB channel
    # inherits the decision of the multi-cast actor's *input* channel.
    cd_orig = {c: CHANNEL_DECISIONS[v] for c, v in zip(space.channels, genotype.cd)}
    decisions: Dict[str, str] = {}
    for c in gt.channels:
        if c in cd_orig:
            decisions[c] = cd_orig[c]
        else:
            # MRB name is "mrb{c_in,c_out1,...}" — inherit from first member.
            inner = c[len("mrb{"):-1].split(",")
            decisions[c] = cd_orig[inner[0]]

    beta_a = {
        a: space.allowed[a][idx % len(space.allowed[a])]
        for a, idx in zip(space.actors, genotype.ba)
        if a in gt.actors
    }

    res = get_decoder(decoder)(
        gt, arch, decisions, beta_a, time_budget_s=ilp_budget_s
    )
    if not res.feasible or res.schedule is None:
        return Individual(genotype, infeasible_objectives(len(objs)), None)
    ctx = EvalContext(gt, arch, res.schedule)
    return Individual(genotype, tuple(o(ctx) for o in objs), res.schedule)


def xi_mode(strategy: str) -> str:
    """Map a ξ-strategy name to the GenotypeSpace sampling mode."""
    try:
        return {"Reference": "never", "MRB_Always": "always", "MRB_Explore": "explore"}[strategy]
    except KeyError:
        raise ValueError(
            f"unknown strategy {strategy!r}; expected one of {STRATEGIES}"
        ) from None


@dataclass
class DSEConfig:
    strategy: str = "MRB_Explore"          # Reference | MRB_Always | MRB_Explore
    decoder: str = "caps_hms"              # any repro_torch.core.decoders registry name
    population: int = 100
    offspring: int = 25
    generations: int = 2500
    crossover_rate: float = 0.95
    ilp_budget_s: float = 3.0
    seed: int = 0
    pipelined: bool = True
    time_budget_s: Optional[float] = None  # wall-clock cap for benchmarks
    # Evaluation-engine knobs (see repro_torch.core.engine). All settings
    # produce bit-identical Pareto fronts under a fixed seed; they only
    # change how much decoding work is shared/parallelized.
    cache_mode: str = "canonical"          # canonical | exact | none
    cache_max_entries: Optional[int] = None
    n_workers: int = 0                     # >0: process-parallel decode


@dataclass
class DSEResult:
    config: DSEConfig
    archive: List[Individual] = field(default_factory=list)  # nondominated-so-far
    history: List[List[Objectives]] = field(default_factory=list)  # per generation
    evaluations: int = 0   # decodes actually performed (cache misses)
    wall_s: float = 0.0
    cache_hits: int = 0
    cache_misses: int = 0

    @property
    def front(self) -> List[Objectives]:
        return nondominated([i.objectives for i in self.archive if i.feasible])


def run_dse(
    g: ApplicationGraph,
    arch: ArchitectureGraph,
    config: DSEConfig,
    *,
    on_generation: Optional[Callable[[int, "DSEResult"], None]] = None,
    engine=None,
    device="cuda",
) -> DSEResult:
    """Paper-configured NSGA-II exploration (Fig. 6): builds an
    :class:`~repro_torch.core.problem.ExplorationProblem` with the paper's
    three objectives and runs it through
    :class:`~repro_torch.core.explorers.NSGA2Explorer`.  Fronts are
    bit-identical to the JAX package's ``run_dse`` under a fixed seed.

    Decoding goes through an :class:`repro_torch.core.engine.EvaluationEngine`
    (memoized, optionally process-parallel) on ``device`` (the card unless
    the caller asks for ``"cpu"``).  Pass ``engine`` to share its decode
    cache across runs — e.g. across strategies on the same app; the
    engine's decoder settings and device then take precedence over
    ``config``'s and ``device``.  All engine configurations yield
    bit-identical fronts under a fixed seed.
    """
    from .explorers import NSGA2Explorer  # deferred: explorers import this module
    from .problem import ExplorationProblem

    problem = ExplorationProblem(
        graph=g,
        arch=arch,
        strategy=config.strategy,
        decoder=config.decoder,
        pipelined=config.pipelined,
        ilp_budget_s=config.ilp_budget_s,
    )
    # DSEResult has no hypervolume trajectory, so don't pay for one.
    explorer = NSGA2Explorer(
        population=config.population,
        offspring=config.offspring,
        generations=config.generations,
        crossover_rate=config.crossover_rate,
        seed=config.seed,
        time_budget_s=config.time_budget_s,
        track_hypervolume=False,
    )

    own_engine = engine is None
    if engine is None:
        engine = problem.make_engine(
            cache_mode=config.cache_mode,
            max_entries=config.cache_max_entries,
            n_workers=config.n_workers,
            device=device,
        )

    result = DSEResult(config)

    def sync(run) -> DSEResult:
        result.archive = run.archive
        result.history = run.history
        result.evaluations = run.evaluations
        result.cache_hits = run.cache_hits
        result.cache_misses = run.cache_misses
        result.wall_s = run.wall_s
        return result

    cb = None
    if on_generation is not None:
        cb = lambda gen, run: on_generation(gen, sync(run))

    try:
        run = explorer.explore(problem, engine=engine, on_generation=cb)
    finally:
        if own_engine:
            engine.close()
    return sync(run)
