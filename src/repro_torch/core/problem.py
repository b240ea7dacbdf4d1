"""Declarative exploration problems: pluggable objectives over phenotypes.

The paper's DSE minimizes a fixed 3-tuple (period P, memory footprint M_F,
core cost K).  This module generalizes that to an *ordered set of named
objectives*, each a pure function of the decoded phenotype, so callers can
add criteria — e.g. NoC communication volume (Bytyn et al., "Dataflow Aware
Mapping of CNNs onto Many-Core Platforms with NoC Interconnect") — without
touching the MOEA or the decoders.

Two pieces:

* :class:`Objective` + registry.  An objective maps an
  :class:`EvalContext` (transformed graph g̃_A, architecture, schedule) to
  a float; all objectives are minimized.  The three paper objectives plus
  ``comm_volume`` (Σ_c φ(c) · hops over the bound route, per iteration)
  are registered here.

* :class:`ExplorationProblem` — the declarative unit an
  :class:`~repro_torch.core.explorers.Explorer` consumes: application graph
  + architecture + objectives + ξ-strategy + decoder + constraints.  It is
  JSON-round-trippable with the graphs embedded, so a problem can be saved
  alongside its :class:`ExplorationRun`.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

from .architecture import ArchitectureGraph
from .binding import core_cost, memory_footprint
from .decoders import get_decoder
from .graph import ApplicationGraph
from .schedule import Schedule

__all__ = [
    "STRATEGIES",
    "EvalContext",
    "Objective",
    "OBJECTIVES",
    "register_objective",
    "get_objective",
    "resolve_objectives",
    "objective_names",
    "PAPER_OBJECTIVES",
    "ExplorationProblem",
]

# ξ-strategies (paper §VI): how the MRB-replacement bits are constrained.
STRATEGIES = ("Reference", "MRB_Always", "MRB_Explore")


@dataclass(frozen=True)
class EvalContext:
    """Everything an objective may read: the decoded phenotype.

    ``graph`` is the ξ-transformed graph g̃_A the schedule was built for
    (MRB channels included), not the original application graph.
    """

    graph: ApplicationGraph
    arch: ArchitectureGraph
    schedule: Schedule


@dataclass(frozen=True)
class Objective:
    """A named minimization criterion over decoded phenotypes."""

    name: str
    fn: Callable[[EvalContext], float]
    unit: str = ""
    description: str = ""

    def __call__(self, ctx: EvalContext) -> float:
        return float(self.fn(ctx))


OBJECTIVES: Dict[str, Objective] = {}


def register_objective(
    name: str, *, unit: str = "", description: str = ""
) -> Callable[[Callable[[EvalContext], float]], Objective]:
    """Register an objective function under ``name`` (decorator).  The
    decorated function is replaced by its :class:`Objective` wrapper."""

    def deco(fn: Callable[[EvalContext], float]) -> Objective:
        obj = Objective(name, fn, unit, description or (fn.__doc__ or "").strip())
        OBJECTIVES[name] = obj
        return obj

    return deco


def get_objective(name_or_obj: Union[str, Objective]) -> Objective:
    if isinstance(name_or_obj, Objective):
        return name_or_obj
    try:
        return OBJECTIVES[name_or_obj]
    except KeyError:
        raise KeyError(
            f"unknown objective {name_or_obj!r}; registered: {objective_names()}"
        ) from None


def resolve_objectives(
    objectives: Optional[Sequence[Union[str, Objective]]],
) -> Tuple[Objective, ...]:
    """Resolve an ordered objective spec; ``None`` means the paper triple."""
    if objectives is None:
        return PAPER_OBJECTIVES
    resolved = tuple(get_objective(o) for o in objectives)
    if not resolved:
        raise ValueError("an exploration needs at least one objective")
    return resolved


def objective_names() -> List[str]:
    return sorted(OBJECTIVES)


# -------------------------------------------------------------- built-ins
@register_objective("period", unit="time units")
def _obj_period(ctx: EvalContext) -> float:
    """P — the modulo-schedule period (paper Eq. 14, minimized)."""
    return float(ctx.schedule.period)


@register_objective("memory", unit="bytes")
def _obj_memory(ctx: EvalContext) -> float:
    """M_F = Σ_c γ(c)·φ(c) with the schedule's (possibly enlarged) γ
    (paper Eq. 24)."""
    return float(memory_footprint(ctx.graph, ctx.schedule.capacities))


@register_objective("core_cost", unit="cost units")
def _obj_core_cost(ctx: EvalContext) -> float:
    """K = Σ_ϑ α(ϑ)·K_ϑ over allocated cores (paper Eq. 25)."""
    return float(core_cost(ctx.arch, ctx.schedule.actor_binding))


@register_objective("comm_volume", unit="byte·hops")
def _obj_comm_volume(ctx: EvalContext) -> float:
    """Interconnect traffic per iteration: Σ over channel accesses of
    rate · φ(c) · hops, where hops counts the interconnects traversed by
    the producer's write (ψ tokens) and each reader's read (κ tokens) of
    channel c under the bound placement (NoC-aware objective in the spirit
    of Bytyn et al.)."""
    g, arch, sched = ctx.graph, ctx.arch, ctx.schedule
    total = 0
    for c, ch in g.channels.items():
        mem = sched.channel_binding[c]
        prod = g.producer[c]
        total += (
            g.prod_rate[(prod, c)]
            * ch.token_bytes
            * len(arch.route_interconnects(sched.actor_binding[prod], mem))
        )
        for r in g.consumers[c]:
            total += (
                g.cons_rate[(c, r)]
                * ch.token_bytes
                * len(arch.route_interconnects(sched.actor_binding[r], mem))
            )
    return float(total)


@register_objective("sim_period", unit="time units")
def _obj_sim_period(ctx: EvalContext) -> float:
    """Measured steady-state iteration interval of the phenotype's
    *self-timed execution* (repro_torch.sim): actors fire when tokens,
    space and their core are available, reads/writes contend for
    interconnects, and the period is read off the firing trace.  Falls back
    to the analytic schedule period while simulation is disabled
    (``repro_torch.sim.set_simulation_enabled(False)`` or
    ``REPRO_SIM_DISABLE``).  Batch evaluations route this objective through
    the batched simulator — the CUDA kernel
    (``EvaluationEngine(..., sim_backend="cuda")``) or the plain batched
    torch program (``sim_backend="torch"``) — so one NSGA-II generation is
    one device call per ξ group."""
    from ..sim import simulate_period, simulation_enabled  # deferred: no cycle

    if not simulation_enabled():
        return float(ctx.schedule.period)
    return float(simulate_period(ctx.graph, ctx.arch, ctx.schedule))


PAPER_OBJECTIVES: Tuple[Objective, ...] = (
    OBJECTIVES["period"],
    OBJECTIVES["memory"],
    OBJECTIVES["core_cost"],
)

DEFAULT_OBJECTIVE_NAMES: Tuple[str, ...] = tuple(o.name for o in PAPER_OBJECTIVES)


# ==========================================================================
@dataclass
class ExplorationProblem:
    """One exploration, declaratively: what to map, onto what, judged how.

    ``objectives`` is an *ordered* tuple of registered objective names (the
    order defines the objective-vector layout everywhere downstream).
    Serialization embeds both graphs.
    """

    graph: ApplicationGraph
    arch: ArchitectureGraph
    objectives: Tuple[str, ...] = DEFAULT_OBJECTIVE_NAMES
    strategy: str = "MRB_Explore"
    decoder: str = "caps_hms"
    pipelined: bool = True
    ilp_budget_s: float = 3.0

    def __post_init__(self) -> None:
        self.objectives = tuple(self.objectives)
        for name in self.objectives:
            get_objective(name)
        if not self.objectives:
            raise ValueError("an exploration needs at least one objective")
        get_decoder(self.decoder)
        if self.strategy not in STRATEGIES:
            raise ValueError(
                f"unknown strategy {self.strategy!r}; expected one of {STRATEGIES}"
            )

    # ------------------------------------------------------------- helpers
    @property
    def name(self) -> str:
        return f"{self.graph.name}@{self.arch.name}/{self.strategy}^{self.decoder}"

    def objective_fns(self) -> Tuple[Objective, ...]:
        return resolve_objectives(self.objectives)

    def n_objectives(self) -> int:
        return len(self.objectives)

    def space(self):
        """The genotype encoding for this problem (cached)."""
        from .dse import GenotypeSpace  # deferred: dse imports this module

        if getattr(self, "_space", None) is None:
            self._space = GenotypeSpace(self.graph, self.arch)
        return self._space

    def make_engine(self, **engine_kwargs):
        """A fresh :class:`~repro_torch.core.engine.EvaluationEngine`
        configured for this problem (decoder, budget, pipelining,
        objectives); ``device`` and ``sim_backend`` pass through."""
        from .engine import EvaluationEngine  # deferred

        return EvaluationEngine(
            self.space(),
            decoder=self.decoder,
            ilp_budget_s=self.ilp_budget_s,
            pipelined=self.pipelined,
            objectives=self.objectives,
            **engine_kwargs,
        )

    # ----------------------------------------------------------- serialize
    def to_json(self) -> Dict[str, Any]:
        return {
            "objectives": list(self.objectives),
            "strategy": self.strategy,
            "decoder": self.decoder,
            "pipelined": self.pipelined,
            "ilp_budget_s": self.ilp_budget_s,
            "graph": self.graph.to_dict(),
            "arch": self.arch.to_dict(),
        }

    def dumps(self) -> str:
        return json.dumps(self.to_json(), sort_keys=True)

    @classmethod
    def from_json(cls, d: Union[str, Dict[str, Any]]) -> "ExplorationProblem":
        if isinstance(d, str):
            d = json.loads(d)
        common = dict(
            objectives=tuple(d.get("objectives", DEFAULT_OBJECTIVE_NAMES)),
            strategy=d.get("strategy", "MRB_Explore"),
            decoder=d.get("decoder", "caps_hms"),
            pipelined=d.get("pipelined", True),
            ilp_budget_s=d.get("ilp_budget_s", 3.0),
        )
        if "scenario" in d:
            raise ValueError(
                "problems given as scenario specs are not supported; "
                "serialize the problem with its graph and arch embedded"
            )
        return cls(
            graph=ApplicationGraph.from_dict(d["graph"]),
            arch=ArchitectureGraph.from_dict(d["arch"]),
            **common,
        )
