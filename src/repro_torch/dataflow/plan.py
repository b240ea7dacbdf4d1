"""Mapping plans: run the paper's DSE on an extracted LM workload.

``plan_mapping`` wires extraction → specification → NSGA-II (ξ, C_d, β_A)
→ CAPS-HMS and returns the Pareto set of :class:`DataflowPlan`s.  A plan
records the phenotype (period → step time, memory footprint → buffer
bytes, core cost → chip-groups) plus the decoded placements, and renders
execution hints (stage → group binding, share-vs-replicate choice per
fan-out) that the launcher can apply.

This is the paper's contribution operating as a *planning layer* for the
LM framework: the model's own execution path runs the model, the dataflow
layer explores where buffers live and whether fan-outs share or copy.

The exploration's engine runs on ``device`` (the card unless the caller
passes ``"cpu"``).  Its objectives are the decoded period, memory and
cost, so no simulation runs inside it; each plan keeps its decoded
``schedule`` and the transformed ``graph`` it runs on (outside equality
and ``repr``), so a caller can simulate it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..core.architecture import ArchitectureGraph
from ..core.dse import DSEConfig, DSEResult, GenotypeSpace, run_dse, transformed_graph
from ..core.graph import ApplicationGraph, multicast_actors
from ..core.schedule import Schedule
from ..models.config import ModelConfig

from .extract import ExtractOptions, extract_application_graph
from .tpu_arch import tpu_pod_architecture

__all__ = ["DataflowPlan", "plan_mapping"]


@dataclass
class DataflowPlan:
    arch: str
    period_us: float              # steady-state period (µs per microbatch)
    buffer_bytes: float           # M_F
    core_cost: float              # K (weighted chip-groups)
    mrb_choices: Dict[str, bool] = field(default_factory=dict)
    stage_binding: Dict[str, str] = field(default_factory=dict)
    channel_binding: Dict[str, str] = field(default_factory=dict)
    schedule: Optional[Schedule] = field(default=None, compare=False, repr=False)
    graph: Optional[ApplicationGraph] = field(default=None, compare=False, repr=False)

    def summary(self) -> str:
        n_mrb = sum(self.mrb_choices.values())
        return (
            f"{self.arch}: period={self.period_us:.0f}µs "
            f"buffers={self.buffer_bytes/2**30:.2f}GiB cost={self.core_cost:.1f} "
            f"MRBs={n_mrb}/{len(self.mrb_choices)}"
        )


def plan_mapping(
    cfg: ModelConfig,
    seq_len: int,
    batch: int,
    *,
    opts: Optional[ExtractOptions] = None,
    arch_graph: Optional[ArchitectureGraph] = None,
    strategy: str = "MRB_Explore",
    generations: int = 40,
    population: int = 32,
    seed: int = 0,
    time_budget_s: Optional[float] = 60.0,
    device="cuda",
) -> List[DataflowPlan]:
    """Explore mappings on ``device``; returns the non-dominated plans
    (Pareto set)."""
    g = extract_application_graph(cfg, seq_len, batch, opts)
    arch = arch_graph or tpu_pod_architecture()
    dse = DSEConfig(
        strategy=strategy,
        decoder="caps_hms",
        population=population,
        offspring=max(8, population // 4),
        generations=generations,
        seed=seed,
        time_budget_s=time_budget_s,
    )
    result: DSEResult = run_dse(g, arch, dse, device=device)
    mcs = multicast_actors(g)
    space = GenotypeSpace(g, arch)
    graphs: Dict[tuple, ApplicationGraph] = {}
    plans: List[DataflowPlan] = []
    seen = set()
    for ind in result.archive:
        if not ind.feasible or ind.objectives in seen:
            continue
        seen.add(ind.objectives)
        xi = dict(zip(sorted(mcs), ind.genotype.xi))
        sched = ind.schedule
        xi_bits = tuple(ind.genotype.xi)
        if xi_bits not in graphs:
            graphs[xi_bits] = transformed_graph(space, xi_bits, dse.pipelined)
        plans.append(
            DataflowPlan(
                arch=cfg.name,
                period_us=ind.objectives[0],
                buffer_bytes=ind.objectives[1],
                core_cost=ind.objectives[2],
                mrb_choices={a: bool(v) for a, v in xi.items()},
                stage_binding=dict(sched.actor_binding) if sched else {},
                channel_binding=dict(sched.channel_binding) if sched else {},
                schedule=sched,
                graph=graphs[xi_bits],
            )
        )
    plans.sort(key=lambda p: p.period_us)
    return plans
