"""Simulator-vs-analytic parity invariants (the tentpole's core check).

For every feasible decode the repo now asserts, next to the static
``validate_schedule`` feasibility conditions:

* the self-timed simulation never beats the resource lower bound
  P_lb (Algorithm 4 line 3) — the busiest resource must serve its whole
  per-iteration load every measured period;
* on *contention-free* mappings (no schedulable resource shared between
  actors, :func:`repro_torch.sim.model.contention_free`) the simulated
  steady-state period equals the analytic CAPS-HMS/ILP period exactly —
  greedy arbitration has nothing to reorder, ASAP execution is monotone,
  and both collapse onto P_lb;
* a feasible phenotype must actually execute: a deadlock is a violation.

:func:`check_sim_invariants` packages these as violation strings in the
style of ``validate_schedule`` so tests and tooling can assert ``== []``.
"""
from __future__ import annotations

from typing import List, Optional

from ..core.architecture import ArchitectureGraph
from ..core.graph import ApplicationGraph
from ..core.schedule import (
    Schedule,
    attach_binding,
    comm_times,
    period_lower_bound,
    validate_schedule,
)
from .events import SimResult, simulate
from .model import SimConfig, contention_free

__all__ = ["check_sim_invariants"]

_EPS = 1e-9


def check_sim_invariants(
    g: ApplicationGraph,
    arch: ArchitectureGraph,
    sched: Schedule,
    *,
    config: Optional[SimConfig] = None,
    result: Optional[SimResult] = None,
    include_static: bool = True,
) -> List[str]:
    """Validate a feasible phenotype against its self-timed execution.

    Pass ``result`` to re-use an existing simulation (e.g. the batched
    backend's, the CUDA kernel's included — the invariants are
    backend-independent).  Returns violation
    strings; an empty list means the phenotype passed every check.
    """
    errs: List[str] = []
    if include_static:
        errs.extend(validate_schedule(g, arch, sched))
    res = result
    if res is None:
        cfg = config or SimConfig(trace=False)
        res = simulate(g, arch, sched, cfg)

    if res.deadlocked:
        errs.append("self-timed execution deadlocked on a feasible phenotype")
        return errs
    if not res.converged:
        errs.append(
            f"self-timed execution not periodic within {res.iterations} iterations"
        )
        return errs

    attach_binding(g, sched.channel_binding)
    read_tau, write_tau = comm_times(g, arch, sched.actor_binding, sched.channel_binding)
    lb = period_lower_bound(g, arch, sched.actor_binding, read_tau, write_tau)
    if res.period < lb - _EPS:
        errs.append(
            f"simulated period {res.period} beats the resource lower bound {lb}"
        )
    if contention_free(g, arch, sched) and abs(res.period - sched.period) > _EPS:
        errs.append(
            "contention-free mapping but simulated period "
            f"{res.period} != analytic period {sched.period}"
        )
    return errs
