"""Optional CP-SAT exact decoder (requires ``ortools``; extras flag
``cpsat``).

Solves the same fixed-period constraint system as :mod:`repro_torch.core.ilp` —
contiguous per-actor windows, edge-level Eq. 16 dependencies, modulo
resource exclusivity — with Google OR-Tools CP-SAT instead of the built-in
backtracking search, and shares Algorithm 3's outer loop
(:func:`repro_torch.core.ilp._decode_exact`): scan the period upward from the
resource lower bound, rebind channels when the schedule overflows a memory.

Modulo non-overlap for two pieces ``[s_i, s_i + d_i)`` and
``[s_j, s_j + d_j)`` on one resource is encoded with one modulo channel per
pair: ``m = (s_j − s_i) mod P`` must lie in ``[d_i, P − d_j]``.  Normalizing
piece *i* to phase 0, piece *j* occupies ``[m, m + d_j)``; it avoids
``[0, d_i)`` without wrapping past ``P`` exactly when ``m`` is in that
interval, so the encoding is both sound and complete.

The module imports cleanly without ortools (``HAVE_ORTOOLS`` is False and
:func:`decode_via_cpsat` raises); the registry only exposes the ``cpsat``
decoder name when ortools is importable, so offline installs are unaffected.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

try:  # pragma: no cover - exercised only where ortools is installed
    from ortools.sat.python import cp_model

    HAVE_ORTOOLS = True
except ImportError:  # pragma: no cover
    cp_model = None
    HAVE_ORTOOLS = False

from .architecture import ArchitectureGraph
from .graph import ApplicationGraph
from .ilp import ExactResult, _decode_exact, _Timeout, _window_layout
from .schedule import TaskTimes

__all__ = ["HAVE_ORTOOLS", "decode_via_cpsat"]


def _cpsat_fixed_period(
    g: ApplicationGraph,
    arch: ArchitectureGraph,
    actor_binding: Dict[str, str],
    channel_binding: Dict[str, str],
    period: int,
    deadline: float,
) -> Optional[TaskTimes]:
    """CP-SAT satisfiability model for one candidate period.

    Same contract as ``ilp._solve_fixed_period``: returns TaskTimes when
    satisfiable, None when refuted, raises ``_Timeout`` when the solver
    cannot decide before the deadline.
    """
    order, layout, window = _window_layout(g, arch, actor_binding, channel_binding)
    for a in order:
        t_in, t_ex, t_out = window[a]
        if t_in + t_ex + t_out > period:
            return None  # window exceeds the period: refuted without solving
    budget = deadline - time.monotonic()
    if budget <= 0:
        raise _Timeout

    model = cp_model.CpModel()
    # Absolute window starts; any modulo-feasible schedule admits absolute
    # times within (#actors + total delay + 2) periods via topological
    # placement, so this horizon loses no solutions.
    horizon = period * (len(order) + 2 + sum(ch.delay for ch in g.channels.values()))
    s = {a: model.NewIntVar(0, horizon, f"s[{a}]") for a in order}

    def write_fin(prod: str, c: str) -> int:
        for kind, t, o, tau, _ in layout[prod]:
            if kind == "w" and t[1] == c:
                return o + tau
        raise AssertionError(c)

    # Edge-level dependencies (Eq. 16 with the δ·P pipelining credit).
    for c, ch in g.channels.items():
        prod = g.producer[c]
        for r in g.consumers[c]:
            off_r = next(
                o for kind, t, o, _, _ in layout[r] if kind == "r" and t[0] == c
            )
            model.Add(
                s[prod] + write_fin(prod, c) <= s[r] + off_r + period * ch.delay
            )

    # Resource exclusivity mod P: actor window hulls on cores, communication
    # tasks on every interconnect along their route.
    pieces: Dict[str, list] = {}
    for a in order:
        t_in, t_ex, t_out = window[a]
        pieces.setdefault(actor_binding[a], []).append((a, 0, t_in + t_ex + t_out))
        for kind, t, o, tau, routes in layout[a]:
            if tau > 0:
                for res in routes:
                    pieces.setdefault(res, []).append((a, o, tau))
    shift = (2 * horizon) // period + 2  # keeps the modulo dividend >= 0
    n_pair = 0
    for res in sorted(pieces):
        items = pieces[res]
        for i in range(len(items)):
            for j in range(i + 1, len(items)):
                a1, o1, d1 = items[i]
                a2, o2, d2 = items[j]
                if a1 == a2:
                    continue  # fixed offsets inside one window never clash
                if d1 == 0 or d2 == 0:
                    continue  # zero-duration piece occupies no resource time
                if d1 + d2 > period:
                    return None  # the two pieces cannot share this resource
                diff = model.NewIntVar(0, 2 * shift * period, f"d{n_pair}")
                model.Add(diff == s[a2] + o2 - s[a1] - o1 + shift * period)
                m = model.NewIntVar(d1, period - d2, f"m{n_pair}")
                model.AddModuloEquality(m, diff, period)
                n_pair += 1

    solver = cp_model.CpSolver()
    solver.parameters.max_time_in_seconds = max(0.05, budget)
    solver.parameters.num_search_workers = 1  # deterministic refutations
    solver.parameters.random_seed = 0
    status = solver.Solve(model)
    if status == cp_model.INFEASIBLE:
        return None
    if status not in (cp_model.OPTIMAL, cp_model.FEASIBLE):
        raise _Timeout

    times = TaskTimes()
    for a in order:
        base = solver.Value(s[a])
        t_in, _, _ = window[a]
        times.actor_start[a] = base + t_in
        for kind, t, o, _, _ in layout[a]:
            if kind == "r":
                times.read_start[t] = base + o
            else:
                times.write_start[t] = base + o
    return times


def decode_via_cpsat(
    g: ApplicationGraph,
    arch: ArchitectureGraph,
    decisions: Dict[str, str],
    actor_binding: Dict[str, str],
    *,
    time_budget_s: float = 3.0,
    max_period: Optional[int] = None,
    max_rebind_rounds: int = 8,
) -> ExactResult:
    """Algorithm 3 with CP-SAT as the fixed-period engine."""
    if not HAVE_ORTOOLS:
        raise RuntimeError(
            "decode_via_cpsat requires ortools; install the 'cpsat' extra"
        )
    return _decode_exact(
        g, arch, decisions, actor_binding, _cpsat_fixed_period,
        time_budget_s=time_budget_s,
        max_period=max_period,
        max_rebind_rounds=max_rebind_rounds,
    )
