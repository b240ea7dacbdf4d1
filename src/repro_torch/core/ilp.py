"""Exact modulo-scheduling decoder (paper §V-A, Algorithm 3, Eqs. 14-23).

No commercial ILP solver is available offline, so the same constraint
system is solved by a branch-and-bound / chronological-backtracking search:

  * the candidate period P is scanned upward from the resource lower bound
    (Eq. 19 analogue); the first P for which the constraint system is
    satisfiable is minimal — *proven* minimal iff every smaller P was
    refuted before its deadline;
  * for a fixed P, actors are placed in topological order with full
    backtracking over their start positions; dominance: only left-shifted
    candidates (s = release, or a piece abutting the end of a busy interval
    on an involved resource) are branched on, which preserves optimality
    for the disjunctive constraint class;
  * the search is *anytime* with a time budget per decode (the paper gives
    its ILP 3 s): on timeout the incumbent feasible schedule (if any) is
    returned and ``proven_optimal`` is False — mirroring the paper's
    observation that the ILP "often delivered at least a feasible
    modulo-schedule" on timeout.

Deviation from the paper's ILP, recorded in DESIGN.md §7: each actor's
reads/execute/writes are kept contiguous (the window the paper's Eq. 23
enforces against *other* actors' tasks); the true ILP additionally allows
idle gaps inside an actor's own window.  Dependency constraints are applied
at edge level (Eq. 16), which is weaker (more permissive) than CAPS-HMS's
actor-level update, so the exact decoder can find shorter periods.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .architecture import ArchitectureGraph
from .binding import determine_channel_bindings
from .graph import ApplicationGraph, topological_priorities
from .schedule import (
    Schedule,
    TaskTimes,
    UtilizationSet,
    attach_binding,
    comm_times,
    f_wrap,
    period_lower_bound,
    required_capacities,
)

__all__ = ["decode_via_ilp", "ExactResult"]


@dataclass
class ExactResult:
    schedule: Optional[Schedule]
    feasible: bool
    proven_optimal: bool
    periods_tried: int = 0

    @property
    def period(self) -> float:
        # math.inf, not a -1 sentinel: an infeasible decode must compare as
        # strictly worse than any feasible period (see DecodeResult.period).
        return self.schedule.period if self.schedule else math.inf

    def to_json(self) -> Dict:
        """JSON form; ``schedule: null`` for infeasible results so the
        ``period`` property yields ``math.inf`` again after ``from_json``."""
        return {
            "schedule": self.schedule.to_json() if self.schedule else None,
            "feasible": self.feasible,
            "proven_optimal": self.proven_optimal,
            "periods_tried": self.periods_tried,
        }

    @classmethod
    def from_json(cls, d: Dict) -> "ExactResult":
        sched = d.get("schedule")
        return cls(
            schedule=Schedule.from_json(sched) if sched else None,
            feasible=bool(d["feasible"]),
            proven_optimal=bool(d.get("proven_optimal", False)),
            periods_tried=d.get("periods_tried", 0),
        )


class _Timeout(Exception):
    pass


def _window_layout(
    g: ApplicationGraph,
    arch: ArchitectureGraph,
    actor_binding: Dict[str, str],
    channel_binding: Dict[str, str],
) -> Tuple[
    List[str],
    Dict[str, List[Tuple[str, Tuple[str, str], int, int, List[str]]]],
    Dict[str, Tuple[int, int, int]],
]:
    """Topological actor order plus the contiguous per-actor window layout
    (reads sorted by channel, execute, writes sorted by channel) shared by
    the backtracking search and the optional CP-SAT decoder.

    Returns ``(order, layout, window)`` where ``layout[a]`` is a list of
    ``(kind, edge, offset, tau, routes)`` items and ``window[a]`` is the
    ``(t_in, t_ex, t_out)`` phase durations.
    """
    read_tau, write_tau = comm_times(g, arch, actor_binding, channel_binding)
    prio = topological_priorities(g)
    order = sorted(g.actors, key=lambda a: (-prio[a], a))

    layout: Dict[str, List[Tuple[str, Tuple[str, str], int, int, List[str]]]] = {}
    window: Dict[str, Tuple[int, int, int]] = {}
    for a in order:
        reads = [(c, a) for c in sorted(g.in_channels(a))]
        writes = [(a, c) for c in sorted(g.out_channels(a))]
        t_in = sum(read_tau[t] for t in reads)
        ctype = arch.cores[actor_binding[a]].ctype
        t_ex = g.actors[a].exec_times[ctype]
        t_out = sum(write_tau[t] for t in writes)
        window[a] = (t_in, t_ex, t_out)
        items = []
        off = 0
        for t in reads:
            items.append(("r", t, off, read_tau[t],
                          arch.route_interconnects(actor_binding[a], channel_binding[t[0]])))
            off += read_tau[t]
        off += t_ex
        for t in writes:
            items.append(("w", t, off, write_tau[t],
                          arch.route_interconnects(actor_binding[a], channel_binding[t[1]])))
            off += write_tau[t]
        layout[a] = items
    return order, layout, window


def _solve_fixed_period(
    g: ApplicationGraph,
    arch: ArchitectureGraph,
    actor_binding: Dict[str, str],
    channel_binding: Dict[str, str],
    period: int,
    deadline: float,
) -> Optional[TaskTimes]:
    """Backtracking satisfiability search for one candidate period.

    Raises _Timeout when the deadline passes; returns None when refuted.
    """
    order, layout, window = _window_layout(g, arch, actor_binding, channel_binding)

    util: Dict[str, UtilizationSet] = {r: UtilizationSet() for r in arch.schedulable_resources()}
    start: Dict[str, int] = {}

    def _write_finish_offset(prod: str, c: str) -> int:
        for k2, t2, o2, tau2, _ in layout[prod]:
            if k2 == "w" and t2[1] == c:
                return o2 + tau2
        raise AssertionError(c)

    def release(a: str) -> int:
        """Edge-level Eq. 16: every read of a must start after the producing
        write finishes (minus P·δ); converted to a window release time."""
        rel = 0
        for kind, t, o, tau, _ in layout[a]:
            if kind != "r":
                continue
            c = t[0]
            prod = g.producer[c]
            if prod in start:
                fin = start[prod] + _write_finish_offset(prod, c) - period * g.channels[c].delay
                rel = max(rel, fin - o)
        return rel

    def deadline_for(a: str) -> int:
        """Eq. 16 seen from the writer: if a consumer of channel c (δ ≥ 1)
        is already placed, a's write must finish within δ periods of the
        consumer's read — an upper bound on a's window start."""
        ub = 1 << 62
        for kind, t, o, tau, _ in layout[a]:
            if kind != "w":
                continue
            c = t[1]
            w_fin = o + tau
            for r in g.consumers[c]:
                if r in start:
                    for k2, t2, o2, _, _ in layout[r]:
                        if k2 == "r" and t2[0] == c:
                            s_r = start[r] + o2
                            ub = min(
                                ub,
                                s_r + period * g.channels[c].delay - w_fin,
                            )
        return ub

    def involved(a: str) -> List[Tuple[int, int, List[str]]]:
        """(offset, tau, resources) pieces of a's window: core + comms."""
        t_in, t_ex, t_out = window[a]
        pieces = [(0, t_in + t_ex + t_out, [actor_binding[a]])]
        for kind, t, o, tau, routes in layout[a]:
            if tau > 0 and routes:
                pieces.append((o, tau, routes))
        return pieces

    def feasible_at(a: str, s: int) -> bool:
        for o, tau, rs in involved(a):
            wr = f_wrap(period, s + o, tau)
            for r in rs:
                if util[r].conflict(wr):
                    return False
        return True

    def candidates(a: str, rel: int) -> List[int]:
        """Left-shift dominant candidate starts in [rel, rel + P)."""
        cands: Set[int] = set()
        if feasible_at(a, rel):
            cands.add(rel)
        for o, tau, rs in involved(a):
            for r in rs:
                u = util[r]
                for e in u.ends:
                    # align piece start phase with busy-interval end e
                    base = (e - (rel + o)) % period
                    s = rel + base
                    if rel <= s < rel + period and feasible_at(a, s):
                        cands.add(s)
        return sorted(cands)

    def place(a: str, s: int) -> List[Tuple[str, List[Tuple[int, int]]]]:
        added = []
        for o, tau, rs in involved(a):
            wr = f_wrap(period, s + o, tau)
            for r in rs:
                util[r].add(wr)
                added.append((r, wr))
        start[a] = s
        return added

    def unplace(a: str, added) -> None:
        for r, wr in added:
            util[r].remove(wr)
        del start[a]

    nodes = 0

    def dfs(i: int) -> bool:
        nonlocal nodes
        if i == len(order):
            return True
        nodes += 1
        if nodes % 64 == 0 and time.monotonic() > deadline:
            raise _Timeout
        a = order[i]
        t_in, t_ex, t_out = window[a]
        if t_in + t_ex + t_out > period:
            return False
        rel = release(a)
        ub = deadline_for(a)
        for s in candidates(a, rel):
            if s > ub:
                break
            added = place(a, s)
            if dfs(i + 1):
                return True
            unplace(a, added)
        return False

    if not dfs(0):
        return None

    times = TaskTimes()
    for a in order:
        s = start[a]
        t_in, t_ex, _ = window[a]
        times.actor_start[a] = s + t_in
        for kind, t, o, tau, _ in layout[a]:
            if kind == "r":
                times.read_start[t] = s + o
            else:
                times.write_start[t] = s + o
    return times


def _decode_exact(
    g: ApplicationGraph,
    arch: ArchitectureGraph,
    decisions: Dict[str, str],
    actor_binding: Dict[str, str],
    solve_fn,
    *,
    time_budget_s: float = 3.0,
    max_period: Optional[int] = None,
    max_rebind_rounds: int = 8,
) -> ExactResult:
    """Algorithm 3's outer loop, parameterized over the fixed-period
    satisfiability engine (backtracking search or CP-SAT): scan P upward
    from the resource lower bound, rebind channels when the found schedule
    overflows a memory.  ``solve_fn`` has :func:`_solve_fixed_period`'s
    signature and raises :class:`_Timeout` past the deadline."""
    t0 = time.monotonic()
    deadline = t0 + time_budget_s
    capacities = {c: ch.capacity for c, ch in g.channels.items()}
    beta_c = determine_channel_bindings(g, arch, decisions, capacities, actor_binding)
    proven = True
    tried = 0

    for _ in range(max_rebind_rounds):
        attach_binding(g, beta_c)
        read_tau, write_tau = comm_times(g, arch, actor_binding, beta_c)
        period = period_lower_bound(g, arch, actor_binding, read_tau, write_tau)
        cap = max_period or (period * 4 + 1024)
        times = None
        while period <= cap:
            tried += 1
            try:
                times = solve_fn(
                    g, arch, actor_binding, beta_c, period, deadline
                )
            except _Timeout:
                proven = False
                # Anytime fallback: greedy completion at growing periods.
                from .caps_hms import caps_hms  # cycle-free local import

                while period <= cap:
                    times = caps_hms(g, arch, actor_binding, beta_c, period)
                    if times is not None:
                        break
                    period += 1
                break
            if times is not None:
                break
            period += 1
        if times is None:
            return ExactResult(None, False, False, tried)

        new_caps = required_capacities(g, times, period, read_tau)
        usage: Dict[str, int] = {}
        for c, gcap in new_caps.items():
            usage[beta_c[c]] = usage.get(beta_c[c], 0) + gcap * g.channels[c].token_bytes
        if all(used <= arch.memories[q].capacity for q, used in usage.items()):
            sched = Schedule(period, times, dict(actor_binding), beta_c, new_caps)
            return ExactResult(sched, True, proven, tried)
        beta_c = determine_channel_bindings(g, arch, decisions, new_caps, actor_binding)
    return ExactResult(None, False, False, tried)


def decode_via_ilp(
    g: ApplicationGraph,
    arch: ArchitectureGraph,
    decisions: Dict[str, str],
    actor_binding: Dict[str, str],
    *,
    time_budget_s: float = 3.0,
    max_period: Optional[int] = None,
    max_rebind_rounds: int = 8,
) -> ExactResult:
    """Algorithm 3: exact decoding with the paper's 3 s anytime budget."""
    return _decode_exact(
        g, arch, decisions, actor_binding, _solve_fixed_period,
        time_budget_s=time_budget_s,
        max_period=max_period,
        max_rebind_rounds=max_rebind_rounds,
    )
