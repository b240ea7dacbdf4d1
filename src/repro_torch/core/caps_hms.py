"""CAPS-HMS — Communication-Aware Periodic Scheduling on Heterogeneous
Many-core Systems (paper Algorithm 5) and the heuristic decoder wrapped
around it (paper Algorithm 4).

The heuristic greedily places each ready actor (priority = topological
order) at the earliest start s'_a ∈ [s_a, s_a + P) such that
  * the bound core is free for the whole window  τ'_a = τ_EI + τ_a + τ_EO
    (reads packed directly before the execution, writes directly after), and
  * every interconnect traversed by each read/write is free during that
    task's slot,
wrapping occupancy into [0, P) via f_wrap.  On failure for every candidate
start, the decoder retries with P+1 (paper-faithful linear period search).

Efficiency note (beyond-paper, semantics-preserving): instead of probing
every integer s'_a the search jumps to the end of the blocking busy
interval, which visits exactly the same sequence of *feasible* candidates
the paper's loop would accept, in O(#busy intervals) instead of O(P).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .architecture import ArchitectureGraph
from .binding import determine_channel_bindings
from .graph import ApplicationGraph, topological_priorities
from .schedule import (
    Schedule,
    TaskTimes,
    UtilizationSet,
    actor_window,
    attach_binding,
    comm_times,
    f_wrap,
    period_lower_bound,
    required_capacities,
)

__all__ = ["caps_hms", "decode_via_heuristic", "DecodeResult"]


@dataclass
class DecodeResult:
    """Phenotype (P, β, γ) plus the full task timing for inspection.

    ``period`` is ``math.inf`` for infeasible decodes so that ad-hoc
    consumers comparing periods never rank an infeasible phenotype as
    "better" (the historical ``-1`` sentinel silently did exactly that);
    this matches the all-∞ objective vector at the ``EvalContext``
    boundary (``infeasible_objectives``).
    """

    schedule: Optional[Schedule]
    feasible: bool
    periods_tried: int = 0

    @property
    def period(self) -> float:
        return self.schedule.period if self.schedule else math.inf

    def to_json(self) -> Dict:
        """JSON form; infeasible results serialize with ``schedule: null``
        so ``period`` is ``math.inf`` again after ``from_json`` (the inf
        never has to survive JSON itself)."""
        return {
            "schedule": self.schedule.to_json() if self.schedule else None,
            "feasible": self.feasible,
            "periods_tried": self.periods_tried,
        }

    @classmethod
    def from_json(cls, d: Dict) -> "DecodeResult":
        sched = d.get("schedule")
        return cls(
            schedule=Schedule.from_json(sched) if sched else None,
            feasible=bool(d["feasible"]),
            periods_tried=d.get("periods_tried", 0),
        )


def _advance_past(period: int, s_abs: int, offset: int, busy_end: int) -> int:
    """Smallest s' > s_abs such that phase(s' + offset) == busy_end, i.e. the
    conflicting piece starting at phase((s_abs + offset) mod P) is moved to
    begin exactly at the end of the blocking busy interval."""
    phase = (s_abs + offset) % period
    delta = (busy_end - phase) % period
    return s_abs + (delta if delta > 0 else period)


@dataclass
class _Ctx:
    """Per-(binding, decisions) invariants hoisted out of the period search."""

    read_tau: Dict[Tuple[str, str], int]
    write_tau: Dict[Tuple[str, str], int]
    route_r: Dict[Tuple[str, str], List[str]]
    prio: Dict[str, int]
    windows: Dict[str, Tuple[int, int, int]]  # (τ_EI, τ_a, τ_EO)
    in_ch: Dict[str, List[str]]
    out_ch: Dict[str, List[str]]


def _build_ctx(
    g: ApplicationGraph,
    arch: ArchitectureGraph,
    actor_binding: Dict[str, str],
    channel_binding: Dict[str, str],
) -> _Ctx:
    attach_binding(g, channel_binding)
    read_tau, write_tau = comm_times(g, arch, actor_binding, channel_binding)
    route_r: Dict[Tuple[str, str], List[str]] = {}
    for c in g.channels:
        mem = channel_binding[c]
        for r in g.consumers[c]:
            route_r[(c, r)] = arch.route_interconnects(actor_binding[r], mem)
        p = g.producer[c]
        route_r[(p, c)] = arch.route_interconnects(actor_binding[p], mem)
    in_ch = {a: g.in_channels(a) for a in g.actors}
    out_ch = {a: g.out_channels(a) for a in g.actors}
    windows = {}
    for a in g.actors:
        t_in = sum(read_tau[(c, a)] for c in in_ch[a])
        t_out = sum(write_tau[(a, c)] for c in out_ch[a])
        ctype = arch.cores[actor_binding[a]].ctype
        windows[a] = (t_in, g.actors[a].exec_times[ctype], t_out)
    return _Ctx(
        read_tau, write_tau, route_r, topological_priorities(g), windows, in_ch, out_ch
    )


def caps_hms(
    g: ApplicationGraph,
    arch: ArchitectureGraph,
    actor_binding: Dict[str, str],
    channel_binding: Dict[str, str],
    period: int,
    ctx: Optional[_Ctx] = None,
) -> Optional[TaskTimes]:
    """Algorithm 5.  Returns task start times on success, None on failure."""
    if ctx is None:
        ctx = _build_ctx(g, arch, actor_binding, channel_binding)
    read_tau, write_tau = ctx.read_tau, ctx.write_tau
    route_r, prio = ctx.route_r, ctx.prio

    util: Dict[str, UtilizationSet] = {r: UtilizationSet() for r in arch.schedulable_resources()}
    times = TaskTimes()
    s_min: Dict[str, int] = {a: 0 for a in g.actors}  # earliest start (deps)

    def ready_initial() -> List[str]:
        out = []
        for a in g.actors:
            if all(g.channels[c].delay >= 1 for c in ctx.in_ch[a]):
                out.append(a)
        return out

    scheduled: Set[str] = set()
    ready: List[str] = ready_initial()

    def newly_ready(a_fired: str) -> List[str]:
        out = []
        for c in ctx.out_ch[a_fired]:
            if g.channels[c].delay >= 1:
                continue
            for a2 in g.consumers[c]:
                if a2 in scheduled or a2 in ready or a2 in out:
                    continue
                ok = True
                for cin in ctx.in_ch[a2]:
                    if g.channels[cin].delay >= 1:
                        continue
                    if g.producer[cin] not in scheduled:
                        ok = False
                        break
                if ok:
                    out.append(a2)
        return out

    while ready:
        ready.sort(key=lambda a: (-prio[a], a))
        a = ready.pop(0)
        p = actor_binding[a]
        reads = [(c, a) for c in ctx.in_ch[a]]
        writes = [(a, c) for c in ctx.out_ch[a]]
        t_in, t_ex, t_out = ctx.windows[a]
        t_win = t_in + t_ex + t_out
        if t_win > period:
            return None  # cannot fit even alone

        placed = False
        s = s_min[a]
        limit = s_min[a] + period
        while s < limit:
            # Core window free?
            pieces = f_wrap(period, s, t_win)
            hit = util[p].conflict(pieces)
            if hit is not None:
                s = _advance_past(period, s, 0, hit[1])
                continue
            # Interconnects free for each comm task at its packed offset?
            off = 0
            comm_offsets: List[Tuple[Tuple[str, str], int, int]] = []
            for t in reads:
                comm_offsets.append((t, off, read_tau[t]))
                off += read_tau[t]
            off += t_ex
            for t in writes:
                comm_offsets.append((t, off, write_tau[t]))
                off += write_tau[t]
            conflict_jump: Optional[int] = None
            for t, o, tau in comm_offsets:
                if tau <= 0:
                    continue
                tp = f_wrap(period, s + o, tau)
                for h in route_r[t]:
                    hit = util[h].conflict(tp)
                    if hit is not None:
                        cand = _advance_past(period, s, o, hit[1])
                        if conflict_jump is None or cand < conflict_jump:
                            conflict_jump = cand
                        break
                if conflict_jump is not None:
                    break
            if conflict_jump is not None:
                s = max(conflict_jump, s + 1)
                continue

            # Commit (Lines 17-21).
            util[p].add(pieces)
            for t, o, tau in comm_offsets:
                if tau <= 0:
                    continue
                for h in route_r[t]:
                    util[h].add(f_wrap(period, s + o, tau))
            times.actor_start[a] = s + t_in
            # Record comm starts (reads then writes, packed; zero-time comms
            # get the packed position too for capacity accounting).
            off = 0
            for t in reads:
                times.read_start[t] = s + off
                off += read_tau[t]
            off += t_ex
            for t in writes:
                times.write_start[t] = s + off
                off += write_tau[t]
            end = s + t_win
            for c in ctx.out_ch[a]:
                if g.channels[c].delay == 0:
                    for a2 in g.consumers[c]:
                        if a2 not in scheduled:
                            s_min[a2] = max(s_min[a2], end)
            scheduled.add(a)
            ready.extend(newly_ready(a))
            placed = True
            break
        if not placed:
            return None

    if len(scheduled) != len(g.actors):
        # Unreachable actors (cyclic zero-delay parts) — treat as failure.
        return None

    # Cross-iteration dependency guard (Eq. 16 for δ ≥ 1 channels).  The
    # paper's Line 20 only propagates zero-delay dependencies; with initial
    # tokens a consumer of higher priority can be placed more than δ
    # periods before its producer's write completes.  Rejecting here makes
    # the decoder retry with a larger P, which absorbs the drift.
    for c in g.channels:
        prod = g.producer[c]
        s_w = times.write_start[(prod, c)]
        tau_w = write_tau[(prod, c)]
        delta = g.channels[c].delay
        for r in g.consumers[c]:
            if s_w + tau_w - period * delta > times.read_start[(c, r)]:
                return None
    return times


def _search_period(
    g: ApplicationGraph,
    arch: ArchitectureGraph,
    actor_binding: Dict[str, str],
    beta_c: Dict[str, str],
    lb: int,
    cap: int,
    mode: str,
    ctx: _Ctx,
) -> Tuple[Optional[TaskTimes], int, int]:
    """Find the smallest period in [lb, cap] CAPS-HMS can schedule.

    mode='linear' is the paper's P ← P+1 loop.  mode='gallop' (default) is a
    semantics-preserving accelerant: multiplicative ramp to the first
    feasible P, then binary search down (feasibility of the greedy heuristic
    is monotone in P for all observed instances; the found period is re-
    verified by an actual schedule, so correctness never depends on this).
    Returns (times, period, attempts)."""
    tried = 0

    def attempt(P: int) -> Optional[TaskTimes]:
        nonlocal tried
        tried += 1
        return caps_hms(g, arch, actor_binding, beta_c, P, ctx)

    if mode == "linear":
        period = lb
        while period <= cap:
            t = attempt(period)
            if t is not None:
                return t, period, tried
            period += 1
        return None, -1, tried

    # gallop up
    lo_fail = lb - 1
    period = lb
    best: Optional[Tuple[TaskTimes, int]] = None
    while period <= cap:
        t = attempt(period)
        if t is not None:
            best = (t, period)
            break
        lo_fail = period
        period = max(period + 1, int(period * 1.25))
    if best is None:
        return None, -1, tried
    # binary search down between last failure and the success
    hi_t, hi_p = best
    lo = lo_fail
    while hi_p - lo > 1:
        mid = (lo + hi_p) // 2
        t = attempt(mid)
        if t is not None:
            hi_t, hi_p = t, mid
        else:
            lo = mid
    return hi_t, hi_p, tried


def decode_via_heuristic(
    g: ApplicationGraph,
    arch: ArchitectureGraph,
    decisions: Dict[str, str],
    actor_binding: Dict[str, str],
    *,
    max_period: Optional[int] = None,
    max_rebind_rounds: int = 8,
    period_search: str = "gallop",
) -> DecodeResult:
    """Algorithm 4: channel bindings → period search via CAPS-HMS → capacity
    enlargement → re-binding loop until all channels fit their memories."""
    capacities: Dict[str, int] = {c: ch.capacity for c, ch in g.channels.items()}
    beta_c = determine_channel_bindings(g, arch, decisions, capacities, actor_binding)
    tried = 0

    for _ in range(max_rebind_rounds):
        ctx = _build_ctx(g, arch, actor_binding, beta_c)
        read_tau, write_tau = ctx.read_tau, ctx.write_tau
        lb = period_lower_bound(g, arch, actor_binding, read_tau, write_tau)
        cap = max_period or (lb * 8 + 4096)
        times, period, n = _search_period(
            g, arch, actor_binding, beta_c, lb, cap, period_search, ctx
        )
        tried += n
        if times is None:
            return DecodeResult(None, False, tried)

        new_caps = required_capacities(g, times, period, read_tau)
        # Does everything still fit where it is bound?
        usage: Dict[str, int] = {}
        for c, gcap in new_caps.items():
            q = beta_c[c]
            usage[q] = usage.get(q, 0) + gcap * g.channels[c].token_bytes
        overflow = [
            q for q, used in usage.items() if used > arch.memories[q].capacity
        ]
        if not overflow:
            sched = Schedule(period, times, dict(actor_binding), beta_c, new_caps)
            return DecodeResult(sched, True, tried)
        beta_c = determine_channel_bindings(g, arch, decisions, new_caps, actor_binding)
    return DecodeResult(None, False, tried)
