"""Shared modulo-scheduling machinery (paper §III-C, §V).

Tasks t ∈ T = A ∪ E: actor firings, read edges (c, a), and write edges
(a, c).  Each task gets one start time s_t repeating with period P.  A task
executing in [s_t, s_t + τ_t) occupies, inside the schedule window [0, P),
the wrapped region  f_wrap(P, s_t, τ_t) = { t mod P | s_t ≤ t < s_t + τ_t }.

Resources r ∈ R \\ Q (cores and interconnects) carry utilization sets U_r of
occupied intervals within [0, P).  Memories are not scheduled (no
utilization), matching the paper.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .architecture import ArchitectureGraph
from .graph import ApplicationGraph

__all__ = [
    "f_wrap",
    "UtilizationSet",
    "TaskTimes",
    "Schedule",
    "comm_times",
    "actor_window",
    "window_task_layout",
    "period_lower_bound",
    "required_capacities",
    "validate_schedule",
]


def f_wrap(period: int, start: int, dur: int) -> List[Tuple[int, int]]:
    """Wrapped occupancy of [start, start+dur) into [0, period) as a list of
    disjoint [b, e) intervals (at most two)."""
    if dur <= 0:
        return []
    if dur >= period:
        return [(0, period)]
    b = start % period
    e = b + dur
    if e <= period:
        return [(b, e)]
    return [(b, period), (0, e - period)]


class UtilizationSet:
    """Sorted disjoint occupied intervals within [0, P).

    Supports O(log n) overlap queries and conflict reporting for the
    jump-ahead candidate search used by both schedulers.
    """

    __slots__ = ("starts", "ends")

    def __init__(self) -> None:
        self.starts: List[int] = []
        self.ends: List[int] = []

    def total(self) -> int:
        return sum(e - s for s, e in zip(self.starts, self.ends))

    def _conflict_one(self, b: int, e: int) -> Optional[Tuple[int, int]]:
        """First occupied interval overlapping [b, e), or None."""
        if b >= e:
            return None
        i = bisect.bisect_right(self.starts, b) - 1
        if i >= 0 and self.ends[i] > b:
            return (self.starts[i], self.ends[i])
        i += 1
        if i < len(self.starts) and self.starts[i] < e:
            return (self.starts[i], self.ends[i])
        return None

    def conflict(self, pieces: Sequence[Tuple[int, int]]) -> Optional[Tuple[int, int]]:
        for b, e in pieces:
            hit = self._conflict_one(b, e)
            if hit is not None:
                return hit
        return None

    def add(self, pieces: Sequence[Tuple[int, int]]) -> None:
        for b, e in pieces:
            if b >= e:
                continue
            i = bisect.bisect_left(self.starts, b)
            self.starts.insert(i, b)
            self.ends.insert(i, e)
        # merge neighbours (intervals are disjoint by construction; merging
        # only coalesces touching intervals to keep lists small)
        i = 0
        while i + 1 < len(self.starts):
            if self.ends[i] >= self.starts[i + 1]:
                self.ends[i] = max(self.ends[i], self.ends[i + 1])
                del self.starts[i + 1]
                del self.ends[i + 1]
            else:
                i += 1

    def remove(self, pieces: Sequence[Tuple[int, int]]) -> None:
        """Exact inverse of add for backtracking search (pieces must be
        occupied)."""
        for b, e in pieces:
            if b >= e:
                continue
            i = bisect.bisect_right(self.starts, b) - 1
            s0, e0 = self.starts[i], self.ends[i]
            assert s0 <= b and e <= e0, "removing unoccupied region"
            del self.starts[i]
            del self.ends[i]
            if s0 < b:
                self.starts.insert(i, s0)
                self.ends.insert(i, b)
                i += 1
            if e < e0:
                self.starts.insert(i, e)
                self.ends.insert(i, e0)

    def copy(self) -> "UtilizationSet":
        u = UtilizationSet()
        u.starts = list(self.starts)
        u.ends = list(self.ends)
        return u


@dataclass
class TaskTimes:
    """Start times for all tasks of one iteration."""

    actor_start: Dict[str, int] = field(default_factory=dict)          # s_a
    read_start: Dict[Tuple[str, str], int] = field(default_factory=dict)   # s_(c,a)
    write_start: Dict[Tuple[str, str], int] = field(default_factory=dict)  # s_(a,c)


@dataclass
class Schedule:
    """A periodic schedule: the phenotype's timing part."""

    period: int
    times: TaskTimes
    actor_binding: Dict[str, str]
    channel_binding: Dict[str, str]
    capacities: Dict[str, int]  # possibly enlarged γ

    def to_json(self) -> Dict:
        """Plain-JSON form (edge keys become [channel, actor, start] rows)."""
        return {
            "period": self.period,
            "actor_start": dict(self.times.actor_start),
            "read_start": [[c, a, s] for (c, a), s in sorted(self.times.read_start.items())],
            "write_start": [[a, c, s] for (a, c), s in sorted(self.times.write_start.items())],
            "actor_binding": dict(self.actor_binding),
            "channel_binding": dict(self.channel_binding),
            "capacities": dict(self.capacities),
        }

    @classmethod
    def from_json(cls, d: Dict) -> "Schedule":
        return cls(
            period=d["period"],
            times=TaskTimes(
                actor_start=dict(d["actor_start"]),
                read_start={(c, a): s for c, a, s in d["read_start"]},
                write_start={(a, c): s for a, c, s in d["write_start"]},
            ),
            actor_binding=dict(d["actor_binding"]),
            channel_binding=dict(d["channel_binding"]),
            capacities=dict(d["capacities"]),
        )


def comm_times(
    g: ApplicationGraph,
    arch: ArchitectureGraph,
    actor_binding: Dict[str, str],
    channel_binding: Dict[str, str],
) -> Tuple[Dict[Tuple[str, str], int], Dict[Tuple[str, str], int]]:
    """τ for every read (c, a) and write (a, c) edge (paper Eq. 11)."""
    read_tau: Dict[Tuple[str, str], int] = {}
    write_tau: Dict[Tuple[str, str], int] = {}
    for c in g.channels:
        ch = g.channels[c]
        mem = channel_binding[c]
        prod = g.producer[c]
        write_tau[(prod, c)] = arch.comm_time(
            ch.token_bytes, actor_binding[prod], mem
        )
        for r in g.consumers[c]:
            read_tau[(c, r)] = arch.comm_time(ch.token_bytes, actor_binding[r], mem)
    return read_tau, write_tau


def actor_exec_time(g: ApplicationGraph, arch: ArchitectureGraph, binding: Dict[str, str], a: str) -> int:
    ctype = arch.cores[binding[a]].ctype
    tau = g.actors[a].exec_times.get(ctype)
    if tau is None:
        raise ValueError(f"actor {a} cannot run on core type {ctype}")
    return tau


def actor_window(
    g: ApplicationGraph,
    arch: ArchitectureGraph,
    actor_binding: Dict[str, str],
    read_tau: Dict[Tuple[str, str], int],
    write_tau: Dict[Tuple[str, str], int],
    a: str,
) -> Tuple[int, int, int]:
    """(τ_EI, τ_a, τ_EO): read-block, exec, write-block durations of actor a.
    The core is occupied for the full window τ'_a = τ_EI + τ_a + τ_EO."""
    t_in = sum(read_tau[(c, a)] for c in g.in_channels(a))
    t_out = sum(write_tau[(a, c)] for c in g.out_channels(a))
    return t_in, actor_exec_time(g, arch, actor_binding, a), t_out


def window_task_layout(
    g: ApplicationGraph,
    a: str,
    exec_time: int,
    read_tau: Dict[Tuple[str, str], int],
    write_tau: Dict[Tuple[str, str], int],
) -> List[Tuple[str, Optional[str], int]]:
    """The packed task sequence of one firing of actor ``a``: reads in
    ``g.in_channels(a)`` order, the execution, then writes in
    ``g.out_channels(a)`` order — the layout both CAPS-HMS and the exact
    decoder assume for the actor window, and the program order the
    self-timed simulator (:mod:`repro_torch.sim`) executes.  Each entry is
    ``(kind, channel, duration)`` with ``kind`` ∈ {"read", "exec",
    "write"} and ``channel`` None for the execution."""
    out: List[Tuple[str, Optional[str], int]] = []
    for c in g.in_channels(a):
        out.append(("read", c, read_tau[(c, a)]))
    out.append(("exec", None, exec_time))
    for c in g.out_channels(a):
        out.append(("write", c, write_tau[(a, c)]))
    return out


def period_lower_bound(
    g: ApplicationGraph,
    arch: ArchitectureGraph,
    actor_binding: Dict[str, str],
    read_tau: Dict[Tuple[str, str], int],
    write_tau: Dict[Tuple[str, str], int],
) -> int:
    """P_lb = max_r Σ_{t ∈ T_r} τ_t over cores and interconnects
    (Algorithm 4, Line 3)."""
    core_load: Dict[str, int] = {p: 0 for p in arch.cores}
    link_load: Dict[str, int] = {h: 0 for h in arch.interconnects}
    for a in g.actors:
        t_in, t_ex, t_out = actor_window(g, arch, actor_binding, read_tau, write_tau, a)
        core_load[actor_binding[a]] += t_in + t_ex + t_out
    for (c, a), tau in read_tau.items():
        if tau <= 0:
            continue
        for h in arch.route_interconnects(actor_binding[a], _mem_of(g, c)):
            link_load[h] += tau
    for (a, c), tau in write_tau.items():
        if tau <= 0:
            continue
        for h in arch.route_interconnects(actor_binding[a], _mem_of(g, c)):
            link_load[h] += tau
    loads = list(core_load.values()) + list(link_load.values())
    return max(1, max(loads) if loads else 1)


# The channel→memory binding is threaded through via a closure-free helper:
# schedulers stash it on the graph object for τ routing lookups.
def _mem_of(g: ApplicationGraph, c: str) -> str:
    return g._channel_binding[c]  # type: ignore[attr-defined]


def attach_binding(g: ApplicationGraph, channel_binding: Dict[str, str]) -> None:
    g._channel_binding = channel_binding  # type: ignore[attr-defined]


def required_capacities(
    g: ApplicationGraph,
    times: TaskTimes,
    period: int,
    read_tau: Dict[Tuple[str, str], int],
) -> Dict[str, int]:
    """Enlarge γ(c) to accommodate the modulo schedule (Algorithms 3/4).

    A token written at s_w (+kP) stays alive until the *last* reader of the
    corresponding iteration finishes, δ iterations later:
        lifetime = (max_r s_(c,r) + τ_(c,r)) + δ·P − s_(a,c)
        γ_needed = δ + floor((F − s_w) / P) + 1,  F = max read finish.
    Never shrinks the declared capacity.
    """
    out: Dict[str, int] = {}
    for c, ch in g.channels.items():
        prod = g.producer[c]
        s_w = times.write_start[(prod, c)]
        fin = max(
            times.read_start[(c, r)] + read_tau[(c, r)] for r in g.consumers[c]
        )
        needed = ch.delay + (fin - s_w) // period + 1
        out[c] = max(ch.capacity, needed, 1)
    return out


def validate_schedule(
    g: ApplicationGraph,
    arch: ArchitectureGraph,
    sched: Schedule,
) -> List[str]:
    """Check the paper's feasibility conditions on a finished schedule:
    resource exclusivity (Eqs. 19-23 analogue) and data dependencies
    (Eqs. 16-18).  Returns violation strings."""
    errs: List[str] = []
    P = sched.period
    attach_binding(g, sched.channel_binding)
    read_tau, write_tau = comm_times(g, arch, sched.actor_binding, sched.channel_binding)

    # Resource exclusivity.
    util: Dict[str, UtilizationSet] = {r: UtilizationSet() for r in arch.schedulable_resources()}

    def occupy(r: str, s: int, d: int, what: str) -> None:
        pieces = f_wrap(P, s, d)
        if util[r].conflict(pieces):
            errs.append(f"overlap on {r} by {what}")
        util[r].add(pieces)

    for a in g.actors:
        t_in, t_ex, t_out = actor_window(g, arch, sched.actor_binding, read_tau, write_tau, a)
        p = sched.actor_binding[a]
        s_a = sched.times.actor_start[a]
        occupy(p, s_a - t_in, t_in + t_ex + t_out, f"actor-window {a}")
    for (c, a), tau in read_tau.items():
        if tau <= 0:
            continue
        s = sched.times.read_start[(c, a)]
        for h in arch.route_interconnects(sched.actor_binding[a], sched.channel_binding[c]):
            occupy(h, s, tau, f"read ({c},{a})")
    for (a, c), tau in write_tau.items():
        if tau <= 0:
            continue
        s = sched.times.write_start[(a, c)]
        for h in arch.route_interconnects(sched.actor_binding[a], sched.channel_binding[c]):
            occupy(h, s, tau, f"write ({a},{c})")

    # Data dependencies: Eq. 16 (write before read, modulo δ iterations),
    # Eq. 17 (reads before actor), Eq. 18 (actor before writes).
    for c in g.channels:
        prod = g.producer[c]
        s_w = sched.times.write_start[(prod, c)]
        tau_w = write_tau[(prod, c)]
        for r in g.consumers[c]:
            s_r = sched.times.read_start[(c, r)]
            if s_w + tau_w - P * g.channels[c].delay > s_r:
                errs.append(f"dependency violated on {c}: write {s_w}+{tau_w} -> read {s_r}")
    for a in g.actors:
        s_a = sched.times.actor_start[a]
        t_ex = actor_exec_time(g, arch, sched.actor_binding, a)
        for c in g.in_channels(a):
            s_r = sched.times.read_start[(c, a)]
            if s_r + read_tau[(c, a)] > s_a:
                errs.append(f"read ({c},{a}) finishes after actor start")
        for c in g.out_channels(a):
            if sched.times.write_start[(a, c)] < s_a + t_ex:
                errs.append(f"write ({a},{c}) starts before actor {a} ends")
    return errs
