"""Independent schedule verifier (paper Eqs. 8, 14-23; README "Schedule
verification").

``verify_schedule`` re-checks a finished :class:`~repro_torch.core.schedule.Schedule`
against the paper's constraint system *without reusing any scheduler
machinery*: occupancy conflicts are detected by a pairwise wrapped-interval
test (not :class:`~repro_torch.core.schedule.UtilizationSet`), communication times
are recomputed from the architecture routes, buffer requirements are
re-derived from token lifetimes, and MRB/FIFO forwarding is replayed through
the exact paper index machine (:class:`~repro_torch.core.mrb.MRBState`).  Every
failed constraint becomes a structured :class:`Violation` so decoders —
CAPS-HMS, the branch-and-bound exact search, CP-SAT, anything registered in
the decoder registry — can be graded by a component none of them share code
with.

Checks and their ``Violation.kind`` values:

=================  =======================================================
``period``         P < 1, or a single task longer than P (self-overlap)
``binding_domain`` unknown core/memory, incompatible core type, missing
                   binding / capacity / task-time entries
``resource_overlap``  two actor windows on one core, or two communication
                   tasks on one interconnect, overlap modulo P (Eq. 23)
``window_order``   a read finishing after its actor starts (Eq. 17) or a
                   write starting before it ends (Eq. 18), or two tasks of
                   one actor overlapping on its core
``edge_dependency``  generalized multi-rate Eq. 16 violated: reader firing
                   k starts before write ⌈(κ(k+1)−δ)/ψ⌉ has finished
                   (arXiv 1807.05721's generalized connections, reduced to
                   one firing per actor per period)
``rate_imbalance`` ψ(e) ≠ κ(e): a single-firing periodic schedule cannot
                   balance the edge (κ>ψ starves, ψ>κ overflows any γ)
``buffer_capacity``  γ(c) in the schedule below the re-derived token
                   lifetime requirement δ + ⌊(F − s_w)/P⌋ + 1
``memory_capacity``  Σ_{c→q} γ(c)·φ(c) > W_q (Eq. 8)
``mrb_single_copy``  phantom/duplicated MRB binding or capacity entry —
                   an MRB must exist exactly once, in one memory
``mrb_forwarding``  the MRBState replay under- or over-flowed: the timed
                   schedule breaks the index machine's FIFO forwarding
=================  =======================================================

The checker is deliberately *edge-level* on dependencies, matching the
exact decoder's documented deviation (DESIGN.md §7): CAPS-HMS enforces a
stronger actor-level update, so all its schedules pass; the exact decoder's
schedules are exactly the feasible set of this checker.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..core.architecture import ArchitectureGraph
from ..core.graph import ApplicationGraph
from ..core.mrb import MRBState
from ..core.schedule import Schedule

__all__ = [
    "VIOLATION_KINDS",
    "Violation",
    "VerificationReport",
    "verify_schedule",
    "verify_decode_result",
]

VIOLATION_KINDS = (
    "period",
    "binding_domain",
    "resource_overlap",
    "window_order",
    "edge_dependency",
    "rate_imbalance",
    "buffer_capacity",
    "memory_capacity",
    "mrb_single_copy",
    "mrb_forwarding",
)


@dataclass(frozen=True)
class Violation:
    """One failed constraint, locatable and JSON-serializable."""

    kind: str
    subject: str          # the resource / channel / actor the check is about
    message: str
    details: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return {
            "kind": self.kind,
            "subject": self.subject,
            "message": self.message,
            "details": dict(self.details),
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "Violation":
        return cls(d["kind"], d["subject"], d["message"], dict(d.get("details", {})))


@dataclass
class VerificationReport:
    """All violations of one schedule (empty ⇔ the schedule is valid)."""

    period: Optional[float]
    violations: List[Violation] = field(default_factory=list)
    feasible: bool = True  # False for infeasible DecodeResults (vacuous pass)

    @property
    def ok(self) -> bool:
        return not self.violations

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for v in self.violations:
            out[v.kind] = out.get(v.kind, 0) + 1
        return out

    def kinds(self) -> set:
        return {v.kind for v in self.violations}

    def by_kind(self, kind: str) -> List[Violation]:
        return [v for v in self.violations if v.kind == kind]

    def summary(self) -> str:
        if not self.feasible:
            return "infeasible (nothing to verify)"
        if self.ok:
            return f"OK (period={self.period:g})"
        parts = ", ".join(f"{k}={n}" for k, n in sorted(self.counts().items()))
        return f"{len(self.violations)} violation(s): {parts}"

    def to_json(self) -> Dict[str, Any]:
        return {
            "period": self.period,
            "feasible": self.feasible,
            "ok": self.ok,
            "counts": self.counts(),
            "violations": [v.to_json() for v in self.violations],
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "VerificationReport":
        return cls(
            period=d.get("period"),
            violations=[Violation.from_json(v) for v in d.get("violations", [])],
            feasible=d.get("feasible", True),
        )

    def dumps(self) -> str:
        return json.dumps(self.to_json(), indent=2, sort_keys=True)


# ------------------------------------------------------------------ helpers
def _wrapped_overlap(period: int, s1: int, d1: int, s2: int, d2: int) -> bool:
    """Do [s1, s1+d1) and [s2, s2+d2), repeated every ``period``, overlap?

    Independent of ``f_wrap``/``UtilizationSet``: shift so task 1 starts at
    0 mod P; overlap iff task 2's wrapped start lands inside task 1 or
    vice versa."""
    if d1 <= 0 or d2 <= 0:
        return False
    if d1 >= period or d2 >= period:
        return True
    if (s2 - s1) % period < d1:
        return True
    return (s1 - s2) % period < d2


def _dependency_slack(psi: int, kappa: int, delta: int) -> Optional[int]:
    """Minimal period-slack m of the generalized Eq. 16: the edge is
    satisfied iff  s_w + τ_w ≤ s_r + m·P.

    With one firing per actor per period, reader firing k (consuming tokens
    κ·k … κ·(k+1)−1, after δ initial tokens) needs j*(k) = ⌈(κ(k+1)−δ)/ψ⌉
    producer firings complete; firing j happens one period after firing
    j−1, so the binding constraint is  fin_w + (j*(k)−1)·P ≤ s_r + k·P,
    i.e. slack k − j*(k) + 1.  For κ ≤ ψ the slack is non-decreasing in k
    past the delay warm-up, so the minimum is attained among the first
    ⌈(δ + lcm(ψ,κ))/κ⌉ + 1 firings.  Returns None when no firing ever
    needs a write (degenerate, e.g. huge δ with tiny horizon — cannot
    happen here since we scan past the warm-up).  Callers must handle
    κ > ψ separately (the slack decreases forever: starvation)."""
    horizon = (delta + math.lcm(psi, kappa)) // kappa + 2
    slack: Optional[int] = None
    for k in range(horizon):
        j = -((-(kappa * (k + 1) - delta)) // psi)  # ceil division
        if j < 1:
            continue
        m = k - j + 1
        slack = m if slack is None else min(slack, m)
    return slack


def _replay_token_machine(
    c: str,
    readers: Tuple[str, ...],
    capacity: int,
    delay: int,
    period: int,
    fin_w: int,
    read_events: Dict[str, Tuple[int, int]],  # reader -> (s_r, tau_r)
    iterations: int,
) -> Optional[Violation]:
    """Drive the periodic schedule's events through the exact MRB index
    machine (paper §II-C).  Underflow at a read start or overflow at a
    write completion breaks FIFO forwarding.  Token slots are freed at
    read *start* (optimistic): the pessimistic side of capacity is covered
    by the ``buffer_capacity`` lifetime check, so this replay never
    reports a false overflow for lifetime-sized buffers."""
    m = MRBState(capacity, readers)
    for _ in range(delay):  # the δ initial tokens (§VI pipelining)
        if not m.can_write():
            return Violation(
                "mrb_forwarding", c,
                f"capacity {capacity} cannot hold the {delay} initial tokens",
                {"capacity": capacity, "delay": delay},
            )
        m.write()
    # Event list: write completions produce, read starts must find a token
    # (and consume it).  Ties: writes before reads, so Eq. 16's equality
    # case (a read starting exactly at a write's completion) is legal.
    events: List[Tuple[int, int, int, str]] = []
    for i in range(iterations):
        events.append((fin_w + i * period, 0, i, ""))
        for r in readers:
            s_r, _tau = read_events[r]
            events.append((s_r + i * period, 1, i, r))
    events.sort()
    for t, phase, i, r in events:
        if phase == 0:  # write completion
            if not m.can_write():
                return Violation(
                    "mrb_forwarding", c,
                    f"overflow: write of iteration {i} completes at t={t} "
                    f"with no free slot (capacity {capacity})",
                    {"time": t, "iteration": i, "capacity": capacity},
                )
            m.write()
        else:  # read start
            if not m.can_read(r):
                return Violation(
                    "mrb_forwarding", c,
                    f"underflow: reader {r} starts at t={t} (iteration {i}) "
                    f"with no token available",
                    {"time": t, "iteration": i, "reader": r},
                )
            m.read(r)
    return None


# ================================================================= verifier
def verify_schedule(
    g: ApplicationGraph,
    arch: ArchitectureGraph,
    sched: Schedule,
    *,
    replay: bool = True,
) -> VerificationReport:
    """Check ``sched`` against every constraint of the paper's model and
    report all violations (never raises on a malformed schedule; malformed
    parts become ``binding_domain`` violations and dependent checks are
    skipped for them)."""
    out: List[Violation] = []
    period = sched.period
    report = VerificationReport(period=float(period), violations=out)
    if not isinstance(period, int) or period < 1:
        out.append(Violation(
            "period", "schedule", f"period must be a positive int, got {period!r}",
            {"period": period},
        ))
        return report  # everything below divides by P

    times = sched.times

    # ------------------------------------------------ binding / key domains
    ok_actor: Dict[str, bool] = {}
    for a in g.actors:
        core = sched.actor_binding.get(a)
        ok_actor[a] = False
        if core is None:
            out.append(Violation("binding_domain", a, "actor has no core binding"))
        elif core not in arch.cores:
            out.append(Violation(
                "binding_domain", a, f"bound to unknown core {core!r}", {"core": core}
            ))
        elif not g.actors[a].can_run_on(arch.cores[core].ctype):
            out.append(Violation(
                "binding_domain", a,
                f"core {core} has type {arch.cores[core].ctype} which actor "
                f"{a} cannot run on",
                {"core": core, "ctype": arch.cores[core].ctype},
            ))
        elif a not in times.actor_start:
            out.append(Violation("binding_domain", a, "missing actor start time"))
        else:
            ok_actor[a] = True
    for a in sched.actor_binding:
        if a not in g.actors:
            out.append(Violation(
                "binding_domain", a, "binding entry for unknown actor"
            ))

    def _phantom_kind(name: str) -> str:
        # A phantom entry that names (or embeds) an MRB channel duplicates
        # the buffer the MRB substitution guarantees to exist exactly once.
        return "mrb_single_copy" if "mrb{" in name else "binding_domain"

    ok_channel: Dict[str, bool] = {}
    for c, ch in g.channels.items():
        mem = sched.channel_binding.get(c)
        ok_channel[c] = False
        if mem is None:
            out.append(Violation(
                _phantom_kind(c), c, "channel has no memory binding"
            ))
        elif mem not in arch.memories:
            out.append(Violation(
                "binding_domain", c, f"bound to unknown memory {mem!r}", {"memory": mem}
            ))
        elif c not in sched.capacities:
            out.append(Violation(_phantom_kind(c), c, "channel has no capacity entry"))
        else:
            prod = g.producer[c]
            missing = [(prod, c)] if (prod, c) not in times.write_start else []
            missing += [(c, r) for r in g.consumers[c] if (c, r) not in times.read_start]
            if missing:
                out.append(Violation(
                    "binding_domain", c,
                    f"missing task times for edges {missing}", {"missing": missing},
                ))
            else:
                ok_channel[c] = True
    for c in sched.channel_binding:
        if c not in g.channels:
            out.append(Violation(
                _phantom_kind(c), c,
                "memory binding for a channel the graph does not have "
                "(duplicated buffer copy)",
            ))
    for c in sched.capacities:
        if c not in g.channels:
            out.append(Violation(
                _phantom_kind(c), c,
                "capacity entry for a channel the graph does not have "
                "(duplicated buffer copy)",
            ))

    # ------------------------------------------- recomputed communication τ
    read_tau: Dict[Tuple[str, str], int] = {}
    write_tau: Dict[Tuple[str, str], int] = {}
    for c, ch in g.channels.items():
        if not ok_channel[c]:
            continue
        mem = sched.channel_binding[c]
        prod = g.producer[c]
        if ok_actor.get(prod):
            write_tau[(prod, c)] = arch.comm_time(
                ch.token_bytes, sched.actor_binding[prod], mem
            )
        for r in g.consumers[c]:
            if ok_actor.get(r):
                read_tau[(c, r)] = arch.comm_time(
                    ch.token_bytes, sched.actor_binding[r], mem
                )

    # Per-actor task lists: (label, start, dur); skip tasks with unknown τ.
    def _actor_tasks(a: str) -> List[Tuple[str, int, int]]:
        tasks: List[Tuple[str, int, int]] = []
        for c in g.in_channels(a):
            if (c, a) in read_tau and (c, a) in times.read_start:
                tasks.append((f"read({c},{a})", times.read_start[(c, a)], read_tau[(c, a)]))
        ctype = arch.cores[sched.actor_binding[a]].ctype
        tasks.append((f"exec({a})", times.actor_start[a], g.actors[a].exec_times[ctype]))
        for c in g.out_channels(a):
            if (a, c) in write_tau and (a, c) in times.write_start:
                tasks.append((f"write({a},{c})", times.write_start[(a, c)], write_tau[(a, c)]))
        return tasks

    # --------------------------------------- window order (Eqs. 17 and 18)
    exec_time: Dict[str, int] = {}
    for a in g.actors:
        if not ok_actor[a]:
            continue
        ctype = arch.cores[sched.actor_binding[a]].ctype
        exec_time[a] = g.actors[a].exec_times[ctype]
        s_a = times.actor_start[a]
        for c in g.in_channels(a):
            if (c, a) not in read_tau or (c, a) not in times.read_start:
                continue
            fin = times.read_start[(c, a)] + read_tau[(c, a)]
            if fin > s_a:
                out.append(Violation(
                    "window_order", a,
                    f"read ({c},{a}) finishes at {fin}, after the actor "
                    f"starts at {s_a} (Eq. 17)",
                    {"channel": c, "read_finish": fin, "actor_start": s_a},
                ))
        for c in g.out_channels(a):
            if (a, c) not in write_tau or (a, c) not in times.write_start:
                continue
            s_w = times.write_start[(a, c)]
            if s_w < s_a + exec_time[a]:
                out.append(Violation(
                    "window_order", a,
                    f"write ({a},{c}) starts at {s_w}, before the actor "
                    f"ends at {s_a + exec_time[a]} (Eq. 18)",
                    {"channel": c, "write_start": s_w, "actor_end": s_a + exec_time[a]},
                ))
        # All tasks of one firing serialize on the actor's core.
        tasks = _actor_tasks(a)
        for i in range(len(tasks)):
            for j in range(i + 1, len(tasks)):
                n1, s1, d1 = tasks[i]
                n2, s2, d2 = tasks[j]
                if _wrapped_overlap(period, s1, d1, s2, d2):
                    out.append(Violation(
                        "window_order", a,
                        f"tasks {n1} and {n2} of actor {a} overlap on its core",
                        {"tasks": [n1, n2]},
                    ))

    # -------------------------------------- resource exclusivity (Eq. 23)
    # Cores: one actor's whole window (hull of its tasks) reserves the core.
    hulls: Dict[str, List[Tuple[str, int, int]]] = {}
    for a in g.actors:
        if not ok_actor[a]:
            continue
        tasks = _actor_tasks(a)
        h0 = min(s for _, s, _ in tasks)
        h1 = max(s + d for _, s, d in tasks)
        if h1 - h0 > period:
            out.append(Violation(
                "period", a,
                f"actor window spans {h1 - h0} > period {period} "
                f"(self-overlap across iterations)",
                {"window": h1 - h0, "period": period},
            ))
            continue
        hulls.setdefault(sched.actor_binding[a], []).append((a, h0, h1 - h0))
    for core, items in hulls.items():
        for i in range(len(items)):
            for j in range(i + 1, len(items)):
                a1, s1, d1 = items[i]
                a2, s2, d2 = items[j]
                if _wrapped_overlap(period, s1, d1, s2, d2):
                    out.append(Violation(
                        "resource_overlap", core,
                        f"windows of actors {a1} and {a2} overlap on core "
                        f"{core} modulo P={period}",
                        {"actors": [a1, a2], "starts": [s1, s2], "durs": [d1, d2]},
                    ))

    # Interconnects: every communication task occupies its whole route.
    link_items: Dict[str, List[Tuple[str, int, int]]] = {}
    for (c, a), tau in read_tau.items():
        if tau <= 0:
            continue
        for h in arch.route_interconnects(sched.actor_binding[a], sched.channel_binding[c]):
            link_items.setdefault(h, []).append(
                (f"read({c},{a})@{a}", times.read_start[(c, a)], tau)
            )
    for (a, c), tau in write_tau.items():
        if tau <= 0:
            continue
        for h in arch.route_interconnects(sched.actor_binding[a], sched.channel_binding[c]):
            link_items.setdefault(h, []).append(
                (f"write({a},{c})@{a}", times.write_start[(a, c)], tau)
            )
    for link, items in link_items.items():
        for i in range(len(items)):
            for j in range(i + 1, len(items)):
                n1, s1, d1 = items[i]
                n2, s2, d2 = items[j]
                if n1.rsplit("@", 1)[1] == n2.rsplit("@", 1)[1]:
                    continue  # same actor: flagged as window_order above
                if _wrapped_overlap(period, s1, d1, s2, d2):
                    out.append(Violation(
                        "resource_overlap", link,
                        f"communication tasks {n1} and {n2} overlap on "
                        f"interconnect {link} modulo P={period}",
                        {"tasks": [n1, n2], "starts": [s1, s2], "durs": [d1, d2]},
                    ))

    # -------------------- dependencies (generalized Eq. 16) and capacities
    mem_usage: Dict[str, int] = {}
    for c, ch in g.channels.items():
        if not ok_channel[c]:
            continue
        prod = g.producer[c]
        if not ok_actor.get(prod):
            continue
        psi = g.prod_rate[(prod, c)]
        fin_w = times.write_start[(prod, c)] + write_tau[(prod, c)]
        fins = []
        # An MRB whose replaced output channels shared a consumer lists that
        # actor once per channel; the schedule (like in_channels/read_tau)
        # has ONE read edge per (channel, actor), so collapse duplicates.
        for r in dict.fromkeys(g.consumers[c]):
            if not ok_actor.get(r):
                continue
            kappa = g.cons_rate[(c, r)]
            s_r = times.read_start[(c, r)]
            fins.append(s_r + read_tau[(c, r)])
            if psi != kappa:
                out.append(Violation(
                    "rate_imbalance", c,
                    f"edge ({c}→{r}) has ψ={psi}, κ={kappa}: one firing per "
                    f"period {'starves the reader' if kappa > psi else 'overflows any finite buffer'}",
                    {"reader": r, "psi": psi, "kappa": kappa},
                ))
                if kappa > psi:
                    continue  # slack decreases forever; no finite bound
            slack = _dependency_slack(psi, kappa, ch.delay)
            if slack is not None and fin_w > s_r + slack * period:
                out.append(Violation(
                    "edge_dependency", c,
                    f"reader {r} starts at {s_r} but the producing write "
                    f"finishes at {fin_w} (> s_r + {slack}·P, Eq. 16 with "
                    f"δ={ch.delay})",
                    {"reader": r, "write_finish": fin_w, "read_start": s_r,
                     "slack_periods": slack, "delay": ch.delay},
                ))
        # Buffer sizing: token lifetime from write start to last read finish.
        if fins:
            needed = ch.delay + (max(fins) - times.write_start[(prod, c)]) // period + 1
            needed = max(needed, 1)
            cap = sched.capacities[c]
            if cap < needed:
                out.append(Violation(
                    "buffer_capacity", c,
                    f"capacity γ={cap} below the {needed} simultaneously "
                    f"live tokens of the modulo schedule",
                    {"capacity": cap, "needed": needed, "delay": ch.delay},
                ))
            mem = sched.channel_binding[c]
            mem_usage[mem] = mem_usage.get(mem, 0) + cap * ch.token_bytes

    # ------------------------------------------------ memory budget (Eq. 8)
    for mem, used in mem_usage.items():
        cap = arch.memories[mem].capacity
        if used > cap:
            out.append(Violation(
                "memory_capacity", mem,
                f"channels bound to {mem} need {used} bytes > W_q={cap}",
                {"used_bytes": used, "capacity_bytes": cap},
            ))

    # -------------------------------- token-machine replay (MRB forwarding)
    if replay:
        for c, ch in g.channels.items():
            if not ok_channel[c] or not ok_actor.get(g.producer[c]):
                continue
            readers = tuple(dict.fromkeys(
                r for r in g.consumers[c] if ok_actor.get(r)
            ))  # one read event per distinct reader (cf. sim._distinct_readers)
            if not readers:
                continue
            prod = g.producer[c]
            if g.prod_rate[(prod, c)] != 1 or any(
                g.cons_rate[(c, r)] != 1 for r in readers
            ):
                continue  # multi-rate edges are judged by the slack check
            cap = max(1, sched.capacities[c])
            v = _replay_token_machine(
                c, readers, cap, ch.delay, period,
                times.write_start[(prod, c)] + write_tau[(prod, c)],
                {r: (times.read_start[(c, r)], read_tau[(c, r)]) for r in readers},
                iterations=cap + ch.delay + 4,
            )
            if v is not None:
                out.append(v)

    return report


def verify_decode_result(
    g: ApplicationGraph,
    arch: ArchitectureGraph,
    result,
    *,
    replay: bool = True,
) -> VerificationReport:
    """Verify any decoder result (``DecodeResult``/``ExactResult``/duck-typed
    ``.feasible``/``.schedule``).  An infeasible result verifies vacuously
    (``feasible=False`` in the report, no violations)."""
    if not getattr(result, "feasible", False) or result.schedule is None:
        return VerificationReport(period=None, violations=[], feasible=False)
    return verify_schedule(g, arch, result.schedule, replay=replay)
