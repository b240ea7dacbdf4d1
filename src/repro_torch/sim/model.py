"""Shared self-timed execution model: phenotype → dense task program.

Both simulator backends (:mod:`repro_torch.sim.events`,
:mod:`repro_torch.sim.batched`) execute exactly the same dynamical system;
this module is its normative definition.  A decoded phenotype (transformed graph g̃_A + architecture +
:class:`~repro_torch.core.schedule.Schedule`) lowers to a :class:`SimProgram`:

* actors, in fixed *arbitration order* (descending topological priority,
  name as tie-break — the same priority CAPS-HMS schedules by);
* per actor, the packed task list of one firing — reads in
  ``g.in_channels(a)`` order, then execute, then writes in
  ``g.out_channels(a)`` order, mirroring the analytic actor window
  τ'_a = τ_EI + τ_a + τ_EO (paper §IV);
* per task, its duration (Eq. 11 comm time / τ(a, ϑ)) and the
  interconnects its route occupies;
* per channel, the schedule's (possibly enlarged) capacity γ, the initial
  tokens δ, and the reader list — every channel is executed with the exact
  MRB index semantics of :class:`~repro_torch.core.mrb.MRBState` (a FIFO is the
  single-reader special case).

Self-timed firing rule (the one all backends implement):

1. an actor *starts a firing* when its bound core is free, every input
   channel has ≥ 1 token available from its read view, and every output
   channel has ≥ 1 free place (the bounded-buffer dataflow enabling rule;
   since each channel has a single writer, the place cannot vanish before
   the write, so a started window never blocks on space — which makes the
   execution provably deadlock-free); the core is then held for the whole
   window;
2. tasks of the window run sequentially; a read/write task additionally
   waits (stalling, core held) until every interconnect on its route is
   free — contention is resolved greedily in arbitration order — and a
   write re-checks the free place (F(c_m) ≥ 1, guaranteed by rule 1);
3. token effects apply at task *completion* (write deposits, read
   advances ρ), matching the dependency conditions Eqs. 16-18.

At any instant, transitions are applied in *synchronous phased rounds*
repeated until quiescence (PR 4 revised this discipline from sequential
per-actor sweeps so a round is data-parallel over the actors — the
throughput basis of the batched backends):

* **completion phase** — every running task whose end time has arrived
  completes; within the phase all read effects apply before all write
  effects (reads touch only their own ρ view and writes only their own
  channel, so each group is order-free);
* **start phase** — window starts (rule 1) are computed from the
  post-completion state and arbitrated first: per core the
  highest-priority candidate wins and opens its window immediately, so
  its first task competes in this very round.  Task-start candidates
  (rule 2, all resource checks against the current state) are then
  arbitrated by scheduler priority: with ``mrb_ports`` set, the
  per-channel port slots go to the highest-ranked timed candidates; a
  task start is deferred to the next round if any higher-priority
  non-port-blocked timed candidate shares an interconnect with it (a
  conservative rule — the top-priority candidate always proceeds, so
  every non-quiescent round makes progress, and deferred candidates
  retry at the same instant).  Winners apply together: zero-duration
  tasks take effect inline (reads before writes again), timed tasks
  occupy their core/route until ``t + duration``.

When a round changes nothing the instant is quiescent and time jumps to
the next task completion.  The round discipline is part of the semantics
— backend equality (asserted by the parity tests) depends on it.

:func:`measure_period` recovers the steady-state iteration interval from
the firing trace: the execution of this deterministic integer-timed system
is eventually periodic, possibly with multiplicity R > 1 (R firings per
regime period D), so the measured period is the rational D / R.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.architecture import ArchitectureGraph
from ..core.graph import ApplicationGraph, topological_priorities
from ..core.schedule import (
    Schedule,
    actor_exec_time,
    comm_times,
    window_task_layout,
)

__all__ = [
    "SimConfig",
    "TaskSpec",
    "SimProgram",
    "lower_phenotype",
    "measure_period",
    "fallback_period",
    "contention_free",
    "predict_horizon",
]

READ, EXEC, WRITE = 0, 1, 2
KIND_NAMES = {READ: "read", EXEC: "exec", WRITE: "write"}


@dataclass(frozen=True)
class SimConfig:
    """Knobs shared by both backends.

    ``iterations`` is the number of firings simulated per actor before the
    period is measured from the tail; when the tail is not yet periodic the
    driver doubles it up to ``max_iterations`` (deterministic re-run).
    ``mrb_ports`` optionally bounds the number of *concurrent* timed
    accesses (reads + the write) to one channel — ``None`` reproduces the
    paper's uncontended-memory model and is required for analytic parity.
    """

    iterations: int = 16
    max_iterations: int = 128
    mrb_ports: Optional[int] = None
    # Contended regimes can settle on cycles of many firings (observed
    # R = 9 on generated split-join scenarios), so the multiplicity search
    # bound is comfortably above anything seen in the sweeps.
    max_multiplicity: int = 16
    checks: int = 3
    trace: bool = True


@dataclass(frozen=True)
class TaskSpec:
    """One task of an actor's firing window."""

    kind: int                 # READ | EXEC | WRITE
    channel: Optional[str]    # None for EXEC
    duration: int
    route: Tuple[str, ...]    # interconnects occupied (empty ⇒ local)
    reader_slot: int = -1     # index into the channel's reader list (reads)

    @property
    def label(self) -> str:
        base = KIND_NAMES[self.kind]
        return base if self.channel is None else f"{base} {self.channel}"


@dataclass
class SimProgram:
    """A phenotype lowered to the dense form both backends execute."""

    graph: ApplicationGraph
    arch: ArchitectureGraph
    schedule: Schedule
    actors: List[str]                      # arbitration order
    core_of: Dict[str, str]
    tasks: Dict[str, List[TaskSpec]]
    channels: List[str]                    # sorted
    capacity: Dict[str, int]               # schedule γ (≥ declared)
    delay: Dict[str, int]
    readers: Dict[str, List[str]]

    def total_tasks(self) -> int:
        return sum(len(ts) for ts in self.tasks.values())

    def window_duration(self, a: str) -> int:
        return sum(t.duration for t in self.tasks[a])


def _distinct_readers(readers: Sequence[str]) -> List[str]:
    # An MRB created from a multi-cast actor whose output channels shared a
    # consumer lists that actor once per replaced channel; the analytic
    # model (in_channels / read_tau) collapses this to ONE read edge per
    # (channel, actor), so the simulator keeps one ρ_r view per *distinct*
    # reader — a phantom never-read slot would wedge F(c_m) at 0.
    out: List[str] = []
    for r in readers:
        if r not in out:
            out.append(r)
    return out


_GRAPH_MEMO: "weakref.WeakKeyDictionary" = None  # type: ignore[assignment]


def _graph_order_readers(g: ApplicationGraph):
    """Arbitration order + distinct-reader lists are graph-only; memoize
    them per graph object so batch lowering doesn't redo the topological
    sort for every phenotype of a shared ξ-transformed graph."""
    global _GRAPH_MEMO
    if _GRAPH_MEMO is None:
        import weakref

        _GRAPH_MEMO = weakref.WeakKeyDictionary()
    hit = _GRAPH_MEMO.get(g)
    if hit is None:
        prio = topological_priorities(g)
        order = sorted(g.actors, key=lambda a: (-prio[a], a))
        readers = {c: _distinct_readers(g.consumers[c]) for c in g.channels}
        hit = (order, readers)
        _GRAPH_MEMO[g] = hit
    return hit


def lower_phenotype(
    g: ApplicationGraph, arch: ArchitectureGraph, sched: Schedule
) -> SimProgram:
    """Lower a decoded phenotype to a :class:`SimProgram`."""
    read_tau, write_tau = comm_times(g, arch, sched.actor_binding, sched.channel_binding)
    order, readers = _graph_order_readers(g)
    tasks: Dict[str, List[TaskSpec]] = {}
    for a in order:
        core = sched.actor_binding[a]
        specs: List[TaskSpec] = []
        for kind, c, dur in window_task_layout(
            g, a, actor_exec_time(g, arch, sched.actor_binding, a), read_tau, write_tau
        ):
            if kind == "exec":
                specs.append(TaskSpec(EXEC, None, dur, ()))
            else:
                route = tuple(
                    arch.route_interconnects(core, sched.channel_binding[c])
                )
                slot = readers[c].index(a) if kind == "read" else -1
                specs.append(
                    TaskSpec(READ if kind == "read" else WRITE, c, dur, route, slot)
                )
        tasks[a] = specs
    return SimProgram(
        graph=g,
        arch=arch,
        schedule=sched,
        actors=order,
        core_of={a: sched.actor_binding[a] for a in g.actors},
        tasks=tasks,
        channels=sorted(g.channels),
        capacity={c: sched.capacities.get(c, g.channels[c].capacity) for c in g.channels},
        delay={c: g.channels[c].delay for c in g.channels},
        readers=readers,
    )


def measure_period(
    fire_times: Dict[str, Sequence[int]],
    *,
    max_multiplicity: int = 8,
    checks: int = 3,
    drain_guard: Optional[int] = None,
) -> Optional[float]:
    """Steady-state period from per-actor firing times, or None.

    Per actor, searches the smallest multiplicity R ≤ ``max_multiplicity``
    such that the last ``checks`` R-strided intervals are one constant D;
    the actor's steady rate is then the rational D / R.  The application's
    iteration interval is the *maximum* over actors — weakly-connected
    components of a disconnected graph settle at independent rates, and
    the slowest one bounds the app.  Returns None until every actor's tail
    is periodic.

    The simulation stops every actor after the same firing count, so the
    *end* of each sequence reflects a draining pipeline (upstream actors
    already stopped), not the steady state; the last ``drain_guard``
    firings (default: a quarter of the sequence) are therefore excluded
    before matching.
    """
    worst: Optional[float] = None
    for ts in fire_times.values():
        guard = drain_guard if drain_guard is not None else max(2, len(ts) // 4)
        ts = ts[: max(0, len(ts) - guard)]
        rate: Optional[float] = None
        for mult in range(1, max_multiplicity + 1):
            if len(ts) < mult * checks + 1:
                break
            d = ts[-1] - ts[-1 - mult]
            if all(
                ts[-1 - (j - 1) * mult] - ts[-1 - j * mult] == d
                for j in range(2, checks + 1)
            ):
                rate = d / mult
                break
        if rate is None:
            return None
        if worst is None or rate > worst:
            worst = rate
    return worst


def fallback_period(fire_times: Dict[str, Sequence[int]]) -> float:
    """Best-effort estimate when the tail never became periodic within the
    horizon budget: the largest per-actor mean interval over the second
    half of the firing sequence.  Both backends share this code path so
    unconverged results are still backend-identical."""
    tail: List[float] = []
    for ts in fire_times.values():
        if len(ts) >= 2:
            mid = len(ts) // 2
            tail.append((ts[-1] - ts[mid]) / max(1, len(ts) - 1 - mid))
    return max(tail) if tail else float("inf")


def predict_horizon(prog: SimProgram, cfg: SimConfig) -> float:
    """Analytic prediction of the final event time of a full
    ``max_iterations`` run: the schedule's steady-state period times the
    firing budget plus pipeline-fill slack.  Contention can push the real
    horizon past this, so fixed-width backends must post-check their
    measured horizon too — the prediction only gates the cheap pre-pass
    (see ``INT32_SAFE_HORIZON`` in :mod:`repro_torch.sim.batched`)."""
    return prog.schedule.period * (cfg.max_iterations + 4)


def contention_free(
    g: ApplicationGraph, arch: ArchitectureGraph, sched: Schedule
) -> bool:
    """True iff no schedulable resource is occupied by tasks of more than
    one actor's window.

    Under this condition greedy self-timed arbitration has nothing to
    arbitrate: every resource serializes a single actor's (already
    sequential) tasks, so ASAP execution is monotone and its steady-state
    period provably equals both the analytic CAPS-HMS period and the
    resource lower bound — the parity invariant the tests assert.
    """
    read_tau, write_tau = comm_times(g, arch, sched.actor_binding, sched.channel_binding)
    owners: Dict[str, set] = {}
    for a in g.actors:
        owners.setdefault(sched.actor_binding[a], set()).add(a)
    for (c, a), tau in read_tau.items():
        if tau <= 0:
            continue
        for h in arch.route_interconnects(sched.actor_binding[a], sched.channel_binding[c]):
            owners.setdefault(h, set()).add(a)
    for (a, c), tau in write_tau.items():
        if tau <= 0:
            continue
        for h in arch.route_interconnects(sched.actor_binding[a], sched.channel_binding[c]):
            owners.setdefault(h, set()).add(a)
    return all(len(v) <= 1 for v in owners.values())
