"""Event-driven reference simulator: self-timed execution with Gantt trace.

Executes the :class:`~repro_torch.sim.model.SimProgram` dynamical system
exactly as specified there (fixpoint sweeps in arbitration order, time
jumping to the next task completion), keeping per-resource trace segments
so a run can be rendered (:mod:`repro_torch.sim.gantt`) and archived as
JSON.

This backend is the semantic reference: the batched simulator
(:mod:`repro_torch.sim.batched`) and its CUDA kernel must produce
bit-identical firing-time sequences on identical phenotypes (asserted by
the parity tests).  It is exact in Python integers, which is why the
batched wrapper routes phenotypes that could overflow int32 here.
"""
from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .. import obs
from ..core.architecture import ArchitectureGraph
from ..core.graph import ApplicationGraph
from ..core.schedule import Schedule
from .model import (
    READ,
    WRITE,
    SimConfig,
    SimProgram,
    fallback_period,
    lower_phenotype,
    measure_period,
)

__all__ = ["Segment", "SimTrace", "SimResult", "simulate", "simulate_period"]

_INF = float("inf")


@dataclass(frozen=True)
class Segment:
    """One occupied interval on one resource."""

    resource: str
    actor: str
    task: str
    iteration: int
    start: int
    end: int


@dataclass
class SimTrace:
    """JSON-serializable execution trace (see README "Simulation subsystem")."""

    app: str
    arch: str
    period: Optional[float]
    deadlocked: bool
    horizon: int
    iterations: int
    segments: List[Segment] = field(default_factory=list)
    fire_times: Dict[str, List[int]] = field(default_factory=dict)
    meta: Dict[str, Any] = field(default_factory=dict)

    def resources(self) -> List[str]:
        seen: List[str] = []
        for s in self.segments:
            if s.resource not in seen:
                seen.append(s.resource)
        return seen

    # ----------------------------------------------------------- serialize
    def to_json(self) -> Dict[str, Any]:
        return {
            "app": self.app,
            "arch": self.arch,
            "period": self.period,
            "deadlocked": self.deadlocked,
            "horizon": self.horizon,
            "iterations": self.iterations,
            "segments": [asdict(s) for s in self.segments],
            "fire_times": {a: list(ts) for a, ts in self.fire_times.items()},
            "meta": dict(self.meta),
        }

    @classmethod
    def from_json(cls, d: Any) -> "SimTrace":
        if isinstance(d, str):
            d = json.loads(d)
        return cls(
            app=d["app"],
            arch=d["arch"],
            period=d.get("period"),
            deadlocked=d.get("deadlocked", False),
            horizon=d.get("horizon", 0),
            iterations=d.get("iterations", 0),
            segments=[Segment(**s) for s in d.get("segments", [])],
            fire_times={a: list(ts) for a, ts in d.get("fire_times", {}).items()},
            meta=dict(d.get("meta", {})),
        )

    def save(self, path: Optional[str] = None, *, out_dir: str = "runs/sim") -> str:
        if path is None:
            path = os.path.join(out_dir, f"trace_{self.app}_{self.horizon}.json")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
        return path

    @classmethod
    def load(cls, path: str) -> "SimTrace":
        with open(path) as f:
            return cls.from_json(json.load(f))


@dataclass
class SimResult:
    """Outcome of one self-timed simulation."""

    period: float                       # measured steady-state period (inf on deadlock)
    converged: bool
    deadlocked: bool
    iterations: int                     # firings simulated per actor
    horizon: int                        # last event time
    fire_times: Dict[str, List[int]]
    trace: Optional[SimTrace] = None


class _ChannelState:
    """Paper-exact MRB index machine over integer reader slots (a FIFO is
    the single-reader case).  δ initial tokens pre-load every reader's view."""

    __slots__ = ("gamma", "n", "omega", "rho")

    def __init__(self, gamma: int, n_readers: int, delay: int) -> None:
        self.gamma = gamma
        self.n = n_readers
        self.omega = delay % gamma
        self.rho = [0 if delay > 0 else -1] * n_readers

    def available(self, slot: int) -> int:
        rho = self.rho[slot]
        if rho == -1:
            return 0
        return ((self.omega - rho - 1) % self.gamma) + 1

    def free(self) -> int:
        return self.gamma - max(self.available(i) for i in range(self.n))

    def read(self, slot: int) -> None:
        if self.available(slot) == 1:
            self.rho[slot] = -1
        else:
            self.rho[slot] = (self.rho[slot] + 1) % self.gamma

    def write(self) -> None:
        for i in range(self.n):
            if self.rho[i] == -1:
                self.rho[i] = self.omega
        self.omega = (self.omega + 1) % self.gamma


class _ActorState:
    __slots__ = ("in_window", "running", "busy_until", "cur", "iters", "window_start")

    def __init__(self) -> None:
        self.in_window = False
        self.running = False
        self.busy_until = 0
        self.cur = 0
        self.iters = 0
        self.window_start = 0


def _run(prog: SimProgram, total_iters: int, cfg: SimConfig) -> SimResult:
    actors = prog.actors
    chan_state = {
        c: _ChannelState(prog.capacity[c], len(prog.readers[c]), prog.delay[c])
        for c in prog.channels
    }
    astate = {a: _ActorState() for a in actors}
    core_owner: Dict[str, Optional[str]] = {prog.core_of[a]: None for a in actors}
    ic_busy: Dict[str, int] = {h: 0 for h in prog.arch.interconnects}
    active: Dict[str, int] = {c: 0 for c in prog.channels}
    fire_times: Dict[str, List[int]] = {a: [] for a in actors}
    segments: List[Segment] = []
    in_edges = {
        a: [(t.channel, t.reader_slot) for t in prog.tasks[a] if t.kind == READ]
        for a in actors
    }
    out_edges = {
        a: [t.channel for t in prog.tasks[a] if t.kind == WRITE] for a in actors
    }
    route_sets = {
        a: [frozenset(t.route) for t in prog.tasks[a]] for a in actors
    }
    ports = cfg.mrb_ports

    def apply_effect(a: str, task) -> None:
        if task.kind == READ:
            chan_state[task.channel].read(task.reader_slot)
        elif task.kind == WRITE:
            chan_state[task.channel].write()
        st = astate[a]
        st.cur += 1
        if st.cur == len(prog.tasks[a]):
            core_owner[prog.core_of[a]] = None
            st.in_window = False
            st.iters += 1

    t = 0
    deadlocked = False
    while True:
        # Synchronous phased rounds at time t until quiescence (the round
        # discipline is normative — see the model docstring).
        while True:
            progressed = False
            # -- completion phase: capture due tasks once, then apply all
            # read effects before all write effects (each group order-free).
            due = [
                (a, prog.tasks[a][astate[a].cur])
                for a in actors
                if astate[a].running and astate[a].busy_until <= t
            ]
            for a, task in due:
                astate[a].running = False
                if task.channel is not None and task.duration > 0:
                    active[task.channel] -= 1
            for a, task in due:
                if task.kind == READ:
                    apply_effect(a, task)
            for a, task in due:
                if task.kind != READ:
                    apply_effect(a, task)
            progressed = bool(due)
            # -- start phase: window starts first (arbitrated per core) so
            # the winners' first tasks compete in this round's candidates.
            core_win: Dict[str, str] = {}
            for a in actors:
                st = astate[a]
                if st.in_window or st.iters >= total_iters:
                    continue
                if core_owner[prog.core_of[a]] is not None:
                    continue
                if any(chan_state[c].available(s) < 1 for c, s in in_edges[a]):
                    continue
                if any(chan_state[c].free() < 1 for c in out_edges[a]):
                    continue
                p = prog.core_of[a]
                if p not in core_win:  # actor order = priority order
                    core_win[p] = a
            for p, a in core_win.items():
                st = astate[a]
                core_owner[p] = a
                st.in_window = True
                st.cur = 0
                st.window_start = t
                fire_times[a].append(t)
                progressed = True
            task_cands = []
            for a in actors:
                st = astate[a]
                if not st.in_window or st.running:
                    continue
                task = prog.tasks[a][st.cur]
                if (
                    task.kind == READ
                    and chan_state[task.channel].available(task.reader_slot) < 1
                ):
                    continue
                if task.kind == WRITE and chan_state[task.channel].free() < 1:
                    continue
                if any(ic_busy[h] > t for h in task.route):
                    continue
                task_cands.append((a, task, route_sets[a][st.cur]))
            # Port slots go to the highest-ranked timed candidates …
            port_blocked = set()
            if ports is not None:
                rank: Dict[str, int] = {}
                for a, task, _ in task_cands:
                    if task.channel is None or task.duration == 0:
                        continue
                    r = rank.get(task.channel, 0)
                    rank[task.channel] = r + 1
                    if active[task.channel] + r >= ports:
                        port_blocked.add(a)
            # … and a timed start is deferred (to the next round, same t)
            # when a higher-priority surviving timed candidate shares an
            # interconnect.  The top candidate always proceeds: progress.
            winners = []
            for i, (a, task, route) in enumerate(task_cands):
                if a in port_blocked:
                    continue
                blocked = any(
                    tb.duration > 0 and b not in port_blocked and (rb & route)
                    for b, tb, rb in task_cands[:i]
                )
                if not blocked:
                    winners.append((a, task))
            # -- apply: zero-duration effects (reads before writes), then
            # timed occupations — all disjoint.
            for kind in (READ, None):
                for a, task in winners:
                    if task.duration == 0 and (task.kind == READ) == (kind == READ):
                        apply_effect(a, task)
                        progressed = True
            for a, task in winners:
                if task.duration == 0:
                    continue
                for h in task.route:
                    ic_busy[h] = t + task.duration
                if task.channel is not None:
                    active[task.channel] += 1
                if cfg.trace:
                    it = astate[a].iters
                    segments.append(
                        Segment(prog.core_of[a], a, task.label, it, t, t + task.duration)
                    )
                    for h in task.route:
                        segments.append(
                            Segment(h, a, task.label, it, t, t + task.duration)
                        )
                st = astate[a]
                st.running = True
                st.busy_until = t + task.duration
                progressed = True
            if not progressed:
                break
            # Early quiescence: a round whose winners were all timed and
            # whose candidates all won cannot have enabled anything new at
            # this instant (timed starts only consume resources; every
            # token/core effect this round fed the candidate computation
            # above), so the extra confirming round is skipped.
            if len(winners) == len(task_cands) and all(
                task.duration > 0 for _, task in winners
            ):
                break
        if all(astate[a].iters >= total_iters for a in actors):
            break
        pending = [astate[a].busy_until for a in actors if astate[a].running]
        if not pending:
            deadlocked = True
            break
        t = min(pending)

    period = None if deadlocked else measure_period(
        fire_times, max_multiplicity=cfg.max_multiplicity, checks=cfg.checks
    )
    trace = None
    if cfg.trace:
        trace = SimTrace(
            app=prog.graph.name,
            arch=prog.arch.name,
            period=_INF if deadlocked else period,
            deadlocked=deadlocked,
            horizon=t,
            iterations=total_iters,
            segments=segments,
            fire_times=fire_times,
            meta={
                "analytic_period": prog.schedule.period,
                "mrb_ports": cfg.mrb_ports,
            },
        )
    return SimResult(
        period=_INF if deadlocked else (period if period is not None else _INF),
        converged=period is not None,
        deadlocked=deadlocked,
        iterations=total_iters,
        horizon=t,
        fire_times=fire_times,
        trace=trace,
    )


def simulate(
    g: ApplicationGraph,
    arch: ArchitectureGraph,
    sched: Schedule,
    config: Optional[SimConfig] = None,
) -> SimResult:
    """Self-timed execution of a decoded phenotype (event-driven backend).

    Runs ``config.iterations`` firings per actor and measures the
    steady-state period from the tail; when the tail is not yet periodic
    the horizon is doubled (up to ``config.max_iterations``) and the run
    repeated — the system is deterministic, so this is a pure extension.
    A deadlock (possible only for phenotypes whose self-timed execution
    cannot sustain the schedule's capacities) yields ``period == inf``.
    """
    cfg = config or SimConfig()
    with obs.span("sim.events", actors=len(g.actors)) as sp:
        prog = lower_phenotype(g, arch, sched)
        iters = max(2, cfg.iterations)
        while True:
            res = _run(prog, iters, cfg)
            if res.deadlocked or res.converged or iters >= cfg.max_iterations:
                if not res.converged and not res.deadlocked:
                    res.period = fallback_period(res.fire_times)
                sp.set(
                    iterations=iters,
                    converged=res.converged,
                    deadlocked=res.deadlocked,
                )
                return res
            iters = min(cfg.max_iterations, iters * 2)


def simulate_period(
    g: ApplicationGraph,
    arch: ArchitectureGraph,
    sched: Schedule,
    config: Optional[SimConfig] = None,
) -> float:
    """Measured steady-state period of the phenotype (no trace kept)."""
    from dataclasses import replace

    cfg = config or SimConfig()
    if cfg.trace:
        cfg = replace(cfg, trace=False)
    return simulate(g, arch, sched, cfg).period
