"""Set-up, the measured window, and what the timed path produced.

The window drives the program's public entry, as a campaign cell does::

    get_explorer(mix["explorer"], **mix["params"]).explore(
        problem, engine=problem.make_engine(sim_backend=..., device=...),
        on_generation=...)

with ``generations`` unbounded and ``time_budget_s`` the run's seconds.
Each generation ends after ranking and the archive fold have read the
device, so the host clock at ``on_generation`` marks finished work.  The
window runs from the end of generation 0 to the end of the last generation
that ends inside the budget.

Set-up warms exactly the cell's shapes: one explore of one generation
(initial population, offspring batch, merged ranking) on a second explorer
with the same parameters and seed.  Its closing re-evaluation of the
survivors through the engine, host decode that warms nothing the window
runs, is skipped by handing it an engine whose ``evaluate_batch`` returns
nothing.  What set-up made (imports, the warm-up) is frozen out of the
garbage collector's full passes for the window, so that such a pass over
torch's modules (about 0.1 s) does not land in it at random.

:class:`Observer` keeps references to what the timed path produced in a
sample of generations drawn from the seed, through the measured
explorer's ``_step`` (the seam of its ``evo.execute`` spans) and
``on_generation``; nothing is read back inside the window.
"""
from __future__ import annotations

import gc
import random
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["build_problem", "Observer", "Window", "run_window"]

# Generations of the window whose outputs the check compares.
KEEP_GENERATIONS = 4


def build_problem(cell):
    """The program's problem, built from the configuration through the
    program's public graph and architecture API."""
    from repro_torch.core import ApplicationGraph, ArchitectureGraph, ExplorationProblem

    app = cell.config["application"]
    g = ApplicationGraph(app["name"])
    for a in app["actors"]:
        g.add_actor(a["name"], a["exec_times"], multicast=a["multicast"])
    for c in app["channels"]:
        g.add_channel(c["name"], c["src"], c["dsts"], delay=c["delay"],
                      capacity=c["capacity"], token_bytes=c["token_bytes"])
    g.validate()
    spec = cell.config["architecture"]
    arch = ArchitectureGraph(spec["name"])
    for tile in spec["tiles"]:
        arch.add_tile(tile["name"], tile["core_types"],
                      core_local_capacity=spec["core_local_bytes"],
                      tile_local_capacity=spec["tile_local_bytes"],
                      crossbar_bandwidth=spec["crossbar_bytes_per_unit"])
    arch.set_global(capacity=spec["global_bytes"], noc_bandwidth=spec["noc_bytes_per_unit"])
    arch.set_core_costs(spec["core_costs"])
    return ExplorationProblem(graph=g, arch=arch, objectives=tuple(cell.mix["objectives"]),
                              strategy=cell.mix["strategy"], pipelined=cell.config["pipelined"])


class Observer:
    """References to the timed path's outputs in a seeded sample of
    generations (reservoir of :data:`KEEP_GENERATIONS`).

    It sees them through two seams of the explorer: the instance's
    ``_step(key, kind, dev, fn, *args)``, through which every device step
    runs (the same seam the program's ``evo.execute`` spans of kind
    ``vary``, ``eval`` and ``rank`` come from, which the per-layer metrics
    read), and the public ``on_generation(gen, run)`` with the archive's
    history.  Per generation it records:

    * ``vary``: the parent population's genes and objectives, and the
      offspring genes;
    * ``eval``: every evaluation's genes and objectives (those before any
      ``vary`` are the initial population's);
    * ``rank``: the merged objectives and their truncation order;
    * the archive before and after the generation (``run.history``);
    * ``next``: the next generation's parents, the population this one
      handed on (when a later generation ran).

    Nothing is copied or read back inside the window.
    """

    KINDS = ("vary", "eval", "rank")

    def __init__(self, seed: int, keep: int = KEEP_GENERATIONS):
        self.rng = random.Random(seed)
        self.keep = keep
        self.cur: Dict[str, Any] = {"evals": []}
        self.kept: List[tuple] = []
        self.seen = 0                   # complete records of generations >= 1
        self.generations = 0            # generations >= 1 that ended
        self.first: List[tuple] = []    # the initial population's (genes, objectives) batches
        self.calls = dict.fromkeys(self.KINDS, 0)
        self._pending: Optional[dict] = None   # the last record, awaiting its "next"

    def attach(self, explorer) -> None:
        """Observe every step of ``explorer`` (this instance only)."""
        step = explorer._step

        def observed(key, kind, dev, fn, *args):
            out = step(key, kind, dev, fn, *args)
            self._record(kind, args, out)
            return out
        explorer._step = observed

    def _record(self, kind: str, args: tuple, out) -> None:
        if kind not in self.calls:
            return
        self.calls[kind] += 1
        if kind == "eval":
            if self.calls["vary"] == 0:
                self.first.append((args[0], out))
            else:
                self.cur["evals"].append((args[0], out))
        elif kind == "vary":
            self.cur["parents"] = args[:2]
            self.cur["child"] = out
            if self._pending is not None:
                self._pending["next"] = args[:2]
                self._pending = None
        else:
            self.cur["merged"] = args[0]
            self.cur["order"] = out

    def end_generation(self, gen: int, run) -> None:
        rec, self.cur = self.cur, {"evals": []}
        if len(run.history) >= 2:
            rec["archive"] = (run.history[-2], run.history[-1])
        self._pending = None
        if gen < 1:
            return
        self.generations += 1
        if any(k not in rec for k in ("parents", "merged", "order", "archive")) \
                or not rec["evals"]:
            return
        i, self.seen = self.seen, self.seen + 1
        if len(self.kept) < self.keep:
            self.kept.append((gen, rec))
        else:
            j = self.rng.randrange(i + 1)
            if j >= self.keep:
                return
            self.kept[j] = (gen, rec)
        self._pending = rec

    def to_host(self) -> dict:
        """The kept outputs as NumPy arrays; drops the device references."""
        def h(x):
            return x.detach().cpu().numpy()

        gens = []
        for gen, rec in sorted(self.kept, key=lambda x: x[0]):
            P, FP = rec["parents"]
            prev, after = rec["archive"]
            gens.append(dict(
                gen=gen, parents=h(P), parents_F=h(FP), child=h(rec["child"]),
                evals=[(h(g), h(f)) for g, f in rec["evals"]],
                merged=h(rec["merged"]), order=h(rec["order"]),
                archive_before=np.array(prev, np.float64).reshape(len(prev), -1),
                archive=np.array(after, np.float64).reshape(len(after), -1),
                next=None if "next" not in rec else tuple(h(x) for x in rec["next"]),
            ))
        first = [(h(g), h(f)) for g, f in self.first]
        expected = min(self.keep, self.generations)
        self.kept, self.first, self.cur, self._pending = [], [], {"evals": []}, None
        return dict(generations=gens, first=first, expected=expected, calls=dict(self.calls))


class _NoClosing:
    """The engine as the warm-up sees it: all of it but the closing
    re-evaluation."""

    def __init__(self, engine):
        self._engine = engine

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def evaluate_batch(self, genotypes):
        return []


@dataclass
class Window:
    ends: List[float]               # perf_counter at the end of each generation
    t_budget: float                 # perf_counter when the budget started
    seconds: float
    closing_s: float                # after the last generation: closing re-evaluation
    candidates: int                 # genotypes the closing re-evaluation scored
    archive: List[int] = field(default_factory=list)   # archive size after each generation
    outputs: dict = field(default_factory=dict)
    memory_peak: int = 0

    @property
    def in_window(self) -> List[float]:
        """End times of generation 0 and of every later generation that
        ended inside the budget."""
        limit = self.t_budget + self.seconds
        return [t for i, t in enumerate(self.ends) if i == 0 or t <= limit]

    def gen_seconds(self) -> List[float]:
        e = self.in_window
        return [b - a for a, b in zip(e, e[1:])]


def make_explorer(cell, seed: int, generations: int, seconds: Optional[float]):
    from repro_torch.core import get_explorer

    return get_explorer(cell.mix["explorer"], generations=generations, seed=seed,
                        time_budget_s=seconds, **cell.mix["params"])


def run_window(cell, problem, engine, seed: int, seconds: float, tracer=None) -> Window:
    """Warm up, then run the measured explore with the observer in place
    (and ``tracer``'s spans and profiler stretch in a traced run)."""
    import torch

    def warm_up():
        make_explorer(cell, seed, 1, None).explore(problem, engine=_NoClosing(engine))
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)

    warm_up()
    if tracer:
        tracer.warm(engine.device)
    observer = Observer(seed)
    ends: List[float] = []
    archive: List[int] = []

    def on_gen(gen, run):
        t = time.perf_counter()
        ends.append(t)
        archive.append(len(run.history[-1]))
        observer.end_generation(gen, run)
        if tracer:
            tracer.on_generation(gen, t)

    explorer = make_explorer(cell, seed, 10**9, seconds)
    observer.attach(explorer)
    gc.collect()
    gc.freeze()
    try:
        if tracer:
            tracer.begin()
        t_budget = time.perf_counter()
        run = explorer.explore(problem, engine=engine, on_generation=on_gen)
        t_done = time.perf_counter()
    finally:
        gc.unfreeze()
        if tracer:
            tracer.end()
    peak = torch.cuda.max_memory_allocated(engine.device) if engine.device.type == "cuda" else 0
    w = Window(ends=ends, t_budget=t_budget, seconds=seconds,
               closing_s=t_done - (ends[-1] if ends else t_budget),
               candidates=int(run.meta.get("relaxed_final_candidates", 0)),
               archive=archive, memory_peak=int(peak))
    w.outputs = observer.to_host()
    return w
