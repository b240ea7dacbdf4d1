"""Memoized, optionally process-parallel genotype evaluation engine.

NSGA-II's elitist μ+λ loop re-visits genotypes constantly (crossover of
similar parents, zero-mutation clones, forced-ξ strategies), and decoding a
genotype — Algorithm 1 + channel binding + CAPS-HMS period search — is the
host half of every evaluation.  This engine factors evaluation out of the
MOEA loop and adds accelerations that all preserve bit-identical Pareto
fronts:

**Content-addressed phenotype-decode cache.**  The decoder's inputs are not
the raw genotype: when ξ(a_m) = 1 the multi-cast actor a_m is *removed*
(its β_A gene is dead) and its member channels collapse into one MRB whose
placement decision comes solely from the alphabetically-first member's C_d
gene (see ``evaluate_genotype``) — the other member genes are dead too.
:func:`decode_key` projects a genotype onto exactly the decoder-visible
alleles, so all genotypes in the same fiber share one decode.  Keys are
hashed (SHA-256 over the canonical projection).  ``cache_mode``:

  * ``"canonical"``  (default) key = decoder-visible projection;
  * ``"exact"``      key = raw genotype;
  * ``"none"``       every request decodes (ablation baseline).

**ξ-graph transform cache.**  The Algorithm-1 substitution (plus pipeline
delays) depends only on the ξ bits; the engine memoizes
``transformed_graph`` per ξ pattern (small LRU) and hands the decoders a
shared read-only graph.

**Batched device simulation.**  With ``sim_period`` among the objectives
and ``sim_backend`` ``"cuda"`` (the default), ``"torch"`` or ``"auto"``,
decodes carry the analytic period as a placeholder and every ξ group of a
batch is then simulated in one call on the engine's device and patched —
one NSGA-II generation is one device call per ξ group.  ``"auto"`` picks
the backend of each ξ group (:func:`resolve_sim_backend`).

**No fallback.**  This is the one deliberate difference from the JAX
package's engine, which catches a failure of its batched simulator, opens
a circuit breaker and degrades the ξ group (and every later one) to the
event simulator.  Here a failure of the batched call — a kernel that does
not build or launch, or a fault fired at the ``engine.sim_batch`` site —
raises out of :meth:`EvaluationEngine.evaluate_batch`.  There is no
breaker and no ``sim_degraded`` count.

**Telemetry.**  Spans and counters carry the JAX package's names:
``engine.transform``, ``engine.decode``, ``engine.sim_patch``, the
``engine.backend_resolved`` event, and the ``engine.cache_hits`` /
``engine.cache_misses`` counters (:mod:`repro_torch.obs`).

**Process-parallel decode.**  ``n_workers > 0`` decodes cache misses of a
batch in a ``ProcessPoolExecutor`` with a ``spawn`` context (the parent may
hold a CUDA context, which a forked child cannot use).  Results are merged
back in input order, so the evolution trajectory is identical to the
serial run.
"""
from __future__ import annotations

import hashlib
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .. import faults, obs
from ..device import resolve_device
from .decoders import get_decoder
from .dse import (
    Genotype,
    GenotypeSpace,
    Individual,
    evaluate_genotype,
    transformed_graph,
)
from .problem import Objective, resolve_objectives

__all__ = [
    "EvaluationEngine",
    "decode_key",
    "resolve_sim_backend",
    "AUTO_MIN_BATCH",
    "CACHE_MODES",
    "SIM_BACKENDS",
]

CACHE_MODES = ("canonical", "exact", "none")

# How the ``sim_period`` objective is computed during evaluation:
#   None / "events"  inline per decode (event-driven reference simulator);
#                    with a non-default sim_config, deferred and run per
#                    phenotype through the event-driven simulator;
#   "cuda"           deferred — decodes carry the analytic period as a
#                    placeholder, then each ξ group is simulated in one
#                    launch of the CUDA kernel (repro_torch.kernels.sim_step)
#                    and patched;
#   "torch"          deferred like "cuda", through the plain batched torch
#                    program on the engine's device;
#   "auto"           deferred; each ξ group picks events / cuda / torch
#                    from its batch size and the engine's device
#                    (resolve_sim_backend); choices are counted in
#                    ``engine.sim_backend_choices`` and surfaced in
#                    ``ExplorationRun.meta``.
# All routes yield identical values (enforced backend parity).
SIM_BACKENDS = (None, "auto", "events", "cuda", "torch")

# "auto" threshold: below AUTO_MIN_BATCH phenotypes a ξ group goes to the
# event simulator.  Set from chip_smoke.py phase 12 (f) on an NVIDIA H100
# 80GB HBM3 at a 700.00 W power limit: the kernel path (lowering, launch
# and copy back included) was faster than the event simulator at every
# batch size from 1 (Sobel 1.70 against 3.32 ms, Multicamera 14.50
# against 492.14 ms at B=1), so every ξ group goes to the kernel.  (The JAX
# package's 4 was measured on a CPU.)  On a CPU engine the plain program
# is far slower than the event simulator at small batches; pass
# sim_backend="events" there.
AUTO_MIN_BATCH = 1


def _task_count(graph) -> int:
    """Structure-size proxy: segments in the simulator's task table (one
    read per in-channel, one write per out-channel, one execute per actor)."""
    return sum(
        len(graph.in_channels(a)) + len(graph.out_channels(a)) + 1
        for a in graph.actors
    )


def resolve_sim_backend(batch_size: int, n_tasks: int, device) -> str:
    """Concrete backend for one ξ group under ``sim_backend="auto"``.

    * groups below ``AUTO_MIN_BATCH`` phenotypes → ``"events"``: one exact
      event-driven run each beats a batched call at that size (on the
      card no group size does, so the threshold is 1);
    * otherwise ``"cuda"`` (the kernel) on a CUDA engine and ``"torch"``
      (the plain batched program) on a CPU engine.

    ``n_tasks`` (:func:`_task_count` of the group's graph) is taken for
    the reference's signature and recorded, but chooses nothing: the JAX
    package's ``AUTO_CPU_MAX_TASKS`` chose between its two JAX programs on
    a CPU (interpreted Pallas kernel or fused lax rounds), and the port has
    one batched program per device, so it has no counterpart here.
    """
    if batch_size < AUTO_MIN_BATCH:
        return "events"
    return "cuda" if torch.device(device).type == "cuda" else "torch"


def _analytic_period_placeholder(ctx) -> float:
    return float(ctx.schedule.period)


# Stands in for the registered ``sim_period`` objective while its real value
# is computed by the batched simulator (module-level so workers pickle it).
_SIM_PERIOD_DEFERRED = Objective(
    "sim_period",
    _analytic_period_placeholder,
    "time units",
    "deferred to the batched simulator (engine sim_backend)",
)

_DEAD = -1  # sentinel for alleles the decoder never reads


def _mc_dead_indices(space: GenotypeSpace) -> List[Tuple[int, List[int]]]:
    """Per multi-cast actor: (its β_A gene index, the C_d gene indices that
    die when it is replaced).  Member ordering matches mrb_channel_name —
    the MRB inherits the alphabetically-first member's decision; the other
    member genes are dead."""
    ch_idx = {c: i for i, c in enumerate(space.channels)}
    a_idx = {a: i for i, a in enumerate(space.actors)}
    out = []
    for a in space.mcast:
        members = sorted(space.g.in_channels(a) + space.g.out_channels(a))
        out.append((a_idx[a], [ch_idx[c] for c in members[1:]]))
    return out


def decode_key(
    space: GenotypeSpace,
    genotype: Genotype,
    dead_map: Optional[List[Tuple[int, List[int]]]] = None,
) -> Tuple:
    """Project a genotype onto its decoder-visible alleles.

    Two genotypes with equal keys produce identical transformed graphs,
    channel decisions, and actor bindings — hence identical phenotypes.
    """
    if dead_map is None:
        dead_map = _mc_dead_indices(space)
    cd = list(genotype.cd)
    ba = [v % len(space.allowed[a]) for a, v in zip(space.actors, genotype.ba)]
    for bit, (ai, ch_is) in zip(genotype.xi, dead_map):
        if not bit:
            continue
        ba[ai] = _DEAD
        for ci in ch_is:
            cd[ci] = _DEAD
    return (genotype.xi, tuple(cd), tuple(ba))


def _digest(key: Tuple) -> str:
    return hashlib.sha256(repr(key).encode()).hexdigest()


# --- process-pool worker plumbing (module level so it pickles) -------------
_WORKER_ARGS: Optional[Tuple] = None
_WORKER_GT: "OrderedDict[Tuple[int, ...], object]" = OrderedDict()  # per-process ξ cache


def _init_worker(
    space, decoder, ilp_budget_s, pipelined, objective_names, defer_sim=False
) -> None:
    global _WORKER_ARGS
    objectives = tuple(
        _SIM_PERIOD_DEFERRED if (defer_sim and name == "sim_period") else name
        for name in objective_names
    )
    _WORKER_ARGS = (space, decoder, ilp_budget_s, pipelined, objectives)
    _WORKER_GT.clear()


def _eval_worker(genotype: Genotype) -> Individual:
    space, decoder, ilp_budget_s, pipelined, objectives = _WORKER_ARGS  # type: ignore[misc]
    gt = _WORKER_GT.get(genotype.xi)
    if gt is None:
        gt = transformed_graph(space, genotype.xi, pipelined)
        _WORKER_GT[genotype.xi] = gt
        if len(_WORKER_GT) > 64:
            _WORKER_GT.popitem(last=False)
    return evaluate_genotype(
        space,
        genotype,
        decoder=decoder,
        ilp_budget_s=ilp_budget_s,
        pipelined=pipelined,
        transformed=gt,
        objectives=objectives,
    )


class EvaluationEngine:
    """Decode cache + batch evaluator bound to one :class:`GenotypeSpace`.

    ``device`` is where the batched simulator runs: ``"cuda"`` (default;
    raises without a Hopper card) or ``"cpu"`` when the caller asks for it.
    A failure of the batched simulator raises (see the module docstring:
    no circuit breaker, no degraded route).
    """

    def __init__(
        self,
        space: GenotypeSpace,
        *,
        decoder: str = "caps_hms",
        ilp_budget_s: float = 3.0,
        pipelined: bool = True,
        cache_mode: str = "canonical",
        max_entries: Optional[int] = None,
        n_workers: int = 0,
        transform_cache: int = 64,
        objectives=None,
        sim_backend: Optional[str] = "cuda",
        sim_config=None,
        device="cuda",
    ) -> None:
        if cache_mode not in CACHE_MODES:
            raise ValueError(f"cache_mode must be one of {CACHE_MODES}")
        if sim_backend not in SIM_BACKENDS:
            raise ValueError(f"sim_backend must be one of {SIM_BACKENDS}")
        get_decoder(decoder)  # fail fast on unknown registry names
        self.device = resolve_device(device)
        self.space = space
        self.decoder = decoder
        self.ilp_budget_s = ilp_budget_s
        self.pipelined = pipelined
        # Ordered objective set (repro_torch.core.problem registry); cached
        # Individuals carry objective vectors in exactly this layout.
        self.objectives = resolve_objectives(objectives)
        self.objective_names = tuple(o.name for o in self.objectives)
        self.sim_backend = sim_backend
        self.sim_config = sim_config
        # Deferred sim: decode with an analytic placeholder, then patch
        # sim_period afterwards — per ξ group through the batched
        # simulator, or per phenotype through the event-driven one.  A
        # non-default sim_config always defers, so the engine's config is
        # honoured on every route (the inline objective can only use the
        # default config).
        self._sim_defer = "sim_period" in self.objective_names and (
            sim_backend in ("auto", "cuda", "torch") or sim_config is not None
        )
        # "auto" resolution counts, per concrete backend chosen (one count
        # per ξ-group patch) — surfaced in ExplorationRun.meta.
        self.sim_backend_choices: Dict[str, int] = {}
        self._decode_objs = tuple(
            _SIM_PERIOD_DEFERRED if (self._sim_defer and o.name == "sim_period") else o
            for o in self.objectives
        )
        self.cache_mode = cache_mode
        self.max_entries = max_entries
        self.n_workers = n_workers
        self.hits = 0
        self.misses = 0
        self.evaluations = 0  # decodes actually performed
        # Wall seconds spent decoding on the host and in the deferred
        # sim_period patch (device call included: results come back to the
        # host before the patch returns).
        self.decode_s = 0.0
        self.sim_s = 0.0
        self._cache: "OrderedDict[str, Individual]" = OrderedDict()
        self._dead_map = _mc_dead_indices(space)
        # ξ → transformed graph; bounded (2^|A_M| patterns exist in theory).
        self._gt_lru: "OrderedDict[Tuple[int, ...], object]" = OrderedDict()
        self._gt_lru_max = transform_cache
        self._pool = None

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def __enter__(self) -> "EvaluationEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _ensure_pool(self):
        if self._pool is None:
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor

            self._pool = ProcessPoolExecutor(
                max_workers=self.n_workers,
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_init_worker,
                initargs=(
                    self.space,
                    self.decoder,
                    self.ilp_budget_s,
                    self.pipelined,
                    self.objective_names,
                    self._sim_defer,
                ),
            )
        return self._pool

    # ----------------------------------------------------------------- core
    def _key(self, genotype: Genotype) -> Optional[str]:
        if self.cache_mode == "none":
            return None
        if self.cache_mode == "exact":
            return _digest((genotype.xi, genotype.cd, genotype.ba))
        return _digest(decode_key(self.space, genotype, self._dead_map))

    def _transformed(self, xi: Tuple[int, ...]):
        if self._gt_lru_max <= 0:
            with obs.span("engine.transform", xi_ones=sum(xi), cached=False):
                return transformed_graph(self.space, xi, self.pipelined)
        gt = self._gt_lru.get(xi)
        if gt is None:
            with obs.span("engine.transform", xi_ones=sum(xi), cached=False):
                gt = transformed_graph(self.space, xi, self.pipelined)
            self._gt_lru[xi] = gt
            if len(self._gt_lru) > self._gt_lru_max:
                self._gt_lru.popitem(last=False)
        else:
            self._gt_lru.move_to_end(xi)
        return gt

    def _decode(self, genotype: Genotype) -> Individual:
        self.evaluations += 1
        t0 = time.perf_counter()
        with obs.span("engine.decode", decoder=self.decoder) as sp:
            ind = evaluate_genotype(
                self.space,
                genotype,
                decoder=self.decoder,
                ilp_budget_s=self.ilp_budget_s,
                pipelined=self.pipelined,
                transformed=self._transformed(genotype.xi),
                objectives=self._decode_objs,
            )
            sp.set(feasible=ind.feasible)
        self.decode_s += time.perf_counter() - t0
        return ind

    def _patch_sim(self, inds: List[Individual]) -> List[Individual]:
        """Replace the deferred ``sim_period`` placeholders with measured
        periods — one batched call per ξ pattern (phenotypes in a ξ fiber
        share their transformed graph) on the engine's device, or
        per-phenotype through the event-driven backend when it was chosen
        (directly, by ``"auto"``, or only to honour a non-default
        ``sim_config``).  Backend parity keeps every route value-identical.
        A failure of a batched call, or a fault fired at
        ``engine.sim_batch``, raises."""
        from ..sim import batch_simulate_periods, simulate_period, simulation_enabled

        if not self._sim_defer or not simulation_enabled():
            return inds
        t0 = time.perf_counter()
        sim_pos = [
            i for i, n in enumerate(self.objective_names) if n == "sim_period"
        ]
        groups: Dict[Tuple[int, ...], List[int]] = {}
        for i, ind in enumerate(inds):
            if ind.feasible and ind.schedule is not None:
                groups.setdefault(ind.genotype.xi, []).append(i)
        out = list(inds)
        for xi, idxs in groups.items():
            gt = self._transformed(xi)
            scheds = [inds[i].schedule for i in idxs]
            backend = self.sim_backend
            if backend == "auto":
                n_tasks = _task_count(gt)
                backend = resolve_sim_backend(len(idxs), n_tasks, self.device)
                self.sim_backend_choices[backend] = (
                    self.sim_backend_choices.get(backend, 0) + 1
                )
                obs.event(
                    "engine.backend_resolved",
                    backend=backend, batch=len(idxs), n_tasks=n_tasks,
                )
            with obs.span(
                "engine.sim_patch", backend=backend, batch=len(idxs),
                xi_ones=sum(xi),
            ):
                if backend in ("cuda", "torch"):
                    faults.fire("engine.sim_batch", backend=backend)
                    periods = batch_simulate_periods(
                        gt, self.space.arch, scheds, self.sim_config,
                        backend=backend, device=self.device,
                    )
                else:
                    periods = [
                        simulate_period(gt, self.space.arch, s, self.sim_config)
                        for s in scheds
                    ]
            for i, p in zip(idxs, periods):
                vec = list(out[i].objectives)
                for j in sim_pos:
                    vec[j] = float(p)
                out[i] = Individual(out[i].genotype, tuple(vec), out[i].schedule)
        self.sim_s += time.perf_counter() - t0
        return out

    def _wrap(self, genotype: Genotype, cached: Individual) -> Individual:
        # A canonical hit may come from a sibling genotype in the same
        # decode fiber: the phenotype is shared, the identity is not.
        if cached.genotype == genotype:
            return cached
        return Individual(genotype, cached.objectives, cached.schedule)

    def _store(self, key: str, ind: Individual) -> None:
        self._cache[key] = ind
        if self.max_entries is not None and len(self._cache) > self.max_entries:
            self._cache.popitem(last=False)  # FIFO eviction; decode is pure

    def evaluate(self, genotype: Genotype) -> Individual:
        key = self._key(genotype)
        if key is None:
            return self._patch_sim([self._decode(genotype)])[0]
        cached = self._cache.get(key)
        if cached is not None:
            self.hits += 1
            obs.counter_add("engine.cache_hits")
            return self._wrap(genotype, cached)
        self.misses += 1
        obs.counter_add("engine.cache_misses")
        ind = self._patch_sim([self._decode(genotype)])[0]
        self._store(key, ind)
        return ind

    def evaluate_batch(self, genotypes: Sequence[Genotype]) -> List[Individual]:
        """Evaluate a batch, memoized, in input order.

        With ``n_workers > 0`` the unique cache misses are decoded in a
        process pool; the merge is order-deterministic, so results are
        independent of worker scheduling.  With ``sim_backend="cuda"``,
        ``"torch"`` or ``"auto"`` the misses' ``sim_period`` values are measured by one
        batched simulation per ξ group after decoding (identical values to
        the inline event-driven route — enforced backend parity).
        """
        if self.n_workers <= 0 and not self._sim_defer:
            return [self.evaluate(gt) for gt in genotypes]

        def decode_many(gts: Sequence[Genotype]) -> List[Individual]:
            if self.n_workers > 0:
                t0 = time.perf_counter()
                pool = self._ensure_pool()
                decoded = list(pool.map(_eval_worker, gts))
                self.evaluations += len(gts)
                self.decode_s += time.perf_counter() - t0
            else:
                decoded = [self._decode(gt) for gt in gts]
            return self._patch_sim(decoded)

        if self.cache_mode == "none":
            return decode_many(genotypes)

        keys = [self._key(gt) for gt in genotypes]
        miss_order: List[str] = []
        miss_geno: Dict[str, Genotype] = {}
        for gt, key in zip(genotypes, keys):
            if key in self._cache or key in miss_geno:
                continue
            miss_order.append(key)
            miss_geno[key] = gt
        if miss_order:
            decoded = decode_many([miss_geno[k] for k in miss_order])
            for key, ind in zip(miss_order, decoded):
                self._store(key, ind)
        out: List[Individual] = []
        fallback = 0
        for gt, key in zip(genotypes, keys):
            cached = self._cache.get(key)
            if cached is None:
                # Evicted within this batch (tiny max_entries): decode inline.
                fallback += 1
                cached = self._patch_sim([self._decode(gt)])[0]
                self._store(key, cached)
            out.append(self._wrap(gt, cached))
        # Hit/miss accounting mirrors the serial path; eviction-fallback
        # decodes are misses, not hits.
        self.misses += len(miss_order) + fallback
        self.hits += len(genotypes) - len(miss_order) - fallback
        obs.counter_add("engine.cache_misses", len(miss_order) + fallback)
        obs.counter_add("engine.cache_hits", len(genotypes) - len(miss_order) - fallback)
        return out

    def clear_cache(self) -> None:
        """Forget every memoized decode (counters and the transformed-graph
        cache are kept): the next lookups decode as on a fresh engine."""
        self._cache.clear()

    # ------------------------------------------------------------ reporting
    def stats(self) -> Dict[str, int]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evaluations": self.evaluations,
            "entries": len(self._cache),
        }
