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
and ``sim_backend`` ``"cuda"`` (the default) or ``"torch"``, decodes carry
the analytic period as a placeholder and every ξ group of a batch is then
simulated in one call on the engine's device and patched — one NSGA-II
generation is one device call per ξ group.  A failure of that call raises:
there is no silent fallback to another backend.

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
#                    program on the engine's device.
# All routes yield identical values (enforced backend parity).
SIM_BACKENDS = (None, "events", "cuda", "torch")


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
            sim_backend in ("cuda", "torch") or sim_config is not None
        )
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
            return transformed_graph(self.space, xi, self.pipelined)
        gt = self._gt_lru.get(xi)
        if gt is None:
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
        ind = evaluate_genotype(
            self.space,
            genotype,
            decoder=self.decoder,
            ilp_budget_s=self.ilp_budget_s,
            pipelined=self.pipelined,
            transformed=self._transformed(genotype.xi),
            objectives=self._decode_objs,
        )
        self.decode_s += time.perf_counter() - t0
        return ind

    def _patch_sim(self, inds: List[Individual]) -> List[Individual]:
        """Replace the deferred ``sim_period`` placeholders with measured
        periods — one batched call per ξ pattern (phenotypes in a ξ fiber
        share their transformed graph) on the engine's device, or
        per-phenotype through the event-driven backend when it was chosen
        only to honour a non-default ``sim_config``.  Backend parity keeps
        every route value-identical."""
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
            if self.sim_backend in ("cuda", "torch"):
                periods = batch_simulate_periods(
                    gt, self.space.arch, scheds, self.sim_config,
                    backend=self.sim_backend, device=self.device,
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
            return self._wrap(genotype, cached)
        self.misses += 1
        ind = self._patch_sim([self._decode(genotype)])[0]
        self._store(key, ind)
        return ind

    def evaluate_batch(self, genotypes: Sequence[Genotype]) -> List[Individual]:
        """Evaluate a batch, memoized, in input order.

        With ``n_workers > 0`` the unique cache misses are decoded in a
        process pool; the merge is order-deterministic, so results are
        independent of worker scheduling.  With ``sim_backend="cuda"`` or
        ``"torch"`` the misses' ``sim_period`` values are measured by one
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
        return out

    # ------------------------------------------------------------ reporting
    def stats(self) -> Dict[str, int]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evaluations": self.evaluations,
            "entries": len(self._cache),
        }
