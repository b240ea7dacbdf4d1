"""`torch_nsga2`: the device-resident NSGA-II explorer.

Registered beside the host ``nsga2`` with the same problem/engine/run seam
and two evaluation paths selected by the ``evaluation`` parameter:

``evaluation="exact"`` (default)
    The host ``nsga2`` generation loop itself (this class subclasses
    :class:`~repro_torch.core.explorers.NSGA2Explorer`) — same
    ``random.Random`` draw sequence, same engine decode — with its
    ``rank_crowd`` (non-dominated sort + crowding) answered by the
    float64 torch ops of :mod:`repro_torch.evo.ranking` on the engine's
    device, through :func:`parity_rank_crowd`.  Fronts are
    **bit-identical** to the host explorer at any fixed seed.

``evaluation="relaxed"``
    The device-resident loop: the population lives as one int32 gene
    matrix and its objectives as one float64 matrix on the engine's
    device; rank → tournament → crossover → mutation → relaxed decode
    (with the ``sim_step`` kernel when ``sim_period`` is an objective) →
    merged rank → truncation runs as torch ops there.  When the strategy
    fixes ξ a generation is one Python function of device ops; when ξ is
    explored, evaluation is bucketed per ξ pattern.  Variation draws from
    a ``torch.Generator`` on the device seeded from ``seed``.  The
    nondominated archive is folded on the host once per generation, and
    the final archive is re-evaluated through the engine, so archived
    objective vectors mean exactly what every other explorer's do.  This
    path trades bit parity for throughput and is gated by a
    relative-hypervolume tolerance instead.

Decode tables and their evaluators are LRU-cached per ξ pattern
(``max_patterns``), and kept across ``explore`` calls on one instance.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.dse import Genotype, xi_mode
from ..core.explorers import NSGA2Explorer, _update_archive, register_explorer
from ..core.pareto import nondominated
from .decode import RELAXED_OBJECTIVES, DecodeTables, make_relaxed_eval
from .encoding import PopulationLayout
from .ranking import crowding, nondomination_ranks, parity_rank_crowd, truncation_order
from .variation import init_population, mutate, tournament_pick, uniform_crossover

__all__ = ["TorchNSGA2Explorer"]


@register_explorer("torch_nsga2")
class TorchNSGA2Explorer(NSGA2Explorer):
    """NSGA-II with device-resident population and ranking (see the module
    docstring for the exact/relaxed split)."""

    def __init__(
        self,
        *,
        population: int = 100,
        offspring: int = 25,
        generations: int = 2500,
        crossover_rate: float = 0.95,
        seed: int = 0,
        time_budget_s: Optional[float] = None,
        track_hypervolume: bool = True,
        evaluation: str = "exact",
        sim_iters: int = 32,
        max_patterns: int = 8,
    ) -> None:
        if evaluation not in ("exact", "relaxed"):
            raise ValueError("evaluation must be 'exact' or 'relaxed'")
        if population < 2 or offspring < 1:
            raise ValueError("population must be >= 2 and offspring >= 1")
        super().__init__(
            population=population, offspring=offspring, generations=generations,
            crossover_rate=crossover_rate, seed=seed, time_budget_s=time_budget_s,
            track_hypervolume=track_hypervolume,
        )
        self.evaluation = evaluation
        self.sim_iters = sim_iters
        self.max_patterns = max_patterns
        # (graph, arch, pipelining, objectives, sim_iters, device, ξ pattern)
        # → relaxed evaluator holding its DecodeTables; LRU of max_patterns.
        self._evals: "OrderedDict[Tuple, Callable]" = OrderedDict()

    def params(self) -> Dict[str, Any]:
        return dict(super().params(), evaluation=self.evaluation)

    def rank_crowd(self, objs, engine):
        """The host loop's ranking core on the engine's device, bit-exact
        (see :mod:`repro_torch.evo.ranking`)."""
        return parity_rank_crowd(objs, engine.device)

    def _evolve(self, problem, engine, run, t0, on_generation) -> None:
        run.meta["evaluation"] = self.evaluation
        if self.evaluation == "exact":
            super()._evolve(problem, engine, run, t0, on_generation)
        else:
            self._explore_relaxed(problem, engine, run, t0, on_generation)

    # --------------------------------------------------- relaxed (device)
    def _explore_relaxed(self, problem, engine, run, t0, on_generation) -> None:
        objectives = tuple(problem.objectives)
        bad = [o for o in objectives if o not in RELAXED_OBJECTIVES]
        if bad:
            raise ValueError(
                f"objectives {bad} are not device-decodable; use "
                "evaluation='exact' for this problem"
            )
        mode = xi_mode(problem.strategy)
        space = engine.space
        dev = engine.device
        layout = PopulationLayout(space, mode)
        pipelined = problem.pipelined
        G = layout.n_genes
        forced_mask = np.zeros(G, bool)
        forced_vals = np.zeros(G, np.int32)
        if layout.xi_forced is not None and layout.n_xi:
            forced_mask[layout.xi_slice] = True
            forced_vals[layout.xi_slice] = layout.xi_forced
        mut_mask = np.ones(G, bool)
        if mode != "explore":
            mut_mask[layout.xi_slice] = False
        bounds = torch.as_tensor(layout.bounds, device=dev)
        forced_m = torch.as_tensor(forced_mask, device=dev)
        forced_v = torch.as_tensor(forced_vals, device=dev)
        mut_m = torch.as_tensor(mut_mask, device=dev)
        gen_rng = torch.Generator(device=dev)
        gen_rng.manual_seed(self.seed)
        mu, count, rate = self.population, self.offspring, self.crossover_rate
        relaxed_evals = 0
        problem_key = (space.g.signature(), space.arch.signature(), pipelined, objectives,
                       self.sim_iters, str(dev))

        def eval_fn(pattern: Tuple[int, ...]) -> Callable:
            """The relaxed evaluator of one ξ pattern (LRU over patterns)."""
            key = problem_key + (pattern,)
            fn = self._evals.get(key)
            if fn is None:
                tab = DecodeTables(space, pattern, pipelined=pipelined)
                fn = make_relaxed_eval(tab, objectives, sim_iters=self.sim_iters, device=dev)
                self._evals[key] = fn
                while len(self._evals) > self.max_patterns:
                    self._evals.popitem(last=False)
            else:
                self._evals.move_to_end(key)
            return fn

        # ξ fixed (or no multicast actors) → one pattern forever → one
        # evaluator and no host look at the genes.  Explored ξ buckets the
        # rows by pattern on the host.
        single = layout.n_xi == 0 or layout.xi_forced is not None
        if single:
            pattern = (layout.xi_forced,) * layout.n_xi if layout.n_xi else ()
            fixed_fn = eval_fn(pattern)

        def evaluate(genes: torch.Tensor) -> torch.Tensor:
            """Relaxed objectives of a device gene matrix."""
            nonlocal relaxed_evals
            relaxed_evals += genes.shape[0]
            if single:
                return fixed_fn(genes)
            F = torch.empty((genes.shape[0], len(objectives)), dtype=torch.float64,
                            device=dev)
            for pat, rows in layout.xi_patterns(genes.cpu().numpy()):
                rows_d = torch.as_tensor(rows, device=dev)
                F[rows_d] = eval_fn(pat)(genes[rows_d])
            return F

        def rank_crowd(F: torch.Tensor):
            ranks = nondomination_ranks(F)
            return ranks, crowding(F, ranks)

        def vary(genes: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
            ranks, crowd = rank_crowd(F)
            ia = tournament_pick(gen_rng, ranks, crowd, count)
            ib = tournament_pick(gen_rng, ranks, crowd, count)
            child = uniform_crossover(gen_rng, genes[ia], genes[ib], rate)
            child = mutate(gen_rng, child, bounds, mut_m)
            return torch.where(forced_m, forced_v, child)

        def step(genes: torch.Tensor, F: torch.Tensor):
            """One generation: rank → select → vary → decode (+ kernel) →
            merged rank → elitist truncation, all on the device."""
            child = vary(genes, F)
            mg = torch.cat([genes, child])
            mF = torch.cat([F, evaluate(child)])
            sel = truncation_order(*rank_crowd(mF))[:mu]
            return mg[sel], mF[sel]

        def fold_archive(ag, aF, genes, F):
            """Nondominated-so-far archive over relaxed objectives
            (first-seen per objective vector, like the host archive)."""
            allg = np.concatenate([ag, genes]) if len(ag) else genes
            allF = np.concatenate([aF, F]) if len(ag) else F
            pts = [tuple(v) for v in allF]
            nd = set(nondominated([p for p in pts if any(np.isfinite(p))]))
            seen = set()
            keep = []
            for i, p in enumerate(pts):
                if p in nd and p not in seen:
                    keep.append(i)
                    seen.add(p)
            return allg[keep], allF[keep]

        genes = init_population(
            gen_rng, mu, bounds,
            forced_m if forced_mask.any() else None, forced_v,
        )
        F = evaluate(genes)
        arch_g, arch_F = fold_archive(
            np.zeros((0, G), np.int32), np.zeros((0, len(objectives))),
            genes.cpu().numpy(), F.cpu().numpy(),
        )
        run.history.append([tuple(v) for v in arch_F])

        for gen in range(self.generations):
            if self.time_budget_s and time.monotonic() - t0 > self.time_budget_s:
                break
            genes, F = step(genes, F)
            arch_g, arch_F = fold_archive(arch_g, arch_F, genes.cpu().numpy(), F.cpu().numpy())
            run.history.append([tuple(v) for v in arch_F])
            if on_generation:
                run.wall_s = time.monotonic() - t0
                on_generation(gen, run)

        # True objectives for the survivors: the archive's relaxed vectors
        # located promising genotypes; the engine scores them.
        cand = layout.decode(np.concatenate([arch_g, genes.cpu().numpy()]))
        uniq: List[Genotype] = []
        seen = set()
        for gt in cand:
            if gt not in seen:
                uniq.append(gt)
                seen.add(gt)
        final = engine.evaluate_batch(uniq)
        _update_archive(run, final)
        run.meta["relaxed_evaluations"] = relaxed_evals
        run.meta["relaxed_final_candidates"] = len(uniq)
