"""Batched k-objective NSGA-II ranking as torch ops, in float64.

Three primitives over an objective matrix ``F`` of shape (N, k) on any
device (all objectives minimized, ``inf`` = infeasible / diverged
coordinate):

* :func:`domination_matrix` — pairwise strict Pareto dominance;
* :func:`nondomination_ranks` — iterative front peeling (the fixpoint of
  :func:`repro_torch.core.pareto.fast_nondominated_sort`), one host check
  per front;
* :func:`crowding` — crowding distance of *all* fronts in one pass: one
  lexicographic sort per objective groups each front into a contiguous
  segment, segment boundaries get ``inf``, interior points accumulate
  (next − prev) / (max − min) with the same ``inf``-safe rules as the host
  implementation.

Bit-for-bit parity with :mod:`repro_torch.core.pareto` is the contract:
ranks are integers and crowding runs in float64 with the host's
accumulation order (one add per objective, objectives in index order).
The host breaks value ties by *position in the front sequence* (Python's
stable sort), so :func:`crowding` takes an explicit ``tie_pos`` vector and
:func:`parity_rank_crowd` replays the host front sequence from the
domination matrix to supply it.  The relaxed device loop uses plain row
order as the tie key instead.

torch has no lexsort: :func:`_lexsort` composes one from stable sorts,
last key first.  ``torch.sort`` is not stable on CUDA unless asked, and a
tie broken differently would change the front the host replays.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device

__all__ = [
    "domination_matrix",
    "nondomination_ranks",
    "crowding",
    "truncation_order",
    "host_front_sequence",
    "parity_rank_crowd",
]


def _lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """``jnp.lexsort(keys)``: the last key is the primary one; ties keep
    row order."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in keys:
        order = order[torch.sort(k[order], stable=True).indices]
    return order


# ------------------------------------------------------------------ ops
def domination_matrix(F: torch.Tensor) -> torch.Tensor:
    """dom[i, j] ⇔ F[i] strictly Pareto-dominates F[j] (N, N) bool."""
    le = (F[:, None, :] <= F[None, :, :]).all(-1)
    lt = (F[:, None, :] < F[None, :, :]).any(-1)
    return le & lt


def nondomination_ranks(F: torch.Tensor) -> torch.Tensor:
    """Front index per row (0 = nondominated), int32 (N,).

    Front r is the rows not dominated by any still-unranked row — the
    fixpoint :func:`fast_nondominated_sort` computes with its decrement
    counters, so ``ranks[i] == front_index_of(i)`` always.
    """
    n = F.shape[0]
    rank = torch.full((n,), -1, dtype=torch.int32, device=F.device)
    if n == 0:
        return rank
    dom = domination_matrix(F)
    for r in range(n):
        remaining = rank < 0
        if not bool(remaining.any()):
            break
        cnt = (dom & remaining[:, None] & remaining[None, :]).sum(0)
        rank = torch.where(remaining & (cnt == 0), r, rank)
    return rank


def crowding(F: torch.Tensor, ranks: torch.Tensor, tie_pos=None) -> torch.Tensor:
    """Crowding distance per row, all fronts at once, float64 (N,).

    ``tie_pos`` breaks equal-value ties inside a front (smaller = earlier
    in the front's sequence); defaults to row order.  Matches the host
    :func:`repro_torch.core.pareto.crowding_distance` bit-for-bit when
    given the host's front-sequence positions: per objective, front
    boundaries are *set* to ``inf``, zero-span objectives contribute
    nothing, infinite spans contribute ``inf`` exactly when one neighbour
    is infinite and the other finite, and finite spans accumulate
    (next − prev) / span in objective order.
    """
    F = F.to(torch.float64)
    n, m = F.shape
    dev = F.device
    if n == 0:
        return torch.zeros((0,), dtype=torch.float64, device=dev)
    ranks = ranks.to(torch.int32)
    idx = torch.arange(n, device=dev)
    pos = idx if tie_pos is None else torch.as_tensor(tie_pos, device=dev)
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=dev)
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    true = torch.ones(1, dtype=torch.bool, device=dev)
    d = torch.zeros((n,), dtype=torch.float64, device=dev)
    for k in range(m):
        v = F[:, k]
        # Fronts become contiguous segments, each sorted by value with the
        # host's stable tie order.
        order = _lexsort((pos, v, ranks))
        vs = v[order]
        seg = ranks[order]
        change = seg[1:] != seg[:-1]
        is_first = torch.cat([true, change])
        is_last = torch.cat([change, true])
        start = torch.cummax(torch.where(is_first, idx, -1), 0).values
        end = torch.cummin(torch.where(is_last, idx, n).flip(0), 0).values.flip(0)
        lo, hi = vs[start], vs[end]
        span = hi - lo
        gap = vs[torch.clamp(idx + 1, max=n - 1)] - vs[torch.clamp(idx - 1, min=0)]
        interior = ~is_first & ~is_last
        contrib = torch.where(
            torch.isinf(span), torch.where(torch.isinf(gap), inf, zero), gap / span
        )
        contrib = torch.where(interior & (hi != lo), contrib, zero)
        # Back to row order: boundaries overwrite (host `d[i] = inf`),
        # interiors accumulate — one add per objective, objectives in order.
        add = torch.empty_like(d).index_put_((order,), contrib)
        bnd = torch.empty_like(is_first).index_put_((order,), is_first | is_last)
        d = torch.where(bnd, inf, d + add)
    return d


def truncation_order(ranks: torch.Tensor, crowd: torch.Tensor) -> torch.Tensor:
    """Stable elitist order: by (rank, −crowding), ties by row index — the
    device form of ``sorted(range(n), key=(rank, -crowd))``."""
    return _lexsort((-crowd, ranks))


# ------------------------------------------------- host-parity front order
def host_front_sequence(dom: np.ndarray) -> List[List[int]]:
    """Replay :func:`fast_nondominated_sort`'s exact front *sequence* from
    a precomputed domination matrix.  The host's within-front order is an
    artifact of its S-list traversal (ascending ``j`` per dominator, front
    members in discovery order); crowding tie-breaks depend on it, so the
    parity path reconstructs it instead of guessing."""
    n = dom.shape[0]
    S = [list(np.nonzero(dom[i])[0]) for i in range(n)]
    counts = dom.sum(axis=0).astype(int)
    fronts: List[List[int]] = [[i for i in range(n) if counts[i] == 0]]
    k = 0
    while fronts[k]:
        nxt: List[int] = []
        for i in fronts[k]:
            for j in S[i]:
                counts[j] -= 1
                if counts[j] == 0:
                    nxt.append(int(j))
        k += 1
        fronts.append(nxt)
    return [f for f in fronts if f]


def parity_rank_crowd(
    objs: Sequence[Sequence[float]], device="cuda",
) -> Tuple[Dict[int, int], Dict[int, float]]:
    """Drop-in replacement for the host explorer's ``rank_crowd``:
    domination + crowding on ``device`` (the card unless the caller asks
    for ``"cpu"``), front sequence replayed on the host — returns the same
    ``(rank, crowd)`` dicts bit-for-bit."""
    dev = resolve_device(device)
    n = len(objs)
    if n == 0:
        return {}, {}
    F = torch.as_tensor(np.asarray(objs, np.float64), device=dev)
    fronts = host_front_sequence(domination_matrix(F).cpu().numpy())
    ranks = np.zeros(n, np.int32)
    tie_pos = np.zeros(n, np.int64)
    for fi, front in enumerate(fronts):
        ranks[front] = fi
    tie_pos[[i for f in fronts for i in f]] = np.arange(n)
    crowd = crowding(
        F, torch.as_tensor(ranks, device=F.device), torch.as_tensor(tie_pos, device=F.device)
    ).cpu().numpy()
    return (
        {i: int(ranks[i]) for i in range(n)},
        {i: float(crowd[i]) for i in range(n)},
    )
