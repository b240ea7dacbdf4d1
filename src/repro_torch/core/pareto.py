"""Pareto machinery: non-dominated sorting, crowding distance, and the
hypervolume indicator (paper §VI-A, Eq. 26-27).

Hypervolume is computed exactly for any dimension by recursive slicing on
the last objective (all objectives minimized, reference point 1 after
normalization to [0, 1]^d against a reference front).
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Sequence, Tuple

__all__ = [
    "weakly_dominates",
    "nondominated",
    "fast_nondominated_sort",
    "crowding_distance",
    "normalize",
    "hypervolume",
    "relative_hypervolume",
]

Point = Tuple[float, ...]


def weakly_dominates(p: Sequence[float], q: Sequence[float]) -> bool:
    """p ⪯ q: p_i ≤ q_i for all i (paper footnote 4)."""
    return all(pi <= qi for pi, qi in zip(p, q))


def dominates(p: Sequence[float], q: Sequence[float]) -> bool:
    return weakly_dominates(p, q) and any(pi < qi for pi, qi in zip(p, q))


def nondominated(points: Iterable[Sequence[float]]) -> List[Point]:
    """Maximal set of mutually non-dominated points (duplicates collapsed)."""
    pts = sorted({tuple(float(x) for x in p) for p in points})
    out: List[Point] = []
    for p in pts:
        if any(dominates(q, p) for q in pts if q != p):
            continue
        out.append(p)
    return out


def fast_nondominated_sort(points: Sequence[Sequence[float]]) -> List[List[int]]:
    """NSGA-II front ranking; returns index lists per front."""
    n = len(points)
    S: List[List[int]] = [[] for _ in range(n)]
    counts = [0] * n
    fronts: List[List[int]] = [[]]
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            if dominates(points[i], points[j]):
                S[i].append(j)
            elif dominates(points[j], points[i]):
                counts[i] += 1
        if counts[i] == 0:
            fronts[0].append(i)
    k = 0
    while fronts[k]:
        nxt: List[int] = []
        for i in fronts[k]:
            for j in S[i]:
                counts[j] -= 1
                if counts[j] == 0:
                    nxt.append(j)
        k += 1
        fronts.append(nxt)
    return [f for f in fronts if f]


def crowding_distance(points: Sequence[Sequence[float]], idx: Sequence[int]) -> Dict[int, float]:
    """Crowding distance within one front (NSGA-II).

    ``inf`` coordinates (infeasibility markers, or objectives that diverge)
    are well-defined: a front mixing finite and infinite values has an
    infinite span, so an interior point contributes 0 for that objective
    unless one of its neighbours is at ``inf`` and the other finite — then
    it sits on the edge of the finite region and gets ``inf``, like a
    boundary point.  Neighbours both at ``inf`` (duplicates at infinity)
    contribute 0 rather than the IEEE ``inf - inf = nan``.  All-finite
    fronts and zero-span objectives are untouched (bit-identical to the
    historical behaviour).
    """
    if not idx:
        return {}
    d = {i: 0.0 for i in idx}
    m = len(points[idx[0]])
    for k in range(m):
        order = sorted(idx, key=lambda i: points[i][k])
        lo, hi = points[order[0]][k], points[order[-1]][k]
        d[order[0]] = d[order[-1]] = float("inf")
        if hi == lo:
            continue
        span = hi - lo
        for a, i in enumerate(order[1:-1], start=1):
            nxt, prv = points[order[a + 1]][k], points[order[a - 1]][k]
            if math.isinf(span):
                gap = nxt - prv
                if math.isinf(gap):
                    d[i] += float("inf")
                continue
            d[i] += (nxt - prv) / span
    return d


def normalize(
    front: Sequence[Sequence[float]], reference_front: Sequence[Sequence[float]]
) -> List[Point]:
    """Normalize objective vectors to [0, 1]^d by the reference front's
    per-objective min/max (paper: both S_Ref and S normalized; values are
    clipped so points worse than the reference extremes contribute 0).

    Non-finite reference coordinates are excluded from the per-objective
    bounds (an ``inf`` extreme would make every finite value map to 0/NaN);
    candidate coordinates at ``inf`` then clip to 1.0 like any
    worse-than-reference value.  All-finite inputs are unchanged."""
    if not front:
        return []
    m = len(reference_front[0])
    lo, hi = [], []
    for k in range(m):
        vals = [p[k] for p in reference_front if math.isfinite(p[k])]
        lo.append(min(vals) if vals else 0.0)
        hi.append(max(vals) if vals else 0.0)
    out = []
    for p in front:
        q = []
        for k in range(m):
            span = hi[k] - lo[k]
            v = 0.0 if span == 0 else (p[k] - lo[k]) / span
            q.append(min(1.0, max(0.0, v)))
        out.append(tuple(q))
    return out


def hypervolume(front: Sequence[Sequence[float]], ref: Sequence[float] = None) -> float:
    """Exact hypervolume of a minimization front w.r.t. reference point
    (default 1^d), by recursive slicing on the last objective."""
    pts = nondominated(front)
    if not pts:
        return 0.0
    d = len(pts[0])
    if ref is None:
        ref = tuple(1.0 for _ in range(d))
    pts = [p for p in pts if all(pi < ri for pi, ri in zip(p, ref))]
    if not pts:
        return 0.0
    if d == 1:
        return ref[0] - min(p[0] for p in pts)

    def hv(points: List[Point], dim: int, reference: Tuple[float, ...]) -> float:
        if dim == 2:
            ordered = sorted(points)
            total = 0.0
            prev_y = reference[1]
            for x, y in ordered:
                if y < prev_y:
                    total += (reference[0] - x) * (prev_y - y)
                    prev_y = y
            return total
        # slice on the last coordinate
        zs = sorted({p[dim - 1] for p in points})
        total = 0.0
        for i, z in enumerate(zs):
            z_next = zs[i + 1] if i + 1 < len(zs) else reference[dim - 1]
            slab = [p[: dim - 1] for p in points if p[dim - 1] <= z]
            slab = nondominated(slab)
            if slab:
                total += hv(slab, dim - 1, reference[: dim - 1]) * (z_next - z)
        return total

    return hv(pts, d, tuple(ref))


def relative_hypervolume(
    front: Sequence[Sequence[float]], reference_front: Sequence[Sequence[float]]
) -> float:
    """hypervolume(S) / hypervolume(S_Ref) after joint normalization
    (paper Eq. 27's per-run term).

    The reference point is 1.1^d (standard Zitzler offset): points that sit
    exactly on the normalization boundary (the union front's worst value in
    some objective) still contribute volume — with small fronts, a strategy
    whose best memory equals the union maximum would otherwise score 0.

    Degenerate reference fronts (a single point, or zero extent in every
    objective) give normalization nothing to scale by — every point maps to
    the origin and the ratio is 0/0-shaped.  We define the value instead:
    1.0 if the candidate front reaches (weakly dominates) the collapsed
    reference point, else 0.0.

    All-``inf`` objective vectors (the infeasibility marker of
    :func:`repro_torch.core.dse.infeasible_objectives`) are dropped from both
    fronts before anything else — they carry no attainment information and
    would otherwise poison the normalization bounds.  Partially-infinite
    points keep their finite coordinates and clip to the normalization
    boundary in the infinite ones (see :func:`normalize`)."""
    front = [p for p in front if any(math.isfinite(v) for v in p)]
    reference_front = [
        p for p in reference_front if any(math.isfinite(v) for v in p)
    ]
    if not reference_front:
        return 0.0
    d = len(reference_front[0])
    lo = [min(p[k] for p in reference_front) for k in range(d)]
    hi = [max(p[k] for p in reference_front) for k in range(d)]
    if all(h == l for l, h in zip(lo, hi)):
        collapsed = tuple(lo)
        return 1.0 if any(weakly_dominates(p, collapsed) for p in front) else 0.0
    ref_pt = tuple(1.1 for _ in range(d))
    hv_ref = hypervolume(normalize(reference_front, reference_front), ref_pt)
    if hv_ref == 0:
        return 0.0
    return hypervolume(normalize(front, reference_front), ref_pt) / hv_ref
