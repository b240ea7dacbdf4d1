"""NSGA-II ranking and elitist truncation, frozen, in plain NumPy float64.

* ranks: front r is the rows that no still-unranked row strictly Pareto
  dominates (all objectives minimized, ``inf`` allowed);
* crowding: per objective, the rows sorted by (rank, value, row); the
  first and last row of each front get ``inf``; an interior row adds
  (next − prev) / (max − min) of its front, nothing where the front's span
  is 0, and ``inf`` exactly where the span is infinite and the gap is too;
  objectives are added in index order;
* truncation: rows in order of (rank, −crowding), ties by row index; the
  first μ survive;
* the archive: the points of the archive so far and of the survivors, in
  that order, that have a finite objective and that no other such point
  strictly dominates, each vector once, where it is first seen.

``dtype`` is the float type the ranking is computed in: float64 is the
configuration's precision, float32 the control's.
"""
from __future__ import annotations

import numpy as np

__all__ = ["ranks", "crowding", "truncation", "survivors", "archive"]


def ranks(F: np.ndarray, dtype=np.float64) -> np.ndarray:
    F = np.asarray(F).astype(dtype)
    n = F.shape[0]
    le = (F[:, None, :] <= F[None, :, :]).all(-1)
    lt = (F[:, None, :] < F[None, :, :]).any(-1)
    dom = le & lt
    out = np.full(n, -1, np.int64)
    r = 0
    while (out < 0).any():
        rem = out < 0
        cnt = (dom & rem[:, None] & rem[None, :]).sum(0)
        out[rem & (cnt == 0)] = r
        r += 1
    return out


def crowding(F: np.ndarray, rank: np.ndarray, dtype=np.float64) -> np.ndarray:
    F = np.asarray(F).astype(dtype)
    n, m = F.shape
    idx = np.arange(n)
    d = np.zeros(n, dtype)
    for k in range(m):
        v = F[:, k]
        order = np.lexsort((idx, v, rank))
        vs, seg = v[order], rank[order]
        change = seg[1:] != seg[:-1]
        is_first = np.concatenate([[True], change])
        is_last = np.concatenate([change, [True]])
        start = np.maximum.accumulate(np.where(is_first, idx, -1))
        end = np.minimum.accumulate(np.where(is_last, idx, n)[::-1])[::-1]
        lo, hi = vs[start], vs[end]
        with np.errstate(invalid="ignore", divide="ignore"):
            span = hi - lo
            gap = vs[np.minimum(idx + 1, n - 1)] - vs[np.maximum(idx - 1, 0)]
            contrib = np.where(np.isinf(span), np.where(np.isinf(gap), dtype(np.inf), dtype(0)),
                               gap / span)
        interior = ~is_first & ~is_last
        contrib = np.where(interior & (hi != lo), contrib, dtype(0))
        add = np.empty(n, dtype)
        add[order] = contrib
        bnd = np.empty(n, bool)
        bnd[order] = is_first | is_last
        with np.errstate(invalid="ignore"):
            d = np.where(bnd, dtype(np.inf), d + add)
    return d.astype(np.float64)


def truncation(rank: np.ndarray, crowd: np.ndarray) -> np.ndarray:
    """Row order of elitist truncation: (rank, −crowding), ties by row."""
    return np.lexsort((-crowd, rank))


def survivors(F: np.ndarray, mu: int) -> np.ndarray:
    """Row indices of the μ rows that elitist truncation keeps, in order."""
    r = ranks(F)
    return truncation(r, crowding(F, r))[:mu]


def archive(before: np.ndarray, F: np.ndarray, dtype=np.float64) -> np.ndarray:
    """The archive after folding the survivors' objectives ``F`` into the
    archive ``before`` (float64 rows holding ``dtype`` values)."""
    pts = np.concatenate([np.asarray(before).reshape(-1, F.shape[1]), F]).astype(dtype)
    cand = np.isfinite(pts).any(1)
    P = pts[cand]
    le = (P[:, None, :] <= P[None, :, :]).all(-1)
    lt = (P[:, None, :] < P[None, :, :]).any(-1)
    keep = np.flatnonzero(cand)[~(le & lt).any(0)]
    out, seen = [], set()
    for i in keep:
        key = tuple(pts[i].tolist())
        if key not in seen:
            seen.add(key)
            out.append(pts[i])
    return np.array(out, np.float64).reshape(len(out), F.shape[1])
