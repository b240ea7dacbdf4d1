"""Dense device encodings of :class:`~repro_torch.core.dse.GenotypeSpace` populations.

The host genotype 𝒢 = (ξ, C_d, β_A) is a triple of small integer tuples;
the device-resident evolutionary loop (:mod:`repro_torch.evo.explorer`) keeps a
whole population as ONE int32 matrix instead::

    genes[n, :]  =  [ ξ bits | C_d genes | β_A genes ]      (N, G) int32

Column order follows the :class:`GenotypeSpace` conventions exactly —
``space.mcast`` / ``space.channels`` / ``space.actors``, all sorted — so a
row round-trips losslessly through :class:`~repro_torch.core.dse.Genotype`.
Every gene is a *bounded* integer: ξ ∈ {0, 1}, C_d indexes
``CHANNEL_DECISIONS``, and β_A indexes the actor's allowed-core list
(``space.allowed``), which makes uniform initialization, uniform
crossover, and resampling mutation uniform torch ops over one bounds
vector.  This module is pure numpy (no torch import) so the layout can be
built — and host populations converted — without touching the device.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..core.binding import CHANNEL_DECISIONS
from ..core.dse import Genotype

__all__ = ["PopulationLayout"]


class PopulationLayout:
    """Fixed gene layout of one :class:`GenotypeSpace` (ξ | C_d | β_A)."""

    def __init__(self, space, xi_mode: str = "explore") -> None:
        self.space = space
        self.xi_mode = xi_mode
        self.n_xi = len(space.mcast)
        self.n_cd = len(space.channels)
        self.n_ba = len(space.actors)
        self.n_genes = self.n_xi + self.n_cd + self.n_ba
        self.xi_slice = slice(0, self.n_xi)
        self.cd_slice = slice(self.n_xi, self.n_xi + self.n_cd)
        self.ba_slice = slice(self.n_xi + self.n_cd, self.n_genes)
        # Exclusive upper bound per gene (uniform sampling / mutation draw
        # from [0, bound)).
        self.bounds = np.concatenate(
            [
                np.full(self.n_xi, 2, np.int32),
                np.full(self.n_cd, len(CHANNEL_DECISIONS), np.int32),
                np.array(
                    [len(space.allowed[a]) for a in space.actors], np.int32
                ).reshape(-1),
            ]
        ).astype(np.int32)
        # Strategy-forced ξ value (None = explored freely).
        self.xi_forced: Optional[int] = {"never": 0, "always": 1}.get(xi_mode)

    # -------------------------------------------------------------- convert
    def encode(self, genotypes: Sequence[Genotype]) -> np.ndarray:
        """Host genotypes → (N, G) int32 matrix (β_A normalized into range,
        matching ``evaluate_genotype``'s ``idx % len(allowed)``)."""
        out = np.zeros((len(genotypes), self.n_genes), np.int32)
        for n, gt in enumerate(genotypes):
            out[n, self.xi_slice] = gt.xi
            out[n, self.cd_slice] = gt.cd
            out[n, self.ba_slice] = gt.ba
        out[:, self.ba_slice] %= self.bounds[self.ba_slice]
        if self.xi_forced is not None:
            out[:, self.xi_slice] = self.xi_forced
        return out

    def decode(self, genes: np.ndarray) -> List[Genotype]:
        """(N, G) matrix → host genotypes."""
        genes = np.asarray(genes, np.int64)
        return [
            Genotype(
                tuple(int(v) for v in row[self.xi_slice]),
                tuple(int(v) for v in row[self.cd_slice]),
                tuple(int(v) for v in row[self.ba_slice]),
            )
            for row in genes
        ]

    # ---------------------------------------------------------- ξ bucketing
    def force_xi(self, genes: np.ndarray) -> np.ndarray:
        if self.xi_forced is not None and self.n_xi:
            genes = np.array(genes, copy=True)
            genes[:, self.xi_slice] = self.xi_forced
        return genes

    def xi_patterns(self, genes: np.ndarray) -> List[Tuple[Tuple[int, ...], np.ndarray]]:
        """Group population rows by ξ pattern: ``[(pattern, row_idx), ...]``
        deterministically ordered by pattern value.  A fixed-ξ strategy
        yields exactly one group — the single-jit fast path."""
        genes = np.asarray(genes)
        if self.n_xi == 0:
            return [((), np.arange(len(genes)))]
        xi = genes[:, self.xi_slice]
        pats, inverse = np.unique(xi, axis=0, return_inverse=True)
        return [
            (tuple(int(v) for v in pats[k]), np.nonzero(inverse == k)[0])
            for k in range(len(pats))
        ]
