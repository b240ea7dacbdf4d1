"""Population variation as torch ops (relaxed device-resident path).

Mirrors the host explorer's operators over the dense gene matrix of
:class:`repro_torch.evo.encoding.PopulationLayout` — binary tournament on
(rank, −crowding), uniform crossover at a whole-child rate, per-gene
resampling mutation at rate 1/G — but draws from an explicit
``torch.Generator`` on the population's device instead of the host
Mersenne Twister.  The exact-parity path never calls into this module
(bit-identical fronts require replaying the host ``random.Random`` draw
sequence); these operators serve the device-resident loop, whose contract
is relative-hypervolume equivalence, not bitwise equality.  For one seed
on one device a run repeats exactly.

Every function takes the generator first and works on tensors of the
generator's device.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = [
    "init_population",
    "tournament_pick",
    "uniform_crossover",
    "mutate",
]


def _uniform(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float64)


def _draw(gen: torch.Generator, n: int, bounds: torch.Tensor) -> torch.Tensor:
    """(n, G) genes, gene g uniform on [0, bounds[g])."""
    u = _uniform(gen, (n, bounds.shape[0]))
    return torch.minimum(torch.floor(u * bounds).to(torch.int32), bounds - 1)


def init_population(
    gen: torch.Generator,
    n: int,
    bounds: torch.Tensor,
    forced_mask: Optional[torch.Tensor] = None,
    forced_vals: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Uniform random population: gene g ~ U[0, bounds[g]) — (n, G) int32.
    ``forced_mask``/``forced_vals`` pin strategy-fixed genes (forced ξ)."""
    genes = _draw(gen, n, bounds.to(torch.int32))
    if forced_mask is not None:
        genes = torch.where(forced_mask, forced_vals.to(torch.int32), genes)
    return genes


def tournament_pick(
    gen: torch.Generator, ranks: torch.Tensor, crowd: torch.Tensor, count: int
) -> torch.Tensor:
    """``count`` binary tournaments over a population of ``ranks.shape[0]``:
    each draws two uniform indices and keeps the lexicographically better
    (rank, −crowding) — ties keep the first draw, like the host's ``<=``."""
    n = ranks.shape[0]
    i, j = torch.randint(0, n, (2, count), generator=gen, device=gen.device)
    better = (ranks[i] < ranks[j]) | ((ranks[i] == ranks[j]) & (crowd[i] >= crowd[j]))
    return torch.where(better, i, j)


def uniform_crossover(
    gen: torch.Generator, pa: torch.Tensor, pb: torch.Tensor, rate: float
) -> torch.Tensor:
    """Whole-child crossover gate at ``rate``; crossed children take each
    gene from either parent with probability ½, otherwise they clone the
    first parent — the host operator, vectorized."""
    n, g = pa.shape
    do_cx = _uniform(gen, (n, 1)) < rate
    take_a = _uniform(gen, (n, g)) < 0.5
    return torch.where(do_cx, torch.where(take_a, pa, pb), pa)


def mutate(
    gen: torch.Generator,
    genes: torch.Tensor,
    bounds: torch.Tensor,
    mut_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-gene resampling mutation at rate 1/G (the host rate): a mutated
    gene redraws uniformly from [0, bound) — possibly its old value, as on
    the host.  ``mut_mask`` excludes strategy-fixed genes (forced ξ)."""
    n, g = genes.shape
    hit = _uniform(gen, (n, g)) < (1.0 / g)
    if mut_mask is not None:
        hit = hit & mut_mask
    return torch.where(hit, _draw(gen, n, bounds.to(torch.int32)), genes)
