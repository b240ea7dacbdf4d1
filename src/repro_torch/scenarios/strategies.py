"""Scenario sampling for tests and sweeps.

Two entry points with identical semantics:

  * :func:`sample_scenarios` — deterministic seeded sampler, dependency-free;
    the property-test harness uses it directly so invariants are exercised
    even where `hypothesis` is absent.
  * :func:`scenario_strategy` / :func:`app_spec_strategy` — real hypothesis
    strategies (CI path), built from the same parameter ranges, so both
    paths explore the same scenario space.

Parameter ranges are deliberately small: the point is *many diverse small
graphs* that decode in milliseconds, not a few big ones.
"""
from __future__ import annotations

import random
from typing import Any, Dict, Iterator, List, Optional, Sequence

from .archs import NOC_PROFILES, TYPE_MIXES, ArchParams
from .families import FAMILIES
from .spec import AppSpec, Scenario

__all__ = [
    "PARAM_RANGES",
    "LARGE_PARAM_RANGES",
    "SIZE_TIERS",
    "ARCH_RANGES",
    "LARGE_ARCH_RANGES",
    "sample_app_spec",
    "sample_arch_params",
    "sample_scenario",
    "sample_scenarios",
    "app_spec_strategy",
    "scenario_strategy",
]

# Per-family parameter ranges: name -> (choices...) drawn uniformly.
PARAM_RANGES: Dict[str, Dict[str, Sequence[Any]]] = {
    "multicast_tree": {"depth": (1, 2), "fanout": (2, 3)},
    "split_join": {"branches": (2, 3, 4), "stages": (1, 2), "fork_prob": (0.0, 0.5, 1.0)},
    "stencil_chain": {"length": (1, 2, 3), "taps": (2, 3)},
    "camera_pipeline": {"cameras": (1, 2), "chain": (2, 3, 4), "tap_width": (1, 2)},
    "random_dag": {
        "n_actors": (4, 6, 8, 10),
        "width": (2, 3),
        "multicast_density": (0.0, 0.4, 1.0),
    },
}

# "large" tier: Multicamera-scale graphs (tens of actors, ~100 channels)
# where decode dominates the sweep and process-parallel evaluation pays
# off (ROADMAP open item; used by dse_experiments.run_scaling --size).
# Grown one notch in PR 5 (each range's ceiling raised ~25-50%) now the
# campaign runner distributes the sweep; run_scaling --size large is
# verified to complete under it.
LARGE_PARAM_RANGES: Dict[str, Dict[str, Sequence[Any]]] = {
    "multicast_tree": {"depth": (2, 3, 4), "fanout": (3, 4, 5)},
    "split_join": {"branches": (4, 6, 8, 10), "stages": (2, 3, 4), "fork_prob": (0.5, 1.0)},
    "stencil_chain": {"length": (4, 6, 8, 10), "taps": (3, 4, 5)},
    "camera_pipeline": {"cameras": (3, 4, 5), "chain": (4, 5, 6, 7), "tap_width": (2,)},
    "random_dag": {
        "n_actors": (16, 24, 32, 40),
        "width": (3, 4, 5, 6),
        "multicast_density": (0.4, 0.7, 1.0),
    },
}

SIZE_TIERS: Dict[str, Dict[str, Dict[str, Sequence[Any]]]] = {
    "standard": PARAM_RANGES,
    "large": LARGE_PARAM_RANGES,
}

ARCH_RANGES: Dict[str, Sequence[Any]] = {
    "tiles": (1, 2, 3),
    "cores_per_tile": (2, 3, 4),
    "type_mix": TYPE_MIXES,
    "noc_profile": tuple(NOC_PROFILES),
    "core_local_kib": (256, 512),
    "tile_local_kib": (4 * 1024, 8 * 1024),
}

# Larger targets to pair with "large" graphs (more tiles/cores so big
# graphs stay schedulable without saturating one crossbar; tiles grown
# one notch with the PR-5 family-param bump).
LARGE_ARCH_RANGES: Dict[str, Sequence[Any]] = {
    "tiles": (3, 4, 6, 8),
    "cores_per_tile": (4, 6),
    "type_mix": TYPE_MIXES,
    "noc_profile": tuple(NOC_PROFILES),
    "core_local_kib": (512, 1024),
    "tile_local_kib": (8 * 1024, 16 * 1024),
}

_ARCH_TIERS = {"standard": ARCH_RANGES, "large": LARGE_ARCH_RANGES}


def sample_app_spec(
    rng: random.Random, family: Optional[str] = None, *, size: str = "standard"
) -> AppSpec:
    fam = family or rng.choice(sorted(FAMILIES))
    params = {k: rng.choice(list(v)) for k, v in SIZE_TIERS[size][fam].items()}
    return AppSpec.make(fam, seed=rng.randrange(1_000_000), **params)


def sample_arch_params(rng: random.Random, *, size: str = "standard") -> ArchParams:
    return ArchParams(**{k: rng.choice(list(v)) for k, v in _ARCH_TIERS[size].items()})


def sample_scenario(
    rng: random.Random, family: Optional[str] = None, *, size: str = "standard"
) -> Scenario:
    return Scenario(
        app=sample_app_spec(rng, family, size=size),
        arch=sample_arch_params(rng, size=size),
        arch_seed=rng.randrange(1_000_000),
    )


def sample_scenarios(
    seed: int,
    n: int,
    families: Optional[Sequence[str]] = None,
    *,
    size: str = "standard",
) -> List[Scenario]:
    """Deterministic list of ``n`` scenarios cycling over ``families``
    (default: all registered families).  ``size`` selects the parameter
    tier (``standard`` | ``large``); the default draws are unchanged from
    the pre-tier sampler."""
    if size not in SIZE_TIERS:
        raise KeyError(f"unknown size tier {size!r}; expected {sorted(SIZE_TIERS)}")
    rng = random.Random(f"scenarios:{seed}" if size == "standard" else f"scenarios:{size}:{seed}")
    fams = list(families or sorted(FAMILIES))
    return [sample_scenario(rng, fams[i % len(fams)], size=size) for i in range(n)]


# ----------------------------------------------------------------- hypothesis
def app_spec_strategy(family: Optional[str] = None):
    """Hypothesis strategy over :class:`AppSpec` (requires hypothesis)."""
    from hypothesis import strategies as st

    def from_seed(fam: str, seed: int) -> AppSpec:
        return sample_app_spec(random.Random(f"hyp:{fam}:{seed}"), fam)

    fams = st.just(family) if family else st.sampled_from(sorted(FAMILIES))
    return st.builds(from_seed, fams, st.integers(0, 10_000))


def scenario_strategy(family: Optional[str] = None):
    """Hypothesis strategy over full :class:`Scenario` specs."""
    from hypothesis import strategies as st

    def from_seed(fam: str, seed: int) -> Scenario:
        return sample_scenario(random.Random(f"hyp:{fam}:{seed}"), fam)

    fams = st.just(family) if family else st.sampled_from(sorted(FAMILIES))
    return st.builds(from_seed, fams, st.integers(0, 10_000))
