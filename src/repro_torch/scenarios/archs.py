"""Heterogeneous architecture-graph generation (scenario subsystem).

Generates families of tiled many-core targets within the paper's §II-D
model (tiles of cores + core-local/tile-local memories + crossbars + one
NoC + global memory), varying:

  * tile count and cores per tile,
  * the per-tile core-type mix (homogeneous t3 tiles up to the paper's
    three-type heterogeneous mix),
  * memory hierarchy sizes (core-local / tile-local capacities),
  * interconnect profile — relative crossbar/NoC bandwidths, including
    per-tile bandwidth variation ("thin" NoCs make channel placement
    decisions matter more).

All knobs live in :class:`ArchParams` so architectures are serializable
and reproducible; `generate_architecture` is deterministic under seed.
"""
from __future__ import annotations

import random
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional

from ..core.architecture import ArchitectureGraph

__all__ = ["ArchParams", "NOC_PROFILES", "generate_architecture"]

# Interconnect profiles: (crossbar bandwidth, NoC bandwidth) in bytes per
# abstract time unit, plus per-tile crossbar jitter (fraction).
NOC_PROFILES: Dict[str, Dict[str, float]] = {
    "uniform": {"xbar": 38_000.0, "noc": 38_000.0, "jitter": 0.0},
    "fat": {"xbar": 76_000.0, "noc": 152_000.0, "jitter": 0.0},
    "thin_noc": {"xbar": 76_000.0, "noc": 19_000.0, "jitter": 0.0},
    "irregular": {"xbar": 57_000.0, "noc": 38_000.0, "jitter": 0.5},
}

# Core-type mixes drawn per tile ("hetero" cycles all three paper types).
TYPE_MIXES = ("hetero", "fast_only", "slow_only", "duo")


@dataclass(frozen=True)
class ArchParams:
    tiles: int = 2
    cores_per_tile: int = 3
    type_mix: str = "hetero"          # one of TYPE_MIXES
    noc_profile: str = "uniform"      # one of NOC_PROFILES
    core_local_kib: int = 512         # memory hierarchy sizes
    tile_local_kib: int = 8 * 1024
    global_kib: int = 1 << 30

    def validate(self) -> None:
        if self.tiles < 1 or self.cores_per_tile < 1:
            raise ValueError("need >= 1 tile and >= 1 core per tile")
        if self.type_mix not in TYPE_MIXES:
            raise ValueError(f"unknown type_mix {self.type_mix!r}")
        if self.noc_profile not in NOC_PROFILES:
            raise ValueError(f"unknown noc_profile {self.noc_profile!r}")


def _tile_types(params: ArchParams, rng: random.Random, tile_idx: int) -> List[str]:
    n = params.cores_per_tile
    if params.type_mix == "fast_only":
        return ["t1"] * n
    if params.type_mix == "slow_only":
        return ["t3"] * n
    if params.type_mix == "duo":
        return [("t1" if (i + tile_idx) % 2 == 0 else "t3") for i in range(n)]
    # hetero: cycle all three, offset per tile so tiles are not identical.
    base = ["t1", "t2", "t3"]
    return [base[(i + tile_idx) % 3] for i in range(n)]


def generate_architecture(params: ArchParams, seed: int = 0) -> ArchitectureGraph:
    """Deterministically build one architecture graph from ``params``."""
    params.validate()
    rng = random.Random(f"arch:{seed}:{sorted(asdict(params).items())}")
    prof = NOC_PROFILES[params.noc_profile]
    kib = 1 << 10
    g = ArchitectureGraph(
        f"gen_t{params.tiles}x{params.cores_per_tile}_{params.type_mix}_{params.noc_profile}"
    )
    for t in range(1, params.tiles + 1):
        jitter = 1.0 + prof["jitter"] * (rng.random() - 0.5)
        g.add_tile(
            f"T{t}",
            _tile_types(params, rng, t - 1),
            core_local_capacity=params.core_local_kib * kib,
            tile_local_capacity=params.tile_local_kib * kib,
            crossbar_bandwidth=max(1.0, prof["xbar"] * jitter),
        )
    g.set_global(capacity=params.global_kib * kib, noc_bandwidth=prof["noc"])
    g.set_core_costs({"t1": 1.5, "t2": 1.0, "t3": 0.5})
    return g
