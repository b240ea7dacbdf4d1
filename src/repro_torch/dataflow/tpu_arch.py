"""TPU pod as the paper's architecture graph (hardware adaptation).

This is the *modelled* target of the planning layer, not the device the
port runs on: the numbers below are the model's parameters (chips per
group, HBM, link rates), none of them a measurement.

Mapping (DESIGN.md §2): a "core" is one model-parallel chip group (16
chips acting as one logical accelerator), a *tile* is an ICI domain of
four such groups, the tile crossbar is intra-domain ICI, the NoC is the
pod-level ICI/DCN fabric, core-local memory is the group's aggregate HBM,
tile-local memory is host DRAM pinned to that domain, and global memory
is the remote (CPU pool / storage) tier that is "large enough".

Heterogeneity: mixed-generation fleets are modeled with three core types
(ϑ1 = v5p-class, ϑ2 = v5e, ϑ3 = v4-class) whose speed ratios the
extraction's τ(a, ϑ) uses, with costs proportional to price.
"""
from __future__ import annotations

from ..core.architecture import ArchitectureGraph

__all__ = ["tpu_pod_architecture"]

GIB = 1 << 30


def tpu_pod_architecture(
    *,
    groups: int = 16,              # model-parallel chip groups ("cores")
    groups_per_tile: int = 4,      # ICI domain size
    chips_per_group: int = 16,
    hbm_per_chip_gib: float = 16.0,
    host_dram_gib: float = 512.0,
    ici_gbps: float = 50.0,        # per-link intra-domain
    dcn_gbps: float = 6.25,        # pod-level fabric per group
    time_unit_us: float = 1.0,
    heterogeneous: bool = True,
) -> ArchitectureGraph:
    g = ArchitectureGraph("tpu-pod")
    n_tiles = groups // groups_per_tile
    xbar_bw = ici_gbps * 1e9 * (time_unit_us * 1e-6)   # bytes per time unit
    noc_bw = dcn_gbps * 1e9 * (time_unit_us * 1e-6)
    hbm_group = int(hbm_per_chip_gib * chips_per_group * GIB)
    types = ["t1", "t2", "t3"] if heterogeneous else ["t2"]
    for t in range(1, n_tiles + 1):
        core_types = [types[(t - 1 + i) % len(types)] for i in range(groups_per_tile)]
        g.add_tile(
            f"T{t}",
            core_types,
            core_local_capacity=hbm_group,
            tile_local_capacity=int(host_dram_gib * GIB),
            crossbar_bandwidth=xbar_bw,
        )
    g.set_global(capacity=1 << 62, noc_bandwidth=noc_bw)
    g.set_core_costs({"t1": 1.5, "t2": 1.0, "t3": 0.5})
    return g
