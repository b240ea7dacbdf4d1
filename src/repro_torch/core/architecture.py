"""Architecture graph model (paper §II-D).

A heterogeneous many-core target g_R = (R, L):
    R = P ∪ Q ∪ H
        P   cores, partitioned by core type ϑ ∈ Θ
        Q   memories: core-local Q_P, tile-local Q_T, global q_global
        H   interconnects: tile crossbars H_T and the NoC h_NoC
Tiles partition all resources except {q_global, h_NoC}.

The routing function R(p, q) gives the set of resources traversed by a data
transfer between core p and memory q:
    R(p_i, q_{p_i})            = {p_i, q_{p_i}}                      (core-local)
    R(p, q) same tile T_j      = {p, h_{T_j}, q}                     (intra-tile)
    R(p, q) different tiles    = {p, h_{T_j}, h_NoC, h_{T_k}, q}     (inter-tile)
    R(p, q_global)             = {p, h_{T_j}, h_NoC, q_global}       (global)

Communication time of one token of φ bytes (paper Eq. 11):
    τ = ceil(φ / min bandwidth over traversed interconnects), 0 if none.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Core",
    "Memory",
    "Interconnect",
    "ArchitectureGraph",
    "paper_architecture",
]


@dataclass(frozen=True)
class Core:
    name: str
    tile: str
    ctype: str  # ϑ


@dataclass(frozen=True)
class Memory:
    name: str
    kind: str  # "core_local" | "tile_local" | "global"
    capacity: int  # W_q in bytes (use a huge int for "large enough" global)
    tile: Optional[str] = None
    owner_core: Optional[str] = None  # for core-local memories


@dataclass(frozen=True)
class Interconnect:
    name: str
    kind: str  # "crossbar" | "noc"
    bandwidth: float  # bytes per time unit (B_h)
    tile: Optional[str] = None


class ArchitectureGraph:
    """Tiled many-core architecture with hierarchical memories."""

    def __init__(self, name: str = "arch") -> None:
        self.name = name
        self.cores: Dict[str, Core] = {}
        self.memories: Dict[str, Memory] = {}
        self.interconnects: Dict[str, Interconnect] = {}
        self.core_costs: Dict[str, float] = {}  # K_ϑ per core type
        self.global_memory: Optional[str] = None
        self.noc: Optional[str] = None

    # ------------------------------------------------------------------ build
    def add_tile(
        self,
        tile: str,
        core_types: Sequence[str],
        *,
        core_local_capacity: int,
        tile_local_capacity: int,
        crossbar_bandwidth: float,
    ) -> None:
        xbar = f"h_{tile}"
        self.interconnects[xbar] = Interconnect(xbar, "crossbar", crossbar_bandwidth, tile)
        self.memories[f"q_{tile}"] = Memory(
            f"q_{tile}", "tile_local", tile_local_capacity, tile
        )
        for i, ctype in enumerate(core_types, start=1):
            p = f"p_{tile}_{i}"
            self.cores[p] = Core(p, tile, ctype)
            self.memories[f"q_{p}"] = Memory(
                f"q_{p}", "core_local", core_local_capacity, tile, owner_core=p
            )

    def set_global(self, capacity: int, noc_bandwidth: float) -> None:
        self.memories["q_global"] = Memory("q_global", "global", capacity)
        self.interconnects["h_NoC"] = Interconnect("h_NoC", "noc", noc_bandwidth)
        self.global_memory = "q_global"
        self.noc = "h_NoC"

    def set_core_costs(self, costs: Dict[str, float]) -> None:
        self.core_costs = dict(costs)

    # ------------------------------------------------------------- structure
    def tiles(self) -> List[str]:
        return sorted({c.tile for c in self.cores.values()})

    def cores_of_type(self, ctype: str) -> List[str]:
        return sorted(p for p, c in self.cores.items() if c.ctype == ctype)

    def core_types(self) -> List[str]:
        return sorted({c.ctype for c in self.cores.values()})

    def core_local_memory(self, core: str) -> str:
        return f"q_{core}"

    def tile_local_memory(self, tile: str) -> str:
        return f"q_{tile}"

    def tile_crossbar(self, tile: str) -> str:
        return f"h_{tile}"

    # --------------------------------------------------------------- routing
    def route(self, core: str, memory: str) -> List[str]:
        """Routing function R(p, q) -> resource names traversed."""
        p = self.cores[core]
        q = self.memories[memory]
        if q.kind == "core_local" and q.owner_core == core:
            return [core, memory]
        if q.kind == "global":
            return [core, self.tile_crossbar(p.tile), self.noc, memory]
        if q.tile == p.tile:
            return [core, self.tile_crossbar(p.tile), memory]
        # inter-tile
        return [core, self.tile_crossbar(p.tile), self.noc, self.tile_crossbar(q.tile), memory]

    def route_interconnects(self, core: str, memory: str) -> List[str]:
        return [r for r in self.route(core, memory) if r in self.interconnects]

    def comm_time(self, token_bytes: int, core: str, memory: str) -> int:
        """τ_(c,a) = τ_(a,c) = φ(c) / min bandwidth of traversed interconnects
        (paper Eq. 11); 0 when no interconnect is traversed.  Integer ceil."""
        hs = self.route_interconnects(core, memory)
        if not hs:
            return 0
        bmin = min(self.interconnects[h].bandwidth for h in hs)
        return max(1, math.ceil(token_bytes / bmin))

    # ------------------------------------------------------------- resources
    def schedulable_resources(self) -> List[str]:
        """R \\ Q — resources that carry utilization sets (cores + interconnects)."""
        return list(self.cores) + list(self.interconnects)

    def core_cost(self, ctype: str) -> float:
        return self.core_costs.get(ctype, 1.0)

    # ------------------------------------------------------------- serialize
    def to_dict(self) -> Dict:
        """Plain-data form (JSON-safe); inverse of :meth:`from_dict`."""
        from dataclasses import asdict

        return {
            "name": self.name,
            "cores": {p: asdict(c) for p, c in sorted(self.cores.items())},
            "memories": {q: asdict(m) for q, m in sorted(self.memories.items())},
            "interconnects": {
                h: asdict(i) for h, i in sorted(self.interconnects.items())
            },
            "core_costs": dict(self.core_costs),
            "global_memory": self.global_memory,
            "noc": self.noc,
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "ArchitectureGraph":
        g = cls(d.get("name", "arch"))
        g.cores = {p: Core(**spec) for p, spec in d["cores"].items()}
        g.memories = {q: Memory(**spec) for q, spec in d["memories"].items()}
        g.interconnects = {
            h: Interconnect(**spec) for h, spec in d["interconnects"].items()
        }
        g.core_costs = dict(d.get("core_costs", {}))
        g.global_memory = d.get("global_memory")
        g.noc = d.get("noc")
        return g

    def signature(self) -> str:
        """Stable content digest of the architecture structure (name
        excluded): equal signatures ⇔ structurally identical targets."""
        import hashlib
        import json

        d = self.to_dict()
        d.pop("name", None)
        blob = json.dumps(d, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()


def paper_architecture(
    *,
    time_unit_us: float = 1.0,
    core_local_mib: float = 2.5,
    tile_local_mib: float = 50.0,
    crossbar_gib_s: float = 8.0,
    noc_gib_s: float = 4.0,
    tiles: int = 4,
    cores_per_tile: int = 6,
) -> ArchitectureGraph:
    """The experimental target of paper §VI: 24 cores in 4 tiles, three core
    types ϑ1 (fast, cost 1.5), ϑ2 (2× slower than ϑ1 relative, cost 1.0),
    ϑ3 (slowest, cost 0.5); 2.5 MiB core-local and 50 MiB tile-local
    memories; 8 GiB/s crossbars; 4 GiB/s NoC; global memory "large enough".

    Bandwidths are converted to bytes per abstract time unit (default 1 µs).
    """
    g = ArchitectureGraph("paper24")
    mib = 1 << 20
    gib = 1 << 30
    xbar_bw = crossbar_gib_s * gib * (time_unit_us * 1e-6)
    noc_bw = noc_gib_s * gib * (time_unit_us * 1e-6)
    # Each tile mixes the three core types (2 of each by default).
    per_tile_types: List[str] = []
    base = ["t1", "t2", "t3"]
    for i in range(cores_per_tile):
        per_tile_types.append(base[i % 3])
    for t in range(1, tiles + 1):
        g.add_tile(
            f"T{t}",
            per_tile_types,
            core_local_capacity=int(core_local_mib * mib),
            tile_local_capacity=int(tile_local_mib * mib),
            crossbar_bandwidth=xbar_bw,
        )
    g.set_global(capacity=1 << 60, noc_bandwidth=noc_bw)
    g.set_core_costs({"t1": 1.5, "t2": 1.0, "t3": 0.5})
    return g
