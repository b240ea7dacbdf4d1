"""The paper's application and architecture model, frozen for the benchmark.

A plain copy of the definitions the relaxed decode and the self-timed
simulator rest on (paper §II, Algorithm 1, §VI), written from the
configuration's data and independent of the program under test:

* an application graph as insertion-ordered dicts (actors, channels with
  one producer and ordered consumers), its multi-cast actors, the MRB
  substitution of Algorithm 1 and the §VI pipeline delays;
* the tiled architecture: cores by type, core-local, tile-local and
  global memories, crossbars and the NoC, the routing function R(p, q)
  and the communication time of Eq. 11;
* the arbitration order (descending topological priority, name as
  tie-break).

Dict insertion order is part of the model: it fixes the read and write
order inside an actor's window (reads in input-channel order, the
execution, writes in output-channel order; :mod:`.decode` lays them out),
and the harness builds the program's graph from the same lists in the same
order.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["Graph", "Arch", "graph_from_config", "arch_from_config", "transformed",
           "arbitration_order", "distinct_readers", "CHANNEL_DECISIONS"]

# Channel placement decisions; a C_d gene indexes this tuple.
CHANNEL_DECISIONS = ("PROD", "TILE-PROD", "CONS", "TILE-CONS", "GLOBAL")


@dataclass
class Channel:
    name: str
    src: str
    dsts: List[str]
    token_bytes: int
    delay: int = 0
    capacity: int = 1
    is_mrb: bool = False


@dataclass
class Graph:
    """Actors (name → exec times by core type, multicast flag) and channels,
    both in insertion order."""

    name: str
    exec_times: Dict[str, Dict[str, int]] = field(default_factory=dict)
    multicast: Dict[str, bool] = field(default_factory=dict)
    channels: Dict[str, Channel] = field(default_factory=dict)

    def copy(self) -> "Graph":
        return Graph(self.name, {a: dict(v) for a, v in self.exec_times.items()},
                     dict(self.multicast),
                     {c: Channel(ch.name, ch.src, list(ch.dsts), ch.token_bytes, ch.delay,
                                 ch.capacity, ch.is_mrb) for c, ch in self.channels.items()})

    def in_channels(self, a: str) -> List[str]:
        return [c for c, ch in self.channels.items() if a in ch.dsts]

    def out_channels(self, a: str) -> List[str]:
        return [c for c, ch in self.channels.items() if ch.src == a]

    def multicast_actors(self) -> List[str]:
        return [a for a in self.exec_times if self.multicast[a]]


def graph_from_config(app: dict) -> Graph:
    g = Graph(app["name"])
    for a in app["actors"]:
        g.exec_times[a["name"]] = dict(a["exec_times"])
        g.multicast[a["name"]] = bool(a.get("multicast", False))
    for c in app["channels"]:
        g.channels[c["name"]] = Channel(c["name"], c["src"], list(c["dsts"]), int(c["token_bytes"]),
                                        int(c.get("delay", 0)), int(c.get("capacity", 1)))
    return g


def transformed(g: Graph, xi: Dict[str, int], pipelined: bool) -> Graph:
    """Algorithm 1 (each multi-cast actor with ξ = 1 and its channels become
    one MRB: γ = γ_in + γ_out, δ = δ_in, φ inherited, named ``mrb{…}`` over
    the sorted member names, appended last), then §VI: every channel gets at
    least one initial token when ``pipelined``."""
    gt = g.copy()
    for am in g.multicast_actors():
        if not xi.get(am, 0):
            continue
        cin = gt.channels[gt.in_channels(am)[0]]
        couts = [gt.channels[c] for c in gt.out_channels(am)]
        readers: List[str] = []
        for co in couts:
            readers.extend(co.dsts)
        name = "mrb{" + ",".join(sorted([cin.name] + [co.name for co in couts])) + "}"
        del gt.exec_times[am], gt.multicast[am]
        for c in [cin.name] + [co.name for co in couts]:
            del gt.channels[c]
        gt.channels[name] = Channel(name, cin.src, readers, cin.token_bytes, cin.delay,
                                    cin.capacity + couts[0].capacity, True)
    if pipelined:
        for ch in gt.channels.values():
            ch.delay = max(ch.delay, 1)
    return gt


def arbitration_order(g: Graph) -> List[str]:
    """Actors by descending topological priority, name as tie-break
    (Kahn's algorithm by name over the zero-delay edges)."""
    adj: Dict[str, set] = {a: set() for a in g.exec_times}
    indeg = {a: 0 for a in g.exec_times}
    for ch in g.channels.values():
        if ch.delay >= 1:
            continue
        for r in ch.dsts:
            if r not in adj[ch.src]:
                adj[ch.src].add(r)
                indeg[r] += 1
    ready = sorted(a for a, d in indeg.items() if d == 0)
    order: List[str] = []
    while ready:
        a = ready.pop(0)
        order.append(a)
        added = []
        for b in adj[a]:
            indeg[b] -= 1
            if indeg[b] == 0:
                added.append(b)
        ready = sorted(ready + added)
    if len(order) != len(g.exec_times):
        raise ValueError("zero-delay cycle")
    prio = {a: len(order) - i for i, a in enumerate(order)}
    return sorted(g.exec_times, key=lambda a: (-prio[a], a))


def distinct_readers(ch: Channel) -> List[str]:
    """One read view per distinct reader (an MRB can list a reader once per
    replaced channel)."""
    out: List[str] = []
    for r in ch.dsts:
        if r not in out:
            out.append(r)
    return out


@dataclass
class Arch:
    """The tiled target: cores (name → (tile, type)), memories (name →
    (kind, capacity, tile, owner core)), interconnects (name → (kind,
    bandwidth in bytes per time unit, tile)) and core costs by type."""

    cores: Dict[str, Tuple[str, str]]
    memories: Dict[str, Tuple[str, int, Optional[str], Optional[str]]]
    interconnects: Dict[str, Tuple[str, float, Optional[str]]]
    core_costs: Dict[str, float]

    def route_interconnects(self, p: str, q: str) -> List[str]:
        tile, _ = self.cores[p]
        kind, _, qtile, owner = self.memories[q]
        if kind == "core_local" and owner == p:
            return []
        if kind == "global":
            return [f"h_{tile}", "h_NoC"]
        if qtile == tile:
            return [f"h_{tile}"]
        return [f"h_{tile}", "h_NoC", f"h_{qtile}"]

    def comm_time(self, token_bytes: int, p: str, q: str) -> int:
        """Eq. 11: ⌈φ / min bandwidth on the route⌉, at least 1; 0 when the
        route crosses no interconnect."""
        hs = self.route_interconnects(p, q)
        if not hs:
            return 0
        bmin = min(self.interconnects[h][1] for h in hs)
        return max(1, math.ceil(token_bytes / bmin))

    def memory_for(self, decision: str, p: str) -> str:
        if decision in ("PROD", "CONS"):
            return f"q_{p}"
        if decision in ("TILE-PROD", "TILE-CONS"):
            return f"q_{self.cores[p][0]}"
        return "q_global"


def arch_from_config(spec: dict) -> Arch:
    """The §VI target from the configuration: per tile a crossbar, a
    tile-local memory and its cores (``p_<tile>_<i>``, each with its
    core-local memory); one global memory behind the NoC."""
    cores: Dict[str, Tuple[str, str]] = {}
    mems: Dict[str, Tuple[str, int, Optional[str], Optional[str]]] = {}
    ics: Dict[str, Tuple[str, float, Optional[str]]] = {}
    for tile in spec["tiles"]:
        t = tile["name"]
        ics[f"h_{t}"] = ("crossbar", float(spec["crossbar_bytes_per_unit"]), t)
        mems[f"q_{t}"] = ("tile_local", int(spec["tile_local_bytes"]), t, None)
        for i, ctype in enumerate(tile["core_types"], start=1):
            p = f"p_{t}_{i}"
            cores[p] = (t, ctype)
            mems[f"q_{p}"] = ("core_local", int(spec["core_local_bytes"]), t, p)
    mems["q_global"] = ("global", int(spec["global_bytes"]), None, None)
    ics["h_NoC"] = ("noc", float(spec["noc_bytes_per_unit"]), None)
    return Arch(cores, mems, ics, {k: float(v) for k, v in spec["core_costs"].items()})

