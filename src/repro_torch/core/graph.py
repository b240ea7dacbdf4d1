"""Application graph model (paper §II-A, §II-B).

An application graph g_A = (A ∪ C, E) is a bipartite graph of actors A and
channels C.  Channels carry tokens with marked-graph semantics by default
(one token consumed per input / produced per output per firing), generalized
to multi-rate via per-edge production ψ and consumption κ rates (§II-C).

Channel attributes (paper notation):
    δ(c)  ``delay``       number of initial tokens
    γ(c)  ``capacity``    maximal number of tokens storable
    φ(c)  ``token_bytes`` size of one token in bytes

Actor execution times are core-type dependent: τ(a, ϑ) ∈ ℕ ∪ {⊥}; ⊥ (None)
means the actor cannot run on that core type.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = [
    "Actor",
    "Channel",
    "ApplicationGraph",
    "multicast_actors",
    "satisfies_multicast_structure",
    "topological_priorities",
]


@dataclass
class Actor:
    """A dataflow actor.

    ``exec_times`` maps core-type name ϑ -> execution time τ(a, ϑ) in integer
    time units.  A missing key encodes ⊥ (actor not mappable to that type).

    ``multicast`` marks copy actors inserted for fork nodes (paper §II-B).
    The flag is semantic — a 1-in/1-out pass-through filter satisfies the
    *structural* Eqs. (1)-(3) too, but only actors whose firing semantics is
    "copy the input token to every output" are MRB-replaceable.
    """

    name: str
    exec_times: Dict[str, int] = field(default_factory=dict)
    multicast: bool = False

    def can_run_on(self, core_type: str) -> bool:
        return core_type in self.exec_times

    def __repr__(self) -> str:  # compact for schedule dumps
        return f"Actor({self.name})"


@dataclass
class Channel:
    """A FIFO channel (or an MRB when it has multiple readers)."""

    name: str
    delay: int = 0          # δ(c): initial tokens
    capacity: int = 1       # γ(c): max tokens
    token_bytes: int = 1    # φ(c): bytes per token
    is_mrb: bool = False    # set by the MRB replacement transform

    @property
    def bytes(self) -> int:
        """Memory footprint contribution γ(c)·φ(c)."""
        return self.capacity * self.token_bytes

    def __repr__(self) -> str:
        return f"Channel({self.name}, δ={self.delay}, γ={self.capacity}, φ={self.token_bytes})"


# Edge-task identifiers used throughout scheduling:  a write task is the pair
# (actor, channel) ∈ E_O and a read task is (channel, actor) ∈ E_I.  We tag
# them so task identity is unambiguous in utilization sets.
WriteEdge = Tuple[str, str]  # (actor, channel)
ReadEdge = Tuple[str, str]   # (channel, actor)


class ApplicationGraph:
    """Bipartite actor/channel graph with marked-graph (or multi-rate) firing.

    Edge sets (paper):
        E_O ⊆ A × C   actor -> channel   (writes)
        E_I ⊆ C × A   channel -> actor   (reads)
    """

    def __init__(self, name: str = "app") -> None:
        self.name = name
        self.actors: Dict[str, Actor] = {}
        self.channels: Dict[str, Channel] = {}
        # producer[c] -> actor name (exactly one writer per channel)
        self.producer: Dict[str, str] = {}
        # consumers[c] -> ordered list of reader actor names (>=1; >1 ⇒ MRB)
        self.consumers: Dict[str, List[str]] = {}
        # multi-rate annotations: tokens produced/consumed per firing per edge.
        self.prod_rate: Dict[Tuple[str, str], int] = {}  # (actor, channel) -> ψ
        self.cons_rate: Dict[Tuple[str, str], int] = {}  # (channel, actor) -> κ

    # ------------------------------------------------------------------ build
    def add_actor(
        self,
        name: str,
        exec_times: Optional[Dict[str, int]] = None,
        *,
        multicast: bool = False,
    ) -> Actor:
        if name in self.actors:
            raise ValueError(f"duplicate actor {name!r}")
        a = Actor(name, dict(exec_times or {}), multicast)
        self.actors[name] = a
        return a

    def add_channel(
        self,
        name: str,
        src: str,
        dsts: Sequence[str] | str,
        *,
        delay: int = 0,
        capacity: int = 1,
        token_bytes: int = 1,
        is_mrb: bool = False,
        prod_rate: int = 1,
        cons_rates: Optional[Dict[str, int]] = None,
    ) -> Channel:
        if name in self.channels:
            raise ValueError(f"duplicate channel {name!r}")
        if isinstance(dsts, str):
            dsts = [dsts]
        if src not in self.actors:
            raise ValueError(f"unknown producer actor {src!r}")
        for d in dsts:
            if d not in self.actors:
                raise ValueError(f"unknown consumer actor {d!r}")
        if len(dsts) == 0:
            raise ValueError("channel needs at least one reader")
        c = Channel(name, delay, capacity, token_bytes, is_mrb or len(dsts) > 1)
        self.channels[name] = c
        self.producer[name] = src
        self.consumers[name] = list(dsts)
        self.prod_rate[(src, name)] = prod_rate
        for d in dsts:
            self.cons_rate[(name, d)] = (cons_rates or {}).get(d, 1)
        return c

    def copy(self) -> "ApplicationGraph":
        g = ApplicationGraph(self.name)
        g.actors = {k: copy.deepcopy(v) for k, v in self.actors.items()}
        g.channels = {k: copy.deepcopy(v) for k, v in self.channels.items()}
        g.producer = dict(self.producer)
        g.consumers = {k: list(v) for k, v in self.consumers.items()}
        g.prod_rate = dict(self.prod_rate)
        g.cons_rate = dict(self.cons_rate)
        return g

    # ------------------------------------------------------------ edge views
    def write_edges(self, actor: Optional[str] = None) -> List[WriteEdge]:
        """E_O, optionally filtered to one actor, in deterministic order."""
        out = [
            (self.producer[c], c)
            for c in self.channels
            if actor is None or self.producer[c] == actor
        ]
        return out

    def read_edges(self, actor: Optional[str] = None) -> List[ReadEdge]:
        """E_I, optionally filtered to one actor, in deterministic order."""
        out: List[ReadEdge] = []
        for c, readers in self.consumers.items():
            for r in readers:
                if actor is None or r == actor:
                    out.append((c, r))
        return out

    def in_channels(self, actor: str) -> List[str]:
        return [c for c, readers in self.consumers.items() if actor in readers]

    def out_channels(self, actor: str) -> List[str]:
        return [c for c, p in self.producer.items() if p == actor]

    def predecessors(self, actor: str) -> Set[str]:
        return {self.producer[c] for c in self.in_channels(actor)}

    def successors(self, actor: str) -> Set[str]:
        succ: Set[str] = set()
        for c in self.out_channels(actor):
            succ.update(self.consumers[c])
        return succ

    # ---------------------------------------------------------------- checks
    def validate(self) -> None:
        for c, readers in self.consumers.items():
            if len(readers) != len(set(readers)):
                raise ValueError(f"channel {c} lists a reader twice")
        for name, ch in self.channels.items():
            if ch.capacity < 1:
                raise ValueError(f"channel {name} capacity must be >= 1")
            if ch.delay < 0:
                raise ValueError(f"channel {name} negative delay")
        # Every actor reachable as producer or consumer of some channel, or
        # isolated (allowed but flagged elsewhere).

    @property
    def memory_footprint(self) -> int:
        """M_F = Σ_c γ(c)·φ(c) (paper Eq. 24)."""
        return sum(ch.bytes for ch in self.channels.values())

    # ------------------------------------------------------------- serialize
    def to_dict(self) -> Dict:
        """Plain-data form (JSON-safe); inverse of :meth:`from_dict`."""
        return {
            "name": self.name,
            "actors": {
                a: {"exec_times": dict(v.exec_times), "multicast": v.multicast}
                for a, v in sorted(self.actors.items())
            },
            "channels": {
                c: {
                    "src": self.producer[c],
                    "dsts": list(self.consumers[c]),
                    "delay": ch.delay,
                    "capacity": ch.capacity,
                    "token_bytes": ch.token_bytes,
                    "is_mrb": ch.is_mrb,
                    "prod_rate": self.prod_rate[(self.producer[c], c)],
                    "cons_rates": {r: self.cons_rate[(c, r)] for r in self.consumers[c]},
                }
                for c, ch in sorted(self.channels.items())
            },
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "ApplicationGraph":
        g = cls(d.get("name", "app"))
        for a, spec in d["actors"].items():
            g.add_actor(a, spec["exec_times"], multicast=spec.get("multicast", False))
        for c, spec in d["channels"].items():
            g.add_channel(
                c,
                spec["src"],
                spec["dsts"],
                delay=spec.get("delay", 0),
                capacity=spec.get("capacity", 1),
                token_bytes=spec.get("token_bytes", 1),
                is_mrb=spec.get("is_mrb", False),
                prod_rate=spec.get("prod_rate", 1),
                cons_rates=spec.get("cons_rates"),
            )
        return g

    def signature(self) -> str:
        """Stable content digest of the graph structure (order-independent,
        name excluded): equal signatures ⇔ structurally identical graphs."""
        import hashlib
        import json

        d = self.to_dict()
        d.pop("name", None)
        blob = json.dumps(d, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()


def satisfies_multicast_structure(g: ApplicationGraph, a: str) -> bool:
    """Structural conditions Eqs. (1)-(3): exactly one input channel, ≥1
    output channels, identical token sizes in/out, zero initial tokens on
    outputs, and identical output capacities."""
    ins = g.in_channels(a)
    outs = g.out_channels(a)
    if len(ins) != 1 or len(outs) < 1:
        return False
    cin = g.channels[ins[0]]
    kouts = [g.channels[c] for c in outs]
    if any(co.token_bytes != cin.token_bytes for co in kouts):
        return False  # Eq. (2)
    if any(co.delay != 0 for co in kouts):
        return False  # Eq. (3)
    if len({co.capacity for co in kouts}) != 1:
        return False  # Eq. (3)
    return True


def multicast_actors(g: ApplicationGraph) -> List[str]:
    """A_M: actors flagged ``multicast`` by the builder; each must satisfy
    the structural Eqs. (1)-(3) (enforced — a violation is a model bug)."""
    result = []
    for a, actor in g.actors.items():
        if not actor.multicast:
            continue
        if not satisfies_multicast_structure(g, a):
            raise ValueError(f"actor {a} flagged multicast but violates Eqs. (1)-(3)")
        result.append(a)
    return result


def topological_priorities(g: ApplicationGraph) -> Dict[str, int]:
    """Priority z_a = topological order of actors (higher = earlier).

    Edges through channels with initial tokens (δ ≥ 1) are *not* precedence
    edges within an iteration (the dependency is on the previous iteration),
    which also makes cyclic marked graphs schedulable.
    """
    adj: Dict[str, Set[str]] = {a: set() for a in g.actors}
    indeg: Dict[str, int] = {a: 0 for a in g.actors}
    for c, readers in g.consumers.items():
        if g.channels[c].delay >= 1:
            continue
        p = g.producer[c]
        for r in readers:
            if r not in adj[p]:
                adj[p].add(r)
                indeg[r] += 1
    # Kahn, deterministic by name.
    ready = sorted([a for a, d in indeg.items() if d == 0])
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
    if len(order) != len(g.actors):
        raise ValueError("zero-delay cycle: graph not schedulable (needs initial tokens)")
    n = len(order)
    # Higher priority = earlier in topological order (descending sort later).
    return {a: n - i for i, a in enumerate(order)}
