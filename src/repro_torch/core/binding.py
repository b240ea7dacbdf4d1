"""Actor/channel bindings and channel decisions (paper §III-B, Algorithm 2).

An implementation binds
  * each actor to exactly one core           β_A ⊆ M_A   (Eq. 6)
  * each channel to exactly one memory       β_C ⊆ M_C   (Eq. 7)
subject to memory capacities W_q             (Eq. 8).

Channel bindings are not explored directly.  Instead a *channel decision*
C_d : C → {PROD, TILE-PROD, CONS, TILE-CONS, GLOBAL} is explored and
Algorithm 2 derives concrete bindings with the capacity-overflow fallback
chain  PROD → TILE-PROD → GLOBAL  and  CONS → TILE-CONS → GLOBAL.

For channels with multiple readers (MRBs) the "consumer" side used by the
CONS/TILE-CONS decisions is the *first* reader (deterministic); this is the
natural generalization — the paper's multi-cast output channels always have
exactly one reader each, and an MRB has many, so a CONS placement pins the
buffer next to one designated reader.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .architecture import ArchitectureGraph
from .graph import ApplicationGraph

__all__ = [
    "CHANNEL_DECISIONS",
    "Binding",
    "determine_channel_bindings",
    "allocation",
    "core_cost",
    "memory_footprint",
    "validate_binding",
]

# Order matters: integer genes index into this tuple.
CHANNEL_DECISIONS: Tuple[str, ...] = (
    "PROD",
    "TILE-PROD",
    "CONS",
    "TILE-CONS",
    "GLOBAL",
)


@dataclass
class Binding:
    """A complete binding β = β_A ∪ β_C."""

    actor_to_core: Dict[str, str] = field(default_factory=dict)   # β_A
    channel_to_mem: Dict[str, str] = field(default_factory=dict)  # β_C

    def core_of(self, actor: str) -> str:
        return self.actor_to_core[actor]

    def memory_of(self, channel: str) -> str:
        return self.channel_to_mem[channel]


def determine_channel_bindings(
    g: ApplicationGraph,
    arch: ArchitectureGraph,
    decisions: Dict[str, str],
    capacities: Dict[str, int],
    actor_binding: Dict[str, str],
) -> Dict[str, str]:
    """Algorithm 2: derive β_C from C_d, γ, and β_A.

    ``capacities`` is the (possibly enlarged) channel capacity function γ.
    Returns channel → memory name.  Deterministic channel order (sorted)
    keeps the greedy capacity accounting reproducible.
    """
    usage: Dict[str, int] = {q: 0 for q in arch.memories}
    beta_c: Dict[str, str] = {}

    def try_bind(c: str, need: int, mem: str) -> bool:
        cap = arch.memories[mem].capacity
        if usage[mem] + need <= cap:
            beta_c[c] = mem
            usage[mem] += need
            return True
        return False

    for c in sorted(g.channels):
        ch = g.channels[c]
        need = capacities.get(c, ch.capacity) * ch.token_bytes
        a_prod = g.producer[c]
        p_prod = actor_binding[a_prod]
        t_prod = arch.cores[p_prod].tile
        a_cons = g.consumers[c][0]
        p_cons = actor_binding[a_cons]
        t_cons = arch.cores[p_cons].tile
        d = decisions.get(c, "GLOBAL")

        if d == "PROD":
            if try_bind(c, need, arch.core_local_memory(p_prod)):
                continue
            d = "TILE-PROD"  # fallback
        if d == "TILE-PROD":
            if try_bind(c, need, arch.tile_local_memory(t_prod)):
                continue
            beta_c[c] = arch.global_memory
            usage[arch.global_memory] += need
            continue
        if d == "CONS":
            if try_bind(c, need, arch.core_local_memory(p_cons)):
                continue
            d = "TILE-CONS"  # fallback
        if d == "TILE-CONS":
            if try_bind(c, need, arch.tile_local_memory(t_cons)):
                continue
            beta_c[c] = arch.global_memory
            usage[arch.global_memory] += need
            continue
        # GLOBAL (assumed large enough — paper assumption)
        beta_c[c] = arch.global_memory
        usage[arch.global_memory] += need
    return beta_c


def allocation(arch: ArchitectureGraph, actor_binding: Dict[str, str]) -> Dict[str, int]:
    """α(ϑ) = number of allocated cores of each type (paper Eq. 9)."""
    used = set(actor_binding.values())
    alloc: Dict[str, int] = {t: 0 for t in arch.core_types()}
    for p in used:
        alloc[arch.cores[p].ctype] += 1
    return alloc


def core_cost(arch: ArchitectureGraph, actor_binding: Dict[str, str]) -> float:
    """K = Σ_ϑ α(ϑ)·K_ϑ (paper Eq. 25)."""
    alloc = allocation(arch, actor_binding)
    return sum(n * arch.core_cost(t) for t, n in alloc.items())


def memory_footprint(g: ApplicationGraph, capacities: Optional[Dict[str, int]] = None) -> int:
    """M_F = Σ_c γ(c)·φ(c) (paper Eq. 24), with optional enlarged γ."""
    total = 0
    for c, ch in g.channels.items():
        gamma = (capacities or {}).get(c, ch.capacity)
        total += gamma * ch.token_bytes
    return total


def validate_binding(
    g: ApplicationGraph,
    arch: ArchitectureGraph,
    binding: Binding,
    capacities: Optional[Dict[str, int]] = None,
) -> List[str]:
    """Check Eqs. (6)-(8).  Returns a list of violation strings (empty = ok)."""
    errs: List[str] = []
    for a, actor in g.actors.items():
        p = binding.actor_to_core.get(a)
        if p is None:
            errs.append(f"actor {a} unbound")
            continue
        ctype = arch.cores[p].ctype
        if not actor.can_run_on(ctype):
            errs.append(f"actor {a} bound to incompatible core type {ctype}")
    usage: Dict[str, int] = {}
    for c, ch in g.channels.items():
        q = binding.channel_to_mem.get(c)
        if q is None:
            errs.append(f"channel {c} unbound")
            continue
        gamma = (capacities or {}).get(c, ch.capacity)
        usage[q] = usage.get(q, 0) + gamma * ch.token_bytes
    for q, used in usage.items():
        if used > arch.memories[q].capacity:
            errs.append(f"memory {q} over capacity: {used} > {arch.memories[q].capacity}")
    return errs
