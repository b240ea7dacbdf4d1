"""Schedule mutations for the verifier's negative test suite.

Each mutation takes a *known-good* schedule and breaks exactly one
constraint class, returning a perturbed deep copy (or ``None`` when the
schedule has nothing to perturb — e.g. no two actors share a core).  The
conformance harness asserts that the verifier flags every applicable
mutation with the expected :class:`~repro_torch.verify.verifier.Violation` kind —
a checker that silently passes a broken schedule is itself broken.

Registered classes (``MUTATIONS``: name → (fn, expected kind)):

``overlap_tasks``      shift one actor's whole window onto a core-mate's
                       execution → ``resource_overlap``
``break_dependency``   move a read before its producing write finishes
                       (minus the δ·P credit) → ``edge_dependency``
``shrink_buffer``      drop a channel capacity below its token-lifetime
                       requirement → ``buffer_capacity``
``duplicate_mrb_copy`` add a phantom second binding/capacity entry for an
                       MRB channel → ``mrb_single_copy``
``swap_window_order``  start a write before its actor's execution ends
                       → ``window_order``
"""
from __future__ import annotations

import copy
import random
from typing import Callable, Dict, Optional, Tuple

from ..core.architecture import ArchitectureGraph
from ..core.graph import ApplicationGraph
from ..core.mrb import mrb_channel_name
from ..core.schedule import Schedule, actor_exec_time

__all__ = ["MUTATIONS", "mutation_names", "apply_mutation"]

MutationFn = Callable[
    [ApplicationGraph, ArchitectureGraph, Schedule, random.Random],
    Optional[Schedule],
]


def _clone(sched: Schedule) -> Schedule:
    return copy.deepcopy(sched)


def mutate_overlap_tasks(
    g: ApplicationGraph, arch: ArchitectureGraph, sched: Schedule, rng: random.Random
) -> Optional[Schedule]:
    """Shift every task of one actor so its execution starts exactly when a
    core-mate's execution starts: a guaranteed core conflict."""
    by_core: Dict[str, list] = {}
    for a, core in sched.actor_binding.items():
        by_core.setdefault(core, []).append(a)
    pairs = [sorted(actors)[:2] for actors in by_core.values() if len(actors) >= 2]
    if not pairs:
        return None
    a, b = rng.choice(sorted(pairs))
    m = _clone(sched)
    delta = m.times.actor_start[a] - m.times.actor_start[b]
    m.times.actor_start[b] += delta
    for key in list(m.times.read_start):
        if key[1] == b:
            m.times.read_start[key] += delta
    for key in list(m.times.write_start):
        if key[0] == b:
            m.times.write_start[key] += delta
    return m


def mutate_break_dependency(
    g: ApplicationGraph, arch: ArchitectureGraph, sched: Schedule, rng: random.Random
) -> Optional[Schedule]:
    """Start one read strictly before its producing write's finish minus the
    δ·P pipelining credit — the tightest possible Eq. 16 violation."""
    candidates = sorted(c for c in g.channels if g.consumers[c])
    if not candidates:
        return None
    # δ=0 edges need only a one-unit shift — the least collateral damage.
    zero_delay = [c for c in candidates if g.channels[c].delay == 0]
    c = rng.choice(zero_delay or candidates)
    r = sorted(g.consumers[c])[0]
    prod = g.producer[c]
    m = _clone(sched)
    mem = m.channel_binding[c]
    tau_w = arch.comm_time(g.channels[c].token_bytes, m.actor_binding[prod], mem)
    fin_w = m.times.write_start[(prod, c)] + tau_w
    m.times.read_start[(c, r)] = fin_w - g.channels[c].delay * m.period - 1
    return m


def mutate_shrink_buffer(
    g: ApplicationGraph, arch: ArchitectureGraph, sched: Schedule, rng: random.Random
) -> Optional[Schedule]:
    """Shrink one channel's capacity below the δ + ⌊(F−s_w)/P⌋ + 1 tokens
    its modulo schedule keeps alive."""
    m = _clone(sched)
    for c in sorted(g.channels, key=lambda c: (g.channels[c].delay, c), reverse=True):
        prod = g.producer[c]
        mem = m.channel_binding[c]
        fins = [
            m.times.read_start[(c, r)]
            + arch.comm_time(g.channels[c].token_bytes, m.actor_binding[r], mem)
            for r in g.consumers[c]
        ]
        if not fins:
            continue
        needed = (
            g.channels[c].delay
            + (max(fins) - m.times.write_start[(prod, c)]) // m.period
            + 1
        )
        m.capacities[c] = max(0, needed - 1)
        return m
    return None


def mutate_duplicate_mrb_copy(
    g: ApplicationGraph, arch: ArchitectureGraph, sched: Schedule, rng: random.Random
) -> Optional[Schedule]:
    """Add a phantom second copy of an MRB buffer (binding + capacity under
    a fresh name), defeating the single-copy invariant the MRB substitution
    exists to provide.  Applicable only when the graph has an MRB."""
    mrbs = sorted(c for c, ch in g.channels.items() if ch.is_mrb)
    if not mrbs:
        return None
    c = rng.choice(mrbs)
    m = _clone(sched)
    copy_name = mrb_channel_name(sorted(g.consumers[c]) + ["copy2"])
    m.channel_binding[copy_name] = m.channel_binding[c]
    m.capacities[copy_name] = m.capacities[c]
    return m


def mutate_swap_window_order(
    g: ApplicationGraph, arch: ArchitectureGraph, sched: Schedule, rng: random.Random
) -> Optional[Schedule]:
    """Start one write one unit before its actor's execution ends (Eq. 18)."""
    keys = sorted(sched.times.write_start)
    if not keys:
        return None
    a, c = rng.choice(keys)
    m = _clone(sched)
    end = m.times.actor_start[a] + actor_exec_time(g, arch, m.actor_binding, a)
    m.times.write_start[(a, c)] = end - 1
    return m


MUTATIONS: Dict[str, Tuple[MutationFn, str]] = {
    "overlap_tasks": (mutate_overlap_tasks, "resource_overlap"),
    "break_dependency": (mutate_break_dependency, "edge_dependency"),
    "shrink_buffer": (mutate_shrink_buffer, "buffer_capacity"),
    "duplicate_mrb_copy": (mutate_duplicate_mrb_copy, "mrb_single_copy"),
    "swap_window_order": (mutate_swap_window_order, "window_order"),
}


def mutation_names() -> Tuple[str, ...]:
    return tuple(sorted(MUTATIONS))


def apply_mutation(
    name: str,
    g: ApplicationGraph,
    arch: ArchitectureGraph,
    sched: Schedule,
    rng: random.Random,
) -> Optional[Schedule]:
    """Apply one registered mutation; returns None when not applicable."""
    fn, _expected = MUTATIONS[name]
    return fn(g, arch, sched, rng)
