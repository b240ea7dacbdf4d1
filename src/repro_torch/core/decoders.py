"""Decoder protocol and registry (paper Fig. 6's "decode" step).

A *decoder* turns the genotype-derived inputs — the ξ-transformed graph
g̃_A, the architecture, per-channel placement decisions C_d, and the actor
binding β_A — into a phenotype (a :class:`~repro_torch.core.schedule.Schedule`
plus feasibility).  The paper evaluates two: the CAPS-HMS list-scheduling
heuristic (§IV) and the exact branch-and-bound "ILP" (§V); this package
registers the CAPS-HMS heuristic, and an unknown name raises.

A decoder is any callable with the :class:`Decoder` signature, registered
by name:

    @register_decoder("my_decoder")
    def decode_my_way(g, arch, decisions, actor_binding, *, time_budget_s=None):
        ...
        return DecodeResult(schedule, feasible)

Everything that decodes — `evaluate_genotype`, `EvaluationEngine`, the
explorers — resolves names through :func:`get_decoder`, so a new scheduler
plugs in without touching the core.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Protocol, runtime_checkable

from .architecture import ArchitectureGraph
from .caps_hms import decode_via_heuristic
from .graph import ApplicationGraph

__all__ = [
    "Decoder",
    "DECODERS",
    "register_decoder",
    "get_decoder",
    "decoder_names",
]


@runtime_checkable
class Decoder(Protocol):
    """Callable signature every registered decoder satisfies.

    Returns any object with ``feasible: bool`` and ``schedule:
    Optional[Schedule]`` attributes (e.g. ``DecodeResult``/``ExactResult``).
    If the result exposes a ``period``, it must be ``math.inf`` — never a
    negative sentinel — when the decode is infeasible, so period
    comparisons in ad-hoc consumers order infeasible phenotypes last
    (matching ``infeasible_objectives`` at the ``EvalContext`` boundary).
    ``time_budget_s`` is advisory: anytime decoders honour it, exhaustive
    heuristics may ignore it.
    """

    def __call__(
        self,
        g: ApplicationGraph,
        arch: ArchitectureGraph,
        decisions: Dict[str, str],
        actor_binding: Dict[str, str],
        *,
        time_budget_s: Optional[float] = None,
    ) -> object: ...


DECODERS: Dict[str, Decoder] = {}


def register_decoder(name: str) -> Callable[[Decoder], Decoder]:
    """Register a decoder under ``name`` (decorator).  Re-registration
    replaces the entry, so tests can shadow a decoder and restore it.
    Callables that do not accept ``time_budget_s`` are adapted."""

    def deco(fn: Decoder) -> Decoder:
        DECODERS[name] = _adapt(fn)
        return fn

    return deco


def get_decoder(name_or_fn) -> Decoder:
    """Resolve a decoder by registry name; callables pass through (adapted
    to tolerate a missing ``time_budget_s`` keyword, so raw decode
    functions like ``decode_via_heuristic`` work unwrapped)."""
    if callable(name_or_fn):
        return _adapt(name_or_fn)
    try:
        return DECODERS[name_or_fn]
    except KeyError:
        raise KeyError(
            f"unknown decoder {name_or_fn!r}; registered: {decoder_names()}"
        ) from None


def _adapt(fn: Callable) -> Decoder:
    """Wrap an ad-hoc callable that does not accept ``time_budget_s``."""
    import inspect

    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        return fn
    if any(
        p.name == "time_budget_s" or p.kind is inspect.Parameter.VAR_KEYWORD
        for p in params
    ):
        return fn

    def dropping_budget(g, arch, decisions, actor_binding, *, time_budget_s=None):
        return fn(g, arch, decisions, actor_binding)

    return dropping_budget


def decoder_names() -> List[str]:
    return sorted(DECODERS)


# --------------------------------------------------------------- built-ins
@register_decoder("caps_hms")
def _decode_caps_hms(
    g: ApplicationGraph,
    arch: ArchitectureGraph,
    decisions: Dict[str, str],
    actor_binding: Dict[str, str],
    *,
    time_budget_s: Optional[float] = None,
) -> object:
    """CAPS-HMS heuristic (paper §IV); the budget is ignored — the
    heuristic always terminates quickly."""
    return decode_via_heuristic(g, arch, decisions, actor_binding)
