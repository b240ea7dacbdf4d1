"""Carry the JAX package's serialized state over to the port's objects.

The system has no weights: its state is the application graph, the
architecture, a decoded schedule and the exploration problem, all of which
both packages serialize to plain JSON-safe dicts.  These functions take
those dicts and return the port's objects, so a test can build state with
the reference, carry it across, and compare — without the port importing
the reference.
"""
from __future__ import annotations

from typing import Any, Dict, Union

from .core.architecture import ArchitectureGraph
from .core.explorers import ExplorationRun
from .core.graph import ApplicationGraph
from .core.problem import ExplorationProblem
from .core.schedule import Schedule

__all__ = [
    "graph_from_dict",
    "arch_from_dict",
    "schedule_from_json",
    "problem_from_json",
    "run_from_json",
]

Json = Union[str, Dict[str, Any]]


def graph_from_dict(d: Dict[str, Any]) -> ApplicationGraph:
    """An ``ApplicationGraph.to_dict()`` of either package."""
    return ApplicationGraph.from_dict(d)


def arch_from_dict(d: Dict[str, Any]) -> ArchitectureGraph:
    """An ``ArchitectureGraph.to_dict()`` of either package."""
    return ArchitectureGraph.from_dict(d)


def schedule_from_json(d: Dict[str, Any]) -> Schedule:
    """A ``Schedule.to_json()`` of either package."""
    return Schedule.from_json(d)


def problem_from_json(d: Json) -> ExplorationProblem:
    """An ``ExplorationProblem.to_json()`` with the graphs embedded."""
    return ExplorationProblem.from_json(d)


def run_from_json(d: Json) -> ExplorationRun:
    """An ``ExplorationRun.to_json()``: problem, archive and trajectory."""
    return ExplorationRun.from_json(d)
