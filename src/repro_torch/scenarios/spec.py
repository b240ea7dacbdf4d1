"""Serializable, seeded scenario specifications.

A :class:`Scenario` pairs an application-graph spec (family + params +
seed) with an architecture spec (:class:`~repro_torch.scenarios.archs.ArchParams`
+ seed).  Specs are plain data: JSON round-trippable, hashable, and
deterministic — ``spec.build()`` always returns structurally identical
graphs (verified via ``ApplicationGraph.signature()``).

This is the unit the benchmarks sweep over and the test strategies draw.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from ..core.architecture import ArchitectureGraph
from ..core.graph import ApplicationGraph
from .archs import ArchParams, generate_architecture
from .families import FAMILIES, build as build_app

__all__ = [
    "AppSpec",
    "Scenario",
    "harmonized",
    "scenario_from_json",
    "validate_scenario",
]


def _freeze(params: Dict[str, Any]) -> Tuple[Tuple[str, Any], ...]:
    return tuple(sorted(params.items()))


@dataclass(frozen=True)
class AppSpec:
    family: str
    seed: int = 0
    params: Tuple[Tuple[str, Any], ...] = ()

    @classmethod
    def make(cls, family: str, seed: int = 0, **params: Any) -> "AppSpec":
        if family not in FAMILIES:
            raise KeyError(f"unknown family {family!r}")
        return cls(family, seed, _freeze(params))

    def build(self) -> ApplicationGraph:
        return build_app(self.family, self.seed, dict(self.params))

    def to_json(self) -> Dict[str, Any]:
        return {"family": self.family, "seed": self.seed, "params": dict(self.params)}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "AppSpec":
        return cls.make(d["family"], d.get("seed", 0), **d.get("params", {}))


@dataclass(frozen=True)
class Scenario:
    app: AppSpec
    arch: ArchParams = field(default_factory=ArchParams)
    arch_seed: int = 0

    def build(self) -> Tuple[ApplicationGraph, ArchitectureGraph]:
        return self.app.build(), generate_architecture(self.arch, self.arch_seed)

    # ------------------------------------------------------------- serialize
    def to_json(self) -> Dict[str, Any]:
        from dataclasses import asdict

        return {
            "app": self.app.to_json(),
            "arch": asdict(self.arch),
            "arch_seed": self.arch_seed,
        }

    def dumps(self) -> str:
        return json.dumps(self.to_json(), sort_keys=True)

    @property
    def name(self) -> str:
        return f"{self.app.family}#{self.app.seed}@{self.arch.tiles}x{self.arch.cores_per_tile}"


def harmonized(sc: Scenario) -> Scenario:
    """The harmonic-period variant of a scenario: same family, seeds and
    topology, but execution times quantized to powers of two and tokens
    shrunk to the smallest class (``families.harmonize_graph``), so exact
    decoders can close their period search.  Idempotent."""
    params = dict(sc.app.params)
    params["harmonic"] = True
    return Scenario(
        app=AppSpec.make(sc.app.family, sc.app.seed, **params),
        arch=sc.arch,
        arch_seed=sc.arch_seed,
    )


def scenario_from_json(d: Any) -> Scenario:
    if isinstance(d, str):
        d = json.loads(d)
    return Scenario(
        app=AppSpec.from_json(d["app"]),
        arch=ArchParams(**d.get("arch", {})),
        arch_seed=d.get("arch_seed", 0),
    )


def validate_scenario(g: ApplicationGraph, arch: ArchitectureGraph) -> None:
    """Invariants every generated scenario must satisfy: a valid bipartite
    graph, paper-legal multi-cast actors, and a non-empty genotype space
    (every actor mappable to some core)."""
    from ..core.dse import GenotypeSpace
    from ..core.graph import multicast_actors, topological_priorities

    g.validate()
    multicast_actors(g)
    topological_priorities(g)  # acyclic (or feasibly delayed)
    GenotypeSpace(g, arch)  # raises if an actor has no feasible core
