"""Decoder conformance: the differential sweep of generated scenarios against
the independent schedule verifier.

For every (generated scenario × decoder) pair the sweep draws seeded random
mappings on the MRB-substituted, pipelined graph, decodes them, and runs
every feasible schedule through :func:`~repro_torch.verify.verifier.verify_schedule`.
A correct decoder produces *zero* violations — the verifier shares no
scheduling code with either decoder, so agreement here is the repo's
ground-truth conformance statement (ROADMAP: "independent schedule
verifier").  The report is plain JSON: per-pair counts plus every violation
record, suitable for the CI artifact upload.
"""
from __future__ import annotations

import random
from typing import Any, Dict, List, Optional, Sequence

from ..core.binding import CHANNEL_DECISIONS
from ..core.decoders import get_decoder
from ..core.dse import GenotypeSpace, transformed_graph
from ..scenarios import SIZE_TIERS, harmonized, sample_scenarios
from ..scenarios.families import FAMILIES
from .verifier import verify_schedule

__all__ = ["differential_sweep", "verify_scenario_decoder"]

DEFAULT_DECODERS = ("caps_hms", "ilp")


def verify_scenario_decoder(
    scenario,
    decoder: str,
    *,
    samples: int = 3,
    tries: int = 60,
    ilp_budget_s: float = 1.0,
    seed: int = 0,
    harmonic: bool = False,
) -> Dict[str, Any]:
    """Decode ``samples`` seeded random mappings of one scenario with one
    registered decoder and verify each feasible schedule.  Returns a JSON
    row: counts plus the violation records (empty ⇔ conformant)."""
    if harmonic:
        scenario = harmonized(scenario)
    g, arch = scenario.build()
    space = GenotypeSpace(g, arch)
    # All multicasts MRB-substituted and pipelined: the decoder-facing graph.
    gt = transformed_graph(space, tuple(1 for _ in space.mcast), True)
    decode = get_decoder(decoder)
    rng = random.Random(f"verify:{scenario.name}:{decoder}:{seed}")
    cores = sorted(arch.cores)
    checked = feasible = 0
    violations: List[Dict[str, Any]] = []
    for _ in range(tries):
        if checked >= samples:
            break
        ba = {
            a: rng.choice(
                [p for p in cores if gt.actors[a].can_run_on(arch.cores[p].ctype)]
            )
            for a in gt.actors
        }
        cd = {c: rng.choice(CHANNEL_DECISIONS) for c in gt.channels}
        res = decode(gt, arch, cd, ba, time_budget_s=ilp_budget_s)
        if not res.feasible:
            continue
        checked += 1
        feasible += 1
        report = verify_schedule(gt, arch, res.schedule)
        for v in report.violations:
            violations.append(dict(v.to_json(), period=res.schedule.period))
    return {
        "scenario": scenario.name,
        "decoder": decoder,
        "checked": checked,
        "feasible": feasible,
        "n_violations": len(violations),
        "violations": violations,
    }


def differential_sweep(
    *,
    seed: int = 0,
    families: Optional[Sequence[str]] = None,
    sizes: Sequence[str] = ("standard",),
    per_family: int = 1,
    samples: int = 3,
    decoders: Sequence[str] = DEFAULT_DECODERS,
    ilp_budget_s: float = 1.0,
    harmonic: bool = False,
) -> Dict[str, Any]:
    """Run :func:`verify_scenario_decoder` over generated scenarios ×
    ``sizes`` × ``decoders`` and fold the rows into one JSON report with a
    total violation count (``ok`` ⇔ zero across the whole sweep)."""
    families = sorted(families) if families else sorted(FAMILIES)
    for size in sizes:
        if size not in SIZE_TIERS:
            raise KeyError(f"unknown size tier {size!r}; known: {sorted(SIZE_TIERS)}")
    rows: List[Dict[str, Any]] = []
    for size in sizes:
        for family in families:
            scenarios = sample_scenarios(
                seed=seed, n=per_family, families=[family], size=size
            )
            for sc in scenarios:
                for decoder in decoders:
                    row = verify_scenario_decoder(
                        sc, decoder,
                        samples=samples, ilp_budget_s=ilp_budget_s,
                        seed=seed, harmonic=harmonic,
                    )
                    row["size"] = size
                    rows.append(row)
    total = sum(r["n_violations"] for r in rows)
    return {
        "seed": seed,
        "families": list(families),
        "sizes": list(sizes),
        "decoders": list(decoders),
        "harmonic": harmonic,
        "rows": rows,
        "n_checked": sum(r["checked"] for r in rows),
        "n_violations": total,
        "ok": total == 0,
    }
