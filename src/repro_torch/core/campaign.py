"""Declarative multi-problem DSE campaigns (see README "Campaign API").

The paper's results are *campaigns*, not single runs: Pareto fronts swept
over applications × strategies × decoders × backends × seeds and compared
by relative hypervolume.  A :class:`Campaign` states that whole matrix as
plain data — JSON-round-trippable like :class:`~repro_torch.scenarios.Scenario`
and :class:`~repro_torch.core.problem.ExplorationProblem` specs — and a
:class:`CampaignRunner` executes it:

* :meth:`Campaign.expand` turns the matrix (problem templates × axes, with
  per-cell overrides and skips) into an ordered list of
  :class:`CampaignCell`\\ s, each a fully self-contained spec with a
  canonical SHA-256 *spec hash*;
* the runner shards cells across a process pool (``jobs``), grouping the
  cells that may legally share one
  :class:`~repro_torch.core.engine.EvaluationEngine` (same graphs / decoder /
  objectives / engine knobs — e.g. the strategies of one scenario) so the
  decode cache is warm across a group exactly as the hand-rolled sweeps
  shared it;
* every finished cell is written atomically into a
  :class:`~repro_torch.core.runstore.RunStore` keyed by its spec hash, so
  re-running a killed campaign — ``python -m repro_torch campaign resume`` —
  skips completed cells and the final manifest is byte-identical to an
  uninterrupted run;
* :func:`build_report` folds the artifacts into a cross-cell report:
  per-cell fronts, relative hypervolume against the union front of each
  problem group, and per-sim-backend timing.

Cells are executed by registered explorers over registered decoders and
objectives, so a campaign reaches everything the exploration API can
express; fronts are bit-identical to direct
:meth:`~repro_torch.core.explorers.NSGA2Explorer.explore` calls with the same
parameters (regression-tested in ``tests/test_torch_campaign.py``).
"""
from __future__ import annotations

import hashlib
import itertools
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from .pareto import nondominated, relative_hypervolume
from .runstore import RunStore, canonical_json

__all__ = [
    "Campaign",
    "CampaignCell",
    "CampaignResult",
    "CampaignRunner",
    "build_report",
    "DEFAULT_CAMPAIGN_ROOT",
]

DEFAULT_CAMPAIGN_ROOT = os.path.join("runs", "campaigns")

# Axis names a campaign matrix may sweep, in expansion order (the cross
# product is taken in exactly this order, problems outermost, so cell
# ordering — and hence the manifest — is deterministic).
AXES = ("strategy", "decoder", "sim_backend", "seed", "explorer")


# Engine kwargs that never change results, only wall time — excluded from
# spec hashes so a campaign resumes across e.g. --jobs / worker-count
# changes (fronts are bit-identical across all of them, README "Evaluation
# engine").  The engine's ``device`` is one of them: the card and the CPU
# give bit-identical fronts, and keeping it out of the cells keeps a
# spec's hashes, campaign id and manifest bytes those of the JAX package.
PERF_ONLY_ENGINE_KEYS = ("n_workers", "device")


def _result_engine(engine: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in engine.items() if k not in PERF_ONLY_ENGINE_KEYS}


def _merge(base: Dict[str, Any], extra: Dict[str, Any]) -> Dict[str, Any]:
    """One-level-nested dict merge (override values win; nested dicts merge)."""
    out = dict(base)
    for k, v in extra.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = {**out[k], **v}
        else:
            out[k] = v
    return out


# ==========================================================================
@dataclass(frozen=True)
class CampaignCell:
    """One fully-resolved exploration of a campaign matrix.

    ``problem`` is an :class:`ExplorationProblem` JSON dict (scenario-backed
    or with embedded graphs); ``engine`` holds
    :class:`~repro_torch.core.engine.EvaluationEngine` kwargs (including
    ``sim_backend``); ``explorer_params`` feeds
    :func:`~repro_torch.core.explorers.get_explorer` (including ``seed``).
    ``coords`` are the matrix coordinates the cell came from — used for
    override matching, report grouping, and human-readable tags; they do
    not enter the spec hash (the resolved spec is the identity).
    """

    problem: Dict[str, Any]
    explorer: str
    explorer_params: Dict[str, Any]
    engine: Dict[str, Any]
    coords: Dict[str, Any]

    def spec_hash(self) -> str:
        """Canonical content address of everything that determines the
        cell's result.  Stable across dict ordering, campaign renames, and
        runner/performance settings (``jobs``, store layout, and
        perf-only engine knobs like ``n_workers`` are not part of it)."""
        return hashlib.sha256(
            canonical_json(
                {
                    "problem": self.problem,
                    "explorer": self.explorer,
                    "explorer_params": self.explorer_params,
                    "engine": _result_engine(self.engine),
                }
            ).encode()
        ).hexdigest()

    @property
    def tag(self) -> str:
        c = self.coords
        parts = [str(c.get("problem", "?"))]
        strategy = c.get("strategy") or self.problem.get("strategy", "MRB_Explore")
        decoder = c.get("decoder") or self.problem.get("decoder", "caps_hms")
        parts.append(f"{strategy}^{decoder}")
        parts.append(self.explorer)
        if c.get("sim_backend") is not None:
            parts.append(str(c["sim_backend"]))
        if c.get("seed") is not None:
            parts.append(f"s{c['seed']}")
        return "/".join(parts)

    def group_key(self) -> Tuple[str, str]:
        """Report group: cells over the same problem label + objective
        layout are hypervolume-comparable."""
        objectives = self.problem.get("objectives") or []
        return (str(self.coords.get("problem")), canonical_json(list(objectives)))

    def engine_key(self) -> str:
        """Cells with equal keys may share one ``EvaluationEngine``:
        identical graphs, decoder settings, objectives, and engine kwargs —
        only the search (strategy / seed / explorer) differs."""
        p = {k: v for k, v in self.problem.items() if k != "strategy"}
        return canonical_json({"problem": p, "engine": self.engine})

    def to_json(self) -> Dict[str, Any]:
        return {
            "problem": self.problem,
            "explorer": self.explorer,
            "explorer_params": self.explorer_params,
            "engine": self.engine,
            "coords": self.coords,
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "CampaignCell":
        return cls(
            problem=d["problem"],
            explorer=d["explorer"],
            explorer_params=dict(d.get("explorer_params", {})),
            engine=dict(d.get("engine", {})),
            coords=dict(d.get("coords", {})),
        )


# ==========================================================================
@dataclass
class Campaign:
    """A declarative experiment matrix.

    ``problems`` — templates, each an :class:`ExplorationProblem` JSON dict
    plus an optional ``"label"`` (defaults to the scenario/graph name).
    Templates may omit ``strategy``/``decoder`` when the matching axis
    supplies them.

    ``axes`` — ``{"strategy": [...], "decoder": [...], "sim_backend":
    [...], "seed": [...], "explorer": [...]}`` (an ``explorer`` axis value
    replaces the campaign-level explorer for that cell, e.g. to A/B the
    host ``nsga2`` against ``torch_nsga2``); missing axes contribute a single implicit
    cell coordinate (the template/explorer defaults).

    ``overrides`` — expansion rules applied per cell, in order::

        {"match": {"problem": "Sobel", "decoder": "ilp"},
         "set": {"explorer_params": {"time_budget_s": 420},
                 "problem": {"ilp_budget_s": 1.0}}}
        {"match": {"problem": "Multicamera", "decoder": "ilp"},
         "skip": true}

    ``match`` keys compare against cell coordinates (``problem``,
    ``strategy``, ``decoder``, ``sim_backend``, ``seed``); a list value
    matches any member.  ``set`` merges into ``problem`` /
    ``explorer_params`` / ``engine``; ``skip`` drops the cell.

    ``share_engines`` — when true (default), cells that may legally share
    one ``EvaluationEngine`` (same graphs / decoder / objectives / engine
    kwargs) run serially against a shared decode cache, like the
    hand-rolled strategy sweeps did.  Set false when per-cell wall times
    must be cold-cache comparable (fronts are bit-identical either way).
    """

    name: str
    problems: List[Dict[str, Any]]
    axes: Dict[str, List[Any]] = field(default_factory=dict)
    explorer: str = "nsga2"
    explorer_params: Dict[str, Any] = field(default_factory=dict)
    engine: Dict[str, Any] = field(default_factory=dict)
    overrides: List[Dict[str, Any]] = field(default_factory=list)
    share_engines: bool = True

    def __post_init__(self) -> None:
        if not self.problems:
            raise ValueError("a campaign needs at least one problem template")
        unknown = set(self.axes) - set(AXES)
        if unknown:
            raise ValueError(f"unknown campaign axes {sorted(unknown)}; known: {AXES}")
        empty = sorted(a for a, vals in self.axes.items() if not list(vals))
        if empty:
            raise ValueError(
                f"campaign axes {empty} have no values — drop the axis or "
                f"give it at least one value"
            )
        matchable = set(AXES) | {"problem", "explorer"}
        settable = {"problem", "engine", "explorer_params"}
        for ov in self.overrides:
            extra = set(ov) - {"match", "set", "skip"}
            if extra:
                raise ValueError(f"override keys must be match/set/skip, got {sorted(extra)}")
            bad = set(ov.get("match", {})) - matchable
            if bad:
                raise ValueError(
                    f"override matches unknown coordinates {sorted(bad)}; "
                    f"matchable: {sorted(matchable)}"
                )
            bad = set(ov.get("set", {})) - settable
            if bad:
                raise ValueError(
                    f"override sets unknown sections {sorted(bad)}; "
                    f"settable: {sorted(settable)}"
                )

    # ------------------------------------------------------------- identity
    def to_json(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "problems": self.problems,
            "axes": self.axes,
            "explorer": self.explorer,
            "explorer_params": self.explorer_params,
            "engine": self.engine,
            "overrides": self.overrides,
            "share_engines": self.share_engines,
        }

    def dumps(self) -> str:
        return json.dumps(self.to_json(), sort_keys=True, indent=2)

    @classmethod
    def from_json(cls, d: Union[str, Dict[str, Any]]) -> "Campaign":
        if isinstance(d, str):
            d = json.loads(d)
        return cls(
            name=d["name"],
            problems=list(d["problems"]),
            axes={k: list(v) for k, v in d.get("axes", {}).items()},
            explorer=d.get("explorer", "nsga2"),
            explorer_params=dict(d.get("explorer_params", {})),
            engine=dict(d.get("engine", {})),
            overrides=list(d.get("overrides", [])),
            share_engines=bool(d.get("share_engines", True)),
        )

    @classmethod
    def load(cls, path: str) -> "Campaign":
        with open(path) as f:
            return cls.from_json(json.load(f))

    def spec_hash(self) -> str:
        """Campaign identity (store directory key): the spec with the
        perf-only engine knobs stripped — campaign and overrides alike —
        so the same matrix resumes the same store across e.g. different
        worker counts."""
        d = self.to_json()
        d["engine"] = _result_engine(d.get("engine", {}))
        d["overrides"] = [
            {
                **ov,
                **(
                    {"set": {**ov["set"], "engine": _result_engine(ov["set"]["engine"])}}
                    if isinstance(ov.get("set", {}).get("engine"), dict)
                    else {}
                ),
            }
            for ov in d.get("overrides", [])
        ]
        return hashlib.sha256(canonical_json(d).encode()).hexdigest()

    def campaign_id(self) -> str:
        """Stable store-directory name: slug + spec digest, so re-running
        the same spec resumes the same store and an edited spec gets a
        fresh one."""
        slug = "".join(ch if ch.isalnum() or ch in "-_" else "-" for ch in self.name)
        return f"{slug}-{self.spec_hash()[:10]}"

    # ------------------------------------------------------------ expansion
    @staticmethod
    def _problem_label(template: Dict[str, Any]) -> str:
        if "label" in template:
            return str(template["label"])
        if "scenario" in template:
            sc = template["scenario"]
            return f"{sc['app']['family']}#{sc['app'].get('seed', 0)}"
        if "graph" in template:
            return str(template["graph"].get("name", "graph"))
        raise ValueError("problem template needs a 'label', 'scenario', or 'graph'")

    @staticmethod
    def _matches(match: Dict[str, Any], coords: Dict[str, Any]) -> bool:
        for k, want in match.items():
            have = coords.get(k)
            if isinstance(want, list):
                if have not in want:
                    return False
            elif have != want:
                return False
        return True

    def expand(self) -> List[CampaignCell]:
        """The ordered cell list (problems outermost, then ``AXES`` order).
        Deterministic: same spec → same cells → same hashes, always."""
        axis_values = [self.axes.get(a) or [None] for a in AXES]
        cells: List[CampaignCell] = []
        for template in self.problems:
            label = self._problem_label(template)
            base_problem = {k: v for k, v in template.items() if k != "label"}
            for combo in itertools.product(*axis_values):
                coords: Dict[str, Any] = {"problem": label, "explorer": self.explorer}
                problem = dict(base_problem)
                engine = dict(self.engine)
                params = dict(self.explorer_params)
                explorer = self.explorer
                for axis, value in zip(AXES, combo):
                    if value is None and axis not in self.axes:
                        continue
                    coords[axis] = value
                    if axis in ("strategy", "decoder"):
                        problem[axis] = value
                    elif axis == "sim_backend":
                        engine["sim_backend"] = value
                    elif axis == "seed":
                        params["seed"] = value
                    elif axis == "explorer":
                        explorer = value
                skip = False
                for ov in self.overrides:
                    if not self._matches(ov.get("match", {}), coords):
                        continue
                    if ov.get("skip"):
                        skip = True
                        break
                    s = ov.get("set", {})
                    problem = _merge(problem, s.get("problem", {}))
                    engine = _merge(engine, s.get("engine", {}))
                    params = _merge(params, s.get("explorer_params", {}))
                if skip:
                    continue
                cells.append(
                    CampaignCell(
                        problem=problem,
                        explorer=explorer,
                        explorer_params=params,
                        engine=engine,
                        coords=coords,
                    )
                )
        return cells

    def manifest(self) -> Dict[str, Any]:
        """The deterministic campaign manifest: spec + ordered cell list."""
        return {
            "campaign_id": self.campaign_id(),
            "spec_hash": self.spec_hash(),
            "campaign": self.to_json(),
            "cells": [
                {"tag": c.tag, "spec_hash": c.spec_hash(), "coords": c.coords}
                for c in self.expand()
            ],
        }


# ==========================================================================
def run_cell(cell: CampaignCell, engine=None) -> Dict[str, Any]:
    """Execute one cell: problem from JSON, engine, registered explorer.
    Returns the cell artifact payload (cell spec + serialized run)."""
    from .explorers import get_explorer
    from .problem import ExplorationProblem

    problem = ExplorationProblem.from_json(cell.problem)
    explorer = get_explorer(cell.explorer, **cell.explorer_params)
    own_engine = engine is None
    if engine is None:
        engine = problem.make_engine(**cell.engine)
    try:
        run = explorer.explore(problem, engine=engine)
    finally:
        if own_engine:
            engine.close()
    return {
        "spec_hash": cell.spec_hash(),
        "tag": cell.tag,
        "cell": cell.to_json(),
        "run": run.to_json(),
    }


# ==========================================================================
def _verify_cell(cell: "CampaignCell", run: Dict[str, Any], limit: int) -> Dict[str, Any]:
    """Re-decode up to ``limit`` archived genotypes with the cell's own
    decoder and run each feasible schedule through the independent verifier
    (README "Schedule verification")."""
    from .dse import Genotype, GenotypeSpace, evaluate_genotype, transformed_graph
    from .problem import ExplorationProblem
    from ..verify import verify_schedule  # function-level: keeps core import-light

    problem = ExplorationProblem.from_json(cell.problem)
    space = GenotypeSpace(problem.graph, problem.arch)
    checked = 0
    violations = 0
    kinds: set = set()
    for entry in run.get("archive", [])[: max(0, limit)]:
        gd = entry.get("genotype") or {}
        geno = Genotype(tuple(gd["xi"]), tuple(gd["cd"]), tuple(gd["ba"]))
        ind = evaluate_genotype(
            space, geno,
            decoder=problem.decoder,
            ilp_budget_s=problem.ilp_budget_s,
            pipelined=problem.pipelined,
        )
        if not ind.feasible or ind.schedule is None:
            continue
        gt = transformed_graph(space, geno.xi, problem.pipelined)
        report = verify_schedule(gt, problem.arch, ind.schedule)
        checked += 1
        violations += len(report.violations)
        kinds |= report.kinds()
    return {
        "checked": checked,
        "violations": violations,
        "kinds": sorted(kinds),
        "ok": violations == 0,
    }


def build_report(
    cells: Sequence[CampaignCell], store: RunStore,
    *, verify: bool = False, verify_limit: int = 3,
) -> Dict[str, Any]:
    """Cross-cell report over whatever artifacts the store holds: per-cell
    fronts and counters, relative hypervolume against each problem group's
    union front, and per-sim-backend timing aggregates.

    With ``verify=True`` each completed cell also gets a ``verify`` column:
    up to ``verify_limit`` archived genotypes are re-decoded and checked by
    :func:`repro_torch.verify.verify_schedule` (zero expected violations)."""
    rows: Dict[str, Dict[str, Any]] = {}
    groups: Dict[Tuple[str, str], List[str]] = {}
    missing: List[str] = []
    for cell in cells:
        h = cell.spec_hash()
        art = store.try_load_cell(h)  # corrupt artifacts count as missing
        if art is None:
            missing.append(cell.tag)
            continue
        run = art["run"]
        backend = cell.engine.get("sim_backend")
        rows[cell.tag] = {
            "spec_hash": h,
            "coords": cell.coords,
            "sim_backend": backend,
            "front": [list(p) for p in run.get("front", [])],
            "objectives": list(cell.problem.get("objectives") or []),
            "evaluations": run.get("evaluations", 0),
            "cache_hits": run.get("cache_hits", 0),
            "cache_misses": run.get("cache_misses", 0),
            "wall_s": run.get("wall_s", 0.0),
            "meta": run.get("meta", {}),
            "verify": _verify_cell(cell, run, verify_limit) if verify else None,
        }
        groups.setdefault(cell.group_key(), []).append(cell.tag)

    # Group display names: the bare problem label, disambiguated by the
    # objective layout when one label carries several (they are not
    # hypervolume-comparable, so they must stay separate groups).
    label_counts: Dict[str, int] = {}
    for label, _ in groups:
        label_counts[label] = label_counts.get(label, 0) + 1
    group_out: Dict[str, Any] = {}
    for (label, obj_key), tags in groups.items():
        name = label
        if label_counts[label] > 1:
            objs = json.loads(obj_key)
            name = f"{label}[{'+'.join(objs) if objs else 'default'}]"
        fronts = {t: [tuple(p) for p in rows[t]["front"]] for t in tags}
        union = nondominated([p for f in fronts.values() for p in f])
        group_out[name] = {
            "cells": list(tags),
            "union_front": [list(p) for p in union],
            "rel_hv": {
                t: relative_hypervolume(f, union) if union else 0.0
                for t, f in fronts.items()
            },
        }

    backend_timing: Dict[str, Dict[str, Any]] = {}
    for row in rows.values():
        key = str(row["sim_backend"])
        agg = backend_timing.setdefault(key, {"cells": 0, "wall_s_total": 0.0})
        agg["cells"] += 1
        agg["wall_s_total"] += row["wall_s"]
    for agg in backend_timing.values():
        agg["wall_s_mean"] = agg["wall_s_total"] / max(agg["cells"], 1)

    return {
        "cells": rows,
        "groups": group_out,
        "backend_timing": backend_timing,
        "n_cells": len(cells),
        "n_completed": len(rows),
        "missing": missing,
    }


# ==========================================================================
@dataclass
class CampaignResult:
    campaign: Campaign
    store: RunStore
    executed: List[str]          # spec hashes run in this invocation
    skipped: List[str]           # spec hashes found completed in the store
    report: Dict[str, Any]
    wall_s: float = 0.0

    @property
    def cells(self) -> Dict[str, Dict[str, Any]]:
        return self.report["cells"]

    def front(self, tag: str) -> List[Tuple[float, ...]]:
        return [tuple(p) for p in self.report["cells"][tag]["front"]]


class CampaignRunner:
    """Executes a :class:`Campaign` into a :class:`RunStore`, resumably.

    ``jobs > 1`` distributes engine-sharing groups of cells across a
    process pool (group = cells legal to share one ``EvaluationEngine``;
    groups are the sharding unit so the in-group decode cache stays warm
    exactly as the hand-rolled sweeps kept it).  Workers write each cell
    artifact atomically the moment it finishes, so a killed campaign
    loses at most the in-flight cells; results and the manifest are
    independent of ``jobs``.
    """

    def __init__(
        self,
        campaign: Campaign,
        *,
        root: str = DEFAULT_CAMPAIGN_ROOT,
        store: Optional[RunStore] = None,
        jobs: int = 1,
        engine_overrides: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.campaign = campaign
        self.store = store if store is not None else RunStore(
            os.path.join(root, campaign.campaign_id())
        )
        self.jobs = jobs
        # Execution-time perf knobs (result-transparent, e.g. n_workers);
        # deliberately outside the cells, hashes, and manifest.
        self.engine_overrides = dict(engine_overrides or {})
        bad = set(self.engine_overrides) - set(PERF_ONLY_ENGINE_KEYS)
        if bad:
            raise ValueError(
                f"engine_overrides may only carry perf-only knobs "
                f"{PERF_ONLY_ENGINE_KEYS}, got {sorted(bad)} — put "
                f"result-affecting engine kwargs in the campaign spec"
            )
        self.cells = campaign.expand()
        if not self.cells:
            raise ValueError("campaign expands to zero cells (all skipped?)")
        hashes = [c.spec_hash() for c in self.cells]
        if len(set(hashes)) != len(hashes):
            raise ValueError(
                "campaign expands to duplicate cells — add a distinguishing "
                "axis (e.g. seed) or a skip rule"
            )
        tags = [c.tag for c in self.cells]
        if len(set(tags)) != len(tags):
            # Tags key the report rows and group tables; distinct cells
            # hiding behind one tag would silently vanish from both.
            dupes = sorted({t for t in tags if tags.count(t) > 1})
            raise ValueError(
                f"campaign expands to distinct cells with identical tags "
                f"{dupes} — give the problem templates distinct labels"
            )
        # Fail fast on registry typos so the CLI reports one line instead
        # of an exploration-time traceback out of a worker.
        from .decoders import decoder_names
        from .engine import SIM_BACKENDS
        from .explorers import explorer_names

        for cell in self.cells:
            backend = cell.engine.get("sim_backend", "cuda")
            if backend not in SIM_BACKENDS:
                raise ValueError(
                    f"unknown sim_backend {backend!r} (cell {cell.tag}); "
                    f"registered: {', '.join(map(str, SIM_BACKENDS))}"
                )
            dec = cell.problem.get("decoder", "caps_hms")
            if dec not in decoder_names():
                raise ValueError(
                    f"unknown decoder {dec!r} (cell {cell.tag}); "
                    f"registered: {', '.join(decoder_names())}"
                )
            if cell.explorer not in explorer_names():
                raise ValueError(
                    f"unknown explorer {cell.explorer!r}; "
                    f"registered: {', '.join(explorer_names())}"
                )

    def run(self, *, jobs: Optional[int] = None) -> CampaignResult:
        t0 = time.monotonic()
        jobs = self.jobs if jobs is None else jobs
        self.store.write_manifest(self.campaign.manifest())

        # A cell counts as done only if its artifact parses: a truncated
        # or corrupt file (outside interference — our writes are atomic)
        # warns and re-executes instead of raising at report time.
        done = {
            h for h in self.store.completed()
            if self.store.try_load_cell(h) is not None
        }
        pending = [c for c in self.cells if c.spec_hash() not in done]
        skipped = [c.spec_hash() for c in self.cells if c.spec_hash() in done]

        # Shard at engine-sharing granularity, preserving expansion order
        # (or per-cell when the campaign wants cold-cache wall times), and
        # drain the groups through the service scheduler in local mode —
        # inline for serial/in-memory runs, a supervised worker pool for
        # jobs > 1.  Served campaigns run the identical path.
        shards: Dict[str, List[CampaignCell]] = {}
        for i, cell in enumerate(pending):
            key = cell.engine_key() if self.campaign.share_engines else f"#{i}"
            shards.setdefault(key, []).append(cell)
        from ..service.scheduler import run_groups_local

        executed = run_groups_local(
            list(shards.values()), self.store,
            jobs=jobs, engine_overrides=self.engine_overrides,
        )

        report = build_report(self.cells, self.store)
        self.store.write_report(report)
        return CampaignResult(
            campaign=self.campaign,
            store=self.store,
            executed=executed,
            skipped=skipped,
            report=report,
            wall_s=time.monotonic() - t0,
        )

    def report(self) -> Dict[str, Any]:
        """(Re)build the cross-cell report from whatever the store holds,
        without executing anything."""
        report = build_report(self.cells, self.store)
        self.store.write_report(report)
        return report
