"""Cells by name: ``BENCHMARK.json`` → configuration, traffic mix, metrics.

Everything that belongs to one configuration, mix or per-layer metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:

* a configuration: the ``file`` of its entry (graph, architecture, source);
* a traffic mix: ``portbench/mixes/<traffic>.json`` (explorer, its
  parameters, strategy, objectives);
* a per-layer metric: ``portbench/metrics/<name>.py``, whose ``read(ctx)``
  returns a number or None when it finds nothing to read.
"""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable, List, Optional

__all__ = ["Cell", "load_cell", "load_reader", "HERE", "ROOT"]

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict            # the configuration's file
    mix: dict               # the traffic mix's file
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]   # the per-layer metrics this cell reports
    chips: int


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(workload: str, root: str = ROOT, bench: Optional[dict] = None) -> Cell:
    """The cell ``workload`` of ``bench`` (by default ``root``'s
    ``BENCHMARK.json``), with its files read under ``root``."""
    if bench is None:
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "portbench", "mixes", w["traffic"] + ".json")) as f:
        mix = json.load(f)
    return Cell(
        name=workload, workload=w, config=config, mix=mix,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
        chips=int(w["chips"]),
    )


def load_reader(name: str) -> Callable:
    """``read(ctx)`` of ``portbench/metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

