"""One run of one cell: set-up, the window, the trace, the check, the result.

:func:`run` is everything a run does after the look for the card, so tests
can drive it on the CPU (``device="cpu"``: the plain simulator in place of
the kernel).
"""
from __future__ import annotations

import sys
import time
from typing import List, Optional, Tuple

from . import check as checks
from .cells import Cell, load_reader
from .drive import build_problem, run_window
from .trace import Context, Tracer, breakdown

__all__ = ["run", "kernel_shape"]


def kernel_shape(cell: Cell, ref: "checks.Reference") -> Optional[dict]:
    """The ``sim_step`` launch of the window (one per generation, over the
    offspring batch) where ξ is fixed, so one table shape serves them all."""
    if ref.forced is None and ref.layout.n_xi:
        return None
    dec = ref.decoder((ref.forced or 0,) * ref.layout.n_xi)
    return dict(B=int(cell.mix["params"]["offspring"]), A=dec.A, C=dec.C, R=dec.R,
                T=int(dec.n_tasks.sum()), Tmax=dec.Tmax, K=int(cell.mix["params"]["sim_iters"]))


def _log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        t_start: Optional[float] = None) -> Tuple[dict, List[str]]:
    """The result object and the lines that print each compared number
    beside its limit."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    problem = build_problem(cell)
    tracer = Tracer(seconds) if trace else None
    with problem.make_engine(sim_backend="cuda" if dev.type == "cuda" else "torch",
                             device=dev) as engine:
        window = run_window(cell, problem, engine, seed, seconds, tracer)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    gens = window.in_window
    setup_s = (gens[0] if gens else window.t_budget) - t_start
    _log(f"set-up {setup_s:.3f} s; {len(gens) - 1} generations in the window "
         f"({len(window.ends)} run); closing re-evaluation of {window.candidates} genotypes "
         f"{window.closing_s:.3f} s")

    gs = window.gen_seconds()
    if gs:
        tenth = max(1, len(gs) // 10)
        parts = [gs[:tenth], gs[len(gs) // 2 - tenth // 2:][:tenth], gs[-tenth:]]
        _log("generation ms (first, middle, last tenth of the window, medians): "
             + " / ".join(f"{1e3 * sorted(p)[len(p) // 2]:.2f}" for p in parts)
             + f"; archive {window.archive[1]} / {window.archive[len(gs) // 2]} / "
               f"{window.archive[len(gs)]} points")
    unseen = [k for k, n in window.outputs["calls"].items() if n == 0 and window.ends]
    if unseen:
        _log(f"the explorer ran no step of kind {unseen} through _step: the check sees "
             "nothing of the window, and every due answer counts as off")
    t0 = time.perf_counter()
    ref = checks.Reference(cell)
    numbers = checks.compare(cell, window.outputs, seed)
    _log(f"reference check {time.perf_counter() - t0:.3f} s")
    ctx = Context(shape=kernel_shape(cell, ref), device_name=name,
                  offspring=int(cell.mix["params"]["offspring"]), setup_s=setup_s,
                  gen_s=window.gen_seconds())
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": name,
                   "count": 1, "memory_peak_bytes": window.memory_peak}
    result = {"correct": all(numbers[k] <= v for k, v in checks.LIMITS.items()),
              "attempted": len(ctx.gen_s) * ctx.offspring, "failed": 0}
    if tracer:
        tracer.read(ctx, window)
        metrics = cell.per_layer
        a, b = ctx.stretch
        device_info.update(busy_s=ctx.busy_us() / 1e6, window_s=(b - a) / 1e6)
    else:
        metrics = cell.end_to_end
    values = {}
    for m in metrics:
        v = load_reader(m["name"])(ctx)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result.update(metrics=values, device=device_info)
    if tracer:
        result["breakdown"] = breakdown(ctx)
    result["checks"] = {k: {"value": numbers[k], "limit": v} for k, v in checks.LIMITS.items()}
    lines = [f"check {k}: {numbers[k]} (limit {v})" for k, v in checks.LIMITS.items()]
    return result, lines
