"""The traced run: the program's spans over the window, ``torch.profiler``
over a steady stretch of it, and the context the per-layer readers read.

* Spans: the program's own telemetry (``repro_torch.obs``) records to a
  directory under ``TMPDIR`` for the whole explore; ``evo.execute`` spans
  of kind ``eval``, ``rank`` and ``vary`` wait for the device while it
  records, so they time each step's work.
* Device: the profiler (CPU and CUDA activities) runs over
  :data:`STRETCH_GENERATIONS` generations starting at the first generation
  end past :data:`STRETCH_AT` of the budget, and never past the budget.  Two markers with their host
  times map the program's spans onto the trace's clock.
* Readers get a :class:`Context`: the steady generations (in the window,
  outside the stretch) and their spans, the stretch's device events and
  the spans mapped onto it, the launch shape of the cell's kernel.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["Tracer", "Context", "STRETCH_AT", "STRETCH_GENERATIONS"]

STRETCH_AT = 0.4
STRETCH_GENERATIONS = 30
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Context:
    """What a metric's reader reads: the run (every run) and the trace
    (traced runs)."""

    shape: Optional[dict]                         # the kernel launch: B, A, C, R, T, Tmax, K
    device_name: str
    offspring: int                                # evaluations per generation
    setup_s: float                                # process start → first timed generation
    gen_s: List[float]                            # wall seconds of the window's generations
    steady_gens: Dict[int, Tuple[int, int]] = field(default_factory=dict)  # gen → (start, end) ns
    spans: List[dict] = field(default_factory=list)            # program spans (ts, dur in ns)
    stretch: Tuple[float, float] = (0.0, 0.0)     # µs on the trace clock
    device_events: List[dict] = field(default_factory=list)   # name, cat, ts, dur (µs), launch
    stretch_spans: List[dict] = field(default_factory=list)   # spans mapped to the trace clock

    def step_spans(self, kind: str) -> List[dict]:
        return [s for s in self.spans if s["name"] == "evo.execute"
                and s["attrs"].get("kind") == kind]

    def per_steady_gen_ms(self, kind: str) -> Optional[float]:
        """Milliseconds per steady generation in ``evo.execute`` spans of
        ``kind``, or None when no steady generation holds one."""
        if not self.steady_gens:
            return None
        total, hit = 0, False
        for s in self.step_spans(kind):
            for a, b in self.steady_gens.values():
                if a <= s["ts"] and s["ts"] + s["dur"] <= b:
                    total += s["dur"]
                    hit = True
                    break
        return total / 1e6 / len(self.steady_gens) if hit else None

    def busy_us(self) -> float:
        """Union of the device events' intervals inside the stretch."""
        a0, b0 = self.stretch
        ivs = sorted((max(e["ts"], a0), min(e["ts"] + e["dur"], b0)) for e in self.device_events)
        busy, end = 0.0, a0
        for a, b in ivs:
            if b <= end:
                continue
            busy += b - max(a, end)
            end = b
        return busy


class Tracer:
    """Spans for the whole explore, the profiler over a steady stretch."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.dir = tempfile.mkdtemp(prefix="portbench-trace-")
        self.prof = None
        self.start_gen: Optional[int] = None
        self.stop_gen: Optional[int] = None
        self.marks: Dict[str, int] = {}
        self.t_budget = 0.0

    def warm(self, device) -> None:
        """Start and stop the profiler once over one small operation, so the
        stretch does not pay its first start."""
        import torch

        with torch.profiler.profile(activities=self._activities()):
            (torch.ones(8, device=device) + 1).sum().item()

    @staticmethod
    def _activities():
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def begin(self) -> None:
        from repro_torch import obs

        obs.configure(True, os.path.join(self.dir, "obs"))
        self.t_budget = time.perf_counter()

    def _mark(self, name: str) -> None:
        import torch

        with torch.profiler.record_function(name):
            self.marks[name] = time.perf_counter_ns()

    def on_generation(self, gen: int, t: float) -> None:
        import torch

        if self.prof is None and self.start_gen is None and gen >= 1 \
                and t - self.t_budget >= STRETCH_AT * self.seconds:
            self.prof = torch.profiler.profile(activities=self._activities())
            self.prof.start()
            self.start_gen = gen
            self._mark("portbench.stretch_begin")
        elif self.prof is not None and (gen >= self.start_gen + STRETCH_GENERATIONS
                                        or t - self.t_budget >= self.seconds):
            self._stop(gen)

    def _stop(self, gen: Optional[int]) -> None:
        self._mark("portbench.stretch_end")
        self.prof.stop()
        self.stop_gen = gen if gen is not None else self.start_gen + STRETCH_GENERATIONS
        path = os.path.join(self.dir, "trace.json")
        self.prof.export_chrome_trace(path)
        self.prof = None

    def end(self) -> None:
        from repro_torch import obs

        if self.prof is not None:
            self._stop(None)
        obs.configure(False)

    def read(self, ctx: Context, window) -> None:
        """Read the spans and the trace back into ``ctx``, then remove both."""
        from repro_torch import obs

        try:
            recs = list(obs.iter_records(os.path.join(self.dir, "obs")))
            spans = [r for r in recs if r.get("t") == "span"]
            gen_spans = {s["attrs"]["gen"]: (s["ts"], s["ts"] + s["dur"]) for s in spans
                         if s["name"] == "explorer.generation"}
            n_window = len(window.in_window)             # gens 0 .. n_window - 1
            stretch_gens = set()
            if self.start_gen is not None:
                stretch_gens = set(range(self.start_gen + 1, (self.stop_gen or self.start_gen) + 1))
            ctx.steady_gens = {g: v for g, v in gen_spans.items()
                               if 1 <= g < n_window and g not in stretch_gens}
            ctx.spans = spans
            path = os.path.join(self.dir, "trace.json")
            if os.path.exists(path):
                self._read_trace(ctx, path, spans)
        finally:
            shutil.rmtree(self.dir, ignore_errors=True)

    def _read_trace(self, ctx: Context, path: str, spans: List[dict]) -> None:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        marks = {e["name"]: e["ts"] for e in events if e.get("ph") == "X"
                 and e.get("cat") == "user_annotation" and e.get("name") in self.marks}
        if len(marks) < 2:
            return
        a, b = marks["portbench.stretch_begin"], marks["portbench.stretch_end"]
        ctx.stretch = (a, b)
        offset_us = a - self.marks["portbench.stretch_begin"] / 1e3
        launch = {}
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver"):
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launch[corr] = e["ts"]
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in _DEVICE_CATS:
                continue
            if e["ts"] + e.get("dur", 0) < a or e["ts"] > b:
                continue
            corr = (e.get("args") or {}).get("correlation")
            ctx.device_events.append(dict(name=e["name"], cat=e["cat"], ts=e["ts"],
                                          dur=e.get("dur", 0), launch=launch.get(corr)))
        for s in spans:
            t0 = s["ts"] / 1e3 + offset_us
            t1 = t0 + s["dur"] / 1e3
            if t1 >= a and t0 <= b:
                ctx.stretch_spans.append(dict(s, ts_us=t0, end_us=t1))


def breakdown(ctx: Context) -> dict:
    """The ten device operations that took most time in the stretch, and
    its ten longest idle gaps, each named by the innermost program span
    open at its midpoint."""
    by_name: Dict[str, float] = {}
    for e in ctx.device_events:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e6
    ops = sorted(by_name.items(), key=lambda x: -x[1])[:10]
    a0, b0 = ctx.stretch
    ivs = sorted((e["ts"], e["ts"] + e["dur"]) for e in ctx.device_events)
    gaps, end = [], a0
    for a, b in ivs:
        if a > end:
            gaps.append((end, min(a, b0)))
        end = max(end, b)
    if end < b0:
        gaps.append((end, b0))
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (a + b) / 2
        open_ = [s for s in ctx.stretch_spans if s["ts_us"] <= mid <= s["end_us"]]
        inner = min(open_, key=lambda s: s["end_us"] - s["ts_us"]) if open_ else None
        name = "none" if inner is None else inner["name"] + (
            ":" + str(inner["attrs"]["kind"]) if "kind" in inner["attrs"] else "")
        named.append([name, (b - a) / 1e6])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}
