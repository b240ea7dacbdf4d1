#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card (Hopper) and check it.

    python3 chip_smoke.py

Phases, none of whose failures is caught (any mismatch exits non-zero):

1. the card's name and power limit; the build of ``sim_step.cu`` (seconds,
   and registers / spills per ``nvcc -Xptxas -v``; the kernel's shared
   memory is dynamic, so each case below prints its bytes per CTA);
2. kernel vs plain: seeded caps_hms decodes (32 distinct, tiled to B=256)
   of Sobel ξ=0/ξ=1, Sobel4 ξ=1, Multicamera ξ=0/ξ=1 and Sobel ξ=1 with
   ``mrb_ports=1``; the kernel's fire/dead/horizon must be bit-identical to
   the plain batched torch program run on the card, and 4 elements per case
   must match the event-driven simulator; kernel and plain times by CUDA
   events;
3. the main path: NSGA-II (population 100, offspring 25, 4 generations,
   seed 0) on Multicamera under MRB_Always with the ``sim_period``
   objective, simulated by the kernel; launch count > 0, no int32 guard
   reroutes, archive periods re-checked with the event-driven simulator;
4. Sobel under MRB_Explore (population 20, offspring 10, 3 generations):
   the ``"cuda"`` and ``"events"`` fronts must be identical.

Then one JSON line describing every kernel, and the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository's ``src/`` beside it, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import functools
import json
import math
import os
import random
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
TILE_B = 256
DISTINCT = 32
K_FIRINGS = 16             # SimConfig().iterations: the first call of a batch
KERNEL_REPS = 20
MAIN_PATH = dict(population=100, offspring=25, generations=4, seed=0)
MAIN_SHAPE_B = 100         # the main path's initial-population batch
SOBEL_PATH = dict(population=20, offspring=10, generations=3, seed=0)


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ cases
def random_schedules(g, arch, n, seed, tries=60):
    """``n`` feasible caps_hms decodes of ``g`` from seeded random
    (β_A, C_d) draws."""
    from repro_torch.core import CHANNEL_DECISIONS, decode_via_heuristic

    rng = random.Random(seed)
    cores = sorted(arch.cores)
    allowed = {
        a: [p for p in cores if g.actors[a].can_run_on(arch.cores[p].ctype)]
        for a in sorted(g.actors)
    }
    out = []
    for _ in range(n * tries):
        ba = {a: rng.choice(allowed[a]) for a in sorted(g.actors)}
        cd = {c: rng.choice(CHANNEL_DECISIONS) for c in sorted(g.channels)}
        res = decode_via_heuristic(g, arch, cd, ba)
        if res.feasible:
            out.append(res.schedule)
            if len(out) == n:
                return out
    raise AssertionError(f"only {len(out)} feasible decodes of {g.name}")


CASES = (  # name, app, ξ, mrb_ports
    ("sobel_xi0", "sobel", 0, None),
    ("sobel_xi1", "sobel", 1, None),
    ("sobel4_xi1", "sobel4", 1, None),
    ("multicamera_xi0", "multicamera", 0, None),
    ("multicamera_xi1", "multicamera", 1, None),
    ("sobel_xi1_ports1", "sobel", 1, 1),
)


@functools.lru_cache(maxsize=None)
def build_case(app, xi, ports, n=DISTINCT, seed=0):
    """(transformed graph, arch, schedules, SimConfig) of one case."""
    from repro_torch import core
    from repro_torch.sim import SimConfig

    g, arch = getattr(core, app)(), core.paper_architecture()
    gt = core.pipeline_delays(
        core.substitute_mrbs(g, {a: xi for a in core.multicast_actors(g)})
    )
    scheds = random_schedules(gt, arch, n, seed=f"chip-smoke:{app}:{xi}:{seed}")
    return gt, arch, scheds, SimConfig(trace=False, mrb_ports=ports)


def case_tables(gt, arch, scheds, device):
    from repro_torch.sim import lower_phenotype
    from repro_torch.sim.batched import _lower_batch, compact_tables

    static, batched = _lower_batch([lower_phenotype(gt, arch, s) for s in scheds])
    return compact_tables(static, batched, device)


def output_bytes(tab, k_max):
    return tab.B * tab.A * k_max * 4 + tab.B * 1 + tab.B * 4


def time_ms(fn, reps, warmup):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_kernel_plain(tab, K, k_max, ports):
    """Kernel and plain outputs on ``tab``; asserts bit-identity and returns
    (max abs difference, plain-run stats with its time in ``ms``)."""
    import torch
    from repro_torch.kernels import sim_step as kmod
    from repro_torch.sim.batched import simulate_plain

    kf, kd, kh = kmod.sim_step(tab, K, k_max, ports)
    stats: dict = {}
    out = []
    stats["ms"] = time_ms(
        lambda: out.append(simulate_plain(tab, K, k_max, ports, stats=stats)), 1, warmup=0
    )
    pf, pd, ph = out[0]
    err = max(
        int((kf.long() - pf.long()).abs().max()),
        int((kh.long() - ph.long()).abs().max()),
        int((kd.long() - pd.long()).abs().max()),
    )
    assert torch.equal(kf, pf), "sim_step fire table differs from the plain version"
    assert torch.equal(kd, pd), "sim_step deadlock flags differ from the plain version"
    assert torch.equal(kh, ph), "sim_step horizons differ from the plain version"
    return err, stats


def phase_kernel_vs_plain(device):
    from repro_torch.kernels import sim_step as kmod
    from repro_torch.sim import batch_simulate, simulate

    k_max = K_FIRINGS
    rows, max_err = [], 0
    for name, app, xi, ports in CASES:
        gt, arch, scheds, cfg = build_case(app, xi, ports)
        tab = case_tables(gt, arch, scheds, device).select(
            [i % DISTINCT for i in range(TILE_B)]
        )
        err, stats = compare_kernel_plain(tab, K_FIRINGS, k_max, cfg.mrb_ports)
        max_err = max(max_err, err)
        rounds = stats["rounds"][:DISTINCT].float()
        ms = time_ms(lambda: kmod.sim_step(tab, K_FIRINGS, k_max, cfg.mrb_ports),
                     KERNEL_REPS, warmup=3)
        plain_ms = stats["ms"]
        # Whole batched path (horizon doubling included) on 4 elements
        # against the exact event-driven simulator.
        mine = batch_simulate(gt, arch, scheds[:4], cfg, backend="cuda", device=device)
        for s, m in zip(scheds[:4], mine):
            e = simulate(gt, arch, s, cfg)
            assert m.fire_times == e.fire_times, f"{name}: kernel path vs events"
            assert m.period == e.period and m.deadlocked == e.deadlocked, name
        nbytes = tab.nbytes() + output_bytes(tab, k_max)
        row = dict(
            case=name, B=tab.B, A=tab.A, C=tab.C, R=tab.R, H=tab.H, Tmax=tab.Tmax,
            tasks=tab.total_tasks(), K=K_FIRINGS, k_max=k_max,
            smem_bytes=kmod.build().sim_step_smem_bytes(tab.A, tab.C, tab.R, tab.H),
            rounds_mean=float(rounds.mean()), rounds_max=int(rounds.max()),
            ms=ms, plain_ms=plain_ms, bytes=nbytes,
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, max_abs_err=err,
        )
        rows.append(row)
        log("phase kernel-vs-plain:", json.dumps(row))
    return rows, max_err


def main_path_timing(device):
    """The kernel's time at the main path's shape: one initial-population
    batch of Multicamera under MRB_Always (B=MAIN_SHAPE_B, K=16)."""
    from repro_torch.kernels import sim_step as kmod

    gt, arch, scheds, cfg = build_case("multicamera", 1, None)
    tab = case_tables(gt, arch, scheds, device).select(
        [i % DISTINCT for i in range(MAIN_SHAPE_B)]
    )
    err, stats = compare_kernel_plain(tab, K_FIRINGS, K_FIRINGS, None)
    ms = time_ms(lambda: kmod.sim_step(tab, K_FIRINGS, K_FIRINGS, None), KERNEL_REPS, warmup=3)
    plain_ms = stats["ms"]
    nbytes = tab.nbytes() + output_bytes(tab, K_FIRINGS)
    row = dict(case="main_path_shape", B=tab.B, A=tab.A, Tmax=tab.Tmax, ms=ms,
               plain_ms=plain_ms, bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
               rounds_mean=float(stats["rounds"].float().mean()), max_abs_err=err)
    log("phase main-path-shape:", json.dumps(row))
    return row


def phase_main_path(device):
    from repro_torch.core import ExplorationProblem, NSGA2Explorer, multicamera, paper_architecture
    from repro_torch.kernels import sim_step as kmod
    from repro_torch.sim import batched, simulate_period

    problem = ExplorationProblem(
        graph=multicamera(), arch=paper_architecture(), strategy="MRB_Always",
        objectives=("sim_period", "memory", "core_cost"),
    )
    gens = []
    with problem.make_engine(sim_backend="cuda", device=device) as eng:
        last = dict(t=time.perf_counter(), decode=0.0, sim=0.0)

        def on_generation(gen, run):
            now = time.perf_counter()
            gens.append(dict(
                gen=gen, wall_s=now - last["t"], decode_s=eng.decode_s - last["decode"],
                sim_s=eng.sim_s - last["sim"], front=len(run.front),
            ))
            last.update(t=now, decode=eng.decode_s, sim=eng.sim_s)
            log("phase main-path: generation", json.dumps(gens[-1]))

        kmod.launches = 0
        batched.int32_fallbacks = 0
        run = NSGA2Explorer(**MAIN_PATH).explore(
            problem, engine=eng, on_generation=on_generation
        )
        launches, fallbacks = kmod.launches, batched.int32_fallbacks
        graph = eng._transformed(run.archive[0].genotype.xi)
    assert launches > 0, "the main path launched no sim_step kernel"
    assert fallbacks == 0, f"{fallbacks} phenotypes rerouted by the int32 guard"
    front = run.front
    assert front and all(len(p) == 3 and all(math.isfinite(v) for v in p) for p in front)
    for ind in run.archive[:4]:
        assert ind.objectives[0] == simulate_period(graph, problem.arch, ind.schedule), \
            "archived sim_period differs from the event-driven simulator"
    summary = dict(launches=launches, int32_fallbacks=fallbacks, front=len(front),
                   evaluations=run.evaluations, wall_s=run.wall_s,
                   decode_s=eng.decode_s, sim_s=eng.sim_s)
    log("phase main-path:", json.dumps(summary))
    return summary


def phase_sobel_fronts(device):
    from repro_torch.core import ExplorationProblem, NSGA2Explorer, paper_architecture, sobel

    fronts = {}
    for backend in ("cuda", "events"):
        problem = ExplorationProblem(
            graph=sobel(), arch=paper_architecture(), strategy="MRB_Explore",
            objectives=("sim_period", "memory", "core_cost"),
        )
        with problem.make_engine(sim_backend=backend, device=device) as eng:
            run = NSGA2Explorer(**SOBEL_PATH).explore(problem, engine=eng)
        fronts[backend] = run.front
    assert fronts["cuda"] == fronts["events"], "cuda and events fronts differ on Sobel"
    log("phase sobel-fronts: identical,", len(fronts["cuda"]), "points")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch import resolve_device
    from repro_torch.kernels import sim_step as kmod

    device = resolve_device("cuda")
    t_start = time.perf_counter()
    log(nvidia_smi_line())
    log(sys.version.split()[0], "torch", torch.__version__, "cuda", torch.version.cuda)
    kmod.build()
    ptxas = [ln.strip() for ln in kmod.build_info["ptxas"].splitlines()
             if re.search(r"registers|smem|spill", ln)]
    log(f"build sim_step.cu: {kmod.build_info['seconds']:.2f} s;", " | ".join(ptxas))

    rows, max_err = phase_kernel_vs_plain(device)
    main_row = main_path_timing(device)
    main = phase_main_path(device)
    phase_sobel_fronts(device)

    kernels = [dict(
        name="sim_step", route="cuda", source="src/repro_torch/csrc/sim_step.cu",
        replaces="src/repro/kernels/sim_step.py:41", launches=main["launches"],
        max_abs_err=max(max_err, main_row["max_abs_err"]), ms=main_row["ms"],
        plain_ms=main_row["plain_ms"], bound_ms=main_row["bound_ms"], bound_by="bytes",
        library_ms=None,
    )]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
