#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card (Hopper) and check it.

    python3 chip_smoke.py

Phases, none of whose failures is caught (any mismatch exits non-zero):

1. the card's name and power limit; the three CUDA sources are built side
   by side (one ``nvcc`` each); the build of ``sim_step.cu`` (seconds,
   and registers, spills and barriers of each kernel instance per
   ``nvcc -Xptxas -v``; the kernel's shared memory is dynamic, so each
   case below prints its bytes per CTA);
2. kernel vs plain: seeded caps_hms decodes (32 distinct, tiled to B=256)
   of Sobel ξ=0/ξ=1, Sobel4 ξ=1, Multicamera ξ=0/ξ=1 and Sobel ξ=1 with
   ``mrb_ports=1``; the kernel's fire/dead/horizon and round counts must be
   bit-identical to the plain batched torch program run on the card, and 4
   elements per case must match the event-driven simulator; kernel and
   plain times by CUDA events, µs per round (ms over the longest
   phenotype's rounds), the launch plan (warps, actors per thread, shared
   memory), each beside its bound by rounds (the longest phenotype's
   rounds times the round floor that ``sim_step.cu``'s calibration kernel
   measures at the kernel's block size) and its bytes bound;
3. the main path: NSGA-II (population 100, offspring 25, 4 generations,
   seed 0) on Multicamera under MRB_Always with the ``sim_period``
   objective, simulated by the kernel; launch count > 0, no int32 guard
   reroutes, archive periods re-checked with the event-driven simulator;
   the kernel's CUDA-event time summed over its launches beside ``sim_s``;
4. Sobel under MRB_Explore (population 20, offspring 10, 3 generations):
   the ``"cuda"`` and ``"events"`` fronts must be identical;
5. the builds of ``mrb_ring.cu`` and ``decode_attention.cu`` (seconds,
   registers, spills and shared memory per ``-Xptxas -v``);
6. the ring kernels vs their plain versions on the card: ``mrb_append``
   exactly equal over the JAX package's sweep (float32 and bfloat16,
   ω ∈ {0, 1, block−1, block, C−1}, mixed token types) and its wrap
   sequence; the fused ``mrb_append_kv`` exactly equal, ω included, over
   the same sweep and the served shapes (Gemma-2, Zamba2's kv=32 d=112,
   MusicGen's kv=24 d=64) with negative and clamped ω, and a
   70-step wrap, one launch per call; ``mrb_decode_attention`` within 3e-5
   (float32) and 2e-2 (bfloat16) on the JAX package's five cases and on
   ragged, G=16 and C=1 cases, on split-edge cases (window far below C, a
   partial fill that leaves nearly every split empty, ragged G=16), at
   t = -1 (nothing readable: the mean of V) and at phase 14's attention
   shapes (Zamba2's d=112 G=1 kv=32, MusicGen's d=64 G=1 kv=24, Mixtral's
   G=4, InternVL2's G=2, Qwen3-MoE's G=16 kv=4; served rings that wrap,
   and rings past and inside a window), also against the
   plain split-and-merge at the kernel's own cluster size; CUDA-event
   times of both at the served shape (over the 42 layers' rings, so L2 is
   cold as in the model) and at long shapes (a Gemma-2 local layer in a
   32k cache and G=16 among them), each with its cluster size and shared
   memory,
   (and each family's served shape, cycling over its model's rings),
   each beside its bytes bound at 3.35 TB/s, the plain version's time and
   one PyTorch call's (``index_copy_``; ``scaled_dot_product_attention``
   where there is no softcap); at the served shape also the fused write
   beside the sequence it replaces (two ``mrb_append``, then ``add_`` and
   ``remainder_`` on ω), one and two ``index_copy_``, and the host µs per
   call of both ring-append wrappers;
7. the serving main path at full width: Gemma-2 9B, bfloat16 weights and
   cache, random weights from seed 0, B=4, a 32-token ``make_batch``
   prompt, 32 greedy tokens, ring capacity 64, through
   ``repro_torch.launch.serve.serve``; launch counts asserted, tokens in
   range, logits finite, one fused ring write per layer and step, the
   kernel against the plain version on the live
   rings of layer 0 (local) and layer 1 (global); init, prefill and
   decode times beside the 5.5 ms weight-read floor, and a profiler
   window of decode steps for the device's busy share;
8. ring wrap, card vs CPU: Gemma-2 smoke with a 32-token window, B=4,
   prompt 24, 48 greedy tokens, ring capacity 64; the card's run through
   the kernels must give the CPU's plain run's logits within 1e-4 at every
   step (TF32 off) and identical greedy tokens;
9. Qwen3-0.6B at full width: B=4, prompt 32, 32 greedy tokens; launch
   counts asserted, timings printed.
10. the device explorer ``torch_nsga2``: (a) the relaxed evaluation on the
    card (its ``sim_step`` launched once per call on tables the decode
    wrote on the device) equal to the same function on CPU tensors, for
    Multicamera ξ=1 at the main path's shapes (B=25 and B=100, K=32) and
    for a population whose event times wrap int32 (inf where the plain
    program wraps); (b) the main path of phase 3 through ``torch_nsga2``
    relaxed: per-generation wall, time to the end of the first generation
    (cold), ``relaxed_evaluations``, ``sim_step`` launches and their
    CUDA-event ms, the first B=100 (on its first 25 rows) and the first
    B=25 relaxed launch held against the plain program on their own
    tables (on the CPU in a spawned process, joined and asserted after
    phase 15), archive periods
    re-checked with the event-driven simulator, relHV against phase 3's
    host front (≥ 0.25); (c)
    ``BENCH_evo.json``'s shape (Sobel Reference, population 512, offspring
    256, 5 generations, seed 11): the host ``nsga2`` against ``torch_nsga2``
    relaxed, warm seconds per generation and relHV (≥ 0.25); (b)'s relaxed
    launches also carry their bound by rounds (the plain program's round
    counts).
11. exact decoders and generated scenarios on the card: (a) the ILP path
    at Sobel on the paper architecture (MRB_Explore, ``decoder="ilp"``
    with a 2.0 s budget, objectives sim_period / memory / core_cost, host
    ``nsga2`` population 8, offspring 4, 2 generations, seed 7,
    ``sim_period`` by the kernel), then ``torch_nsga2`` in exact mode on
    the same engine with the same front; the number of decodes that
    proved optimal; (b) the large tier, one generated scenario of each
    family (``sample_scenarios(seed=0, n=5, size="large")``), MRB_Explore
    through host ``nsga2`` with caps_hms (16 / 8, 2 generations).  Every
    feasible schedule (a) decoded, and a seeded sample of at most 8 per
    scenario of (b) (3 where a graph has more than 64 actors), is
    re-simulated by the kernel (``batch_simulate``) and the event
    simulator: identical fire times and periods, zero violations of the
    independent verifier, equal ``check_sim_invariants`` lists.  Every
    ``sim_step`` launch of the phase is printed with its shape (B, A,
    Tmax, K, warps), its ms between CUDA events and its bound by rounds;
    ``int32_fallbacks`` are reported, not asserted.
12. the paper's campaign through ``python -m repro_torch``'s entry point
    (``repro_torch.cli.main`` in process, ``--device cuda``): (a) a spec
    written from code, Sobel, Sobel4 and Multicamera on the paper
    architecture at full size, objectives sim_period / memory /
    core_cost, strategies Reference, MRB_Always and MRB_Explore with
    ``nsga2`` (population 100, offspring 25, seed 0, generations cut to
    ``CAMPAIGN_GENERATIONS``), ``torch_nsga2`` relaxed on MRB_Always, and
    one ``sim_backend="auto"`` cell (Sobel MRB_Explore); (b) ``campaign
    run --jobs 1``, kernel counts reset just before and read just after:
    every cell completed, ``sim_step`` launched, the ``auto`` cell's
    choices recorded, every ``nsga2`` cell of Sobel and Sobel4 equal to a
    direct ``NSGA2Explorer`` run, up to 8 archived schedules per cell
    (4 at Multicamera) kernel = events (phase 11's checks) with their
    archived ``sim_period``, and ``campaign report --verify`` with 0
    violations; each cell's wall, ``engine.decode_s``, ``engine.sim_s``,
    launches and CUDA-event kernel ms are printed; (c) ``campaign
    resume`` after one Sobel artifact is deleted: only that cell re-runs,
    the manifest stays byte-identical, the front equal; (d) a Sobel-only
    copy as a subprocess, ``python -m repro_torch campaign run --jobs 2``
    (a spawn pool of two workers on the card), fronts equal to (b)'s;
    (e) one Sobel MRB_Explore cell (``torch_nsga2`` exact) with
    recording on, ``trace export --min-cats 4`` (``sim.execute`` carrying
    ``backend="cuda"``) and the ``trace summary`` table; (f) the
    ``auto`` backend's crossover: wall ms of one ξ=1 group at B = 1, 2,
    4, 8, 16 through the event simulator and through the kernel (one run
    each), at Sobel and Multicamera, and the least B at which the kernel is no
    slower (``AUTO_MIN_BATCH`` is set from it).
13. the campaign service, chaos sweeps and the planning layer on the card:
    (a) ``python -m repro_torch campaign serve --device cuda --workers 2``
    in a subprocess on 127.0.0.1, phase 12's campaign cut to Sobel and
    Sobel4 (8 cells) submitted as tenants ``alice`` (``--no-wait``) and
    ``bob`` through ``repro_torch.cli.main``: both done, one success-log
    line per cell hash, both manifests byte-identical to the one a local
    ``CampaignRunner`` writes, every served artifact (wall time dropped)
    equal to phase 12's artifact of the same hash, ``/metrics`` (JSON and
    Prometheus text) timing the cells under ``cuda``, no claim left once
    the server stops on SIGINT; the server's start, each tenant's, each
    cell's and the pool's wall times; (b) ``make_server(workers=0)`` in
    this process with one Sobel MRB_Explore cell on a fresh store, its
    ``sim_step`` launches (> 0) and their CUDA-event ms, its artifact equal
    to phase 12's; (c) a spawned worker's imports and the chaos spec's
    unit on the card twice (the first pays the CUDA set-up), within the
    chaos harness's 6 s unit deadline and 3 s heartbeat timeout, then
    ``python -m repro_torch chaos run --device cuda --workers 2 --seed 0
    --plans CHAOS_PLANS``: every plan converged, every site class fired,
    each plan's faulty and heal seconds and worker respawns; (d)
    ``plan_mapping`` on the card (MusicGen-medium 8 stages, Zamba2-7B 8,
    Mixtral-8x7B 4; seq 4096, batch 256; 15 generations, population 16,
    seed 2, no wall budget), every plan's schedule through the ``"cuda"``
    backend equal to the event simulator, launches > 0,
    ``int32_fallbacks`` printed, the MRB trade-off held where both
    choices survive.
14. the model families, bfloat16 weights and cache, random weights from
    seed 0, B=4, a 32-token ``make_batch`` prompt, 32 greedy tokens, ring
    64: (a) Zamba2-7B at full width and depth (81 Mamba2 layers, 13
    shared-attention invocations, a 3-layer tail) through
    ``repro_torch.launch.serve.serve``: 13 × 64 launches of each ring
    kernel, no ``sim_step``, every shared ring's t = 64, every state leaf
    finite, tokens in range, the kernel against the plain version on the
    first and last shared rings; (b) ``prefill_step`` at L=4096, B=1, for
    Zamba2-7B (16 SSD chunks, chunked shared attention) and InternVL2-2B
    (256 image + 3,840 text tokens): logits finite of shape [1, 1, V], wall
    time, peak memory and the largest difference to the same model's
    direct-attention path (the threshold raised for one call); (c)
    Mixtral-8x7B cut to 8 of its 32 layers (the 32 need 93 GB in bfloat16,
    over one card's 80 GB), MusicGen-medium (4 codebooks, 256 conditioning
    embeddings; tokens [4, 4, 32]) and Mamba2-370M (no ring launch) served
    with the same checks; each served run prints init s, prefill s, decode
    ms per step, tok/s, launches per step (torch.profiler) and the
    weight-read floor (parameters × 2 B / 3.35 TB/s; all of Mixtral's
    experts, which its formulation reads); (d) each of the six smoke
    configurations this slice adds, card (kernels) against CPU (plain
    versions), float32 with TF32 off: prompt 24, 48 greedy tokens, ring 64
    (Zamba2's window cut to 32), so every ring wraps; logits within 1e-4
    at every step, identical tokens, then ``forward`` and ``prefill_step``
    (L=128, blocks lowered to 32/64 rows so the chunked path runs) within
    1e-4.  Qwen3-MoE-235B (470 GB in bfloat16) is not served at full width:
    its attention shape is held in phase 6 and its smoke config in (d).
15. training on the card, no kernel of the repository on its path (each
    path's launch counts reset before it and read after it: 0 each): (a)
    Qwen3-0.6B at full width and depth (28 layers, d=1024, V=151,936,
    tied embeddings, AdamW, remat), bfloat16 random weights from seed 0,
    ``run_training`` at seq 1024 and global batch 8 for 8 steps, then
    again with a checkpoint every 4 steps and a failure injected at step
    5: every loss finite, the last below the first, the resumed run's
    final loss equal to the straight run's within 1e-6 relative; warm s
    per step, tokens/s, the model FLOPs' share of the bf16 peak, peak GB,
    checkpoint write and restore s, the optimizer's ms per step (CUDA
    events), launches per step and the device's busy share (torch.profiler
    over 2 steps); (b) Mamba2-370M at full width (the chunked SSD's
    backward), 4 steps at seq 1024, batch 4: losses finite and falling;
    (c) the ten smoke configurations, card against CPU in float32 (TF32
    off), 3 steps each with the spec's optimizer (Adafactor for Qwen3-MoE
    and Nemotron), Nemotron's bf16 gradients over 2 microbatches and
    Gemma-2's gather CE: loss and ``grad_norm`` within 1e-4 at every step.
16. distribution (launch counts reset before the path and read after it:
    0 each): (a) phase 15 (a)'s Qwen3-0.6B at full width and depth on one
    NCCL rank (a file store in a temporary directory), from one copy of
    the state: 3 int8 compressed data-parallel steps
    (``make_compressed_dp_train_step``) and 3 uncompressed steps in turns,
    the first step's loss within 1e-5 relative of the uncompressed step's
    and the parameters it leaves within 5e-3 (``tests/test_substrate.py``'s
    one-step bounds), every loss finite; the first step's reduced gradient
    of each stacked leaf against the plain gradient quantized and
    dequantized apart from the step (``int8_decompress`` of
    ``int8_error_feedback_compress``), its residuals likewise, its
    ``grad_norm`` the reduced gradients' norm and the optimizer's gradients
    those clipped by it, bit for bit (one int8 quantum allowed at 1e-5 of
    the elements where the gradient's run-to-run noise moves a rounding); s per step of each, the later
    steps' loss and parameter differences, ``compressed_psum``'s ms per
    step (CUDA events), peak GB, the residual's norm; (b) ``python -m repro_torch.launch.dryrun
    --arch qwen3-0.6b --shape train_4k`` on the production 16×16 mesh in a
    spawned process (fake tensors, no CUDA device visible) started before
    phase 15: an ``ok`` record with per-device FLOPs and collective bytes,
    its ``hbm_bytes`` equal to the card's ``total_memory``.

Then one JSON line describing every kernel, and the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository's ``src/`` beside it, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import json
import math
import multiprocessing
import os
import random
import re
import subprocess
import sys
import tempfile
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


def kernel_modules():
    """Kernel name → wrapper module holding its ``launches`` count."""
    from repro_torch.kernels import decode_attention, mrb_ring, sim_step

    return {"sim_step": sim_step, "mrb_append": mrb_ring, "mrb_decode_attention": decode_attention}


def reset_counts():
    for mod in kernel_modules().values():
        mod.launches = 0


def read_counts():
    return {name: mod.launches for name, mod in kernel_modules().items()}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def nvidia_smi_clocks() -> str:
    """SM and memory clocks, power draw and temperature, as nvidia-smi reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,temperature.gpu",
         "--format=csv,noheader"],
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


ROUND_FLOOR_ROUNDS = (2_000, 102_000)


@functools.lru_cache(maxsize=None)
def round_floor_ms(threads, device):
    """The least time a simulator round can take in one CTA of ``threads``
    threads: ms per round of the calibration kernel (one shared-memory
    write, one barrier, one shared-memory read per round), from the
    difference of two round counts so the launch drops out."""
    from repro_torch.kernels import sim_step as kmod

    lo, hi = ROUND_FLOOR_ROUNDS
    t_lo, t_hi = (time_ms(lambda r=r: kmod.round_floor(threads, r, device), 5, warmup=1)
                  for r in (lo, hi))
    return (t_hi - t_lo) / (hi - lo)


def plan_of(tab):
    from repro_torch.kernels.sim_step import launch_plan

    return launch_plan(tab.A, tab.C, tab.R, tab.H, tab.Tmax, tab.total_tasks())


def plan_row(tab):
    """The launch plan, checked against the CUDA side's shared-memory
    bytes."""
    from repro_torch.kernels import sim_step as kmod

    plan = plan_of(tab)
    smem = kmod.build().sim_step_smem_bytes(tab.A, tab.C, tab.R, tab.H, plan["tasks"],
                                            plan["warps"])
    assert smem == plan["smem_bytes"], f"launch_plan {plan['smem_bytes']} B, CUDA side {smem} B"
    return dict(warps=plan["warps"], actors_per_thread=plan["actors_per_thread"],
                smem_bytes=plan["smem_bytes"])


def rounds_bound(tab, rounds_max, ms, device):
    """sim_step's bound by rounds: the longest phenotype's round count times
    the round floor at the kernel's block size (the launch plan's
    threads); its CTAs run side by side."""
    threads = plan_of(tab)["threads"]
    floor = round_floor_ms(threads, device)
    bound_ms = rounds_max * floor
    return dict(bound_ms=bound_ms, bound_by="rounds", round_floor_us=floor * 1e3,
                threads=threads, gap_to_bound=ms / bound_ms,
                us_per_round=ms * 1e3 / rounds_max)


def compare_kernel_plain(tab, K, k_max, ports):
    """Kernel and plain outputs on ``tab``; asserts bit-identity, round
    counts included, and returns (max abs difference, plain-run stats with
    its time in ``ms``)."""
    import torch
    from repro_torch.kernels import sim_step as kmod
    from repro_torch.sim.batched import simulate_plain

    kstats: dict = {}
    kf, kd, kh = kmod.sim_step(tab, K, k_max, ports, stats=kstats)
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
    assert torch.equal(kstats["rounds"], stats["rounds"]), \
        "sim_step round counts differ from the plain version"
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
            **plan_row(tab),
            rounds_mean=float(rounds.mean()), rounds_max=int(rounds.max()),
            ms=ms, plain_ms=plain_ms, bytes=nbytes,
            bytes_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, max_abs_err=err,
            **rounds_bound(tab, int(rounds.max()), ms, device),
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
    rounds = stats["rounds"].float()
    row = dict(case="main_path_shape", B=tab.B, A=tab.A, Tmax=tab.Tmax, ms=ms,
               **plan_row(tab),
               plain_ms=plain_ms, bytes=nbytes, bytes_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
               rounds_mean=float(rounds.mean()), rounds_max=int(rounds.max()), max_abs_err=err,
               **rounds_bound(tab, int(rounds.max()), ms, device))
    log("phase main-path-shape:", json.dumps(row))
    log(f"phase main-path-shape: sim_step {ms:.6f} ms ({row['us_per_round']:.6f} us per round) "
        f"against its rounds bound {row['bound_ms']:.6f} ms ({row['rounds_max']} rounds x "
        f"{row['round_floor_us']:.5f} us): {row['gap_to_bound']:.1f}x")
    return row


def phase_main_path(device):
    from repro_torch.core import ExplorationProblem, NSGA2Explorer, multicamera, paper_architecture
    from repro_torch.sim import batched, simulate_period

    problem = ExplorationProblem(
        graph=multicamera(), arch=paper_architecture(), strategy="MRB_Always",
        objectives=("sim_period", "memory", "core_cost"),
    )
    import torch
    from repro_torch.kernels import sim_step as kmod

    gens = []
    events = []
    launch = kmod.sim_step

    def timed_launch(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch(*args, **kwargs)
        end.record()
        events.append((start, end))
        return out

    kmod.sim_step = timed_launch  # batched._run_batch looks it up at each call
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

        reset_counts()
        batched.int32_fallbacks = 0
        run = NSGA2Explorer(**MAIN_PATH).explore(
            problem, engine=eng, on_generation=on_generation
        )
        counts, fallbacks = read_counts(), batched.int32_fallbacks
        launches = counts["sim_step"]
        graph = eng._transformed(run.archive[0].genotype.xi)
    kmod.sim_step = launch
    torch.cuda.synchronize()
    kernel_ms = [s.elapsed_time(e) for s, e in events]
    assert launches > 0, "the main path launched no sim_step kernel"
    assert fallbacks == 0, f"{fallbacks} phenotypes rerouted by the int32 guard"
    front = run.front
    assert front and all(len(p) == 3 and all(math.isfinite(v) for v in p) for p in front)
    for ind in run.archive[:4]:
        assert ind.objectives[0] == simulate_period(graph, problem.arch, ind.schedule), \
            "archived sim_period differs from the event-driven simulator"
    summary = dict(launches=launches, counts=counts, int32_fallbacks=fallbacks, front=len(front),
                   evaluations=run.evaluations, wall_s=run.wall_s,
                   decode_s=eng.decode_s, sim_s=eng.sim_s,
                   kernel_s=sum(kernel_ms) / 1e3, kernel_ms_per_launch=kernel_ms)
    log("phase main-path:", json.dumps(summary))
    summary["front_points"] = front   # phase 10's yardstick; not logged
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


# ------------------------------------------------------------ ring kernels
BF16_PEAK_FLOPS = 989e12   # H100 SXM dense bfloat16 tensor-core rate (NVIDIA data sheet)
F32_PEAK_FLOPS = 67e12     # H100 SXM float32 outside the tensor cores (NVIDIA data sheet)
APPEND_CASES = (  # B, C, H, d, block: the JAX package's tests/test_kernels.py sweep
    (1, 256, 2, 128, 128), (2, 512, 4, 128, 256), (2, 1024, 8, 64, 256),
)
ATTN_CASES = (  # B, C, kv, G, d, window, softcap, t
    (2, 512, 4, 3, 128, 0, 0.0, 100),        # the JAX package's five: partial fill
    (1, 512, 2, 8, 64, 128, 30.0, 700),      # wrap + window + softcap
    (2, 256, 1, 12, 128, 0, 0.0, 255),       # exactly full
    (1, 1024, 8, 2, 128, 512, 0.0, 2000),    # deep wrap + window
    (1, 256, 2, 1, 128, 0, 0.0, 0),          # single token, G=1
    (3, 100, 2, 5, 32, 0, 50.0, 250),        # ragged last tile, d=32
    (2, 4113, 1, 16, 256, 4096, 50.0, 9000), # ragged, G=16, d=256, window
    (2, 1, 1, 16, 256, 0, 0.0, 7),           # capacity 1
    (1, 32768, 2, 2, 128, 64, 0.0, 40000),   # window << C: a few tiles of a long ring
    (2, 32768, 1, 4, 256, 0, 50.0, 10),      # partial fill: nearly all splits empty
    (1, 4113, 8, 16, 256, 0, 0.0, 4200),     # ragged, G=16, no window
    (1, 4096, 2, 2, 128, 0, 50.0, -1),       # nothing readable: the mean of V, split S >= 2
    (1, 4096, 2, 2, 128, 256, 50.0, -1),     # the same with a window
    # the model families' attention layers: at their served ring (64 slots,
    # wrapped), and inside and past the window of a ring that wraps
    (4, 64, 32, 1, 112, 4096, 0.0, 100),     # Zamba2 shared: d=112 (14 bf16 chunks), G=1
    (2, 256, 32, 1, 112, 100, 0.0, 300),     # d=112, window < C, past the window
    (1, 4160, 32, 1, 112, 4096, 0.0, 3000),  # d=112, inside the window, no wrap yet
    (1, 4160, 32, 1, 112, 4096, 0.0, 9000),  # d=112, past the window, wrapped
    (4, 64, 24, 1, 64, 0, 0.0, 100),         # MusicGen: d=64, G=1, kv=24
    (2, 512, 24, 1, 64, 0, 0.0, 300),        # MusicGen, partial fill
    (4, 64, 8, 4, 128, 4096, 0.0, 100),      # Mixtral: G=4, window 4096
    (1, 4160, 8, 4, 128, 4096, 0.0, 9000),   # Mixtral, past the window, wrapped
    (4, 64, 8, 2, 128, 0, 0.0, 100),         # InternVL2: G=2, d=128
    (4, 64, 4, 16, 128, 0, 0.0, 100),        # Qwen3-MoE: G=16, kv=4
    (1, 4160, 4, 16, 128, 0, 0.0, 5000),     # Qwen3-MoE, wrapped
)
ATTN_TOL = {"float32": 3e-5, "bfloat16": 2e-2}
GEMMA_LAYERS = 42
TIMED_ATTN = (  # name, B, C, kv, G, d, window, softcap, t, rings cycled
    ("served_local", 4, 64, 8, 2, 256, 4096, 50.0, 63, GEMMA_LAYERS),
    ("served_global", 4, 64, 8, 2, 256, 0, 50.0, 63, GEMMA_LAYERS),
    ("long_local", 16, 4096, 8, 2, 256, 4096, 50.0, 4096 + 5, 1),
    ("long_global", 16, 32768, 8, 2, 256, 0, 50.0, 32768 + 5, 1),
    ("qwen3_long", 16, 32768, 8, 2, 128, 0, 0.0, 32768 + 5, 1),
    ("local_in_32k", 16, 32768, 8, 2, 256, 4096, 50.0, 32768 + 5, 1),  # Gemma-2 local layer, 32k cache
    ("g16_4k", 16, 4096, 8, 16, 256, 0, 0.0, 4096 + 5, 1),  # the most readers a kv head may have
    # phase 14's families at their served shape, cycling over their rings
    ("zamba2_shared", 4, 64, 32, 1, 112, 4096, 0.0, 63, 13),
    ("mixtral_served", 4, 64, 8, 4, 128, 4096, 0.0, 63, 8),
    ("musicgen_served", 4, 64, 24, 1, 64, 0, 0.0, 63, 48),
    ("internvl2_served", 4, 64, 8, 2, 128, 0, 0.0, 63, 24),
    ("qwen3moe_served", 4, 64, 4, 16, 128, 0, 0.0, 63, 94),
    ("zamba2_long", 16, 4096, 32, 1, 112, 4096, 0.0, 4096 + 5, 1),
)
FAMILY_ATTN = ("zamba2_shared", "mixtral_served", "musicgen_served", "internvl2_served",
               "qwen3moe_served", "zamba2_long")
TIMED_APPEND = (  # name, B, C, H (kv heads), d, rings cycled; the served shape first
    ("served", 4, 64, 8, 256, GEMMA_LAYERS),
    ("long_local", 16, 4096, 8, 256, 1),
    ("long_global", 16, 32768, 8, 256, 1),
    ("qwen3_long", 16, 32768, 8, 128, 1),
    ("zamba2_shared", 4, 64, 32, 112, 13),
    ("musicgen_served", 4, 64, 24, 64, 48),
)
FAMILY_APPEND = ("zamba2_shared", "musicgen_served")
SERVE = dict(batch=4, prompt_len=32, new_tokens=32, context=64, seed=0)
WRAP = dict(batch=4, prompt_len=24, new_tokens=48, context=64, window=32)


def randn(shape, dtype, device, gen, scale=1.0):
    import torch

    return torch.randn(shape, generator=gen, device=device, dtype=dtype).mul_(scale)


def time_cycle(fn, n, reps, warmup=2):
    """Mean ms per call of ``fn(i)``, i cycling over ``n`` inputs."""
    it = iter(range(10 ** 9))
    return time_ms(lambda: fn(next(it) % n), reps, warmup)


def bound(nbytes, flops, peak_flops):
    """(least ms, what bounds it) on an H100 SXM at its data-sheet rates."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_append(device):
    """mrb_append vs its plain version over the sweep, mixed token types,
    negative ω and the wrap sequence; exact.  Returns the max abs error."""
    import torch
    from repro_torch.kernels.mrb_ring import mrb_append
    from repro_torch.kernels.ref import mrb_append_ref

    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    n = 0
    for B, C, H, d, block in APPEND_CASES:
        for bdt in (torch.float32, torch.bfloat16):
            for tdt in (torch.float32, torch.bfloat16):
                buf = randn((B, C, H, d), bdt, device, gen)
                tok = randn((B, 1, H, d), tdt, device, gen)
                for omega in (0, 1, block - 1, block, C - 1, -1):
                    om = torch.tensor(omega, dtype=torch.int32, device=device)
                    got = mrb_append(buf.clone(), om, tok)
                    want = mrb_append_ref(buf.clone(), om, tok)
                    assert torch.equal(got, want), f"mrb_append differs at {(B, C, H, d, omega, bdt, tdt)}"
                    n += 1
    C = 8
    ring = torch.zeros((1, C, 1, 128), device=device)
    for i in range(C + 3):
        mrb_append(ring, torch.tensor(i % C, dtype=torch.int32, device=device),
                   torch.full((1, 1, 1, 128), float(i + 1), device=device))
    want = torch.tensor([9, 10, 11, 4, 5, 6, 7, 8], dtype=torch.float32, device=device)
    assert torch.equal(ring[0, :, 0, 0], want), "mrb_append wrap sequence"
    torch.cuda.synchronize()
    log(f"phase ring-kernels: mrb_append exact on {n} writes and the wrap sequence")
    return 0.0


def check_append_kv(device):
    """mrb_append_kv vs its plain version over the sweep (ring and token
    types, ω in range, negative, clamped at either end, ω = C - 1) and a
    70-step wrap sequence; exact, ω included, one launch per call.
    Returns the max abs error."""
    import torch
    from repro_torch.kernels import mrb_ring
    from repro_torch.kernels.ref import mrb_append_kv_ref

    gen = torch.Generator(device=device)
    gen.manual_seed(17)
    n = 0

    def both(bk, bv, omega, k, v):
        om, om_ref = (torch.tensor(omega, dtype=torch.int32, device=device) for _ in range(2))
        got_k, got_v, want_k, want_v = bk.clone(), bv.clone(), bk.clone(), bv.clone()
        before = mrb_ring.launches
        mrb_ring.mrb_append_kv(got_k, got_v, om, k, v)
        assert mrb_ring.launches == before + 1, "mrb_append_kv: one launch per call"
        mrb_append_kv_ref(want_k, want_v, om_ref, k, v)
        assert torch.equal(got_k, want_k) and torch.equal(got_v, want_v), \
            f"mrb_append_kv rings differ at {(tuple(bk.shape), omega, bk.dtype, k.dtype)}"
        assert int(om) == int(om_ref), f"mrb_append_kv ω {int(om)} != {int(om_ref)}"

    # and the served shapes: Gemma-2, Zamba2's shared block, MusicGen
    for B, C, H, d, block in APPEND_CASES + ((4, 64, 8, 256, 64), (4, 64, 32, 112, 64),
                                             (4, 64, 24, 64, 64)):
        for bdt in (torch.float32, torch.bfloat16):
            for tdt in (torch.float32, torch.bfloat16):
                bk, bv = randn((B, C, H, d), bdt, device, gen), randn((B, C, H, d), bdt, device, gen)
                k, v = randn((B, 1, H, d), tdt, device, gen), randn((B, 1, H, d), tdt, device, gen)
                for omega in (0, 1, block - 1, block, C - 1, -1, -C - 3, C + 5):
                    both(bk, bv, omega, k, v)
                    n += 1
    C, steps = 8, 70
    bk = torch.zeros((2, C, 2, 64), device=device, dtype=torch.bfloat16)
    bv = torch.zeros_like(bk)
    om = torch.tensor(C - 2, dtype=torch.int32, device=device)
    rk, rv, rom = bk.clone(), bv.clone(), om.clone()
    for i in range(steps):
        k = torch.full((2, 1, 2, 64), float(i + 1), device=device)
        mrb_ring.mrb_append_kv(bk, bv, om, k, -k)
        mrb_append_kv_ref(rk, rv, rom, k, -k)
    assert torch.equal(bk, rk) and torch.equal(bv, rv) and int(om) == int(rom) == (C - 2 + steps) % C
    last = [float(steps - (steps + C - 3 - s) % C) for s in range(C)]  # the last C tokens
    assert bk[0, :, 0, 0].float().tolist() == last, "mrb_append_kv wrap sequence"
    torch.cuda.synchronize()
    log(f"phase ring-kernels: mrb_append_kv exact (rings and ω) on {n} writes and a {steps}-step wrap")
    return 0.0


def check_attention_case(case, dtype_name, device, seed=7):
    """Kernel vs plain on one case, and vs the plain split-and-merge at the
    kernel's own cluster size; asserts the tolerance, returns max abs error."""
    import torch
    from repro_torch.kernels.decode_attention import launch_plan, mrb_decode_attention
    from repro_torch.kernels.ref import decode_attention_ref, decode_attention_split_ref

    B, C, kv, G, d, window, cap, t = case
    dt = getattr(torch, dtype_name)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    q = randn((B, kv * G, d), dt, device, gen, 0.3)
    k = randn((B, C, kv, d), dt, device, gen, 0.3)
    v = randn((B, C, kv, d), dt, device, gen, 0.3)
    tt = torch.tensor(t, dtype=torch.int32, device=device)
    got = mrb_decode_attention(q, k, v, tt, window=window, softcap=cap)
    want = decode_attention_ref(q, k, v, tt, window, cap)
    plan = launch_plan(q, k, window=window)
    split = decode_attention_split_ref(q, k, v, tt, window, cap, plan["splits"], plan["tile"])
    assert got.dtype == dt and got.shape == q.shape
    err = float((got.float() - want.float()).abs().max())
    tol = ATTN_TOL[dtype_name]
    assert torch.allclose(got.float(), want.float(), atol=tol, rtol=tol), \
        f"mrb_decode_attention {case} {dtype_name}: max abs err {err}"
    assert torch.allclose(got.float(), split.float(), atol=tol, rtol=tol), \
        f"mrb_decode_attention {case} {dtype_name}: differs from the split-and-merge plain version"
    return err


def valid_slots(C, t, window):
    return min(C, t + 1, window if window > 0 else C)


def time_attention(row, device):
    """CUDA-event times of kernel, plain version and (without softcap) one
    scaled_dot_product_attention call on the same rings; the bound counts
    the valid slots' K/V, q, out and t.  Also the cluster size, shared
    memory per CTA and tile the kernel is launched with."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import launch_plan, mrb_decode_attention
    from repro_torch.kernels.ref import decode_attention_ref

    name, B, C, kv, G, d, window, cap, t, n = row
    H, dt = kv * G, torch.bfloat16
    gen = torch.Generator(device=device)
    gen.manual_seed(11)
    q = randn((n, B, H, d), dt, device, gen, 0.3)
    k = randn((n, B, C, kv, d), dt, device, gen, 0.3)
    v = randn((n, B, C, kv, d), dt, device, gen, 0.3)
    tt = torch.tensor(t, dtype=torch.int32, device=device)
    big = n == 1
    ms = time_cycle(lambda i: mrb_decode_attention(q[i], k[i], v[i], tt, window=window, softcap=cap),
                    n, reps=10 if big else 5 * n)
    plain_ms = time_cycle(lambda i: decode_attention_ref(q[i], k[i], v[i], tt, window, cap),
                          n, reps=2 if big else n, warmup=1)
    library_ms = None
    if cap == 0:
        slot = torch.arange(C, device=device)
        pos = t - torch.remainder(t - slot, C)
        ok = (pos >= 0) & ((pos > t - window) if window > 0 else True)
        mask = ok.view(1, 1, 1, C)

        def library(i):
            return F.scaled_dot_product_attention(
                q[i].view(B, H, 1, d), k[i].permute(0, 2, 1, 3), v[i].permute(0, 2, 1, 3),
                attn_mask=mask, enable_gqa=True)

        ref = mrb_decode_attention(q[0], k[0], v[0], tt, window=window, softcap=cap)
        assert torch.allclose(library(0).reshape(B, H, d).float(), ref.float(), atol=2e-2, rtol=2e-2), \
            f"{name}: scaled_dot_product_attention computes another function"
        library_ms = time_cycle(library, n, reps=10 if big else 5 * n)
    cv = valid_slots(C, t, window)
    nbytes = 2 * B * H * d * 2 + 2 * B * cv * kv * d * 2 + 4
    bound_ms, bound_by = bound(nbytes, 4 * B * H * cv * d, BF16_PEAK_FLOPS)
    out = dict(shape=name, B=B, C=C, kv=kv, G=G, d=d, window=window, softcap=cap, t=t,
               rings=n, **launch_plan(q[0], k[0], window=window), ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by,
               bytes_per_s=nbytes / (ms * 1e-3))
    del q, k, v
    torch.cuda.empty_cache()
    return out


def host_us(fn, n, calls=1000):
    """Host µs per call of ``fn(i)``, i cycling over ``n`` inputs: a host
    clock over ``calls`` calls with no synchronisation between them."""
    import torch

    for i in range(3):
        fn(i % n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(calls):
        fn(i % n)
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def time_append(row, device):
    """mrb_append (bfloat16) at one of TIMED_APPEND's shapes, cycling over
    ``rings`` rings; ω sits mid-ring.  Each ring's views are made before
    the clock starts, so every row times the call alone.  At the served
    shape (the first row) also the fused per-layer write (``kv``) beside
    what it replaces and what PyTorch would do: CUDA-event ms per call of
    - ``ms``: mrb_append_kv, K and V of one layer and ω's advance;
    - ``replaced_ms``: the sequence it replaces, two mrb_append launches
      then add_ and remainder_ on ω;
    - ``library_ms``: one index_copy_ (a token, with a long index made once);
    - ``pair_library_ms``: two index_copy_ then add_ and remainder_ on ω;
    and the host µs per call of both wrappers and of index_copy_."""
    import torch
    from repro_torch.kernels.mrb_ring import mrb_append, mrb_append_kv
    from repro_torch.kernels.ref import mrb_append_ref

    name, B, C, H, d, n = row
    gen = torch.Generator(device=device)
    gen.manual_seed(13)
    buf = randn((n, B, C, H, d), torch.bfloat16, device, gen)
    tok = randn((n, B, 1, H, d), torch.bfloat16, device, gen)
    bk, k = list(buf.unbind(0)), list(tok.unbind(0))
    om = torch.tensor(C // 2 + 5, dtype=torch.int32, device=device)
    om_long = om.long().reshape(1)
    reps = max(5 * n, 50)
    ms = time_cycle(lambda i: mrb_append(bk[i], om, k[i]), n, reps=reps)
    plain_ms = time_cycle(lambda i: mrb_append_ref(bk[i], om, k[i]), n, reps=reps)
    library_ms = time_cycle(lambda i: bk[i].index_copy_(1, om_long, k[i]), n, reps=reps)
    nbytes = 2 * B * H * d * 2 + 4
    bound_ms, bound_by = bound(nbytes, 0, BF16_PEAK_FLOPS)
    out = dict(shape=name, B=B, C=C, H=H, d=d, rings=n, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by)
    if name == TIMED_APPEND[0][0]:
        bv = list(randn((n, B, C, H, d), torch.bfloat16, device, gen).unbind(0))
        v = list(randn((n, B, 1, H, d), torch.bfloat16, device, gen).unbind(0))
        oms = list(torch.full((n,), C // 2 + 5, dtype=torch.int32, device=device).unbind(0))

        def fused(i):
            mrb_append_kv(bk[i], bv[i], oms[i], k[i], v[i])

        def replaced(i):
            mrb_append(bk[i], oms[i], k[i])
            mrb_append(bv[i], oms[i], v[i])
            oms[i].add_(1).remainder_(C)

        def pair(i):
            bk[i].index_copy_(1, om_long, k[i])
            bv[i].index_copy_(1, om_long, v[i])
            oms[i].add_(1).remainder_(C)

        def index_copy(i):
            bk[i].index_copy_(1, om_long, k[i])

        # in turns: fused, replaced, one index_copy_, pair, fused
        kv_ms = time_cycle(fused, n, reps=reps)
        replaced_ms = time_cycle(replaced, n, reps=reps)
        one_ms = time_cycle(index_copy, n, reps=reps)
        pair_ms = time_cycle(pair, n, reps=reps)
        kv_ms_2 = time_cycle(fused, n, reps=reps)
        kv_bytes = 2 * (2 * B * H * d * 2) + 2 * 4
        out["kv"] = dict(
            ms=min(kv_ms, kv_ms_2), ms_runs=[kv_ms, kv_ms_2], replaced_ms=replaced_ms,
            library_ms=one_ms, pair_library_ms=pair_ms, bytes=kv_bytes,
            bound_ms=bound(kv_bytes, 0, BF16_PEAK_FLOPS)[0],
            host_us=host_us(fused, n),
            single_host_us=host_us(lambda i: mrb_append(bk[i], om, k[i]), n),
            index_copy_host_us=host_us(index_copy, n),
        )
        out["host_us"] = out["kv"]["single_host_us"]
        del bv, v, oms
    del buf, tok, bk, k
    torch.cuda.empty_cache()
    return out


def phase_ring_kernels(device):
    append_err = max(check_append(device), check_append_kv(device))
    attn_err = 0.0
    for case in ATTN_CASES:
        for dtype_name in ("float32", "bfloat16"):
            err = check_attention_case(case, dtype_name, device)
            attn_err = max(attn_err, err)
            log(f"phase ring-kernels: mrb_decode_attention {case} {dtype_name}: max abs err {err:.3e}")
    append_rows = []
    for row in TIMED_APPEND:
        append_rows.append(time_append(row, device))
        log("phase ring-kernels: mrb_append timing", json.dumps(append_rows[-1]))
    attn_rows = []
    for row in TIMED_ATTN:
        attn_rows.append(time_attention(row, device))
        log("phase ring-kernels: mrb_decode_attention timing", json.dumps(attn_rows[-1]))
    log("phase ring-kernels: clocks after the timings:", nvidia_smi_clocks())
    return append_err, attn_err, append_rows, attn_rows


def ring_check(rings, idxs, n_heads, hd, windows, softcap, device):
    """The kernel against the plain version on live rings ``idxs`` of a
    stacked ring state (``k``/``v`` [n, B, C, kv, d], ``t`` [n]), with a
    seeded query at the last written position; returns each max abs error."""
    import torch
    from repro_torch.kernels.decode_attention import mrb_decode_attention
    from repro_torch.kernels.ref import decode_attention_ref

    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    errs = []
    for l, window in zip(idxs, windows):
        q = randn((rings["k"].shape[1], n_heads, hd), rings["k"].dtype, device, gen, 0.3)
        t = rings["t"][l] - 1  # the last written position
        args = (q, rings["k"][l], rings["v"][l], t)
        got = mrb_decode_attention(*args, window=window, softcap=softcap)
        want = decode_attention_ref(*args, window, softcap)
        err = float((got.float() - want.float()).abs().max())
        assert torch.allclose(got.float(), want.float(), atol=2e-2, rtol=2e-2), \
            f"live ring {l}: max abs err {err}"
        errs.append(err)
    return errs


def live_ring_check(model, state, device):
    """The kernel against the plain version on the live rings of layer 0
    (local) and layer 1 (global) after a serving run."""
    cfg = model.cfg
    return ring_check(state["layers"], (0, 1), cfg.n_heads, cfg.resolved_head_dim,
                      model.windows[:2], cfg.attn_softcap, device)


def profile_decode(model, state, steps=3, batch=SERVE["batch"], cond=None):
    """Device busy share and the top kernels over ``steps`` decode steps
    (tokens [batch, 1], or [batch, K, 1] for audio; ``cond`` passed to
    every step), from torch.profiler's CUDA kernel events (None where it
    saw none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime import make_serve_step

    cfg = model.cfg
    step = make_serve_step(cfg)
    shape = (batch, cfg.n_codebooks, 1) if cfg.n_codebooks else (batch, 1)
    tok = torch.zeros(shape, dtype=torch.int32, device=model.device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            tok, _, state = step(model, tok, state, cond)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return None
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    ours = {}
    for key, tag in (("mrb_append", "mrb_append_kv_kernel"),
                     ("mrb_decode_attention", "decode_attention_kernel")):
        durs = [e.time_range.elapsed_us() for e in kernels if tag in e.name]
        ours[key] = dict(launches_per_step=len(durs) / steps,
                         device_ms_per_launch=sum(durs) / max(len(durs), 1) / 1e3)
    return dict(steps=steps, wall_ms_per_step=wall_us / steps / 1e3,
                device_busy_ms_per_step=busy_us / steps / 1e3, busy_share=busy_us / wall_us,
                kernels_per_step=len(kernels) / steps, ours=ours,
                top=[(n[:60], us / steps / 1e3) for n, us in top])


def phase_serving(device):
    """Gemma-2 9B at full width through the port's serve(); asserts the
    launch counts, the outputs and the live rings."""
    import torch
    from repro_torch.launch.serve import serve

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = serve("gemma2-9b", device=device, **SERVE)
    counts = read_counts()
    model, state = res["model"], res["state"]
    cfg = model.cfg
    steps = SERVE["prompt_len"] + SERVE["new_tokens"]
    assert counts["mrb_append"] == cfg.n_layers * steps, counts
    assert counts["mrb_decode_attention"] == cfg.n_layers * steps, counts
    assert counts["sim_step"] == 0, counts
    gen = res["generated"]
    assert tuple(gen.shape) == (SERVE["batch"], SERVE["new_tokens"])
    assert 0 <= int(gen.min()) and int(gen.max()) < cfg.vocab, "tokens out of range"
    assert torch.isfinite(res["last_logits"]).all(), "non-finite logits"
    assert state["layers"]["t"].tolist() == [steps] * cfg.n_layers
    live = live_ring_check(model, state, device)
    floor_ms = cfg.param_count() * 2 / HBM_BYTES_PER_S * 1e3
    summary = dict(res["summary"], launches=counts, weight_floor_ms=floor_ms,
                   params=cfg.param_count(), live_ring_err=live,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   first_tokens=gen[0, :8].tolist())
    log("phase serving:", json.dumps(summary))
    prof = profile_decode(model, state)
    if prof:  # the profiler slows the host; the unprofiled step is the wall to compare with
        prof["busy_share_of_unprofiled_step"] = (
            prof["device_busy_ms_per_step"] / summary["decode_ms_per_step"])
    log("phase serving: profile", json.dumps(prof) if prof else "device busy share: not measured")
    del res, model, state
    torch.cuda.empty_cache()
    return summary, prof


def phase_ring_wrap(device):
    """Card (kernels) vs CPU (plain versions) on the same weights and
    prompt, with the ring wrapping; float32 throughout, TF32 off."""
    import copy

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.launch.serve import generate
    from repro_torch.models import init_model

    cfg = get_config("gemma2-9b").smoke.replace(sliding_window=WRAP["window"])
    host_model = init_model(cfg, seed=0, device="cpu")
    card_model = copy.deepcopy(host_model).to(device)
    prompt = make_batch(cfg, WRAP["prompt_len"], WRAP["batch"], device="cpu")["tokens"]
    n_new, ctx = WRAP["new_tokens"], WRAP["context"]
    reset_counts()
    card = generate(card_model, prompt.to(device), n_new, ctx, keep_logits=True)
    counts = read_counts()
    host = generate(host_model, prompt, n_new, ctx, keep_logits=True)
    steps = WRAP["prompt_len"] + n_new
    assert counts["mrb_append"] == cfg.n_layers * steps, counts
    assert counts["mrb_decode_attention"] == cfg.n_layers * steps, counts
    assert torch.equal(card["generated"].cpu(), host["generated"]), "greedy tokens differ"
    err = 0.0
    for a, b in zip(card["logits"], host["logits"]):
        a = a.cpu()
        err = max(err, float((a - b).abs().max()))
        assert torch.allclose(a, b, atol=1e-4, rtol=1e-4), f"logits differ by {err}"
    assert len(card["logits"]) == steps
    out = dict(steps=steps, ring_capacity=ctx, window=cfg.sliding_window,
               max_abs_logit_err=err, tokens_identical=True, launches=counts)
    log("phase ring-wrap:", json.dumps(out))
    return out


def phase_qwen3(device):
    import torch
    from repro_torch.launch.serve import serve

    reset_counts()
    res = serve("qwen3-0.6b", device=device, **SERVE)
    counts = read_counts()
    cfg = res["model"].cfg
    steps = SERVE["prompt_len"] + SERVE["new_tokens"]
    assert counts["mrb_append"] == cfg.n_layers * steps, counts
    assert counts["mrb_decode_attention"] == cfg.n_layers * steps, counts
    gen = res["generated"]
    assert 0 <= int(gen.min()) and int(gen.max()) < cfg.vocab, "tokens out of range"
    assert torch.isfinite(res["last_logits"]).all(), "non-finite logits"
    floor_ms = cfg.param_count() * 2 / HBM_BYTES_PER_S * 1e3
    summary = dict(res["summary"], launches=counts, weight_floor_ms=floor_ms,
                   params=cfg.param_count())
    log("phase qwen3:", json.dumps(summary))
    del res
    torch.cuda.empty_cache()
    return summary


# ------------------------------------------------------- device explorer
EVO_OBJECTIVES = ("sim_period", "period", "memory", "core_cost", "comm_volume")
EVO_IDENTITY = dict(distinct=8, B=TILE_B, K=16)   # card B=256 = 8 distinct rows tiled
EVO_MAIN_OBJECTIVES = ("sim_period", "memory", "core_cost")  # the main path's problem
# The main path's own launch shapes: B = offspring and B = population at
# ξ=1 (MRB_Always), K = the explorer's sim_iters; 25 distinct rows.
EVO_MAIN_IDENTITY = dict(distinct=MAIN_PATH["offspring"],
                         Bs=(MAIN_PATH["offspring"], MAIN_PATH["population"]))
EVO_BENCH = dict(population=512, offspring=256, generations=5, seed=11)  # BENCH_evo.json
RELHV_GATE = 0.25                                  # tests/test_torch_evo.py's gate
PLAIN_JOB_THREADS = 2      # the spawned plain re-check's share of the card host's 8 cores


def relaxed_identity(g, xi, device, objectives=EVO_OBJECTIVES, distinct=EVO_IDENTITY["distinct"],
                     Bs=(EVO_IDENTITY["B"],), K=EVO_IDENTITY["K"]):
    """The relaxed evaluation of graph ``g`` at ξ = ``xi`` (every bit) for
    each batch of ``B`` in ``Bs`` seeded gene rows (``distinct`` rows
    tiled) on the card against the same function on CPU tensors (the plain
    simulator, one intra-op thread) over the distinct rows; asserts
    equality, inf in the same places, and one ``sim_step`` launch for each
    of the card's two calls per batch.  Returns (max abs difference over
    finite entries, the card's F on the host per batch, the second card
    call's ms between CUDA events per batch)."""
    import numpy as np
    import torch
    from repro_torch.core import ExplorationProblem, paper_architecture
    from repro_torch.evo import PopulationLayout
    from repro_torch.evo.decode import DecodeTables, make_relaxed_eval
    from repro_torch.kernels import sim_step as kmod

    problem = ExplorationProblem(graph=g, arch=paper_architecture(), objectives=objectives)
    layout = PopulationLayout(problem.space())
    rng = np.random.default_rng(1000 + xi)
    rows = rng.integers(0, layout.bounds, size=(distinct, layout.n_genes)).astype(np.int32)
    rows[:, layout.xi_slice] = xi
    tab = DecodeTables(problem.space(), (xi,) * layout.n_xi)
    card_fn = make_relaxed_eval(tab, objectives, sim_iters=K, device=device)
    cpu_fn = make_relaxed_eval(tab, objectives, sim_iters=K, device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        host_rows = cpu_fn(torch.as_tensor(rows))
    finally:
        torch.set_num_threads(threads)
    errs, cards, times = [], [], []
    for B in Bs:
        pick = np.arange(B) % distinct
        genes = torch.as_tensor(rows[pick], device=device)
        before = kmod.launches
        card = card_fn(genes)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        again = card_fn(genes)
        end.record()
        torch.cuda.synchronize()
        assert kmod.launches == before + 2, \
            "the relaxed evaluation did not launch sim_step once a call"
        assert torch.equal(torch.isinf(card), torch.isinf(again)) and torch.equal(
            card[torch.isfinite(card)], again[torch.isfinite(again)]), "two card calls differ"
        host = host_rows[torch.as_tensor(pick)]
        card = card.cpu()
        where = f"{g.name} ξ={xi} B={B} K={K}"
        assert torch.equal(torch.isinf(card), torch.isinf(host)), f"{where}: inf differs"
        fin = torch.isfinite(host)
        err = float((card[fin] - host[fin]).abs().max()) if bool(fin.any()) else 0.0
        assert torch.equal(card[fin], host[fin]), f"{where}: card and CPU differ by {err}"
        errs.append(err)
        cards.append(card)
        times.append(start.elapsed_time(end))
    return max(errs), cards, times


def merged_on_cpu(tabs):
    """One CPU table of all of ``tabs``' phenotypes (one ξ pattern: the
    same graph-derived tensors, which it checks) and the tables' sizes."""
    import dataclasses
    import torch

    per_phenotype = ("dur", "route", "core", "gamma")
    shared = [f.name for f in dataclasses.fields(tabs[0])
              if isinstance(getattr(tabs[0], f.name), torch.Tensor)
              and f.name not in per_phenotype]
    assert all(getattr(t, f) is getattr(tabs[0], f) for t in tabs for f in shared), \
        "the tables do not share their graph-derived tensors"
    cpu = dataclasses.replace(
        tabs[0], **{f: getattr(tabs[0], f).cpu() for f in shared},
        **{f: torch.cat([getattr(t, f) for t in tabs]).cpu() for f in per_phenotype})
    return cpu, [t.B for t in tabs]


def plain_job(cpu, sizes, K, k_max, ports, threads):
    """The plain program on the merged CPU table ``cpu`` at ``threads``
    intra-op threads, as one batch (its rows are independent): ``(fire,
    dead, horizon)`` and the round counts per table of ``sizes``, and the
    seconds it took.  Runs in a spawned process beside the card's phases."""
    import torch
    from repro_torch.sim.batched import simulate_plain

    torch.set_num_threads(threads)
    t0 = time.perf_counter()
    stats = {}
    outs = simulate_plain(cpu, K, k_max, ports, stats=stats)
    return (list(zip(*(out.split(sizes) for out in outs))), stats["rounds"].split(sizes),
            time.perf_counter() - t0)


def first_rows(tab, n):
    """``tab`` cut to its first ``n`` phenotypes (the per-phenotype tables;
    the graph-derived ones shared)."""
    import dataclasses

    return dataclasses.replace(tab, **{f: getattr(tab, f)[:n]
                                       for f in ("dur", "route", "core", "gamma")})


def huge_graph():
    """Two actors of 3·2**26 on every core type, one channel (δ=1, γ=2):
    event times pass 2**31 within 16 firings and wrap as int32."""
    from repro_torch.core import ApplicationGraph

    g = ApplicationGraph("huge")
    for a in ("A", "B"):
        g.add_actor(a, {"t1": 3 * 2**26, "t2": 3 * 2**26, "t3": 3 * 2**26})
    g.add_channel("c", "A", "B", delay=1, capacity=2, token_bytes=64)
    return g


def timed_generations(explorer, problem, engine, on_launch=None):
    """Run ``explorer`` and return (run, per-generation wall seconds, seconds
    from the call to the end of generation 0, launch marks per generation)."""
    marks = []
    t = [time.perf_counter()]
    t0 = t[0]
    walls = []
    first = []

    def on_generation(gen, run):
        now = time.perf_counter()
        walls.append(now - t[0])
        t[0] = now
        if not first:
            first.append(now - t0)
        if on_launch is not None:
            marks.append(on_launch())

    run = explorer.explore(problem, engine=engine, on_generation=on_generation)
    return run, walls, first[0], marks


def relaxed_generation_parts(device, graph, strategy, objectives, population, offspring,
                             reps=5, seed=0):
    """Where a warm relaxed generation's time goes, by parts timed alone
    (host clock around a synchronize, best of ``reps``): the relaxed
    evaluation of ``offspring`` rows, the ranking (ranks + crowding) of
    the merged ``population + offspring`` points, and the variation
    (tournaments, crossover, mutation); the evaluation's launches and
    device busy share from torch.profiler (None where it saw no kernel)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import ExplorationProblem, paper_architecture, xi_mode
    from repro_torch.evo import PopulationLayout, ranking, variation
    from repro_torch.evo.decode import DecodeTables, make_relaxed_eval

    problem = ExplorationProblem(graph=graph, arch=paper_architecture(), strategy=strategy,
                                 objectives=objectives)
    layout = PopulationLayout(problem.space(), xi_mode(strategy))
    fn = make_relaxed_eval(DecodeTables(problem.space(), (layout.xi_forced or 0,) * layout.n_xi),
                           objectives, device=device)
    rng = np.random.default_rng(seed)
    genes = torch.as_tensor(layout.force_xi(rng.integers(
        0, layout.bounds, size=(population + offspring, layout.n_genes)).astype(np.int32)),
        device=device)
    F = fn(genes)
    bounds = torch.as_tensor(layout.bounds, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def best_ms(f):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return min(out)

    def rank():
        r = ranking.nondomination_ranks(F)
        return r, ranking.crowding(F, r)

    def vary():
        r, c = rank_pop
        ia = variation.tournament_pick(gen, r, c, offspring)
        ib = variation.tournament_pick(gen, r, c, offspring)
        child = variation.uniform_crossover(gen, genes[ia], genes[ib], 0.95)
        return variation.mutate(gen, child, bounds)

    rank_pop = rank()
    parts = dict(eval_ms=best_ms(lambda: fn(genes[:offspring])), rank_ms=best_ms(rank),
                 vary_ms=best_ms(vary), fronts=int(rank_pop[0].max()) + 1,
                 population=population, offspring=offspring)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(genes[:offspring])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if kernels:
        busy_us = sum(e.time_range.elapsed_us() for e in kernels)
        parts.update(eval_kernels=len(kernels), eval_device_ms=busy_us / 1e3,
                     eval_busy_share=busy_us / wall_us)
    return parts


def phase_device_explorer(device, host_front):
    """Phase 10: (a) card-vs-CPU relaxed-eval identity on Multicamera ξ=1
    at the main path's own shapes, and on a population whose event times
    wrap; (b) ``torch_nsga2`` relaxed on the main path, one relaxed
    ``sim_step`` launch of each shape handed to a spawned plain re-check
    (``out["launch_checks"]``, for :func:`finish_launch_checks`); (c) the
    BENCH_evo.json shape, host ``nsga2`` against ``torch_nsga2`` relaxed."""
    import inspect
    import torch
    from repro_torch.core import (ExplorationProblem, NSGA2Explorer, multicamera,
                                  paper_architecture, relative_hypervolume, sobel)
    from repro_torch.evo import TorchNSGA2Explorer
    from repro_torch.kernels import sim_step as kmod
    from repro_torch.sim import simulate_period

    out = dict(identity=[])
    # (the B=256 identity at K=16 is held by tests/test_torch_cuda.py, and
    # sim_step at B=256 by phase 2)
    k_main = inspect.signature(TorchNSGA2Explorer).parameters["sim_iters"].default
    t0 = time.perf_counter()
    err, cards, ms = relaxed_identity(multicamera(), 1, device, EVO_MAIN_OBJECTIVES, K=k_main,
                                      **EVO_MAIN_IDENTITY)
    out["identity"].append(dict(case="main_path_shape_multicamera_xi1",
                                B=[c.shape[0] for c in cards], K=k_main,
                                distinct=EVO_MAIN_IDENTITY["distinct"], max_abs_err=err,
                                card_ms=ms, inf_rows=[int(torch.isinf(c).any(1).sum())
                                                      for c in cards],
                                seconds=time.perf_counter() - t0))
    log("phase device-explorer: identity", json.dumps(out["identity"][-1]))
    err, cards, ms = relaxed_identity(huge_graph(), 0, device, ("sim_period", "memory"),
                                      Bs=(64,))
    assert bool(torch.isinf(cards[0][:, 0]).any()), "no wrapped population gave inf"
    out["identity"].append(dict(case="int32_wrap", B=64, max_abs_err=err,
                                inf_rows=int(torch.isinf(cards[0][:, 0]).sum())))
    log("phase device-explorer: identity", json.dumps(out["identity"][-1]))

    # (b) the main path through torch_nsga2 relaxed, sim_period by the kernel
    problem = ExplorationProblem(
        graph=multicamera(), arch=paper_architecture(), strategy="MRB_Always",
        objectives=EVO_MAIN_OBJECTIVES,
    )
    events = []
    calls = []
    launch = kmod.sim_step

    def timed_launch(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = launch(*args, **kwargs)
        end.record()
        events.append((start, end))
        calls.append((args, kwargs, res))  # the tables and outputs, kept on the card
        return res

    kmod.sim_step = timed_launch  # bound by make_relaxed_eval and batched._run_batch
    try:
        with problem.make_engine(sim_backend="cuda", device=device) as eng:
            reset_counts()
            run, walls, ttfg, marks = timed_generations(
                TorchNSGA2Explorer(evaluation="relaxed", **MAIN_PATH), problem, eng,
                on_launch=lambda: len(events))
            counts = read_counts()
            graph = eng._transformed(run.archive[0].genotype.xi)
    finally:
        kmod.sim_step = launch
    torch.cuda.synchronize()
    relaxed_launches = marks[-1]
    kernel_ms = [s.elapsed_time(e) for s, e in events]
    assert counts["sim_step"] > 0 and relaxed_launches == 1 + MAIN_PATH["generations"], \
        (counts, marks)
    # Every relaxed launch of the run against the plain program on a CPU
    # copy of the very tables the decode wrote on the card, all launches
    # in one plain batch (its rows are independent; one batch costs less).
    relaxed = calls[:relaxed_launches]
    calls.clear()
    ports = {args[3] for args, _, _ in relaxed}
    assert all(not kwargs and args[1] == args[2] == k_main for args, kwargs, _ in relaxed) \
        and len(ports) == 1, [(args[1:], kwargs) for args, kwargs, _ in relaxed]
    assert [args[0].B for args, _, _ in relaxed] == (
        [MAIN_PATH["population"]] + [MAIN_PATH["offspring"]] * MAIN_PATH["generations"])
    # one launch of each shape (B=100, then the first B=25) held against the
    # plain program, the B=100 launch on its first 25 rows (the program's
    # rows are independent); the other B=25 launches differ only in their rows
    relaxed = relaxed[:2]
    rows = MAIN_PATH["offspring"]
    cpu, sizes = merged_on_cpu([first_rows(args[0], rows) for args, _, _ in relaxed])
    launch_checks = dict(
        rows=rows, K=k_main,
        card=[[x[:rows].cpu() for x in card] for _, _, card in relaxed],
        launches=[dict(B=args[0].B, A=args[0].A, Tmax=args[0].Tmax, ms=ms,
                       round_floor_ms=round_floor_ms(plan_of(args[0])["threads"], device))
                  for (args, _, _), ms in zip(relaxed, kernel_ms)],
        # the CPU half of the check runs in a spawned process while the
        # card goes on with the next phases; main() joins it at the end
        pool=concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")))
    launch_checks["job"] = launch_checks["pool"].submit(
        plain_job, cpu, sizes, k_main, k_main, ports.pop(), PLAIN_JOB_THREADS)
    front = run.front
    assert front and all(len(p) == 3 and all(math.isfinite(v) for v in p) for p in front)
    for ind in run.archive[:4]:
        assert ind.objectives[0] == simulate_period(graph, problem.arch, ind.schedule), \
            "archived sim_period differs from the event-driven simulator"
    relhv = relative_hypervolume(front, host_front)
    assert relhv >= RELHV_GATE, f"torch_nsga2 relHV {relhv} against phase 3's host front"
    out["main_path"] = dict(
        launches=counts["sim_step"], relaxed_launches=relaxed_launches,
        engine_launches=counts["sim_step"] - relaxed_launches,
        relaxed_evaluations=run.meta["relaxed_evaluations"],
        relaxed_final_candidates=run.meta["relaxed_final_candidates"],
        gen_wall_s=walls, warm_gen_s=sum(walls[1:]) / len(walls[1:]), ttfg_s=ttfg,
        wall_s=run.wall_s, front=len(front), relhv_vs_nsga2=relhv,
        relaxed_kernel_ms=kernel_ms[:relaxed_launches],
        engine_kernel_ms=kernel_ms[relaxed_launches:],
    )
    log("phase device-explorer: main path", json.dumps(out["main_path"]))
    out["main_path_parts"] = relaxed_generation_parts(
        device, multicamera(), "MRB_Always", problem.objectives, MAIN_PATH["population"],
        MAIN_PATH["offspring"])
    log("phase device-explorer: main path, a warm generation's parts",
        json.dumps(out["main_path_parts"]))

    # (c) BENCH_evo.json's shape: host nsga2 against torch_nsga2 relaxed
    bench = ExplorationProblem(graph=sobel(), arch=paper_architecture(), strategy="Reference")
    arms = {}
    for name, explorer in (
        ("host_nsga2", NSGA2Explorer(track_hypervolume=False, **EVO_BENCH)),
        ("torch_nsga2", TorchNSGA2Explorer(evaluation="relaxed", track_hypervolume=False,
                                           **EVO_BENCH)),
    ):
        with bench.make_engine(sim_backend="cuda", device=device) as eng:
            run, walls, ttfg, _ = timed_generations(explorer, bench, eng)
        arms[name] = dict(gen_wall_s=walls, warm_gen_s=sum(walls[1:]) / len(walls[1:]),
                          ttfg_s=ttfg, wall_s=run.wall_s, front=run.front,
                          decodes=run.evaluations,
                          relaxed_evaluations=run.meta.get("relaxed_evaluations"))
    relhv = relative_hypervolume(arms["torch_nsga2"]["front"], arms["host_nsga2"]["front"])
    assert relhv >= RELHV_GATE, f"BENCH_evo shape: relHV {relhv}"
    for arm in arms.values():
        arm["front"] = len(arm["front"])
    out["bench_evo"] = dict(arms, relhv=relhv, warm_speedup=arms["host_nsga2"]["warm_gen_s"]
                            / arms["torch_nsga2"]["warm_gen_s"])
    log("phase device-explorer: BENCH_evo shape", json.dumps(out["bench_evo"]))
    out["bench_evo_parts"] = relaxed_generation_parts(
        device, sobel(), "Reference", bench.objectives, EVO_BENCH["population"],
        EVO_BENCH["offspring"])
    log("phase device-explorer: BENCH_evo shape, a warm generation's parts",
        json.dumps(out["bench_evo_parts"]))
    out["max_abs_err"] = max(row["max_abs_err"] for row in out["identity"])
    out["launch_checks"] = launch_checks
    return out


def finish_launch_checks(checks):
    """Phase 10 (b)'s relaxed launches against the plain program: joins the
    spawned job and asserts the kernel's outputs equal to the plain
    program's on the same tables; returns the rows, each with its bound by
    rounds (the plain program's round counts, equal to the kernel's in
    phase 2, over the rows checked)."""
    import torch

    try:
        plain, rounds, plain_s = checks["job"].result()
    finally:
        checks["pool"].shutdown()
    rows = []
    for row, card, (pf, pd, ph), r in zip(checks["launches"], checks["card"], plain, rounds):
        kf, kd, kh = card
        err = max(int((kf.long() - pf.long()).abs().max()),
                  int((kh.long() - ph.long()).abs().max()),
                  int((kd.long() - pd.long()).abs().max()))
        assert torch.equal(kf, pf) and torch.equal(kd, pd) and torch.equal(kh, ph), \
            f"main-path sim_step launch at B={row['B']} differs from the plain version by {err}"
        rounds_max = int(r.max())
        floor_ms = row.pop("round_floor_ms")
        rows.append(dict(row, rows_checked=checks["rows"], K=checks["K"], max_abs_err=err,
                         dead=int(kd.sum()), rounds_max=rounds_max,
                         rounds_bound_ms=rounds_max * floor_ms))
    log("phase device-explorer: main-path launches against the plain version",
        json.dumps(dict(launches=rows, plain_s=plain_s, threads=PLAIN_JOB_THREADS)))
    return rows


# ------------------------------------------- exact decoders and scenarios
EXACT_OBJECTIVES = ("sim_period", "memory", "core_cost")
# tests/test_explorers.py's golden ILP configuration on Sobel: population 8,
# offspring 4, 2 generations, seed 7, a 2.0 s ILP budget per decode.
EXACT_PATH = dict(population=8, offspring=4, generations=2, seed=7)
EXACT_BUDGET_S = 2.0
LARGE_PATH = dict(population=16, offspring=8, generations=2, seed=0)
LARGE_CHECKED = 8        # schedules of a large scenario re-simulated, at most
LARGE_CHECKED_WIDE = 3   # ... where a transformed graph has more than 64 actors:
                         # the Python event simulator's cost grows with width


def large_tier():
    """The generated "large" tier, one scenario of each family: the first
    five draws of ``sample_scenarios(seed=0, size="large")``, which cycle
    over the families."""
    from repro_torch.scenarios import FAMILIES, sample_scenarios

    tier = sample_scenarios(seed=0, n=len(FAMILIES), size="large")
    assert sorted(sc.app.family for sc in tier) == sorted(FAMILIES)
    return tier


@functools.lru_cache(maxsize=None)
def build_large_case(family, n=4, seed=0):
    """(transformed graph, arch, schedules) of the large tier's scenario of
    ``family`` at ξ=1, pipelined: ``n`` seeded caps_hms decodes."""
    from repro_torch import core

    sc = next(s for s in large_tier() if s.app.family == family)
    g, arch = sc.build()
    gt = core.pipeline_delays(
        core.substitute_mrbs(g, {a: 1 for a in core.multicast_actors(g)})
    )
    scheds = random_schedules(gt, arch, n, seed=f"chip-smoke:{sc.name}:1:{seed}")
    return gt, arch, scheds


class LaunchLog:
    """Records every ``sim_step`` call made while it is entered: the tables'
    shape, CUDA events around the call and the kernel's round counts, each
    under the current ``label``.  ``finish`` turns them into rows with ms
    and the bound by rounds."""

    def __init__(self):
        self.rows = []
        self.label = None

    def __enter__(self):
        import torch
        from repro_torch.kernels import sim_step as kmod

        launch = self._launch = kmod.sim_step

        def recorded(tab, K, k_max, ports, stats=None):
            stats = {} if stats is None else stats
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            res = launch(tab, K, k_max, ports, stats=stats)
            end.record()
            plan = plan_of(tab)
            self.rows.append(dict(path=self.label, B=tab.B, A=tab.A, Tmax=tab.Tmax, K=K,
                                  k_max=k_max, warps=plan["warps"], threads=plan["threads"],
                                  events=(start, end), rounds=stats["rounds"]))
            return res

        kmod.sim_step = recorded  # batched._run_batch looks it up at each call
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import sim_step as kmod

        kmod.sim_step = self._launch

    def finish(self, device):
        import torch

        torch.cuda.synchronize()
        for row in self.rows:
            start, end = row.pop("events")
            rounds = row.pop("rounds")
            row["ms"] = start.elapsed_time(end)
            row["rounds_max"] = int(rounds.max()) if rounds.numel() else 0
            row["rounds_bound_ms"] = row["rounds_max"] * round_floor_ms(row["threads"], device)
        return self.rows


def feasible_by_xi(engine, individuals):
    """Feasible decoded individuals grouped by ξ pattern (one transformed
    graph each)."""
    groups = {}
    for ind in individuals:
        if ind.feasible and ind.schedule is not None:
            groups.setdefault(ind.genotype.xi, []).append(ind.schedule)
    return {xi: (engine._transformed(xi), scheds) for xi, scheds in groups.items()}


def check_backends(gt, arch, scheds, device):
    """Three checks on schedules of one transformed graph: the kernel
    (``batch_simulate``, backend ``"cuda"``, one call) against the
    event-driven simulator, with identical fire times, periods and deadlock
    flags; zero violations of the independent verifier; and equal
    ``check_sim_invariants`` lists from either backend's result.  Returns
    (the invariant lists, seconds in the event simulator)."""
    from repro_torch.sim import SimConfig, batch_simulate, check_sim_invariants, simulate
    from repro_torch.verify import verify_schedule

    cfg = SimConfig(trace=False)
    kernel = batch_simulate(gt, arch, scheds, cfg, backend="cuda", device=device)
    lists, events_s = [], 0.0
    for s, k in zip(scheds, kernel):
        t0 = time.perf_counter()
        e = simulate(gt, arch, s, cfg)
        events_s += time.perf_counter() - t0
        assert (k.fire_times, k.period, k.deadlocked) == (e.fire_times, e.period, e.deadlocked), \
            f"{gt.name} (A={len(gt.actors)}): kernel and event simulator differ"
        report = verify_schedule(gt, arch, s)
        assert report.ok, f"{gt.name}: {report.summary()}"
        inv = check_sim_invariants(gt, arch, s, result=k)
        assert inv == check_sim_invariants(gt, arch, s, result=e), \
            f"{gt.name}: invariants differ between the kernel's and the events' results"
        lists.append(inv)
    return lists, events_s


def phase_exact_and_scenarios(device):
    """Phase 11: (a) the ILP path at Sobel (MRB_Explore, ``decoder="ilp"``,
    host ``nsga2``, ``sim_period`` by the kernel) and ``torch_nsga2`` in
    exact mode on the same engine; (b) the generated large tier through
    host ``nsga2`` with caps_hms.  Their decoded schedules are held, kernel
    against events, by :func:`check_backends`; every ``sim_step`` launch of
    the phase is printed with its shape, ms and bound by rounds."""
    from repro_torch.core import (ExplorationProblem, NSGA2Explorer, decoders, get_explorer,
                                  paper_architecture, sobel)
    from repro_torch.sim import batched

    t_phase = time.perf_counter()
    out = dict(large=[])
    launches = LaunchLog()

    # (a) the ILP path at Sobel, the paper's app on its architecture
    problem = ExplorationProblem(graph=sobel(), arch=paper_architecture(), strategy="MRB_Explore",
                                 decoder="ilp", ilp_budget_s=EXACT_BUDGET_S,
                                 objectives=EXACT_OBJECTIVES)
    ilp = decoders.DECODERS["ilp"]
    proven = []

    def counted(*args, **kwargs):
        res = ilp(*args, **kwargs)
        proven.append(res.proven_optimal)
        return res

    decoders.DECODERS["ilp"] = counted
    try:
        with problem.make_engine(sim_backend="cuda", device=device) as eng, launches:
            launches.label = "ilp_path"
            reset_counts()
            batched.int32_fallbacks = 0
            t0 = time.perf_counter()
            host = NSGA2Explorer(**EXACT_PATH).explore(problem, engine=eng)
            host_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            dev = get_explorer("torch_nsga2", evaluation="exact", **EXACT_PATH).explore(
                problem, engine=eng)
            dev_s = time.perf_counter() - t0
            counts, fallbacks = read_counts(), batched.int32_fallbacks
            assert counts["sim_step"] > 0, "the ILP path launched no sim_step kernel"
            assert dev.front == host.front and dev.history == host.history, \
                "torch_nsga2 exact and host nsga2 differ on the ILP path"
            assert host.front and all(math.isfinite(v) for p in host.front for v in p)
            launches.label = "ilp_check"
            lists, events_s = [], 0.0
            for gt, scheds in feasible_by_xi(eng, eng._cache.values()).values():
                got, secs = check_backends(gt, problem.arch, scheds, device)
                lists += got
                events_s += secs
    finally:
        decoders.DECODERS["ilp"] = ilp
    out["ilp"] = dict(decodes=len(proven), proven_optimal=sum(proven), host_nsga2_s=host_s,
                      torch_nsga2_exact_s=dev_s, decode_s=eng.decode_s, sim_s=eng.sim_s,
                      launches=counts["sim_step"], int32_fallbacks=fallbacks,
                      front=host.front, checked=len(lists),
                      invariant_violations=[x for x in lists if x], events_s=events_s)
    log("phase exact-scenarios: ilp path", json.dumps(out["ilp"]))
    log(f"phase exact-scenarios: {sum(proven)} of {len(proven)} ILP decodes proved optimal")

    # (b) the generated large tier, caps_hms
    for sc in large_tier():
        problem = ExplorationProblem.from_scenario(sc, objectives=EXACT_OBJECTIVES,
                                                   strategy="MRB_Explore")
        with problem.make_engine(sim_backend="cuda", device=device) as eng, launches:
            launches.label = sc.name
            reset_counts()
            batched.int32_fallbacks = 0
            t0 = time.perf_counter()
            run = NSGA2Explorer(**LARGE_PATH).explore(problem, engine=eng)
            wall_s = time.perf_counter() - t0
            counts, fallbacks = read_counts(), batched.int32_fallbacks
            assert counts["sim_step"] > 0, f"{sc.name}: no sim_step kernel launched"
            assert run.front and all(math.isfinite(v) for p in run.front for v in p)
            inds = sorted((ind for ind in eng._cache.values() if ind.feasible),
                          key=lambda ind: (ind.genotype.xi, ind.genotype.cd, ind.genotype.ba))
            widths = {len(eng._transformed(ind.genotype.xi).actors) for ind in inds}
            k = LARGE_CHECKED if max(widths) <= 64 else LARGE_CHECKED_WIDE
            picked = random.Random(f"chip-smoke:large:{sc.name}").sample(inds, min(k, len(inds)))
            launches.label = f"{sc.name}:check"
            lists, events_s, checked_widths = [], 0.0, []
            for gt, scheds in feasible_by_xi(eng, picked).values():
                got, secs = check_backends(gt, problem.arch, scheds, device)
                lists += got
                events_s += secs
                checked_widths += [len(gt.actors)] * len(scheds)
        out["large"].append(dict(
            scenario=sc.name, actors=[min(widths), max(widths)],
            cores=len(problem.arch.cores), interconnects=len(problem.arch.interconnects),
            wall_s=wall_s, decode_s=eng.decode_s, sim_s=eng.sim_s, decodes=run.evaluations,
            launches=counts["sim_step"], int32_fallbacks=fallbacks, front=len(run.front),
            checked=len(lists), checked_actors=checked_widths,
            invariant_violations=[x for x in lists if x], events_s=events_s))
        log("phase exact-scenarios: large", json.dumps(out["large"][-1]))

    rows = launches.finish(device)
    for i, row in enumerate(rows):
        log("phase exact-scenarios: sim_step", i, json.dumps(row))
    by_shape = {}
    for row in rows:
        key = (row["path"].endswith("check"), row["A"], row["warps"])
        by_shape.setdefault(key, []).append(row)
    out["shapes"] = [dict(check=check, A=A, warps=warps, launches=len(rs),
                          B=sorted({r["B"] for r in rs}), K=sorted({r["K"] for r in rs}),
                          ms=[min(r["ms"] for r in rs), max(r["ms"] for r in rs)],
                          rounds_bound_ms=[min(r["rounds_bound_ms"] for r in rs),
                                           max(r["rounds_bound_ms"] for r in rs)])
                     for (check, A, warps), rs in sorted(by_shape.items())]
    out["path_launches"] = sum(1 for r in rows if not r["path"].endswith("check"))
    out["check_launches"] = len(rows) - out["path_launches"]
    out["kernel_ms"] = sum(r["ms"] for r in rows)
    out["max_warps"] = max(r["warps"] for r in rows)
    out["seconds"] = time.perf_counter() - t_phase
    log("phase exact-scenarios: launches by (check, A, warps)", json.dumps(out["shapes"]))
    log(f"phase exact-scenarios: kernel = events on {out['ilp']['checked']} ILP schedules and "
        f"{sum(r['checked'] for r in out['large'])} large-tier schedules; 0 verifier "
        f"violations; invariant lists equal; {out['path_launches']} path and "
        f"{out['check_launches']} check launches; {out['seconds']:.1f} s")
    return out


# --------------------------------------- the paper's campaign through the CLI
# Phase 12's campaign: the paper's three apps on its 24-core, 5-interconnect
# target at full size, population 100, offspring 25, seed 0; the paper runs
# 2,500 generations, cut here to CAMPAIGN_GENERATIONS (generations only).
CAMPAIGN_GENERATIONS = 2
CAMPAIGN_PARAMS = dict(population=100, offspring=25, generations=CAMPAIGN_GENERATIONS, seed=0)
CAMPAIGN_APPS = ("Sobel", "Sobel4", "Multicamera")
CAMPAIGN_DIRECT = ("Sobel", "Sobel4")    # nsga2 cells re-run directly and compared
CAMPAIGN_CHECKED = {"Sobel": 8, "Sobel4": 8, "Multicamera": 4}  # archived schedules
# per cell held kernel = events (the event simulator takes ~0.6 s a
# Multicamera schedule)
CROSSOVER_BATCHES = (1, 2, 4, 8, 16)


def campaign_spec(name="paper-campaign", apps=CAMPAIGN_APPS, strategies=None, explorers=None,
                  backends=("cuda", "auto")):
    """The phase's campaign as JSON: apps × strategies × explorers ×
    sim_backend, with ``torch_nsga2`` (relaxed) on MRB_Always only and
    ``auto`` on one cell, Sobel MRB_Explore ``nsga2``."""
    from repro_torch import core

    arch = core.paper_architecture().to_dict()
    graphs = {"Sobel": core.sobel, "Sobel4": core.sobel4, "Multicamera": core.multicamera}
    return {
        "name": name,
        "problems": [{"label": app, "graph": graphs[app]().to_dict(), "arch": arch,
                      "objectives": ["sim_period", "memory", "core_cost"]} for app in apps],
        "axes": {"strategy": list(strategies or ("Reference", "MRB_Always", "MRB_Explore")),
                 "sim_backend": list(backends),
                 "explorer": list(explorers or ("nsga2", "torch_nsga2"))},
        "explorer": "nsga2",
        "explorer_params": dict(CAMPAIGN_PARAMS),
        "overrides": [
            {"match": {"explorer": "torch_nsga2", "strategy": ["Reference", "MRB_Explore"]},
             "skip": True},
            {"match": {"sim_backend": "auto", "explorer": "torch_nsga2"}, "skip": True},
            {"match": {"sim_backend": "auto", "strategy": ["Reference", "MRB_Always"]},
             "skip": True},
            {"match": {"sim_backend": "auto", "problem": ["Sobel4", "Multicamera"]},
             "skip": True},
            {"match": {"explorer": "torch_nsga2"},
             "set": {"explorer_params": {"evaluation": "relaxed"}}},
        ],
    }


def write_spec(path, spec):
    with open(path, "w") as f:
        json.dump(spec, f)
    return path


def cli_out(argv):
    """``repro_torch.cli.main(argv)`` with its standard output captured:
    (exit code, the text it printed)."""
    import contextlib
    import io

    from repro_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def check_archive(cell, art, device, limit):
    """Re-decode up to ``limit`` archived genotypes of one cell; their
    archived ``sim_period`` equals the event simulator's, and the kernel
    equals the event simulator on their schedules (phase 11's
    :func:`check_backends`: also the verifier and the invariants)."""
    from repro_torch.core import ExplorationProblem
    from repro_torch.core.dse import Genotype, GenotypeSpace, evaluate_genotype, transformed_graph
    from repro_torch.sim import SimConfig, simulate_period

    problem = ExplorationProblem.from_json(cell.problem)
    space = GenotypeSpace(problem.graph, problem.arch)
    groups = {}
    for entry in art["run"]["archive"][:limit]:
        gd = entry["genotype"]
        geno = Genotype(tuple(gd["xi"]), tuple(gd["cd"]), tuple(gd["ba"]))
        ind = evaluate_genotype(space, geno, decoder=problem.decoder,
                                ilp_budget_s=problem.ilp_budget_s, pipelined=problem.pipelined)
        assert ind.feasible, f"{cell.tag}: an archived genotype no longer decodes"
        groups.setdefault(geno.xi, []).append((ind.schedule, entry["objectives"][0]))
    checked = 0
    for xi, pairs in groups.items():
        gt = transformed_graph(space, xi, problem.pipelined)
        scheds = [s for s, _ in pairs]
        check_backends(gt, problem.arch, scheds, device)
        for s, period in pairs:
            assert period == simulate_period(gt, problem.arch, s, SimConfig(trace=False)), \
                f"{cell.tag}: archived sim_period differs from the event simulator"
        checked += len(scheds)
    return checked


def crossover(device, reps=1):
    """Phase 12 (f): wall ms of one ξ=1 group of B phenotypes through the
    event simulator (one run each) and through the kernel
    (``batch_simulate``, lowering included), min of ``reps``; the crossing
    is the least B at which the kernel is no slower."""
    from repro_torch.sim import batch_simulate_periods, simulate_period

    rows, crossing = [], {}
    for app in ("sobel", "multicamera"):
        gt, arch, scheds, cfg = build_case(app, 1, None, n=max(CROSSOVER_BATCHES))
        batch_simulate_periods(gt, arch, scheds[:2], cfg, backend="cuda", device=device)
        for B in CROSSOVER_BATCHES:
            sub = scheds[:B]
            walls = {"events": [], "cuda": []}
            for _ in range(reps):
                t0 = time.perf_counter()
                ev = [simulate_period(gt, arch, s, cfg) for s in sub]
                walls["events"].append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                cu = batch_simulate_periods(gt, arch, sub, cfg, backend="cuda", device=device)
                walls["cuda"].append(time.perf_counter() - t0)
                assert cu == ev, f"{app} B={B}: kernel and event periods differ"
            row = dict(app=app, A=len(gt.actors), B=B,
                       events_ms=min(walls["events"]) * 1e3, cuda_ms=min(walls["cuda"]) * 1e3)
            rows.append(row)
            log("phase campaign: crossover", json.dumps(row))
            if app not in crossing and row["cuda_ms"] <= row["events_ms"]:
                crossing[app] = B
    return rows, crossing


def phase_campaign(device):
    """Phase 12: the paper's campaign through ``python -m repro_torch``'s
    entry point, in process: (a) the campaign spec written from code; (b)
    ``campaign run --jobs 1 --device cuda`` with the kernel counts reset
    just before and read just after, then its checks; (c) ``campaign
    resume`` after one Sobel artifact is deleted; (d) a Sobel-only copy
    through a ``--jobs 2`` spawn pool in a subprocess; (e) one Sobel
    MRB_Explore cell with recording on, ``trace export`` and ``trace
    summary``; (f) the ``auto`` backend's crossover batch size."""
    import shutil
    import tempfile

    import torch
    from repro_torch import obs
    from repro_torch.core import Campaign, ExplorationProblem, NSGA2Explorer, RunStore
    from repro_torch.core import campaign as campaign_mod
    from repro_torch.kernels import sim_step as kmod
    from repro_torch.sim import batched

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-campaign-")
    out = {}
    try:
        # (a) the spec
        spec = campaign_spec()
        spec_path = write_spec(os.path.join(tmp, "campaign.json"), spec)
        camp = Campaign.from_json(spec)
        cells = camp.expand()
        root = os.path.join(tmp, "campaigns")
        store = RunStore(os.path.join(root, camp.campaign_id()))
        log(f"phase campaign: {len(cells)} cells, campaign {camp.campaign_id()}, "
            f"generations cut to {CAMPAIGN_GENERATIONS}")

        # (b) the campaign through the CLI, each cell's engine seconds and
        # the kernel's CUDA-event time per launch
        events, per_cell = [], {}
        launch, run_cell = kmod.sim_step, campaign_mod.run_cell

        def timed_launch(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            res = launch(*args, **kwargs)
            end.record()
            events.append((start, end))
            return res

        def timed_run_cell(cell, engine=None):
            d0, s0, n0, t0 = engine.decode_s, engine.sim_s, len(events), time.perf_counter()
            art = run_cell(cell, engine=engine)
            per_cell[cell.tag] = dict(wall_s=time.perf_counter() - t0,
                                      decode_s=engine.decode_s - d0, sim_s=engine.sim_s - s0,
                                      launches=(n0, len(events)))
            return art

        kmod.sim_step, campaign_mod.run_cell = timed_launch, timed_run_cell
        batched.int32_fallbacks = 0
        t0 = time.perf_counter()
        try:
            reset_counts()
            rc, text = cli_out(["campaign", "run", spec_path, "--root", root, "--jobs", "1",
                                "--device", "cuda"])
            counts = read_counts()
        finally:
            kmod.sim_step, campaign_mod.run_cell = launch, run_cell
        run_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        for line in text.splitlines():
            log("phase campaign: cli |", line)
        assert rc == 0, f"campaign run exited {rc}"
        report = store.read_report()
        assert report["n_completed"] == len(cells) and not report["missing"], report["missing"]
        assert counts["sim_step"] > 0, "the campaign launched no sim_step kernel"
        assert counts["sim_step"] == len(events)
        kernel_ms = [s.elapsed_time(e) for s, e in events]
        for cell in cells:
            row = per_cell[cell.tag]
            a, b = row.pop("launches")
            row.update(launches=b - a, kernel_ms=sum(kernel_ms[a:b]),
                       front=len(report["cells"][cell.tag]["front"]))
            log("phase campaign: cell", cell.tag, json.dumps(row))
        auto = [c for c in cells if c.engine.get("sim_backend") == "auto"]
        assert len(auto) == 1
        choices = report["cells"][auto[0].tag]["meta"].get("sim_backend_choices")
        assert choices, "the auto cell recorded no backend choice"
        log("phase campaign: auto cell's choices", json.dumps(choices))
        out["run"] = dict(cells=len(cells), wall_s=run_s, launches=counts["sim_step"],
                          kernel_ms=sum(kernel_ms), counts=counts,
                          int32_fallbacks=batched.int32_fallbacks, auto_choices=choices)
        log("phase campaign: run", json.dumps(out["run"]))

        t0 = time.perf_counter()
        direct = 0
        for cell in cells:
            if cell.explorer != "nsga2" or cell.coords["problem"] not in CAMPAIGN_DIRECT:
                continue
            problem = ExplorationProblem.from_json(cell.problem)
            with problem.make_engine(device=device, **cell.engine) as eng:
                run = NSGA2Explorer(**cell.explorer_params).explore(problem, engine=eng)
            got = [tuple(p) for p in report["cells"][cell.tag]["front"]]
            assert sorted(run.front) == sorted(got), f"{cell.tag}: campaign and direct fronts differ"
            direct += 1
        log(f"phase campaign: {direct} nsga2 cells equal to direct explorer runs "
            f"({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        checked = sum(check_archive(c, store.load_cell(c.spec_hash()), device,
                                    CAMPAIGN_CHECKED[c.coords["problem"]]) for c in cells)
        log(f"phase campaign: kernel = events on {checked} archived schedules "
            f"({time.perf_counter() - t0:.1f} s)")
        rc, text = cli_out(["campaign", "report", camp.campaign_id(), "--root", root, "--verify"])
        verified = store.read_report()
        violations = sum(r["verify"]["violations"] for r in verified["cells"].values())
        vchecked = sum(r["verify"]["checked"] for r in verified["cells"].values())
        assert rc == 0 and violations == 0 and vchecked > 0, f"report --verify: {violations}"
        log(f"phase campaign: report --verify: {vchecked} schedules, 0 violations")
        out["checks"] = dict(direct=direct, archived=checked, verified=vchecked)

        # (c) resume after one Sobel cell's artifact is lost
        victim = next(c for c in cells if c.coords["problem"] == "Sobel"
                      and c.coords["strategy"] == "MRB_Explore" and c.explorer == "nsga2"
                      and c.engine.get("sim_backend") == "cuda")
        manifest_path = os.path.join(store.root, "manifest.json")
        with open(manifest_path, "rb") as f:
            manifest = f.read()
        published = len(store.success_log())
        store.delete_cell(victim.spec_hash())
        rc, _ = cli_out(["campaign", "resume", camp.campaign_id(), "--root", root,
                         "--jobs", "1", "--device", "cuda"])
        assert rc == 0
        with open(manifest_path, "rb") as f:
            assert f.read() == manifest, "the manifest changed on resume"
        redone = [r["spec"] for r in store.success_log()[published:]]
        assert redone == [victim.spec_hash()], f"resume re-executed {redone}"
        assert store.read_report()["cells"][victim.tag]["front"] == \
            report["cells"][victim.tag]["front"]
        log(f"phase campaign: resume re-executed only {victim.tag}; manifest byte-identical")
        # phase 13 holds the served artifacts against these
        out["artifacts"] = {c.spec_hash(): store.load_cell(c.spec_hash()) for c in cells}

        # (d) the spawn pool on the card, in a subprocess
        sobel_spec = campaign_spec(name="paper-campaign-sobel", apps=("Sobel",))
        sobel_path = write_spec(os.path.join(tmp, "sobel.json"), sobel_spec)
        pool_root = os.path.join(tmp, "pool")
        env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch", "campaign", "run", sobel_path,
             "--root", pool_root, "--jobs", "2", "--device", "cuda"],
            env=env, capture_output=True, text=True, timeout=600,
        )
        pool_s = time.perf_counter() - t0
        assert proc.returncode == 0, f"spawn pool run exited {proc.returncode}:\n{proc.stderr}"
        pool_camp = Campaign.from_json(sobel_spec)
        pool_store = RunStore(os.path.join(pool_root, pool_camp.campaign_id()))
        pool_report = pool_store.read_report()
        assert pool_report["n_completed"] == len(pool_camp.expand())
        for tag, row in pool_report["cells"].items():
            assert row["front"] == report["cells"][tag]["front"], f"{tag}: pool front differs"
        owners = sorted({r["owner"].rsplit(":", 1)[-1] for r in pool_store.success_log()})
        assert owners and all(o.startswith("w") for o in owners), owners
        out["pool"] = dict(cells=pool_report["n_completed"], wall_s=pool_s, workers=owners)
        log("phase campaign: spawn pool", json.dumps(out["pool"]))

        # (e) one Sobel MRB_Explore cell with recording on
        trace_spec = campaign_spec(name="paper-campaign-trace", apps=("Sobel",),
                                   strategies=("MRB_Explore",), explorers=("torch_nsga2",),
                                   backends=("cuda",))
        trace_spec["overrides"] = []   # torch_nsga2 in exact mode: host loop, device ranking
        trace_path = write_spec(os.path.join(tmp, "trace.json"), trace_spec)
        obs_dir = os.path.join(tmp, "obs")
        obs.configure(True, obs_dir)
        try:
            rc, _ = cli_out(["campaign", "run", trace_path, "--root", os.path.join(tmp, "traced"),
                             "--device", "cuda"])
        finally:
            obs.shutdown()
            obs.configure(None)
        assert rc == 0
        trace_out = os.path.join(tmp, "trace-export.json")
        rc, text = cli_out(["trace", "export", "--obs-dir", obs_dir, "--out", trace_out,
                            "--min-cats", "4"])
        assert rc == 0, text
        log("phase campaign: trace export |", text.strip())
        with open(trace_out) as f:
            trace = json.load(f)
        cats = set(obs.validate_chrome_trace(trace)["cats"])
        assert {"engine", "explorer", "sim"} <= cats and cats & {"runstore", "evo"}, cats
        executes = [e for e in trace["traceEvents"] if e["name"] == "sim.execute"]
        assert executes and all(e["args"]["backend"] == "cuda" for e in executes)
        rc, text = cli_out(["trace", "summary", "--obs-dir", obs_dir, "--top", "8"])
        assert rc == 0 and "self" in text
        for line in text.splitlines():
            log("phase campaign: trace summary |", line)
        out["trace"] = dict(cats=sorted(cats), sim_execute_spans=len(executes))

        # (f) auto's crossover
        rows, crossing = crossover(device)
        out["crossover"] = dict(crossing=crossing, rows=rows)
        log("phase campaign: auto crossover batch size", json.dumps(crossing))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase campaign: {out['seconds']:.1f} s")
    return out


# ------------------- the campaign service, chaos sweeps and the planning layer
# Phase 13 (a): phase 12's campaign cut to Sobel and Sobel4 (8 cells), served
# to two tenants by `campaign serve --workers 2` in a subprocess.
SERVED_APPS = ("Sobel", "Sobel4")
SERVED_TENANTS = ("alice", "bob")
# (c): `chaos run` plans on the card; the JAX package's default is 20, cut
# to one plan, about 45 s (each injected crash respawns a
# worker, which pays an interpreter and a torch import).
CHAOS_PLANS = 1
# (d): benchmarks/dataflow_plans.py's settings, without its 60 s wall budget
# (the fronts would depend on the clock).
DATAFLOW_MODELS = (("musicgen-medium", 8), ("zamba2-7b", 8), ("mixtral-8x7b", 4))
DATAFLOW_SHAPE = dict(seq_len=4096, batch=256)
DATAFLOW_PARAMS = dict(generations=15, population=16, seed=2, time_budget_s=None)


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def strip_wall(art):
    """A cell artifact without its wall time (the only field two runs of
    one cell on one device may differ in)."""
    art = json.loads(json.dumps(art))
    art["run"].pop("wall_s", None)
    return art


def timed_sim_step(events):
    """Wrap ``kernels.sim_step.sim_step`` so each launch records a pair of
    CUDA events; returns the original to restore."""
    import torch
    from repro_torch.kernels import sim_step as kmod

    launch = kmod.sim_step

    def timed(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = launch(*args, **kwargs)
        end.record()
        events.append((start, end))
        return res

    kmod.sim_step = timed
    return launch


def served_campaign(tmp, local_artifacts):
    """Phase 13 (a): `campaign serve --device cuda --workers 2` in a
    subprocess, the spec submitted as two tenants through the CLI."""
    import signal

    from repro_torch.core import Campaign, CampaignRunner, RunStore
    from repro_torch.service import GlobalStore, ServiceClient, ServiceError

    spec = campaign_spec(name="paper-campaign-served", apps=SERVED_APPS, backends=("cuda",))
    spec_path = write_spec(os.path.join(tmp, "served.json"), spec)
    camp = Campaign.from_json(spec)
    cells = camp.expand()
    hashes = sorted(c.spec_hash() for c in cells)
    root = os.path.join(tmp, "service")
    port = free_port()
    url = f"http://127.0.0.1:{port}"
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    log_path = os.path.join(tmp, "serve.log")
    out = {"cells": len(cells)}
    t0 = time.perf_counter()
    with open(log_path, "w") as server_log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch", "campaign", "serve", "--device", "cuda",
             "--workers", "2", "--service-root", root, "--host", "127.0.0.1",
             "--port", str(port)],
            env=env, stdout=server_log, stderr=subprocess.STDOUT,
        )
        try:
            client = ServiceClient(url, retries=0)
            while True:
                assert proc.poll() is None, f"campaign serve exited {proc.returncode}"
                try:
                    client.healthz()
                    break
                except ServiceError:
                    assert time.perf_counter() - t0 < 120, "campaign serve did not answer"
                    time.sleep(0.2)
            out["server_start_s"] = time.perf_counter() - t0
            client = ServiceClient(url)
            t_sub = time.perf_counter()
            rc, text = cli_out(["campaign", "submit", spec_path, "--url", url,
                                "--tenant", SERVED_TENANTS[0], "--no-wait"])
            assert rc == 0, text
            sids = [text.split("submitted ")[1].split(":")[0]]
            rc, text = cli_out(["campaign", "submit", spec_path, "--url", url,
                                "--tenant", SERVED_TENANTS[1]])
            out[f"{SERVED_TENANTS[1]}_s"] = time.perf_counter() - t_sub
            assert rc == 0, text
            for line in text.splitlines():
                log("phase service: cli |", line)
            sids.append(text.split("submitted ")[1].split(":")[0])
            status = client.wait(sids[0], timeout_s=900)
            out[f"{SERVED_TENANTS[0]}_s"] = time.perf_counter() - t_sub
            statuses = [status, client.status(sids[1])]
            out["pool_s"] = time.perf_counter() - t_sub
            for sid, st in zip(sids, statuses):
                assert st["done"], f"{sid} not done: {st.get('scheduler')}"
                assert st["report"]["n_completed"] == len(cells)
            walls = {}
            for sid in sids:
                for e in client.events(sid):
                    if e["type"] == "cell_done":
                        walls[e["tag"]] = dict(wall_s=e["wall_s"], tenant=e["tenant"])
            metrics = client.metrics()
            prom = client.metrics_text()
        finally:
            proc.send_signal(signal.SIGINT)
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                raise AssertionError("campaign serve did not stop on SIGINT")
    with open(log_path) as f:
        for line in f.read().splitlines()[:4]:
            log("phase service: serve |", line)
    assert proc.returncode == 0, f"campaign serve exited {proc.returncode}"
    gs = GlobalStore(root)
    counts = {}
    for rec in gs.cells.success_log():
        counts[rec["spec"]] = counts.get(rec["spec"], 0) + 1
    assert counts == {h: 1 for h in hashes}, f"success log {counts}"
    claims = os.listdir(os.path.join(root, "global", "claims"))
    assert claims == [], f"claims left: {claims}"
    # the manifest a local CampaignRunner writes for the same spec (every
    # cell already stored, so it executes none)
    local = RunStore(os.path.join(tmp, "local-served", camp.campaign_id()))
    for h in hashes:
        local.save_cell(h, gs.cells.load_cell(h))
    ran = CampaignRunner(camp, store=local, engine_overrides={"device": "cuda"}).run()
    assert not ran.executed
    with open(os.path.join(local.root, "manifest.json"), "rb") as f:
        manifest = f.read()
    for sid in sids:
        with open(os.path.join(gs.view(sid).root, "manifest.json"), "rb") as f:
            assert f.read() == manifest, f"{sid}: manifest differs from a local run's"
    for h in hashes:
        assert strip_wall(gs.cells.load_cell(h)) == strip_wall(local_artifacts[h]), \
            f"served artifact {h[:12]} differs from phase 12's"
    timing = metrics["backend_timing"]
    assert set(timing) == {"cuda"} and timing["cuda"]["cells"] == len(cells), timing
    assert metrics["counters"]["cells_executed"] == len(cells)
    assert metrics["counters"]["cells_deduped"] == len(cells)
    assert f'repro_backend_cells_total{{backend="cuda"}} {len(cells)}' in prom
    for tag in sorted(walls):
        log("phase service: cell", tag, json.dumps(walls[tag]))
    out.update(sids=sids, cell_wall_s=sum(w["wall_s"] for w in walls.values()),
               backend_timing=timing, worker_restarts=metrics["counters"]["worker_restarts"],
               dedup_hit_rate=metrics["dedup_hit_rate"])
    return out


def served_inline(tmp, local_artifacts):
    """Phase 13 (b): `make_server(workers=0)` in this process, one Sobel
    MRB_Explore cell on a fresh store, its `sim_step` launches counted."""
    import threading

    import torch
    from repro_torch.core import Campaign
    from repro_torch.kernels import sim_step as kmod
    from repro_torch.service import ServiceClient, make_server

    spec = campaign_spec(name="paper-campaign-inline", apps=("Sobel",),
                         strategies=("MRB_Explore",), explorers=("nsga2",), backends=("cuda",))
    (cell,) = Campaign.from_json(spec).expand()
    server, service = make_server(os.path.join(tmp, "inline"), workers=0, device="cuda")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    host, port = server.server_address[:2]
    events = []
    launch = timed_sim_step(events)
    try:
        client = ServiceClient(f"http://{host}:{port}")
        sid = client.submit(spec, tenant="inline")["submission_id"]
        t0 = time.perf_counter()
        reset_counts()
        service.scheduler.drain()
        counts = read_counts()
        wall = time.perf_counter() - t0
        status = client.status(sid)
    finally:
        kmod.sim_step = launch
        server.shutdown()
        server.server_close()
        service.close()
    torch.cuda.synchronize()
    assert status["done"], status.get("scheduler")
    assert counts["sim_step"] > 0, "the inline served cell launched no sim_step kernel"
    assert counts["sim_step"] == len(events)
    art = service.store.cells.load_cell(cell.spec_hash())
    assert strip_wall(art) == strip_wall(local_artifacts[cell.spec_hash()]), \
        "the inline served artifact differs from phase 12's"
    assert os.listdir(os.path.join(tmp, "inline", "global", "claims")) == []
    return dict(cell=cell.tag, wall_s=wall, launches=counts["sim_step"],
                kernel_ms=sum(s.elapsed_time(e) for s, e in events), counts=counts)


def worker_start_probe(spec_path, store_root):
    """Run in a fresh ``spawn`` process: the imports a scheduler worker
    makes before it reports ready, then the chaos spec's one unit on the
    card twice (fresh stores; the first pays the process's CUDA set-up),
    each timed, with the longest gap of a 0.1 s heartbeat thread over the
    units (the chaos harness replaces a worker after a 3 s gap and cancels
    a unit after 6 s)."""
    import threading

    t0 = time.perf_counter()
    from repro_torch.core.campaign import Campaign
    from repro_torch.core.runstore import RunStore
    from repro_torch.service import scheduler

    out = {"import_s": time.perf_counter() - t0}
    gaps, stop = [], threading.Event()

    def beat():
        last = time.perf_counter()
        while not stop.wait(0.1):
            now = time.perf_counter()
            gaps.append(now - last)
            last = now

    threading.Thread(target=beat, daemon=True).start()
    with open(spec_path) as f:
        cells = Campaign.from_json(json.load(f)).expand()
    for key in ("first_unit_s", "second_unit_s"):
        t0 = time.perf_counter()
        scheduler._execute_unit(cells, RunStore(os.path.join(store_root, key)), owner="probe",
                                engine_overrides={"device": "cuda"})
        out[key] = time.perf_counter() - t0
    stop.set()
    out.update(cells=len(cells), max_heartbeat_gap_s=max(gaps))
    return out


def chaos_sweep(tmp):
    """Phase 13 (c): a spawned worker's start on the card (the chaos
    timings hold only if a healthy first unit stays well inside them),
    then `python -m repro_torch chaos run --device cuda` over the port's
    smoke spec in a subprocess."""
    import multiprocessing

    from repro_torch.faults import DEFAULT_SPEC

    with multiprocessing.get_context("spawn").Pool(1) as pool:
        start = pool.apply(worker_start_probe, (DEFAULT_SPEC, os.path.join(tmp, "probe")))
    log("phase service: worker start", json.dumps(start))
    assert start["first_unit_s"] < 6.0 and start["max_heartbeat_gap_s"] < 3.0, start
    out_root = os.path.join(tmp, "chaos")
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch", "chaos", "run", "--device", "cuda",
         "--workers", "2", "--seed", "0", "--plans", str(CHAOS_PLANS), "--out", out_root],
        env=env, capture_output=True, text=True, timeout=900,
    )
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        log("phase service: chaos |", line)
    assert proc.returncode == 0, f"chaos run exited {proc.returncode}:\n{proc.stderr[-4000:]}"
    with open(os.path.join(out_root, "chaos_report.json")) as f:
        report = json.load(f)
    assert report["ok"] and report["device"] == "cuda", report
    assert all(report["site_class_coverage"].values()), report["site_class_coverage"]
    rows = [dict(plan=r["plan"], fired=r["fired_sites"], faulty_s=r["faulty_s"],
                 heal_s=r["heal_s"], worker_restarts=r["worker_restarts"])
            for r in report["results"]]
    for row in rows:
        log("phase service: chaos plan", json.dumps(row))
    return dict(plans=len(rows), wall_s=wall, report_wall_s=report["wall_s"], rows=rows,
                worker_restarts=sum(sum(r["worker_restarts"].values()) for r in rows),
                worker_start=start)


def dataflow_plans(device):
    """Phase 13 (d): `plan_mapping` on the card at dataflow_plans.py's
    settings; every plan's schedule through the engine's "cuda" backend
    equal to the event simulator."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import multicast_actors
    from repro_torch.dataflow import extract_application_graph, plan_mapping, tpu_pod_architecture
    from repro_torch.kernels import sim_step as kmod
    from repro_torch.dataflow.extract import ExtractOptions
    from repro_torch.sim import SimConfig, batch_simulate_periods, batched, simulate_period

    arch = tpu_pod_architecture()
    cfg_sim = SimConfig(trace=False)
    rows = []
    events = []
    reset_counts()
    batched.int32_fallbacks = 0
    launch = timed_sim_step(events)
    try:
        for name, stages in DATAFLOW_MODELS:
            cfg = get_config(name).model
            opts = ExtractOptions(n_stages=stages)
            g = extract_application_graph(cfg, DATAFLOW_SHAPE["seq_len"], DATAFLOW_SHAPE["batch"],
                                          opts)
            t0 = time.perf_counter()
            plans = plan_mapping(cfg, DATAFLOW_SHAPE["seq_len"], DATAFLOW_SHAPE["batch"],
                                 opts=opts, device=device, **DATAFLOW_PARAMS)
            plan_s = time.perf_counter() - t0
            assert plans, f"{name}: no feasible plan"
            n0 = len(events)
            t0 = time.perf_counter()
            groups = {}
            for p in plans:
                groups.setdefault(id(p.graph), []).append(p)
            max_period = 0.0
            for group in groups.values():
                gt = group[0].graph
                scheds = [p.schedule for p in group]
                kernel = batch_simulate_periods(gt, arch, scheds, cfg_sim, backend="cuda",
                                                device=device)
                ev = [simulate_period(gt, arch, s, cfg_sim) for s in scheds]
                assert kernel == ev, f"{name}: kernel and event periods differ"
                max_period = max(max_period, *ev)
            check_s = time.perf_counter() - t0
            with_mrb = [p for p in plans if p.mrb_choices and all(p.mrb_choices.values())]
            without = [p for p in plans if not any(p.mrb_choices.values())]
            if with_mrb and without:
                assert min(p.buffer_bytes for p in with_mrb) < min(p.buffer_bytes for p in without)
            row = dict(model=name, stages=stages, actors=len(g.actors), channels=len(g.channels),
                       multicast=len(multicast_actors(g)),
                       pareto=len(plans), plan_s=plan_s, check_s=check_s,
                       launches=len(events) - n0, max_sim_period=max_period,
                       both_mrb_choices=bool(with_mrb and without),
                       fastest=plans[0].summary(),
                       smallest=min(plans, key=lambda p: p.buffer_bytes).summary())
            rows.append(row)
            log("phase service: dataflow", json.dumps(row))
    finally:
        kmod.sim_step = launch
    torch.cuda.synchronize()
    counts = read_counts()
    assert counts["sim_step"] > 0 and counts["sim_step"] == len(events)
    return dict(rows=rows, launches=counts["sim_step"], int32_fallbacks=batched.int32_fallbacks,
                kernel_ms=sum(s.elapsed_time(e) for s, e in events))


def phase_service(device, local_artifacts):
    """Phase 13: the campaign service over HTTP, chaos sweeps and the
    planning layer on the card: (a) a served campaign through the CLI;
    (b) an inline served pass that counts `sim_step` launches; (c) `chaos
    run`; (d) `plan_mapping` with every plan's schedule held kernel =
    events."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-service-")
    out = {}
    try:
        t0 = time.perf_counter()
        out["served"] = served_campaign(tmp, local_artifacts)
        out["served"]["seconds"] = time.perf_counter() - t0
        log("phase service: served", json.dumps(out["served"]))
        t0 = time.perf_counter()
        out["inline"] = served_inline(tmp, local_artifacts)
        out["inline"]["seconds"] = time.perf_counter() - t0
        log("phase service: inline", json.dumps(out["inline"]))
        t0 = time.perf_counter()
        out["chaos"] = chaos_sweep(tmp)
        out["chaos"]["seconds"] = time.perf_counter() - t0
        log("phase service: chaos", json.dumps({k: v for k, v in out["chaos"].items()
                                                if k != "rows"}))
        t0 = time.perf_counter()
        out["dataflow"] = dataflow_plans(device)
        out["dataflow"]["seconds"] = time.perf_counter() - t0
        log("phase service: dataflow", json.dumps({k: v for k, v in out["dataflow"].items()
                                                   if k != "rows"}))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase service: {out['seconds']:.1f} s")
    return out


# ------------------------------------------------------------ model families
# Phase 14: every family the JAX package serves, random weights from seed 0,
# bfloat16 weights and cache, B=4, a 32-token make_batch prompt, 32 greedy
# tokens, ring 64 (FAMILY_SERVE).  Cuts: Mixtral-8x7B's depth to
# MIXTRAL_LAYERS of 32 (its 32 layers need 93 GB in bfloat16, over one
# card's 80 GB; 8 layers are 11.9e9 parameters); Qwen3-MoE-235B is not
# served at full width (470 GB in bfloat16): its attention shape is held in
# phase 6 and its smoke config in (d).  Zamba2-7B, MusicGen-medium (4
# codebooks, 256 conditioning embeddings), Mamba2-370M and InternVL2-2B
# (prefill only: its decode takes text tokens) run at full width and depth.
FAMILY_SERVE = dict(batch=4, prompt_len=32, new_tokens=32, context=64, seed=0)
MIXTRAL_LAYERS = 8
PREFILL_LEN = 4096   # (b): 16 SSD chunks and the chunked attention (L > 2048)
FAMILY_SMOKE = ("mixtral-8x7b", "qwen3-moe-235b-a22b", "mamba2-370m", "zamba2-7b",
                "musicgen-medium", "internvl2-2b")
FAMILY_WRAP = dict(batch=4, prompt_len=24, new_tokens=48, context=64, zamba2_window=32)
FORWARD = dict(batch=2, L=128, q_block=32, k_block=64)  # (d): chunked through lowered blocks


def ring_layers(cfg) -> int:
    """Rings one decode step writes and reads: a hybrid's shared
    invocations, every layer of an attention config, none for Mamba2."""
    if cfg.shared_attn_every:
        return cfg.n_layers // cfg.shared_attn_every
    return 0 if cfg.layer_kinds()[0] == "s" else cfg.n_layers


def served_family(res, counts, device, cond=None):
    """Phase 14's checks and timings of one served run: launch counts,
    tokens, logits, every state leaf finite, ring counters, the kernel on
    the first and last live rings, the weight-read floor, a profiled
    window of decode steps."""
    import torch

    model, state = res["model"], res["state"]
    cfg = model.cfg
    steps = FAMILY_SERVE["prompt_len"] + FAMILY_SERVE["new_tokens"]
    n = ring_layers(cfg)
    assert counts["mrb_append"] == n * steps, (cfg.name, counts)
    assert counts["mrb_decode_attention"] == n * steps, (cfg.name, counts)
    assert counts["sim_step"] == 0, counts
    gen = res["generated"]
    want = (FAMILY_SERVE["batch"],) + ((cfg.n_codebooks,) if cfg.n_codebooks else ()) + (
        FAMILY_SERVE["new_tokens"],)
    assert tuple(gen.shape) == want, (cfg.name, tuple(gen.shape))
    assert 0 <= int(gen.min()) and int(gen.max()) < cfg.vocab, "tokens out of range"
    assert torch.isfinite(res["last_logits"]).all(), f"{cfg.name}: non-finite logits"
    for top, leaves in state.items():
        for k, v in leaves.items():
            assert v.dtype == torch.int32 or torch.isfinite(v.float()).all(), f"{top}.{k} not finite"
    live = []
    if n:
        rings = state["shared"] if cfg.shared_attn_every else state["layers"]
        assert rings["t"].tolist() == [steps] * n, rings["t"].tolist()
        windows = ([cfg.sliding_window] * 2 if cfg.shared_attn_every
                   else [model.windows[0], model.windows[-1]])
        live = ring_check(rings, (0, n - 1), cfg.n_heads, cfg.resolved_head_dim, windows,
                          cfg.attn_softcap, device)
    params = cfg.param_count()
    summary = dict(res["summary"], launches=counts, ring_layers=n, params=params,
                   weight_floor_ms=params * 2 / HBM_BYTES_PER_S * 1e3, live_ring_err=live,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   first_tokens=gen[0].reshape(-1)[:8].tolist())
    prof = profile_decode(model, state, batch=FAMILY_SERVE["batch"], cond=cond)
    if prof:
        prof["busy_share_of_unprofiled_step"] = (
            prof["device_busy_ms_per_step"] / summary["decode_ms_per_step"])
        summary["launches_per_step"] = prof["kernels_per_step"]
    summary["profile"] = prof
    log("phase families: served", json.dumps(summary))
    return summary


def serve_depth_cut(arch, n_layers, device):
    """``serve`` for a configuration cut to ``n_layers``: the launcher's
    init_model, make_batch and generate, timed as ``serve`` times them."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.launch.serve import generate
    from repro_torch.models import init_model

    cfg = get_config(arch).model.replace(n_layers=n_layers)
    S = FAMILY_SERVE
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = init_model(cfg, seed=S["seed"], device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    data = make_batch(cfg, S["prompt_len"], S["batch"], device=device)
    res = generate(model, data["tokens"], S["new_tokens"], S["context"],
                   cond_embeds=data.get("cond_embeds"))
    res["model"] = model
    res["summary"] = dict(
        arch=f"{cfg.name} (depth {n_layers})", init_s=init_s, prefill_s=res["prefill_s"],
        decode_ms_per_step=res["decode_s"] / S["new_tokens"] * 1e3,
        decode_tok_per_s=S["new_tokens"] * S["batch"] / res["decode_s"],
        ring_capacity=S["context"], device=torch.cuda.get_device_name(device))
    return res


def prefill_at_full_width(model, device):
    """(b): ``prefill_step`` on a PREFILL_LEN-token make_batch input (B=1),
    then once more with the port's CHUNKED_ATTN_THRESHOLD raised so that
    every attention takes the direct path; wall time, peak memory and the
    largest logit difference between the two."""
    import torch
    import repro_torch.models.model as TM
    from repro_torch.data import make_batch

    cfg = model.cfg
    data = make_batch(cfg, PREFILL_LEN, 1, device=device)
    kw = {k: data[k] for k in ("img_embeds", "cond_embeds") if k in data}
    out = {}
    for path in ("chunked", "direct"):
        old = TM.CHUNKED_ATTN_THRESHOLD
        if path == "direct":
            TM.CHUNKED_ATTN_THRESHOLD = 10 ** 9
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            logits = TM.prefill_step(model, data["tokens"], **kw)
            torch.cuda.synchronize()
            out[path] = dict(s=time.perf_counter() - t0,
                             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        finally:
            TM.CHUNKED_ATTN_THRESHOLD = old
        want = (1,) + ((cfg.n_codebooks,) if cfg.n_codebooks else ()) + (1, cfg.vocab)
        assert tuple(logits.shape) == want and torch.isfinite(logits).all(), (cfg.name, path)
        out[path]["logits"] = logits
    diff = float((out["chunked"].pop("logits") - out["direct"].pop("logits")).abs().max())
    row = dict(arch=cfg.name, L=PREFILL_LEN, chunked=out["chunked"], direct=out["direct"],
               max_abs_diff_chunked_vs_direct=diff)
    log("phase families: prefill_step", json.dumps(row))
    return row


def family_card_vs_cpu(arch, device):
    """(d): a smoke configuration on the card (kernels) and on the CPU
    (plain versions), same weights, float32 (TF32 off): a wrapping ring's
    logits within 1e-4 at every step and identical greedy tokens, then
    ``forward`` and ``prefill_step`` within 1e-4 on the chunked path
    (the port's block constants lowered for the call)."""
    import copy

    import torch
    import repro_torch.models.model as TM
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.launch.serve import generate
    from repro_torch.models import init_model

    cfg = get_config(arch).smoke
    if cfg.shared_attn_every:
        cfg = cfg.replace(sliding_window=FAMILY_WRAP["zamba2_window"])
    host = init_model(cfg, seed=0, device="cpu")
    card = copy.deepcopy(host).to(device)
    W = FAMILY_WRAP
    data = make_batch(cfg, W["prompt_len"] + cfg.n_img_tokens, W["batch"], device="cpu")
    cond = data.get("cond_embeds")
    reset_counts()
    on_card = generate(card, data["tokens"].to(device), W["new_tokens"], W["context"],
                       cond_embeds=None if cond is None else cond.to(device), keep_logits=True)
    counts = read_counts()
    on_cpu = generate(host, data["tokens"], W["new_tokens"], W["context"], cond_embeds=cond,
                      keep_logits=True)
    steps = W["prompt_len"] + W["new_tokens"]
    n = ring_layers(cfg)
    assert counts["mrb_append"] == counts["mrb_decode_attention"] == n * steps, (arch, counts)
    assert torch.equal(on_card["generated"].cpu(), on_cpu["generated"]), f"{arch}: tokens differ"
    assert len(on_card["logits"]) == steps
    err = 0.0
    for a, b in zip(on_card["logits"], on_cpu["logits"]):
        a = a.cpu()
        err = max(err, float((a - b).abs().max()))
        assert torch.allclose(a, b, atol=1e-4, rtol=1e-4), f"{arch}: logits differ by {err}"

    F = FORWARD
    fb = make_batch(cfg, F["L"], F["batch"], device="cpu")
    kw = {k: fb[k] for k in ("img_embeds", "cond_embeds") if k in fb}
    kw_card = {k: v.to(device) for k, v in kw.items()}
    saved = (TM.CHUNKED_ATTN_THRESHOLD, TM.ATTN_Q_BLOCK, TM.ATTN_K_BLOCK)
    TM.CHUNKED_ATTN_THRESHOLD, TM.ATTN_Q_BLOCK, TM.ATTN_K_BLOCK = 1, F["q_block"], F["k_block"]
    try:
        (hf, ha), (cf, ca) = (TM.forward(host, fb["tokens"], **kw),
                              TM.forward(card, fb["tokens"].to(device), **kw_card))
        hp = TM.prefill_step(host, fb["tokens"], **kw)
        cp = TM.prefill_step(card, fb["tokens"].to(device), **kw_card)
    finally:
        TM.CHUNKED_ATTN_THRESHOLD, TM.ATTN_Q_BLOCK, TM.ATTN_K_BLOCK = saved
    fwd_err = float((cf.detach().cpu() - hf.detach()).abs().max())
    pre_err = float((cp.cpu() - hp).abs().max())
    assert torch.allclose(cf.detach().cpu(), hf.detach(), atol=1e-4, rtol=1e-4), \
        f"{arch}: forward differs by {fwd_err}"
    assert abs(float(ca) - float(ha)) <= 1e-4 * max(1.0, abs(float(ha))), f"{arch}: aux differs"
    assert torch.allclose(cp.cpu(), hp, atol=1e-4, rtol=1e-4), \
        f"{arch}: prefill_step differs by {pre_err}"
    row = dict(arch=cfg.name, steps=steps, ring_capacity=W["context"], ring_layers=n,
               window=cfg.sliding_window, max_abs_logit_err=err, tokens_identical=True,
               launches=counts, forward_err=fwd_err, prefill_step_err=pre_err)
    log("phase families: card vs CPU", json.dumps(row))
    return row


def phase_families(device):
    """Phase 14: (a) Zamba2-7B served at full width and depth, (b)
    ``prefill_step`` at L=4096 for Zamba2-7B and InternVL2-2B, (c)
    Mixtral-8x7B (depth cut), MusicGen-medium and Mamba2-370M served, (d)
    the six new smoke configurations on the card equal to the CPU."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.launch.serve import serve
    from repro_torch.models import init_model

    t_phase = time.perf_counter()
    out = {"served": {}, "prefill": {}, "smoke": {}}
    live = []

    def run(arch, fn):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        res = fn()
        counts = read_counts()
        cond = None
        if res["model"].cfg.n_cond_tokens:  # the conditioning serve() passed to every step
            cfg = res["model"].cfg
            cond = make_batch(cfg, FAMILY_SERVE["prompt_len"], FAMILY_SERVE["batch"],
                              device=device)["cond_embeds"]
        row = served_family(res, counts, device, cond=cond)
        live.extend(row["live_ring_err"])
        out["served"][arch] = row
        return res

    # (a) and (b): Zamba2-7B, the slice's full-width path, then its prefill
    res = run("zamba2-7b", lambda: serve("zamba2-7b", device=device, **FAMILY_SERVE))
    model = res["model"]
    del res
    out["prefill"]["zamba2-7b"] = prefill_at_full_width(model, device)
    del model
    torch.cuda.empty_cache()
    model = init_model(get_config("internvl2-2b").model, seed=0, device=device)
    out["prefill"]["internvl2-2b"] = prefill_at_full_width(model, device)
    del model
    # (c)
    res = run("mixtral-8x7b", lambda: serve_depth_cut("mixtral-8x7b", MIXTRAL_LAYERS, device))
    del res
    for arch in ("musicgen-medium", "mamba2-370m"):
        res = run(arch, lambda: serve(arch, device=device, **FAMILY_SERVE))
        del res
    torch.cuda.empty_cache()
    # (d)
    for arch in FAMILY_SMOKE:
        out["smoke"][arch] = family_card_vs_cpu(arch, device)
    out["live_ring_err"] = max(live)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase families: {out['seconds']:.1f} s")
    return out


# ------------------------------------------------------------------ training
# Phase 15 (a): Qwen3-0.6B at full width and depth (configs/qwen3_0_6b.py,
# hf Qwen/Qwen3-0.6B: 28 layers, d=1024, V=151,936, tied embeddings, its
# spec's AdamW, remat on), bf16 random weights from seed 0, seq 1024,
# global batch 8, 8 steps; then the same run with a checkpoint every 4
# steps and a failure injected at step 5.  (b) Mamba2-370M at full width.
# (c) every smoke configuration card = CPU in float32 (TF32 off), its
# spec's optimizer (Adafactor for Qwen3-MoE and Nemotron), Nemotron with
# bf16 gradients over 2 microbatches, Gemma-2 with the gather CE.
# The tokens are the reference's uniform synthetic stream, so a few steps
# can only shrink the loss's excess over ln V, against a batch-to-batch
# spread of about 0.01: the learning rates are high enough for the fall to
# clear that spread within the steps run, and low enough not to diverge.
TRAIN_FULL = dict(steps=8, seq_len=1024, global_batch=8, peak_lr=1e-3, warmup=6, seed=0)
TRAIN_RESUME = dict(ckpt_every=4, inject_failure_at=5)
TRAIN_MAMBA = dict(steps=4, seq_len=1024, global_batch=4, peak_lr=5e-3, warmup=1, seed=0)
TRAIN_SMOKE = dict(steps=3, seq_len=64, batch=4, peak_lr=1e-3, warmup=2,
                   gather_arch="gemma2-9b")
TRAIN_RTOL = 1e-4           # (c): loss and grad_norm, card against CPU, every step
RESUME_RTOL = 1e-6          # (a): tests/test_substrate.py::test_resume_is_bit_deterministic


def train_flops(cfg, seq_len, batch):
    """Model FLOPs of one training step: 6 × parameters × tokens, plus the
    attention products (QK and PV, forward and backward, every position
    pair: 12 × B × S² × heads × head_dim per attention layer); remat's
    recomputation not counted."""
    attn_layers = sum(k != "s" for k in cfg.layer_kinds())
    attn = 12 * batch * seq_len ** 2 * cfg.n_heads * cfg.resolved_head_dim * attn_layers
    return 6 * cfg.param_count() * seq_len * batch + attn


def profile_train_steps(step_fn, state, batch, steps=2):
    """Launches per step and the device's busy share over ``steps`` warm
    training steps (torch.profiler; None where it saw no kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step_fn(state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return dict(launches_per_step=None, busy_share=None)
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(launches_per_step=len(kernels) / steps, busy_share=busy_us / wall_us,
                device_ms_per_step=busy_us / 1e3 / steps,
                top_kernels_ms_per_step={name[:80]: ms for name, ms in top})


def train_full_width(device):
    """(a): the straight and the resumed run through ``run_training``, then
    the step's parts on a fresh state: the optimizer's ms per step (CUDA
    events), peak GB, launches per step and busy share."""
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.runtime import TrainLoopConfig, init_train_state, make_train_step, \
        run_training

    spec = get_config("qwen3-0.6b")
    cfg = spec.model
    assert cfg.remat and cfg.dtype == "bfloat16"
    loop = dict(TRAIN_FULL, optimizer=spec.optimizer)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    straight = run_training(cfg, TrainLoopConfig(**loop), device=device)
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with tempfile.TemporaryDirectory(prefix="chip-smoke-ckpt-") as d:
        reset_counts()
        resumed = run_training(cfg, TrainLoopConfig(ckpt_dir=d, **loop, **TRAIN_RESUME),
                               device=device)
        counts_resumed = read_counts()
    losses = straight.losses
    assert all(math.isfinite(x) for x in losses + resumed.losses), (losses, resumed.losses)
    assert losses[-1] < losses[0], f"Qwen3-0.6B loss did not fall: {losses}"
    assert resumed.restarts == 1 and resumed.steps_done == TRAIN_FULL["steps"]
    rel = abs(resumed.final_loss - straight.final_loss) / abs(straight.final_loss)
    assert rel <= RESUME_RTOL, \
        f"resumed run ends at {resumed.final_loss}, the straight run at {straight.final_loss}"
    assert counts == counts_resumed == {name: 0 for name in counts}, (counts, counts_resumed)

    # the step's parts, on a fresh state
    tokens = TRAIN_FULL["seq_len"] * TRAIN_FULL["global_batch"]
    state, upd = init_train_state(cfg, spec.optimizer, TRAIN_FULL["peak_lr"],
                                  TRAIN_FULL["warmup"], TRAIN_FULL["steps"], seed=0,
                                  device=device)
    marks = []

    def timed_update(grads, opt, model):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        upd(grads, opt, model)
        b.record()
        marks.append((a, b))

    step_fn = make_train_step(cfg, timed_update)
    batch = make_batch(cfg, TRAIN_FULL["seq_len"], TRAIN_FULL["global_batch"], device=device)
    for _ in range(3):
        step_fn(state, batch)
    torch.cuda.synchronize()
    opt_ms = [a.elapsed_time(b) for a, b in marks[1:]]
    prof = profile_train_steps(step_fn, state, batch)
    warm_s = sum(straight.step_times[1:]) / len(straight.step_times[1:])
    flops = train_flops(cfg, TRAIN_FULL["seq_len"], TRAIN_FULL["global_batch"])
    out = dict(
        arch=cfg.name, params=cfg.param_count(), optimizer=spec.optimizer, **TRAIN_FULL,
        losses=losses, resumed_losses=resumed.losses, resume_rel_diff=rel,
        first_step_s=straight.step_times[0], warm_s_per_step=warm_s,
        tokens_per_s=tokens / warm_s, model_flops_per_step=flops,
        bf16_peak_share=flops / warm_s / BF16_PEAK_FLOPS, optimizer_ms=opt_ms,
        peak_gb=peak_gb, ckpt_write_s=resumed.ckpt_write_s, restore_s=resumed.restore_s,
        launches=counts, **prof, device=torch.cuda.get_device_name(0))
    log("phase training: qwen3-0.6b", json.dumps(out))
    del state, step_fn, batch
    torch.cuda.empty_cache()
    return out


def train_mamba(device):
    """(b): Mamba2-370M at full width, the chunked SSD's backward on the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.runtime import TrainLoopConfig, run_training

    spec = get_config("mamba2-370m")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    rep = run_training(spec.model, TrainLoopConfig(**TRAIN_MAMBA, optimizer=spec.optimizer),
                       device=device)
    counts = read_counts()
    assert all(math.isfinite(x) for x in rep.losses), rep.losses
    assert rep.losses[-1] < rep.losses[0], f"Mamba2-370M loss did not fall: {rep.losses}"
    assert counts == {name: 0 for name in counts}, counts
    warm_s = sum(rep.step_times[1:]) / len(rep.step_times[1:])
    out = dict(arch=spec.model.name, **TRAIN_MAMBA, losses=rep.losses,
               first_step_s=rep.step_times[0], warm_s_per_step=warm_s,
               tokens_per_s=TRAIN_MAMBA["seq_len"] * TRAIN_MAMBA["global_batch"] / warm_s,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9, launches=counts)
    log("phase training: mamba2-370m", json.dumps(out))
    torch.cuda.empty_cache()
    return out


def train_card_vs_cpu(arch, device, steps=TRAIN_SMOKE["steps"]):
    """(c): ``arch``'s smoke configuration trained on the card and on the
    CPU from the same weights and batches with its spec's optimizer (and
    Nemotron's bf16 gradients over 2 microbatches; the gather CE for
    ``TRAIN_SMOKE["gather_arch"]``): loss and grad_norm within
    ``TRAIN_RTOL`` at every step."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.runtime import init_train_state, make_train_step

    spec = get_config(arch)
    cfg = spec.smoke
    settings = dict(microbatches=2 if spec.grad_dtype == "bfloat16" else 1,
                    grad_dtype=spec.grad_dtype,
                    ce_mode="gather" if arch == TRAIN_SMOKE["gather_arch"] else "onehot")
    states, steppers = {}, {}
    for dev in ("cpu", device):
        states[dev], upd = init_train_state(cfg, spec.optimizer, TRAIN_SMOKE["peak_lr"],
                                            TRAIN_SMOKE["warmup"], steps, seed=0, device=dev)
        steppers[dev] = make_train_step(cfg, upd, **settings)
    with torch.no_grad():
        for a, b in zip(states["cpu"].model.parameters(), states[device].model.parameters()):
            b.copy_(a)
    rows = []
    reset_counts()
    for step in range(steps):
        m = {}
        for dev in ("cpu", device):
            batch = make_batch(cfg, TRAIN_SMOKE["seq_len"], TRAIN_SMOKE["batch"],
                               seed=np.uint64(step), device=dev)
            _, metrics = steppers[dev](states[dev], batch)
            m[dev] = {k: float(metrics[k]) for k in ("loss", "grad_norm")}
        for k in ("loss", "grad_norm"):
            want, got = m["cpu"][k], m[device][k]
            assert math.isfinite(got) and abs(got - want) <= TRAIN_RTOL * abs(want), \
                f"{arch} step {step}: {k} {got} on the card, {want} on the CPU"
        rows.append(dict(step=step, card=m[device], cpu=m["cpu"]))
    counts = read_counts()
    assert counts == {name: 0 for name in counts}, (arch, counts)
    err = max(abs(r["card"][k] - r["cpu"][k]) / abs(r["cpu"][k])
              for r in rows for k in ("loss", "grad_norm"))
    out = dict(arch=cfg.name, optimizer=spec.optimizer, **settings, max_rel_err=err, steps=rows)
    log("phase training: card vs CPU", json.dumps(out))
    return out


def phase_training(device):
    """Phase 15: (a) Qwen3-0.6B trained at full width, straight and resumed
    through an injected failure, (b) Mamba2-370M at full width, (c) the ten
    smoke configurations card = CPU; no kernel of the repository launched."""
    from repro_torch.configs import list_archs

    t_phase = time.perf_counter()
    out = dict(qwen3=train_full_width(device), mamba2=train_mamba(device))
    out["smoke"] = {arch: train_card_vs_cpu(arch, device) for arch in list_archs()}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase training: {out['seconds']:.1f} s")
    return out


# ------------------------------------------------------------- distribution
# Phase 16 (a): phase 15 (a)'s Qwen3-0.6B at full width and depth (bf16,
# AdamW, remat, seq 1024, global batch 8, seed 0) on one NCCL rank (the
# card's host has one H100 and NCCL puts one rank on a GPU): from one copy
# of the state, 3 int8 compressed data-parallel steps and 3 uncompressed
# steps in turns; the first step held to tests/test_substrate.py's
# one-step bounds (loss relative 1e-5, parameters within 5e-3) and its
# reduction to the plain gradients quantized apart from the step
# (check_reduction), the later steps' differences reported.  (b) one dry-run cell of the
# production 16×16 mesh on fake tensors in a spawned process beside
# phases 15 and 16 (no card memory).
DIST = dict(steps=3, seq_len=1024, global_batch=8, peak_lr=1e-3, warmup=6, seed=0)
DIST_LOSS_RTOL = 1e-5
DIST_PARAM_ATOL = 5e-3
DRYRUN_CELL = dict(arch="qwen3-0.6b", shape="train_4k", threads=2)


def start_dryrun(out_dir):
    """Phase 16 (b)'s dry run in a child process (no CUDA device visible,
    ``threads`` intra-op threads), its output in files under ``out_dir``."""
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS=str(DRYRUN_CELL["threads"]))
    argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", DRYRUN_CELL["arch"],
            "--shape", DRYRUN_CELL["shape"], "--out", out_dir]
    log_f = open(os.path.join(out_dir, "dryrun.log"), "w")
    return dict(proc=subprocess.Popen(argv, env=env, stdout=log_f, stderr=subprocess.STDOUT),
                log=log_f, t0=time.perf_counter(), out_dir=out_dir)


def finish_dryrun(run):
    """Waits for the dry run and checks its record: ``ok`` on the 16×16 mesh,
    per-device FLOPs and collective bytes, ``fits_hbm`` against the card."""
    import torch
    from repro_torch.launch.mesh import HW

    rc = run["proc"].wait(timeout=900)
    seconds = time.perf_counter() - run["t0"]
    run["log"].close()
    with open(os.path.join(run["out_dir"], "dryrun.log")) as f:
        tail = f.read()[-3000:]
    tag = f"{DRYRUN_CELL['arch']}__{DRYRUN_CELL['shape']}__single"
    path = os.path.join(run["out_dir"], tag + ".json")
    rec = None
    if os.path.exists(path):
        with open(path) as f:
            rec = json.load(f)
    assert rc == 0 and rec is not None, f"dry run exited {rc}: {tail} {json.dumps(rec)}"
    assert rec["status"] == "ok" and rec["devices"] == 256, rec
    assert rec["hlo_cost"]["flops"] > 0 and rec["hlo_cost"]["collective_bytes"] > 0, rec
    total = torch.cuda.get_device_properties(0).total_memory
    assert rec["memory"]["hbm_bytes"] == HW.HBM_BYTES == total, (HW.HBM_BYTES, total)
    out = dict(record=rec, wall_s=seconds, card_total_memory=total)
    log("phase distribution: dry run", json.dumps(out))
    return out


def reduction_reference(cfg, model, batch, err):
    """One compressed step's reduction at world size 1, computed apart from
    the step, by reference key: each stacked leaf's plain gradient
    (``make_loss_fn``, autograd) quantized with its residual ``err`` and
    dequantized (``int8_decompress(int8_error_feedback_compress(g, err))``),
    the scale, the new residual, and ``noise``: how far two runs of the same
    gradient part on this device (0 where the backward is deterministic)."""
    import torch
    from repro_torch.models import tree
    from repro_torch.optim import int8_decompress, int8_error_feedback_compress
    from repro_torch.runtime.train import make_loss_fn

    loss_fn = make_loss_fn(cfg)
    names, params = zip(*model.named_parameters())

    def grads():
        loss, _ = loss_fn(model, batch)
        gs = torch.autograd.grad(loss, params, allow_unused=True)
        return {n: torch.zeros_like(p) if g is None else g for n, p, g in zip(names, params, gs)}

    g1, g2 = grads(), grads()
    out = {}
    for key, leaf in tree.layout(cfg).items():
        a = tree.stacked(leaf, g1)
        q, scale, new_err = int8_error_feedback_compress(a, err[key])
        noise = float((a.float() - tree.stacked(leaf, g2).float()).abs().max())
        out[key] = dict(mean=int8_decompress(q, scale), scale=float(scale), err=new_err,
                        noise=noise)
    return out


@contextlib.contextmanager
def recording_reduction(rec):
    """While open, the compressed step's ``compressed_psum`` results (one
    per stacked leaf, in ``tree.layout`` order) are kept in ``rec["means"]``
    and the gradients it hands the optimizer in ``rec["grads"]`` (through
    :func:`capturing`)."""
    from repro_torch.runtime import compressed_dp

    psum = compressed_dp.compressed_psum

    def kept(*a, **k):
        out = psum(*a, **k)
        rec["means"].append(out[0].detach().clone())
        return out

    rec.update(means=[], grads=None, on=True)
    compressed_dp.compressed_psum = kept
    try:
        yield rec
    finally:
        compressed_dp.compressed_psum = psum
        rec["on"] = False


def capturing(upd, rec):
    """The optimizer update ``upd``, keeping a copy of its gradients in
    ``rec["grads"]`` while ``rec["on"]``."""

    def update(grads, opt, model):
        if rec.get("on"):
            rec["grads"] = {k: g.detach().clone() for k, g in grads.items()}
        return upd(grads, opt, model)

    return update


def check_reduction(cfg, want, rec, err, grad_norm, grad_clip=1.0, max_off=1e-5):
    """Holds one compressed step at world size 1 against ``want``
    (:func:`reduction_reference`): the leaf means and the optimizer's
    gradients kept by :func:`recording_reduction`, the step's new residuals
    ``err`` and its pre-clip ``grad_norm``.  A mean or a residual may part
    from the reference by the gradient's run-to-run noise and, at no more
    than ``max_off`` of all elements, by one int8 quantum more (a rounding
    at a .5 boundary that the noise moved); the norm is the recorded means'
    (relative 1e-5) and the optimizer's gradients are the means' rows
    clipped by it, bit for bit.  Raises on a mismatch; returns the counts."""
    import torch
    from repro_torch.models import tree

    layout = tree.layout(cfg)
    assert len(rec["means"]) == len(layout) and rec["grads"] is not None, len(rec["means"])
    n = off_mean = off_err = 0
    noise = 0.0
    with torch.no_grad():
        for (key, leaf), mean in zip(layout.items(), rec["means"]):
            w = want[key]
            q, nz = w["scale"], w["noise"]
            noise = max(noise, nz)
            for got, ref, slack, tag in ((mean, w["mean"], 1.01 * nz, "mean"),
                                         (err[key], w["err"], 2.02 * nz, "err")):
                assert tuple(got.shape) == tuple(ref.shape) == leaf.shape, (key, tag)
                d = (got.float() - ref.float()).abs()
                far = d > slack
                if bool(far.any()):
                    worst = float(d[far].max())
                    assert worst <= 1.01 * q + slack, (key, tag, worst, q, slack)
                if tag == "mean":
                    off_mean += int(far.sum())
                else:
                    off_err += int(far.sum())
            n += mean.numel()
        norm = torch.stack([m.square().sum() for m in rec["means"]]).sum().sqrt()
        assert abs(float(grad_norm) - float(norm)) <= 1e-5 * float(norm), (grad_norm, norm)
        scale = torch.clamp(grad_clip / torch.clamp(grad_norm, min=1e-9), max=1.0)
        for (key, leaf), mean in zip(layout.items(), rec["means"]):
            assert torch.equal(tree.stacked(leaf, rec["grads"]), mean * scale), key
    assert off_mean <= max_off * n and off_err <= max_off * n, (off_mean, off_err, n)
    return dict(elements=n, means_off=off_mean, residuals_off=off_err, grad_noise=noise)


def compressed_vs_plain(device, tmp):
    """(a): the int8 compressed step against the uncompressed step on one
    NCCL rank, from one copy of the state."""
    import copy

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.models import tree
    from repro_torch.runtime import compressed_dp, init_train_state, make_train_step

    spec = get_config("qwen3-0.6b")
    cfg = spec.model
    assert cfg.remat and cfg.dtype == "bfloat16"
    store = dist.FileStore(os.path.join(tmp, "nccl-store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1, device_id=device)
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        comp, upd = init_train_state(cfg, spec.optimizer, DIST["peak_lr"], DIST["warmup"],
                                     DIST["steps"], seed=DIST["seed"], device=device)
        plain = copy.deepcopy(comp)
        batch = make_batch(cfg, DIST["seq_len"], DIST["global_batch"], device=device)
        marks = []
        psum = compressed_dp.compressed_psum

        def timed_psum(*a, **k):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = psum(*a, **k)
            e1.record()
            marks[-1].append((e0, e1))
            return out

        def param_diff():
            a, b = dict(cs.model.named_parameters()), dict(plain.model.named_parameters())
            with torch.no_grad():
                return max(float((tree.stacked(leaf, a).float() - tree.stacked(leaf, b).float())
                                 .abs().max()) for leaf in tree.layout(cfg).values())

        def timed(step, state):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, m = step(state, batch)
            torch.cuda.synchronize()
            return time.perf_counter() - t0, m

        compressed_dp.compressed_psum = timed_psum
        try:
            rec = {}
            init_cs, cstep = compressed_dp.make_compressed_dp_train_step(cfg, capturing(upd, rec))
            pstep = make_train_step(cfg, upd)
            cs = init_cs(comp)
            want = reduction_reference(cfg, plain.model, batch, cs.err)
            reset_counts()
            rows = []
            for i in range(DIST["steps"]):  # in turns, from the same state
                marks.append([])
                with recording_reduction(rec) if i == 0 else contextlib.nullcontext():
                    s_c, m_c = timed(cstep, cs)
                if i == 0:  # the first step's reduction against the plain gradients
                    reduction = check_reduction(cfg, want, rec, cs.err, m_c["grad_norm"])
                    del want
                    rec.clear()
                    torch.cuda.empty_cache()  # the peak is the steps', not the check's copies
                    torch.cuda.reset_peak_memory_stats()
                s_p, m_p = timed(pstep, plain)
                rows.append(dict(s=s_c, loss=float(m_c["loss"]), plain_s=s_p,
                                 plain_loss=float(m_p["loss"]),
                                 grad_norm=float(m_c["grad_norm"]),
                                 plain_grad_norm=float(m_p["grad_norm"]),
                                 max_param_diff=param_diff()))
            counts = read_counts()
        finally:
            compressed_dp.compressed_psum = psum
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        for r, step_marks in zip(rows, marks):
            r["compress_ms"] = sum(a.elapsed_time(b) for a, b in step_marks)
            r["loss_rel_diff"] = abs(r["loss"] - r["plain_loss"]) / abs(r["plain_loss"])
        err_norm = float(torch.stack([e.square().sum() for e in cs.err.values()]).sum().sqrt())
        assert all(e.is_cuda for e in cs.err.values())
    finally:
        dist.destroy_process_group()
    assert counts == {name: 0 for name in counts}, counts
    assert all(math.isfinite(r["loss"]) and math.isfinite(r["plain_loss"]) for r in rows), rows
    # the reference's bounds are one step's: the loss at the shared state and
    # the parameters that step leaves; later steps part by design (each
    # takes its own optimizer path), and their differences are reported
    assert rows[0]["loss_rel_diff"] <= DIST_LOSS_RTOL, rows
    assert rows[0]["max_param_diff"] < DIST_PARAM_ATOL, rows
    assert err_norm > 0
    warm = rows[1:]
    out = dict(arch=cfg.name, world_size=1, backend="nccl", **DIST, steps_rows=rows,
               warm_s_per_step=sum(r["s"] for r in warm) / len(warm),
               warm_plain_s_per_step=sum(r["plain_s"] for r in warm) / len(warm),
               compress_ms_per_step=sum(r["compress_ms"] for r in warm) / len(warm),
               err_norm=err_norm, peak_gb=peak_gb, reduction=reduction,
               launches=counts, device=torch.cuda.get_device_name(0))
    out["overhead_s_per_step"] = out["warm_s_per_step"] - out["warm_plain_s_per_step"]
    log("phase distribution: compressed step", json.dumps(out))
    del comp, plain, cs, batch
    torch.cuda.empty_cache()
    return out


def phase_distribution(device, dry, tmp):
    """Phase 16: (a) Qwen3-0.6B's int8 compressed data-parallel step at
    full width on NCCL against the uncompressed step, no kernel of the
    repository launched; (b) the dry run's record of one production cell."""
    t_phase = time.perf_counter()
    out = dict(compressed=compressed_vs_plain(device, tmp))
    out["dryrun"] = finish_dryrun(dry)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase distribution: {out['seconds']:.1f} s")
    return out


def ptxas_lines(info):
    return [ln.strip() for ln in info["ptxas"].splitlines()
            if re.search(r"registers|barriers|smem|spill|Compiling entry", ln)]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch import resolve_device
    from repro_torch.kernels import _build, decode_attention, mrb_ring
    from repro_torch.kernels import sim_step as kmod

    device = resolve_device("cuda")
    # float32 matmuls and convolutions in full float32 (phase 8 compares
    # the card with the CPU at 1e-4)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    log(nvidia_smi_line())
    log(sys.version.split()[0], "torch", torch.__version__, "cuda", torch.version.cuda,
        "| TF32 off")
    t0 = time.perf_counter()
    _build.build_all([kmod.LIBRARY, mrb_ring.LIBRARY, decode_attention.LIBRARY])
    log(f"build: three sources side by side in {time.perf_counter() - t0:.2f} s")
    log(f"build sim_step.cu: {kmod.build_info['seconds']:.2f} s;",
        " | ".join(ptxas_lines(kmod.build_info)))

    rows, max_err = phase_kernel_vs_plain(device)
    main_row = main_path_timing(device)
    main = phase_main_path(device)
    phase_sobel_fronts(device)

    for lib in (mrb_ring.LIBRARY, decode_attention.LIBRARY):
        log(f"phase build {os.path.basename(lib.source)}: {lib.info['seconds']:.2f} s;",
            " | ".join(ptxas_lines(lib.info)))
    smem = decode_attention.LIBRARY.load().decode_attention_smem_bytes
    log("phase build: decode_attention dynamic shared memory per CTA:",
        {f"G={G},d={d},{name}": smem(G, d, elt) for G, d in ((2, 256), (2, 128), (16, 256))
         for name, elt in (("bf16", 2), ("f32", 4))})
    append_err, attn_err, append_rows, attn_rows = phase_ring_kernels(device)
    append_row = append_rows[0]
    serving, _ = phase_serving(device)
    phase_ring_wrap(device)
    phase_qwen3(device)
    evo = phase_device_explorer(device, main["front_points"])
    exact = phase_exact_and_scenarios(device)
    campaign = phase_campaign(device)
    service = phase_service(device, campaign.pop("artifacts"))
    families = phase_families(device)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-dist-") as dist_tmp:
        dry = start_dryrun(dist_tmp)
        try:
            training = phase_training(device)
            distribution = phase_distribution(device, dry, dist_tmp)
        finally:
            if dry["proc"].poll() is None:
                dry["proc"].kill()
                dry["proc"].wait()
            dry["log"].close()
    launch_checks = finish_launch_checks(evo.pop("launch_checks"))

    served = attn_rows[0]
    timed_keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    family_launches = {
        name: dict({arch: row["launches"][name] for arch, row in families["served"].items()},
                   smoke={arch: row["launches"][name] for arch, row in families["smoke"].items()})
        for name in ("mrb_append", "mrb_decode_attention")}
    qwen3_long = next(r for r in attn_rows if r["shape"] == "qwen3_long")
    kernels = [
        dict(name="sim_step", route="cuda", source="src/repro_torch/csrc/sim_step.cu",
             replaces="src/repro/kernels/sim_step.py:41", launches=main["launches"],
             max_abs_err=max([max_err, main_row["max_abs_err"], evo["max_abs_err"]]
                             + [c["max_abs_err"] for c in launch_checks]),
             ms=main_row["ms"],
             plain_ms=main_row["plain_ms"], bound_ms=main_row["bytes_bound_ms"],
             bound_by="bytes", library_ms=None,
             rounds_bound_ms=main_row["bound_ms"], rounds_max=main_row["rounds_max"],
             round_floor_us=main_row["round_floor_us"], us_per_round=main_row["us_per_round"],
             warps=main_row["warps"], main_path_kernel_s=main["kernel_s"],
             main_path_sim_s=main["sim_s"],
             device_explorer_launches=evo["main_path"]["launches"],
             device_explorer_kernel_ms=evo["main_path"]["relaxed_kernel_ms"],
             device_explorer_max_abs_err=max([evo["max_abs_err"]]
                                             + [c["max_abs_err"] for c in launch_checks]),
             exact_path_launches=exact["ilp"]["launches"],
             large_tier_launches=[r["launches"] for r in exact["large"]],
             exact_scenarios_kernel_ms=exact["kernel_ms"],
             exact_scenarios_max_warps=exact["max_warps"],
             campaign_launches=campaign["run"]["launches"],
             campaign_kernel_ms=campaign["run"]["kernel_ms"],
             auto_crossover_batch=campaign["crossover"]["crossing"],
             training_launches=training["qwen3"]["launches"]["sim_step"],
             distribution_launches=distribution["compressed"]["launches"]["sim_step"],
             served_launches=service["inline"]["launches"],
             served_kernel_ms=service["inline"]["kernel_ms"],
             dataflow_launches=service["dataflow"]["launches"]),
        dict(name="mrb_append", route="cuda", source="src/repro_torch/csrc/mrb_ring.cu",
             replaces="src/repro/kernels/mrb_ring.py:35",
             launches=serving["launches"]["mrb_append"], max_abs_err=append_err,
             ms=append_row["ms"], plain_ms=append_row["plain_ms"],
             bound_ms=append_row["bound_ms"], bound_by=append_row["bound_by"],
             library_ms=append_row["library_ms"], host_us=append_row["host_us"],
             kv={key: append_row["kv"][key]
                 for key in ("ms", "replaced_ms", "library_ms", "bound_ms", "host_us")},
             families={r["shape"]: {key: r[key] for key in timed_keys}
                       for r in append_rows if r["shape"] in FAMILY_APPEND},
             training_launches=training["qwen3"]["launches"]["mrb_append"],
             distribution_launches=distribution["compressed"]["launches"]["mrb_append"],
             family_launches=family_launches["mrb_append"]),
        dict(name="mrb_decode_attention", route="cuda",
             source="src/repro_torch/csrc/decode_attention.cu",
             replaces="src/repro/kernels/decode_attention.py:82",
             launches=serving["launches"]["mrb_decode_attention"],
             max_abs_err=max([attn_err, families["live_ring_err"]] + serving["live_ring_err"]),
             ms=served["ms"], plain_ms=served["plain_ms"], bound_ms=served["bound_ms"],
             bound_by=served["bound_by"], library_ms=served["library_ms"],
             qwen3_long={key: qwen3_long[key] for key in ("ms", "library_ms", "bound_ms")},
             families={r["shape"]: {key: r[key] for key in timed_keys + ("splits", "tile")}
                       for r in attn_rows if r["shape"] in FAMILY_ATTN},
             family_launches=family_launches["mrb_decode_attention"],
             training_launches=training["qwen3"]["launches"]["mrb_decode_attention"],
             distribution_launches=distribution["compressed"]["launches"][
                 "mrb_decode_attention"]),
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
