"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: without a CUDA device every test here skips (decided in a
fixture, never at import), but the service's default-device check, which
then holds the one-line start-up failure.  Run on the card with

    python -m pytest -q -m gpu tests/test_torch_cuda.py

The cases are those of ``chip_smoke.py``: ``sim_step``'s kernel-vs-plain
phase at its 32 distinct decodes, the large tier's widest scenarios and
ILP-decoded Sobel schedules against the event simulator, a served cell
and an extracted LM graph's plan schedules through the kernel, the ring
kernels' sweeps (exact for ``mrb_append`` and the fused ``mrb_append_kv``,
ω included; 3e-5 float32 and 2e-2 bfloat16 for ``mrb_decode_attention``,
also at ``t = -1``, where the answer is the mean of V, and at every model
family's attention shape), each model family's smoke configuration
served on the card against the CPU, and training: the bf16 vocabulary
product's forward and backward against the float32 product, a train step
card = CPU, and a checkpoint of card tensors taken while the next step
runs, and distribution: ``compressed_psum`` over NCCL on card tensors
against the CPU over gloo, bit for bit, and the compressed step at one
NCCL rank against the uncompressed step.  This file imports no JAX: the
card's host has none.
"""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch import resolve_device

    return resolve_device("cuda")


@pytest.mark.parametrize("case", chip_smoke.CASES, ids=[c[0] for c in chip_smoke.CASES])
def test_kernel_matches_plain(device, case):
    from repro_torch.kernels import sim_step as kmod

    _, app, xi, ports = case
    gt, arch, scheds, cfg = chip_smoke.build_case(app, xi, ports)
    tab = chip_smoke.case_tables(gt, arch, scheds, device)
    before = kmod.launches
    for K, k_max in ((16, 16), (32, 32), (5, 8)):
        err, _ = chip_smoke.compare_kernel_plain(tab, K, k_max, cfg.mrb_ports)
        assert err == 0
    assert kmod.launches == before + 3


def test_kernel_path_matches_events(device):
    from repro_torch.sim import batch_simulate, simulate

    gt, arch, scheds, cfg = chip_smoke.build_case("sobel4", 1, None)
    mine = batch_simulate(gt, arch, scheds[:8], cfg, backend="cuda", device=device)
    for s, m in zip(scheds[:8], mine):
        e = simulate(gt, arch, s, cfg)
        assert (m.fire_times, m.period, m.deadlocked) == (e.fire_times, e.period, e.deadlocked)


def _kernel_vs_events(device, gt, arch, scheds):
    """The kernel against the plain program on the schedules' tables, then
    phase 11's checks: through ``batch_simulate`` against the event
    simulator, the verifier and the invariant lists."""
    tab = chip_smoke.case_tables(gt, arch, scheds, device)
    err, _ = chip_smoke.compare_kernel_plain(tab, 16, 16, None)
    assert err == 0
    chip_smoke.check_backends(gt, arch, scheds, device)
    return tab


@pytest.mark.parametrize("family,A,warps", [("split_join", 99, 4), ("multicast_tree", 122, 4)])
def test_kernel_matches_events_on_large_tier(device, family, A, warps):
    """The large tier's widest scenarios at ξ=1, B=4: four warps."""
    gt, arch, scheds = chip_smoke.build_large_case(family)
    tab = _kernel_vs_events(device, gt, arch, scheds)
    assert (tab.B, tab.A, chip_smoke.plan_of(tab)["warps"]) == (4, A, warps)


def test_kernel_matches_events_on_ilp_schedules(device):
    """Sobel ξ=1 schedules of the exact decoder (proven optimal, shorter
    than caps_hms's on the same mappings), B=4."""
    import random

    from repro_torch import core

    gt, arch, _, _ = chip_smoke.build_case("sobel", 1, None)
    cores = sorted(arch.cores)
    allowed = {a: [p for p in cores if gt.actors[a].can_run_on(arch.cores[p].ctype)]
               for a in sorted(gt.actors)}
    scheds = []
    for k in (1, 4, 10, 12):
        rng = random.Random(f"card-ilp:sobel:{k}")
        ba = {a: rng.choice(allowed[a]) for a in sorted(gt.actors)}
        cd = {c: rng.choice(core.CHANNEL_DECISIONS) for c in sorted(gt.channels)}
        res = core.decode_via_ilp(gt, arch, cd, ba, time_budget_s=60.0)
        assert res.feasible and res.proven_optimal
        assert res.period < core.decode_via_heuristic(gt, arch, cd, ba).schedule.period
        scheds.append(res.schedule)
    _kernel_vs_events(device, gt, arch, scheds)


def test_wrapper_rejects_bad_inputs(device):
    from repro_torch.kernels import sim_step as kmod

    gt, arch, scheds, _ = chip_smoke.build_case("sobel", 1, None)
    tab = chip_smoke.case_tables(gt, arch, scheds, device)
    bad = chip_smoke.case_tables(gt, arch, scheds, device)
    bad.dur = bad.dur.to(torch.int64)
    with pytest.raises(TypeError):
        kmod.sim_step(bad, 16, 16, None)
    with pytest.raises(ValueError):
        kmod.sim_step(tab, 32, 16, None)


# ------------------------------------------------------- sim_step edge cases
def _chain(A, seed=0, feeder=False):
    """A pipelined chain of A actors on paper_architecture(), every fifth
    actor also writing a two-reader buffer two actors on; with ``feeder``
    one more actor, on a self-loop, feeds the head through a channel
    holding three tokens (A + 1 actors in all)."""
    import random

    from repro_torch.core import ApplicationGraph, paper_architecture, pipeline_delays

    rng = random.Random(f"sim-edge:{A}:{seed}")
    g = ApplicationGraph(f"chain{A}")
    names = [f"a{i:04d}" for i in range(A)]
    for n in names:
        w = rng.randint(3, 40)
        g.add_actor(n, {"t1": -(-w // 3), "t2": -(-w // 2), "t3": w})
    for i in range(A - 1):
        g.add_channel(f"c{i:04d}", names[i], names[i + 1], capacity=2, token_bytes=1 << 16)
    for i in range(0, A - 2, 5):
        g.add_channel(f"m{i:04d}", names[i], [names[i + 1], names[i + 2]], capacity=2,
                      token_bytes=1 << 18)
    if feeder:
        g.add_actor("feeder", {"t1": 5, "t2": 8, "t3": 15})
        g.add_channel("loop", "feeder", "feeder", capacity=2, token_bytes=64)
        g.add_channel("feed", "feeder", names[0], delay=3, capacity=4, token_bytes=64)
    return pipeline_delays(g), paper_architecture()


def _edge_tables(g, arch, device, n, seed=0, delay=None):
    """Tables of n seeded caps_hms decodes of g; ``delay`` ({channel: δ})
    overrides initial tokens in the lowered programs."""
    from dataclasses import replace

    from repro_torch.sim import lower_phenotype
    from repro_torch.sim.batched import _lower_batch, compact_tables

    scheds = chip_smoke.random_schedules(g, arch, n, seed=f"sim-edge:{g.name}:{seed}")
    progs = [lower_phenotype(g, arch, s) for s in scheds]
    if delay is not None:
        progs = [replace(p, delay={**p.delay, **delay}) for p in progs]
    return compact_tables(*_lower_batch(progs), device)


def _huge(exec_time):
    """Two actors of exec_time on every core type, one channel (δ=1, γ=2):
    event times pass 2**31 within 16 firings."""
    from repro_torch.core import ApplicationGraph, paper_architecture

    g = ApplicationGraph("huge")
    g.add_actor("A", {"t1": exec_time, "t2": exec_time, "t3": exec_time})
    g.add_actor("B", {"t1": exec_time, "t2": exec_time, "t3": exec_time})
    g.add_channel("c", "A", "B", delay=1, capacity=2, token_bytes=64)
    return g, paper_architecture()


@pytest.mark.parametrize("A", [32, 33, 64, 65])
def test_kernel_matches_plain_across_warp_edges(device, A):
    """Bit-identical to the plain program, round counts included, at A on
    either side of one warp (no block barriers) and of two warps; K=1 and
    k_max > K."""
    g, arch = _chain(A)
    tab = _edge_tables(g, arch, device, n=8)
    assert tab.A == A and tab.R == 2
    for K, k_max in ((4, 4), (1, 1), (3, 8)):
        err, _ = chip_smoke.compare_kernel_plain(tab, K, k_max, None)
        assert err == 0


@pytest.mark.parametrize("A,ports", [(6, 2), (33, 2), (65, 2), (65, 1)])
def test_kernel_matches_plain_with_ports(device, A, ports):
    g, arch = _chain(A)
    tab = _edge_tables(g, arch, device, n=8)
    err, _ = chip_smoke.compare_kernel_plain(tab, 4, 4, ports)
    assert err == 0


def test_kernel_matches_plain_on_a_deadlock(device):
    """The feeder's self-loop emptied of its token: the feeder never fires,
    the head fires on the three tokens it was given, the chain drains,
    then every element deadlocks short of K firings."""
    from repro_torch.kernels import sim_step as kmod

    g, arch = _chain(32, feeder=True)
    tab = _edge_tables(g, arch, device, n=4, delay={"loop": 0})
    err, _ = chip_smoke.compare_kernel_plain(tab, 4, 4, None)
    assert err == 0
    _, dead, _ = kmod.sim_step(tab, 4, 4, None)
    assert bool(dead.all())


def test_kernel_wraps_int32_like_plain(device):
    """As tests/test_torch_sim.py's _huge: t + duration passes 2**31 and
    wraps as int32 arithmetic does, identically in both.  A wrapped end
    time is due at once, so firings then follow each other closer than an
    actor's execution time, and the horizon trips the wrapper's guard."""
    from repro_torch.kernels import sim_step as kmod
    from repro_torch.sim.batched import INT32_SAFE_HORIZON

    exec_time = 3 * 2**26
    g, arch = _huge(exec_time)
    tab = _edge_tables(g, arch, device, n=2)
    err, _ = chip_smoke.compare_kernel_plain(tab, 16, 16, None)
    assert err == 0
    fire, _, horizon = kmod.sim_step(tab, 16, 16, None)
    assert int(horizon.min()) >= INT32_SAFE_HORIZON
    assert int((fire[:, :, 1:] - fire[:, :, :-1]).min()) < exec_time


@pytest.mark.parametrize("B", [1, 257])
def test_kernel_matches_plain_at_batch_edges(device, B):
    g, arch = _chain(33)
    tab = _edge_tables(g, arch, device, n=4).select([i % 4 for i in range(B)])
    err, _ = chip_smoke.compare_kernel_plain(tab, 2, 4, None)
    assert err == 0


def test_launch_plan_matches_the_cuda_side(device):
    """launch_plan's shared-memory bytes are the kernel's, at every plan."""
    from repro_torch.kernels import sim_step as kmod

    lib = kmod.build()
    for A, C, R, H, T in ((7, 7, 1, 5, 21), (39, 37, 2, 5, 136), (62, 111, 1, 5, 284),
                          (65, 70, 2, 32, 200), (1024, 8, 1, 5, 2048)):
        plan = kmod.launch_plan(A, C, R, H, 64, T)
        assert lib.sim_step_smem_bytes(A, C, R, H, T, plan["warps"]) == plan["smem_bytes"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", chip_smoke.ATTN_CASES, ids=str)
def test_decode_attention_kernel_matches_plain(device, case, dtype):
    from repro_torch.kernels import decode_attention as kattn

    before = kattn.launches
    chip_smoke.check_attention_case(case, dtype, device)
    assert kattn.launches == before + 1


def test_decode_attention_launch_plan(device):
    """One plan per shape, chosen once: a cluster of 1-16 CTAs, shared
    memory within the card's 227 KB per CTA, 32- or 64-slot stages; the
    served shape's 64-slot ring is one CTA per (batch row, kv head)."""
    from repro_torch.kernels.decode_attention import launch_plan

    cases = (  # B, C, kv, G, d, window, dtype, splits when fixed
        (4, 64, 8, 2, 256, 4096, torch.bfloat16, 1),
        (16, 4096, 8, 2, 128, 0, torch.bfloat16, None),
        (1, 4113, 8, 16, 256, 0, torch.float32, None),
        (2, 1, 1, 16, 256, 0, torch.float32, 1),
    )
    for B, C, kv, G, d, window, dt, splits in cases:
        q = torch.empty((B, kv * G, d), dtype=dt, device=device)
        k = torch.empty((B, C, kv, d), dtype=dt, device=device)
        plan = launch_plan(q, k, window=window)
        assert plan == launch_plan(q, k, window=window)
        assert plan["splits"] in (1, 2, 4, 8, 16) and plan["tile"] in (32, 64)
        assert 0 < plan["smem_bytes"] <= 232448
        if splits is not None:
            assert plan["splits"] == splits, (B, C, kv, G, d, plan)


def test_mrb_append_kernel_matches_plain(device):
    from repro_torch.kernels import mrb_ring as kring

    before = kring.launches
    chip_smoke.check_append(device)
    assert kring.launches > before


def test_mrb_append_kv_kernel_matches_plain(device):
    """The fused write exactly equals mrb_append_kv_ref, ω included, over
    f32/bf16 rings and tokens, negative and clamped ω and a 70-step wrap,
    with one launch per call (asserted inside)."""
    from repro_torch.kernels import mrb_ring as kring

    before = kring.launches
    assert chip_smoke.check_append_kv(device) == 0.0
    assert kring.launches > before


def test_mrb_append_cached_path_stays_exact_and_checked(device):
    """After its first call a signature takes the lean path: still exact
    against the plain version, one launch per call; a changed shape, dtype
    or device goes through the full checks again and raises."""
    from repro_torch.kernels import mrb_ring as kring
    from repro_torch.kernels.ref import mrb_append_kv_ref, mrb_append_ref

    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    buf = chip_smoke.randn((2, 16, 2, 64), torch.bfloat16, device, gen)
    ref = buf.clone()
    for i in range(20):
        tok = chip_smoke.randn((2, 1, 2, 64), torch.float32, device, gen)
        om = torch.tensor(i - 5, dtype=torch.int32, device=device)
        before = kring.launches
        kring.mrb_append(buf, om, tok)
        assert kring.launches == before + 1
        mrb_append_ref(ref, om, tok)
        assert torch.equal(buf, ref)
    om = torch.zeros((), dtype=torch.int32, device=device)
    with pytest.raises(ValueError):
        kring.mrb_append(buf, om, torch.zeros((2, 1, 2, 32), device=device))
    with pytest.raises(ValueError):
        kring.mrb_append(buf, om, torch.zeros((2, 2, 2, 64), device=device)[:, :1])  # strided
    with pytest.raises(TypeError):
        kring.mrb_append(buf, om.long(), torch.zeros((2, 1, 2, 64), device=device))
    bv, rv = buf.clone(), ref.clone()
    om, rom = (torch.tensor(15, dtype=torch.int32, device=device) for _ in range(2))
    for i in range(3):
        tok = chip_smoke.randn((2, 1, 2, 64), torch.bfloat16, device, gen)
        kring.mrb_append_kv(buf, bv, om, tok, -tok)
        mrb_append_kv_ref(ref, rv, rom, tok, -tok)
        assert torch.equal(buf, ref) and torch.equal(bv, rv) and int(om) == int(rom) == i
    with pytest.raises(ValueError):
        kring.mrb_append_kv(buf, bv[:, :8], om, tok, tok)
    with pytest.raises(TypeError):
        kring.mrb_append_kv(buf, bv.float(), om, tok, tok)
    with pytest.raises(ValueError):
        kring.mrb_append_kv(buf, bv, om.cpu(), tok, tok)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 256])
def test_decode_attention_without_readable_positions_is_the_mean_of_v(device, window, dtype):
    """t = -1: the kernel returns the mean of V over all C slots, as the
    reference does, within 3e-5 (f32) / 2e-2 (bf16), at a shape whose
    cluster splits the walk (S >= 2)."""
    from repro_torch.kernels.decode_attention import launch_plan, mrb_decode_attention

    B, C, kv, G, d = 1, 4096, 2, 2, 128
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    q = chip_smoke.randn((B, kv * G, d), dt, device, gen, 0.3)
    k = chip_smoke.randn((B, C, kv, d), dt, device, gen, 0.3)
    v = chip_smoke.randn((B, C, kv, d), dt, device, gen, 0.3)
    assert launch_plan(q, k, window=window)["splits"] >= 2
    got = mrb_decode_attention(q, k, v, torch.tensor(-1, dtype=torch.int32, device=device),
                               window=window, softcap=50.0)
    want = v.float().mean(dim=1).repeat_interleave(G, dim=1)
    tol = chip_smoke.ATTN_TOL[dtype]
    assert torch.isfinite(got.float()).all()
    assert torch.allclose(got.float(), want, atol=tol, rtol=tol)


def test_ring_wrappers_reject_bad_inputs(device):
    from repro_torch.kernels import ring_append, ring_decode_attention

    buf = torch.zeros((2, 8, 2, 32), device=device)
    tok = torch.zeros((2, 1, 2, 32), device=device)
    om = torch.zeros((), dtype=torch.int32, device=device)
    with pytest.raises(TypeError):
        ring_append(buf.half(), om, tok)
    with pytest.raises(TypeError):
        ring_append(buf, om.long(), tok)
    with pytest.raises(ValueError):
        ring_append(buf[:, ::2], om, tok)  # not contiguous
    with pytest.raises(ValueError):
        ring_append(buf, om.cpu(), tok)
    with pytest.raises(ValueError):
        ring_append(buf, om, tok[:, :, :1])

    q = torch.zeros((2, 4, 32), device=device)
    with pytest.raises(TypeError):
        ring_decode_attention(q.half(), buf, buf, om)
    with pytest.raises(ValueError):
        ring_decode_attention(q, buf, buf, om.cpu())  # t on another device
    with pytest.raises(ValueError):
        ring_decode_attention(q, buf.transpose(1, 2).contiguous().transpose(1, 2), buf, om)
    with pytest.raises(ValueError):
        ring_decode_attention(torch.zeros((2, 34, 32), device=device), buf, buf, om)  # G=17
    with pytest.raises(ValueError):
        big = torch.zeros((1, 4, 1, 512), device=device)
        ring_decode_attention(torch.zeros((1, 1, 512), device=device), big, big, om)


def test_serving_on_the_card_matches_the_cpu(device):
    """Gemma-2 smoke with the ring wrapping: kernels on the card, plain
    versions on the CPU, same logits (1e-4, TF32 off) and tokens."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = chip_smoke.phase_ring_wrap(device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert out["tokens_identical"]


@pytest.mark.parametrize("arch", chip_smoke.FAMILY_SMOKE)
def test_family_serving_on_the_card_matches_the_cpu(device, arch):
    """Each family this slice adds, at its smoke width with every ring
    wrapping (Zamba2's window cut to 32): kernels on the card, plain
    versions on the CPU, the same greedy tokens and logits within 1e-4 at
    every step (TF32 off); ``forward`` and ``prefill_step`` on the chunked
    path within 1e-4."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = chip_smoke.family_card_vs_cpu(arch, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert out["tokens_identical"]
    assert out["launches"]["mrb_decode_attention"] == out["ring_layers"] * out["steps"]


# ------------------------------------------------- the device explorer (evo)
@pytest.mark.parametrize("case", ["xi1", "xi0", "main_path_xi1"])
def test_relaxed_eval_on_the_card_matches_the_cpu(device, case):
    """Multicamera: the decode writes the simulator's tables on the card,
    sim_step runs once a call, and every objective equals the same
    function on CPU tensors.  ``xi1``/``xi0``: B=256 (8 seeded gene rows
    tiled), K=16, all five relaxed objectives.  ``main_path_xi1``: the
    shapes torch_nsga2 gives sim_step on the main path (MRB_Always, B =
    offspring and B = population, K = k_max = the explorer's sim_iters)."""
    import inspect

    from repro_torch.core import multicamera
    from repro_torch.evo import TorchNSGA2Explorer

    if case == "main_path_xi1":
        K = inspect.signature(TorchNSGA2Explorer).parameters["sim_iters"].default
        err, cards, _ = chip_smoke.relaxed_identity(
            multicamera(), 1, device, chip_smoke.EVO_MAIN_OBJECTIVES, K=K,
            **chip_smoke.EVO_MAIN_IDENTITY)
        assert K == 32 and [c.shape for c in cards] == [(25, 3), (100, 3)]
    else:
        err, cards, _ = chip_smoke.relaxed_identity(multicamera(), int(case[-1]), device)
        assert [c.shape for c in cards] == [(256, len(chip_smoke.EVO_OBJECTIVES))]
    assert err == 0.0
    assert all(bool(torch.isfinite(c[:, 1:]).all()) for c in cards)


def test_relaxed_eval_counts_one_launch_per_call(device):
    import numpy as np
    from repro_torch.core import ExplorationProblem, paper_architecture, sobel
    from repro_torch.evo import PopulationLayout
    from repro_torch.evo.decode import DecodeTables, make_relaxed_eval
    from repro_torch.kernels import sim_step as kmod

    problem = ExplorationProblem(graph=sobel(), arch=paper_architecture())
    layout = PopulationLayout(problem.space(), "always")
    genes = torch.as_tensor(np.random.default_rng(0).integers(
        0, layout.bounds, size=(40, layout.n_genes)).astype(np.int32), device=device)
    tab = DecodeTables(problem.space(), (1,) * layout.n_xi)
    with_sim = make_relaxed_eval(tab, ("sim_period", "memory"), device=device)
    without = make_relaxed_eval(tab, ("period", "memory"), device=device)
    before = kmod.launches
    a, b = with_sim(genes), with_sim(genes)
    assert kmod.launches == before + 2 and torch.equal(a, b) and a.device.type == "cuda"
    without(genes)
    assert kmod.launches == before + 2


def test_relaxed_eval_is_inf_where_event_times_wrap(device):
    """A population whose event times pass 2**31: inf on the card exactly
    where the CPU's plain program wraps, the other objective finite."""
    err, (card,), _ = chip_smoke.relaxed_identity(
        chip_smoke.huge_graph(), 0, device, ("sim_period", "memory"), Bs=(64,))
    assert bool(torch.isinf(card[:, 0]).any()) and bool(torch.isfinite(card[:, 1]).all())


def _sobel_sim_problem(strategy):
    from repro_torch.core import ExplorationProblem, paper_architecture, sobel

    return ExplorationProblem(graph=sobel(), arch=paper_architecture(), strategy=strategy,
                              objectives=("sim_period", "memory", "core_cost"))


def test_exact_mode_on_the_card_matches_host_nsga2(device):
    from repro_torch.core import NSGA2Explorer, get_explorer

    problem = _sobel_sim_problem("MRB_Explore")
    cfg = dict(population=12, offspring=6, generations=3, seed=7)
    with problem.make_engine(sim_backend="cuda", device=device) as eng:
        host = NSGA2Explorer(**cfg).explore(problem, engine=eng)
    with problem.make_engine(sim_backend="cuda", device=device) as eng:
        dev = get_explorer("torch_nsga2", evaluation="exact", **cfg).explore(problem, engine=eng)
    assert dev.front == host.front
    assert dev.history == host.history
    assert dev.evaluations == host.evaluations
    assert dev.meta["device"].startswith("cuda") and dev.meta["evaluation"] == "exact"


def test_relaxed_mode_on_the_card_repeats_and_launches_per_generation(device):
    from repro_torch.evo import TorchNSGA2Explorer
    from repro_torch.kernels import sim_step as kmod

    problem = _sobel_sim_problem("MRB_Always")
    runs, counts = [], []
    for _ in range(2):
        with problem.make_engine(sim_backend="events", device=device) as eng:
            before = kmod.launches
            runs.append(TorchNSGA2Explorer(evaluation="relaxed", population=16, offspring=8,
                                           generations=3, seed=4).explore(problem, engine=eng))
            counts.append(kmod.launches - before)
    a, b = runs
    assert counts == [1 + 3, 1 + 3]     # the initial population, then one per generation
    assert a.history == b.history and a.front == b.front
    assert a.meta["relaxed_evaluations"] == 16 + 3 * 8


def _two_cell_sobel_campaign(path):
    """Two Sobel cells (Reference and MRB_Explore) with ``sim_period`` on
    the default engine backend (``cuda``)."""
    from repro_torch.core import Campaign, paper_architecture, sobel

    camp = Campaign(
        name="card-two-cells",
        problems=[{"label": "Sobel", "graph": sobel().to_dict(),
                   "arch": paper_architecture().to_dict(),
                   "objectives": ["sim_period", "memory", "core_cost"]}],
        axes={"strategy": ["Reference", "MRB_Explore"]},
        explorer_params={"population": 12, "offspring": 6, "generations": 2, "seed": 0},
    )
    path.write_text(camp.dumps())
    return camp


def test_campaign_cli_on_the_card_matches_the_cpu(device, tmp_path, capsys):
    """``python -m repro_torch campaign run`` on the card: the kernel runs
    and both cells' fronts equal a ``--device cpu`` run of the same spec
    (same store name: the device is not part of the campaign's identity)."""
    from repro_torch.cli import main
    from repro_torch.core import RunStore
    from repro_torch.kernels import sim_step as kmod

    spec = tmp_path / "spec.json"
    camp = _two_cell_sobel_campaign(spec)
    before = kmod.launches
    assert main(["campaign", "run", str(spec), "--root", str(tmp_path / "card")]) == 0
    assert kmod.launches > before
    assert main(["campaign", "run", str(spec), "--root", str(tmp_path / "cpu"),
                 "--device", "cpu"]) == 0
    capsys.readouterr()
    card = RunStore(str(tmp_path / "card" / camp.campaign_id())).read_report()
    cpu = RunStore(str(tmp_path / "cpu" / camp.campaign_id())).read_report()
    assert card["n_completed"] == cpu["n_completed"] == 2
    for tag, row in card["cells"].items():
        assert row["front"] == cpu["cells"][tag]["front"], tag
        assert row["meta"]["device"].startswith("cuda")
        assert cpu["cells"][tag]["meta"]["device"] == "cpu"


def test_sim_parity_cli_on_the_card(device, capsys):
    from repro_torch.cli import main
    from repro_torch.kernels import sim_step as kmod

    before = kmod.launches
    assert main(["sim", "parity", "--batch", "16", "--device", "cuda"]) == 0
    assert "periods identical across backends: OK" in capsys.readouterr().out
    assert kmod.launches > before


# ------------------------------------- the campaign service and planning layer
def _inline_served_spec():
    spec = chip_smoke.campaign_spec(name="served-on-the-card", apps=("Sobel",),
                                    strategies=("MRB_Explore",), explorers=("nsga2",),
                                    backends=("cuda",))
    spec["explorer_params"] = {"population": 12, "offspring": 6, "generations": 2, "seed": 0}
    return spec


def test_inline_served_cell_on_the_card_equals_a_local_run(device, tmp_path):
    """A service built with its default device runs a Sobel MRB_Explore
    cell inline through the kernel; its artifact, wall time dropped, is
    the local ``CampaignRunner``'s on the card."""
    from repro_torch.core import Campaign, CampaignRunner, RunStore
    from repro_torch.kernels import sim_step as kmod
    from repro_torch.service import CampaignService

    spec = _inline_served_spec()
    (cell,) = Campaign.from_json(spec).expand()
    service = CampaignService(str(tmp_path / "svc"), workers=0)
    try:
        assert service.device == "cuda"
        sid = service.submit(spec, tenant="card")["submission_id"]
        before = kmod.launches
        service.scheduler.drain()
        launched = kmod.launches - before
        assert service.status(sid)["done"]
        served = service.store.cells.load_cell(cell.spec_hash())
    finally:
        service.close()
    assert launched > 0
    local = RunStore(str(tmp_path / "local"))
    CampaignRunner(Campaign.from_json(spec), store=local,
                   engine_overrides={"device": "cuda"}).run()
    assert chip_smoke.strip_wall(served) == chip_smoke.strip_wall(
        local.load_cell(cell.spec_hash()))
    assert served["run"]["meta"]["device"].startswith("cuda")
    assert os.listdir(tmp_path / "svc" / "global" / "claims") == []


def test_plan_schedules_on_the_card_match_events(device):
    """An extracted LM graph's plans (MusicGen-medium, 6 stages) on the
    card: every plan's schedule through the kernel gives the event
    simulator's fire times and period, with no int32 reroute."""
    from repro_torch.configs import get_config
    from repro_torch.dataflow import plan_mapping, tpu_pod_architecture
    from repro_torch.dataflow.extract import ExtractOptions
    from repro_torch.kernels import sim_step as kmod
    from repro_torch.sim import SimConfig, batch_simulate, batched, simulate

    plans = plan_mapping(get_config("musicgen-medium").model, 4096, 256,
                         opts=ExtractOptions(n_stages=6), generations=3, population=8,
                         seed=0, time_budget_s=None)
    assert plans
    arch, cfg = tpu_pod_architecture(), SimConfig(trace=False)
    before, fallbacks = kmod.launches, batched.int32_fallbacks
    for plan in plans:
        (mine,) = batch_simulate(plan.graph, arch, [plan.schedule], cfg, backend="cuda",
                                 device=device)
        e = simulate(plan.graph, arch, plan.schedule, cfg)
        assert (mine.fire_times, mine.period, mine.deadlocked) == (
            e.fire_times, e.period, e.deadlocked)
    assert kmod.launches - before == len(plans)
    assert batched.int32_fallbacks == fallbacks


def test_service_default_device_is_the_card(tmp_path, capsys):
    """Decided inside the test: with a card, a service built without a
    device runs on it; without one, ``campaign serve`` fails at start-up
    in one line (nothing falls back to the CPU)."""
    from repro_torch.cli import main
    from repro_torch.service import CampaignService

    if torch.cuda.is_available():
        service = CampaignService(str(tmp_path / "svc"), workers=0)
        assert service.device == "cuda"
        service.close()
        return
    assert main(["campaign", "serve", "--workers", "0",
                 "--service-root", str(tmp_path / "svc")]) == 2
    err = capsys.readouterr().err
    assert err.startswith("repro_torch: error: ") and "CUDA" in err
    assert len(err.strip().splitlines()) == 1


@pytest.mark.parametrize("tied", [False, True])
def test_vocab_matmul_bf16_forward_and_backward(device, tied):
    """``_matmul_f32`` with bfloat16 weights on the card (``mm`` with a
    float32 output, its backward in ``_MatmulF32``) against the float32
    product: forward to float32 rounding, gradients to bfloat16 rounding
    of the incoming gradient; ``tied`` passes the transposed embedding."""
    from repro_torch.models.layers import _matmul_f32

    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(2, 64, 256, device=device, generator=gen).to(torch.bfloat16)
    tok = (torch.randn(1000, 256, device=device, generator=gen) * 0.02).to(torch.bfloat16)
    x.requires_grad_(True)
    tok.requires_grad_(True)
    out = _matmul_f32(x, tok.t() if tied else tok.t().contiguous())
    assert out.dtype == torch.float32 and out.shape == (2, 64, 1000)
    g = torch.randn(out.shape, device=device, generator=gen)
    dx, dtok = torch.autograd.grad(out, (x, tok), g)
    assert dx.dtype == torch.bfloat16 and dtok.dtype == torch.bfloat16
    xf = x.detach().float().requires_grad_(True)
    tf = tok.detach().float().requires_grad_(True)
    ref = xf @ tf.t()
    rdx, rdtok = torch.autograd.grad(ref, (xf, tf), g)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    for got, want in ((dx, rdx), (dtok, rdtok)):
        assert float((got.float() - want).abs().max()) <= 1e-2 * float(want.abs().max())


def test_train_step_on_the_card_matches_the_cpu(device):
    """qwen3-smoke, float32, TF32 off: loss and grad_norm within 1e-4 of the
    CPU's at each of 3 steps (``chip_smoke.py`` phase 15 (c))."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        row = chip_smoke.train_card_vs_cpu("qwen3-0.6b", device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert len(row["steps"]) == 3 and row["max_rel_err"] <= chip_smoke.TRAIN_RTOL


def test_checkpoint_of_card_state_taken_while_the_next_step_runs(device, tmp_path):
    """bf16 weights and float32 optimizer state on the card: ``save``
    returns once the host copy is taken, the next step updates the weights
    in place while the writer runs, and the checkpoint restores exactly
    the state at the save (bfloat16 bits included)."""
    from repro_torch.ckpt import CheckpointManager, restore_pytree
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.runtime.train import (init_train_state, load_state_tree,
                                           make_train_step, state_tree)

    cfg = get_config("qwen3-0.6b").smoke.replace(dtype="bfloat16")
    state, upd = init_train_state(cfg, device=device)
    step = make_train_step(cfg, upd)
    batch = make_batch(cfg, 32, 2, device=device)
    step(state, batch)

    def flat(t, prefix=""):
        out = {}
        for k, v in t.items():
            out.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                       else {f"{prefix}{k}": v.detach().cpu().clone()})
        return out

    want = flat(state_tree(state))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state_tree(state))
    step(state, batch)
    mgr.wait()
    assert not torch.equal(flat(state_tree(state))["params/blocks/attn/wq"],
                           want["params/blocks/attn/wq"])
    got = flat(restore_pytree(str(tmp_path), 1, state_tree(state, template=True)))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert want["params/blocks/attn/wq"].dtype == torch.bfloat16
    load_state_tree(state, restore_pytree(str(tmp_path), 1, state_tree(state, template=True)))
    assert int(state.opt.step) == 1


# ------------------------------------------------------------- distribution
@pytest.fixture
def nccl_one(device, tmp_path):
    """An NCCL group of one rank on the card (a file store under
    ``tmp_path``) and a gloo group over the same rank, closed afterwards."""
    import torch.distributed as dist

    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1, device_id=device)
    try:
        yield dist.new_group(backend="gloo")
    finally:
        dist.destroy_process_group()


def test_compressed_psum_of_card_tensors_equals_cpu(device, nccl_one):
    """``compressed_psum`` over NCCL on card tensors gives the CPU's result
    over gloo bit for bit: int8 values, scale, mean and residual; the card
    tensors never leave the card."""
    from repro_torch.optim import compressed_psum, int8_error_feedback_compress

    gen = torch.Generator().manual_seed(3)
    for shape in ((257,), (28, 1024, 3072), (3, 5, 7)):
        g = torch.randn(shape, generator=gen) * 5
        e = torch.randn(shape, generator=gen) * 0.01
        cq, cs, ce = int8_error_feedback_compress(g.to(device), e.to(device))
        q, s, r = int8_error_feedback_compress(g, e)
        assert torch.equal(cq.cpu(), q) and torch.equal(cs.cpu(), s) and torch.equal(ce.cpu(), r)
        cm, cr = compressed_psum(g.to(device), e.to(device))
        m, r = compressed_psum(g, e, group=nccl_one)
        assert cm.is_cuda and cr.is_cuda
        assert torch.equal(cm.cpu(), m) and torch.equal(cr.cpu(), r)


def test_compressed_step_at_one_nccl_rank_matches_uncompressed(device, nccl_one):
    """Qwen3 smoke, one NCCL rank: the int8 compressed step against the
    uncompressed step from the same state, within the reference's bounds
    (loss relative 1e-5, parameters within 5e-3); the residual is not 0.
    Those bounds hold for any finite update (AdamW's first step moves each
    weight by about lr), so the step's reduction is also held, leaf by
    leaf, against the plain gradients quantized and dequantized apart from
    the step (``chip_smoke.check_reduction``)."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.models import tree
    from repro_torch.runtime import make_compressed_dp_train_step, make_train_step
    from repro_torch.runtime.train import init_train_state

    cfg = get_config("qwen3-0.6b").smoke
    batch = make_batch(cfg, 64, 4, device=device)
    comp, upd = init_train_state(cfg, device=device)
    plain, _ = init_train_state(cfg, device=device)
    rec = {}
    init_cs, cstep = make_compressed_dp_train_step(cfg, chip_smoke.capturing(upd, rec))
    cs = init_cs(comp)
    want = chip_smoke.reduction_reference(cfg, plain.model, batch, cs.err)
    with chip_smoke.recording_reduction(rec):
        cs, cm = cstep(cs, batch)
    chip_smoke.check_reduction(cfg, want, rec, cs.err, cm["grad_norm"])
    _, pm = make_train_step(cfg, upd)(plain, batch)
    assert float(cm["loss"]) == pytest.approx(float(pm["loss"]), rel=1e-5)
    a, b = dict(cs.model.named_parameters()), dict(plain.model.named_parameters())
    with torch.no_grad():
        for key, leaf in tree.layout(cfg).items():
            d = (tree.stacked(leaf, a) - tree.stacked(leaf, b)).abs().max()
            assert float(d) < 5e-3, key
    assert all(e.is_cuda for e in cs.err.values())
    assert sum(float(e.abs().sum()) for e in cs.err.values()) > 0
