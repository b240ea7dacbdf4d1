"""The host side of the CUDA simulation kernel, on the CPU.

``kernels/sim_step.py::launch_plan`` (warps, actors per thread, shared
memory and its layout), ``sim/batched.py::pack_tables`` (tasks packed by
actor offsets, the window-start gate masks), the kernel's division-free MRB
arithmetic against ``floor_mod``, and the wrapper's CPU path.  No JAX: the
packed gate masks are held against the port's own ``_lower_batch``.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke  # noqa: E402
from repro_torch.kernels import sim_step as kmod  # noqa: E402
from repro_torch.kernels.sim_step import SMEM_LIMIT, launch_plan  # noqa: E402
from repro_torch.sim import lower_phenotype  # noqa: E402
from repro_torch.sim.batched import (  # noqa: E402
    _lower_batch, compact_tables, pack_tables, simulate_plain,
)

CASES = {name: (app, xi, ports) for name, app, xi, ports in chip_smoke.CASES}


def _tables(name, n=2):
    app, xi, ports = CASES[name]
    gt, arch, scheds, cfg = chip_smoke.build_case(app, xi, ports, n=n)
    static, batched = _lower_batch([lower_phenotype(gt, arch, s) for s in scheds])
    return static, compact_tables(static, batched, "cpu"), cfg


def _plan_of(tab):
    return launch_plan(tab.A, tab.C, tab.R, tab.H, tab.Tmax, tab.total_tasks())


# (A, warps, actors per thread) of the six phase-2 shapes
PHASE2 = {
    "sobel_xi0": (7, 1, 1), "sobel_xi1": (6, 1, 1), "sobel4_xi1": (19, 1, 1),
    "multicamera_xi0": (62, 2, 1), "multicamera_xi1": (39, 2, 1), "sobel_xi1_ports1": (6, 1, 1),
}


@pytest.mark.parametrize("name", sorted(PHASE2))
def test_launch_plan_of_phase2_shapes(name):
    _, tab, _ = _tables(name)
    plan = _plan_of(tab)
    A, warps, apt = PHASE2[name]
    assert tab.A == A
    assert (plan["warps"], plan["actors_per_thread"], plan["threads"]) == (warps, apt, 32 * warps)
    assert plan["threads"] * plan["actors_per_thread"] >= tab.A
    assert plan["tasks"] == int(tab.n_tasks.sum())
    # 12 B per task packed by actor offsets, not padded to Tmax
    assert plan["layout"]["route"] - plan["layout"]["desc"] == 2 * plan["tasks"]
    assert 0 < plan["smem_bytes"] <= SMEM_LIMIT
    assert plan["pack"]["words"] == tab.pack.numel()


@pytest.mark.parametrize("A,warps,apt", [
    (1, 1, 1), (31, 1, 1), (32, 1, 1), (33, 2, 1), (64, 2, 1), (65, 3, 1), (1024, 32, 1),
])
def test_launch_plan_across_warp_edges(A, warps, apt):
    plan = launch_plan(A, 37, 2, 5, 4, 3 * A)
    assert (plan["warps"], plan["actors_per_thread"], plan["threads"]) == (warps, apt, 32 * warps)
    assert plan["threads"] >= A > plan["threads"] - 32
    assert 0 < plan["smem_bytes"] <= SMEM_LIMIT
    T, C, CR, H = 3 * A, 37, 74, 5
    # desc/dur/route; gam/nrd/nfull/wrt/active; avail/rdr; blocked/owner/
    # claim/chcand; icbusy; the warps' prefix-OR totals and flag words
    assert plan["smem_bytes"] == 4 * (3 * T + 5 * C + 2 * CR + 4 * A + H + 3 * warps)


@pytest.mark.parametrize("shape", [
    dict(A=1025, C=4, R=1, H=5, Tmax=4, T=8),       # more actors than a CTA holds
    dict(A=0, C=4, R=1, H=5, Tmax=4, T=0),
    dict(A=16, C=4, R=1, H=33, Tmax=4, T=8),        # routes are 32-bit masks
    dict(A=16, C=4, R=1, H=5, Tmax=4, T=65),        # more tasks than A * Tmax
    dict(A=64, C=20_000, R=1, H=5, Tmax=4, T=64),   # tables overflow shared memory
    dict(A=1024, C=8, R=1, H=5, Tmax=64, T=30_000),
])
def test_launch_plan_raises(shape):
    with pytest.raises(ValueError):
        launch_plan(**shape)


def _unpack(pack, A, C, R, Tmax, plan):
    """kind/chan/slot (A, Tmax) and n_tasks from the packed words, padding
    as compact_tables writes it (EXEC, -1, -1)."""
    words = pack.numpy().astype(np.int64)
    off = words[:A + 1]
    desc = words[plan["pack"]["desc"]:plan["pack"]["gin"]]
    kind = np.ones((A, Tmax), np.int64)
    chan = np.full((A, Tmax), -1, np.int64)
    slot = np.full((A, Tmax), -1, np.int64)
    for a in range(A):
        d = desc[off[a]:off[a + 1]]
        kind[a, :d.size] = d & 0xFF
        slot[a, :d.size] = ((d >> 8) & 0xFF).astype(np.uint8).astype(np.int8)
        chan[a, :d.size] = d >> 16
    return kind, chan, slot, off[1:] - off[:-1]


def _bits(words, n):
    A = words.shape[0]
    w = words.astype(np.uint32)
    return ((w[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1).reshape(A, -1)[:, :n] == 1


GATE_CASES = ["sobel_xi0", "sobel_xi1", "sobel4_xi1", "multicamera_xi0", "multicamera_xi1"]


@pytest.mark.parametrize("name", GATE_CASES)
def test_packed_tasks_unpack_to_the_tables(name):
    _, tab, _ = _tables(name)
    plan = _plan_of(tab)
    kind, chan, slot, n_tasks = _unpack(tab.pack, tab.A, tab.C, tab.R, tab.Tmax, plan)
    assert np.array_equal(kind, tab.kind.numpy())
    assert np.array_equal(chan, tab.chan.numpy())
    assert np.array_equal(slot, tab.slot.numpy())
    assert np.array_equal(n_tasks, tab.n_tasks.numpy())


@pytest.mark.parametrize("name", GATE_CASES)
def test_packed_gate_masks_are_lower_batch_masks(name):
    static, tab, _ = _tables(name)
    plan = _plan_of(tab)
    A, C, R = tab.A, tab.C, tab.R
    words = tab.pack.numpy().view(np.uint32)
    wv, wc = plan["mask_words"]["views"], plan["mask_words"]["channels"]
    gin = words[plan["pack"]["gin"]:plan["pack"]["gout"]].reshape(A, wv)
    gout = words[plan["pack"]["gout"]:plan["pack"]["words"]].reshape(A, wc)
    assert np.array_equal(_bits(gin, C * R), static["inmask"].reshape(A, C * R))
    assert np.array_equal(_bits(gout, C), static["outmask"])


# (A, C, R, warps) of the large tier's scenarios at ξ=1 (chip_smoke phase 11
# and the card tests): up to four warps and nine readers of one view
LARGE = {
    "camera_pipeline": (33, 31, 2, 2), "multicast_tree": (122, 121, 3, 4),
    "random_dag": (40, 34, 9, 2), "split_join": (99, 103, 2, 4),
    "stencil_chain": (34, 33, 3, 2),
}


def _large_tables(family):
    gt, arch, scheds = chip_smoke.build_large_case(family)
    static, batched = _lower_batch([lower_phenotype(gt, arch, s) for s in scheds])
    return static, compact_tables(static, batched, "cpu")


@pytest.mark.parametrize("family", sorted(LARGE))
def test_large_tier_tables_pack_and_plan(family):
    """The packed tasks and gate masks of the large tier's tables unpack to
    the tables and the lowering's masks, and the plan holds the actors."""
    static, tab = _large_tables(family)
    plan = _plan_of(tab)
    A, C, R, warps = LARGE[family]
    assert (tab.A, tab.C, tab.R, tab.B) == (A, C, R, 4)
    assert (plan["warps"], plan["threads"]) == (warps, 32 * warps)
    assert plan["threads"] >= A > plan["threads"] - 32
    assert 0 < plan["smem_bytes"] <= SMEM_LIMIT
    assert plan["pack"]["words"] == tab.pack.numel()
    kind, chan, slot, n_tasks = _unpack(tab.pack, tab.A, tab.C, tab.R, tab.Tmax, plan)
    assert np.array_equal(kind, tab.kind.numpy())
    assert np.array_equal(chan, tab.chan.numpy())
    assert np.array_equal(slot, tab.slot.numpy())
    assert np.array_equal(n_tasks, tab.n_tasks.numpy())
    words = tab.pack.numpy().view(np.uint32)
    wv, wc = plan["mask_words"]["views"], plan["mask_words"]["channels"]
    gin = words[plan["pack"]["gin"]:plan["pack"]["gout"]].reshape(A, wv)
    gout = words[plan["pack"]["gout"]:plan["pack"]["words"]].reshape(A, wc)
    assert np.array_equal(_bits(gin, C * R), static["inmask"].reshape(A, C * R))
    assert np.array_equal(_bits(gout, C), static["outmask"])


@pytest.mark.parametrize("inmask,outmask", [
    ([[[False]], [[False]]], [[True], [True]]),   # two writers of channel 0
    ([[[True]], [[True]]], [[False], [False]]),   # two readers of view (0, 0)
])
def test_pack_rejects_shared_views_and_channels(inmask, outmask):
    kind = np.array([[2], [2]]) if np.any(outmask) else np.array([[0], [0]])
    chan = np.array([[0], [0]])
    slot = np.array([[-1], [-1]]) if np.any(outmask) else np.array([[0], [0]])
    with pytest.raises(ValueError):
        pack_tables(kind, chan, slot, [1, 1], np.array(inmask), np.array(outmask))


def _floor_mod(a, m):
    return np.mod(a, m)  # numpy's % is floored, as jnp's


def avail_count(omega, rho, gamma):
    """Tokens a live view (ω, ρ ∈ [0, γ)) can still read,
    ``floor_mod(ω − ρ − 1, γ) + 1``, by one compare-and-add, as the kernel
    keeps it: the operand lies in [−γ, γ − 2]."""
    x = omega - rho - 1
    return np.where(x < 0, x + gamma, x) + 1


def advance(x, gamma):
    """``floor_mod(x + 1, γ)`` for x ∈ [0, γ), by one compare."""
    return np.where(x + 1 == gamma, 0, x + 1)


@pytest.mark.parametrize("lo,hi", [(1, 60), (60, 160), (160, 301)])
def test_compare_and_add_equal_floor_mod(lo, hi):
    """avail_count and advance against floor_mod on their whole operand
    range (ω, ρ, x ∈ [0, γ)), for γ in 1..300; and the avail updates the
    kernel applies (a read: avail - 1; a write below γ: avail + 1; a dead
    view revived: 1) against the ω/ρ machine they stand for."""
    for g in range(lo, hi):
        om, rho = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
        want = _floor_mod(om - rho - 1, g) + 1
        got = avail_count(om, rho, g)
        assert np.array_equal(got, want)
        assert got.min() >= 1 and got.max() <= g
        x = np.arange(g)
        assert np.array_equal(advance(x, g), _floor_mod(x + 1, g))
        # a read advances ρ: avail - 1 (a view at 1 dies instead)
        live = want >= 2
        assert np.array_equal(avail_count(om, advance(rho, g), g)[live], want[live] - 1)
        # a write advances ω: avail + 1 wherever the view is not full
        room = want < g
        assert np.array_equal(avail_count(advance(om, g), rho, g)[room], want[room] + 1)
        # a dead view revived at ω holds 1 after ω advances
        assert np.array_equal(avail_count(advance(x, g), x, g), np.ones(g, np.int64))
        # the one modulo before the loop: floor_mod(δ - 1, γ) + 1 for ρ = 0
        d = np.arange(1, 3 * g + 2)
        assert np.array_equal(_floor_mod(d - 1, g) + 1, avail_count(_floor_mod(d, g), 0, g))


def test_wrapper_on_cpu_tensors_runs_the_plain_program():
    _, tab, cfg = _tables("sobel_xi1", n=3)
    before = kmod.launches
    stats, plain_stats = {}, {}
    got = kmod.sim_step(tab, 8, 8, cfg.mrb_ports, stats=stats)
    want = simulate_plain(tab, 8, 8, cfg.mrb_ports, stats=plain_stats)
    assert kmod.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(stats["rounds"], plain_stats["rounds"])


def test_total_tasks_from_the_pack_needs_no_device_sync():
    _, tab, _ = _tables("multicamera_xi1")
    T = int(tab.n_tasks.sum())
    assert tab.total_tasks() == T
    tab.pack = None
    assert tab.total_tasks() == T
