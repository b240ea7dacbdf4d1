"""Batched caps_hms-compatible relaxed decode: genes → objective vectors.

The host decode (:func:`repro_torch.core.caps_hms.decode_via_heuristic`)
is a sequential modulo-scheduling search, one genotype at a time.  This
module evaluates the *list-scheduling relaxation* of it for a whole
population at once, as torch ops over the population axis, on the
segment-packed task tables of the batched simulator
(:func:`repro_torch.sim.batched.lower_structure`):

1. **binding scan** — Algorithm 2's greedy channel→memory derivation,
   replayed exactly (sorted channel order, PROD→TILE-PROD→GLOBAL /
   CONS→TILE-CONS→GLOBAL fallback chains, running int64 capacity
   accounting) as a loop over channels with the *declared* γ (the host's
   enlarge-and-rebind fixpoint is the relaxed part);
2. **ASAP pass** — one dependency-driven pass over actors in topological
   (= arbitration) order gives uncontended task start/finish times, from
   which the capacity enlargement γ̂ of Algorithms 3/4 is estimated with
   the same lifetime formula ``δ + ⌊(F − s_w)/P⌋ + 1``;
3. **period** — the resource lower bound P_lb = max_r Σ τ (Algorithm 4
   line 3, where the host's gallop search *starts*), or — when the
   objective list asks for ``sim_period`` — the measured steady-state
   period of the phenotype's self-timed execution: the decode writes the
   simulator's per-phenotype tables (durations, route bitmasks, compact
   cores, γ̂) on the device and hands them to
   :func:`repro_torch.kernels.sim_step.sim_step`, one launch per call,
   with no host round trip between decode and simulation.

One :class:`DecodeTables` is built per ξ pattern (the MRB substitution
changes the graph, so tables cannot be shared across patterns; the
explorer buckets the population and LRU-caches tables per pattern).

This is a *relaxation*: no modulo-window conflict resolution, no
enlarge-rebind fixpoint, a single-shot simulation horizon.  The explorer's
relaxed path is gated by a relative-hypervolume tolerance against the host
front, never by bit equality.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.binding import CHANNEL_DECISIONS
from ..core.schedule import Schedule, TaskTimes
from ..device import resolve_device

__all__ = ["DecodeTables", "RELAXED_OBJECTIVES", "make_relaxed_eval", "asap_pass", "device_period"]

# Objectives the relaxed decode can produce, and how (see module
# docstring).  Anything else (a user-registered objective) needs the host
# engine — the explorer refuses relaxed evaluation for it.
RELAXED_OBJECTIVES = ("period", "memory", "core_cost", "comm_volume", "sim_period")

_BIG = 1 << 40  # sentinel beyond any schedule time


class DecodeTables:
    """Host-precomputed lookup tables for one (ξ pattern, space) pair.

    Everything gene-independent is baked here as numpy arrays; the decode
    only gathers.  Axis conventions match the batched simulator: actors in
    arbitration order (descending topological priority — also a valid ASAP
    order, since zero-delay edges always point down the priority), channels
    sorted, cores / memories / interconnects sorted.  ``sim`` holds the
    simulator's graph-derived tables (``kind``, ``chan``, ``slot``,
    ``n_tasks``, ``nread``, ``delay`` and the kernel's ``pack``) as CPU
    tensors; :meth:`sim_static` copies them to a device once.
    """

    def __init__(self, space, xi_bits: Tuple[int, ...], *, pipelined: bool = True):
        from ..core.dse import transformed_graph
        from ..sim.batched import compact_tables, lower_structure
        from ..sim.model import lower_phenotype

        arch = space.arch
        gt = transformed_graph(space, tuple(xi_bits), pipelined)
        self.xi_bits = tuple(xi_bits)
        self.gt = gt

        cores = sorted(arch.cores)
        mems = sorted(arch.memories)
        p_idx = {p: i for i, p in enumerate(cores)}
        q_idx = {q: i for i, q in enumerate(mems)}
        P, Q = len(cores), len(mems)

        # A representative schedule (first allowed core, GLOBAL placement)
        # only to *lower the structure*: the static tables depend on the
        # graph alone, never on this binding.
        beta_a = {a: space.allowed[a][0] for a in gt.actors}
        rep = Schedule(
            period=1,
            times=TaskTimes(),
            actor_binding=beta_a,
            channel_binding={c: arch.global_memory for c in gt.channels},
            capacities={c: gt.channels[c].capacity for c in gt.channels},
        )
        prog = lower_phenotype(gt, arch, rep)
        self.static, rep_batched = lower_structure(prog)
        tab = compact_tables(self.static, rep_batched, "cpu")
        self.sim = {
            name: getattr(tab, name)
            for name in ("kind", "chan", "slot", "n_tasks", "nread", "delay", "pack")
        }
        self._sim_on: Dict[str, Dict[str, torch.Tensor]] = {}
        actors = prog.actors            # arbitration (= topological) order
        channels = prog.channels        # sorted
        ics = sorted(arch.interconnects)
        A, C, H = len(actors), len(channels), len(ics)
        self.A, self.C, self.P, self.Q, self.H = A, C, P, Q, H

        # ---- gene plumbing -------------------------------------------
        # Gene segment lengths follow the *original* space (MRB
        # substitution changes channels, never the gene layout).
        self.n_xi_genes = len(space.mcast)
        self.n_cd_genes = len(space.channels)
        self.n_ba_genes = len(space.actors)
        gene_pos = {a: i for i, a in enumerate(space.actors)}
        self.ba_gene_of = np.array([gene_pos[a] for a in actors], np.int32)
        jmax = max(len(space.allowed[a]) for a in actors)
        self.allowed_core = np.zeros((A, jmax), np.int32)
        self.n_allowed = np.zeros(A, np.int32)
        for ai, a in enumerate(actors):
            opts = space.allowed[a]
            self.n_allowed[ai] = len(opts)
            for j in range(jmax):
                self.allowed_core[ai, j] = p_idx[opts[j % len(opts)]]
        # C_d genes follow space.channels; an MRB channel inherits its
        # first member's decision (evaluate_genotype's name parsing).
        cpos = {c: i for i, c in enumerate(space.channels)}
        self.cd_gene_of = np.zeros(C, np.int32)
        for ci, c in enumerate(channels):
            if c in cpos:
                self.cd_gene_of[ci] = cpos[c]
            else:
                inner = c[len("mrb{"):-1].split(",")
                self.cd_gene_of[ci] = cpos[inner[0]]

        # ---- architecture tables -------------------------------------
        self.exec_time = np.zeros((A, P), np.int32)
        for ai, a in enumerate(actors):
            for p in cores:
                t = gt.actors[a].exec_times.get(arch.cores[p].ctype)
                self.exec_time[ai, p_idx[p]] = 0 if t is None else t
        self.core_cost = np.array(
            [arch.core_cost(arch.cores[p].ctype) for p in cores], np.float64
        )
        self.mem_cap = np.array(
            [arch.memories[q].capacity for q in mems], np.int64
        )
        # Decision → memory, given the decision's relevant core.
        self.mem_sel = np.zeros((len(CHANNEL_DECISIONS), P), np.int32)
        for di, d in enumerate(CHANNEL_DECISIONS):
            for p in cores:
                if d in ("PROD", "CONS"):
                    q = arch.core_local_memory(p)
                elif d in ("TILE-PROD", "TILE-CONS"):
                    q = arch.tile_local_memory(arch.cores[p].tile)
                else:
                    q = arch.global_memory
                self.mem_sel[di, p_idx[p]] = q_idx[q]
        # τ(φ(c), p, q) per channel (Eq. 11) and route occupancy / hops.
        self.tau = np.zeros((C, P, Q), np.int32)
        self.route_occ = np.zeros((P, Q, max(H, 1)), np.int8)
        h_idx = {h: i for i, h in enumerate(ics)}
        for p in cores:
            for q in mems:
                for h in arch.route_interconnects(p, q):
                    self.route_occ[p_idx[p], q_idx[q], h_idx[h]] = 1
        self.hops = self.route_occ.sum(-1).astype(np.int32)
        for ci, c in enumerate(channels):
            phi = gt.channels[c].token_bytes
            for p in cores:
                for q in mems:
                    self.tau[ci, p_idx[p], q_idx[q]] = arch.comm_time(phi, p, q)

        # ---- channel tables ------------------------------------------
        a_idx = {a: i for i, a in enumerate(actors)}
        self.phi = np.array([gt.channels[c].token_bytes for c in channels], np.int64)
        self.gamma0 = np.array([gt.channels[c].capacity for c in channels], np.int64)
        self.delta = np.array([gt.channels[c].delay for c in channels], np.int64)
        self.prod_a = np.array([a_idx[gt.producer[c]] for c in channels], np.int32)
        self.cons0_a = np.array(
            [a_idx[gt.consumers[c][0]] for c in channels], np.int32
        )
        self.prod_rate = np.array(
            [gt.prod_rate[(gt.producer[c], c)] for c in channels], np.int64
        )
        R = self.static["R"]
        self.reader_a = np.zeros((C, R), np.int32)
        self.read_rate = np.zeros((C, R), np.int64)
        for ci, c in enumerate(channels):
            for ri, r in enumerate(prog.readers[c]):
                self.reader_a[ci, ri] = a_idx[r]
                self.read_rate[ci, ri] = gt.cons_rate[(c, r)]
        # Zero-delay input gate: which channels an actor's window waits on
        # within one iteration (initial tokens break the dependency).
        inmask = self.static["inmask"]          # (A, C, R) bool
        self.in0mask = inmask.any(-1) & (self.delta[None, :] == 0)
        self.outmask = self.static["outmask"]   # (A, C) bool

    def sim_static(self, device: torch.device) -> Dict[str, torch.Tensor]:
        """The simulator's graph-derived tables on ``device`` (copied once)."""
        key = str(device)
        if key not in self._sim_on:
            self._sim_on[key] = {k: v.to(device) for k, v in self.sim.items()}
        return self._sim_on[key]


# ==========================================================================
def make_relaxed_eval(
    tables: DecodeTables,
    objectives: Sequence[str],
    *,
    sim_iters: int = 32,
    mrb_ports: Optional[int] = None,
    device="cuda",
):
    """Build the per-ξ-pattern evaluation ``genes (N, G) → F (N, k)``.

    ``genes`` is an integer tensor on ``device`` (``"cuda"`` unless the
    caller asks for ``"cpu"``); ``F`` is float64 on the same device.
    Capacity arithmetic is int64.  With ``sim_period`` among the
    objectives each call launches the ``sim_step`` kernel once on CUDA
    tensors (its plain program on CPU tensors) with ``K = k_max =
    sim_iters``.
    """
    unsupported = [o for o in objectives if o not in RELAXED_OBJECTIVES]
    if unsupported:
        raise ValueError(
            f"relaxed decode cannot produce objectives {unsupported}; "
            f"supported: {RELAXED_OBJECTIVES}"
        )
    from ..kernels.sim_step import sim_step
    from ..sim.batched import SimTables

    dev = resolve_device(device)
    t = tables
    st = t.static
    A, C, Tmax = t.A, t.C, st["Tmax"]
    objectives = tuple(objectives)
    want_sim = "sim_period" in objectives
    i64 = torch.int64

    def T(x, dtype=i64):
        return torch.as_tensor(np.asarray(x), device=dev).to(dtype)

    # Graph-derived task structure, as in the simulator's lowering.
    ts_tab = np.asarray(st["ts_tab"])
    chan_oh = ts_tab[:, :, 2:2 + C] > 0                    # (A, Tmax, C)
    is_rd = ts_tab[:, :, 0] > 0
    is_wr = ts_tab[:, :, 1] > 0
    has_chan = is_rd | is_wr
    valid = np.arange(Tmax)[None, :] < np.asarray(st["n_tasks"])[:, None]
    cidx = chan_oh.argmax(-1)                              # (A, Tmax)
    comm = has_chan & valid
    asap = asap_pass(t, dev)

    a_iota = torch.arange(A, device=dev)
    cidx_d = T(cidx)
    comm_d = T(comm, torch.bool)
    exec_slot = T(valid & ~has_chan, torch.bool)
    allowed = T(t.allowed_core)
    n_allowed = T(t.n_allowed)
    ba_gene_of = T(t.ba_gene_of)
    cd_gene_of = T(t.cd_gene_of)
    exec_time = T(t.exec_time)
    tau = T(t.tau)
    route_occ = T(t.route_occ)
    hops = T(t.hops)
    mem_sel = T(t.mem_sel)
    mem_cap = T(t.mem_cap)
    kcost = T(t.core_cost, torch.float64)
    phi = T(t.phi)
    gamma0 = T(t.gamma0)
    delta = T(t.delta)
    prod_a = T(t.prod_a)
    cons0_a = T(t.cons0_a)
    prod_rate = T(t.prod_rate)
    reader_a = T(t.reader_a)
    read_rate = T(t.read_rate)
    reader_mask = T(st["reader_mask"])
    need = gamma0 * phi
    n_xi, n_cd, n_ba = t.n_xi_genes, t.n_cd_genes, t.n_ba_genes
    H = st["H"]
    bits = T([1 << h for h in range(max(H, 1))]) * (H > 0)
    sim_static = t.sim_static(dev) if want_sim else None

    def evaluate(genes: torch.Tensor) -> torch.Tensor:
        genes = genes.to(dev, i64)
        B = genes.shape[0]
        # ---- gene decode -------------------------------------------------
        cd_genes = genes[:, n_xi:n_xi + n_cd]
        ba_genes = genes[:, n_xi + n_cd:n_xi + n_cd + n_ba]
        j = torch.remainder(ba_genes[:, ba_gene_of], n_allowed)
        core = allowed[a_iota, j]                            # (B, A) core idx
        d = cd_genes[:, cd_gene_of]                          # (B, C) decision
        p_rel = torch.where(d < 2, core[:, prod_a], core[:, cons0_a])

        # ---- Algorithm 2: greedy binding with fallback chains ------------
        first_q = mem_sel[d, p_rel]
        # PROD→TILE-PROD and CONS→TILE-CONS; TILE-* and GLOBAL fall back to
        # global directly.
        second_q = torch.where(
            (d == 0) | (d == 2), mem_sel[torch.clamp(d + 1, 0, 4), p_rel],
            mem_sel[4, p_rel],
        )
        third_q = mem_sel[4, p_rel]
        # A channel fits memory q while usage[q] ≤ cap[q] − need[c].
        room1, room2 = mem_cap[first_q] - need, mem_cap[second_q] - need
        need_b = need.expand(B, C)
        usage = torch.zeros((B, mem_cap.shape[0]), dtype=i64, device=dev)
        q_cols = []
        for c in range(C):
            q1, q2, col = first_q[:, c:c + 1], second_q[:, c:c + 1], slice(c, c + 1)
            q = torch.where(
                usage.gather(1, q1) <= room1[:, col], q1,
                torch.where(usage.gather(1, q2) <= room2[:, col], q2, third_q[:, col]),
            )
            usage.scatter_add_(1, q, need_b[:, col])
            q_cols.append(q)
        q_of = torch.cat(q_cols, 1)                          # (B, C)

        # ---- per-slot durations (Eq. 11 / τ(a, ϑ)) -----------------------
        q_slot = q_of[:, cidx_d]                             # (B, A, Tmax)
        dur_comm = tau[cidx_d, core[:, :, None], q_slot]
        e_a = exec_time[a_iota, core]                        # (B, A)
        dur = torch.where(
            comm_d, dur_comm, torch.where(exec_slot, e_a[:, :, None], 0)
        )

        # ---- ASAP pass (uncontended list schedule) -----------------------
        rfin, wstart = asap(dur)

        # ---- resource loads → period lower bound (Alg. 4, line 3) --------
        window = dur.sum(2)
        core_load = torch.zeros((B, t.P), dtype=i64, device=dev).scatter_add(1, core, window)
        occ = route_occ[core[:, :, None], q_slot] * comm_d[..., None]  # (B, A, Tmax, H)
        link_load = (dur[..., None] * occ).sum((1, 2))
        p_lb = torch.clamp(
            torch.maximum(core_load.amax(1), link_load.amax(1)), min=1
        )[:, None]

        # ---- capacity enlargement estimate (Algorithms 3/4) --------------
        seen = (rfin > -_BIG) & (wstart > -_BIG)
        gamma_hat = torch.where(
            seen,
            torch.maximum(
                gamma0, delta + torch.div(rfin - wstart, p_lb, rounding_mode="floor") + 1
            ),
            gamma0,
        )
        gamma_hat = torch.clamp(gamma_hat, min=1)

        # ---- objectives --------------------------------------------------
        vals: Dict[str, torch.Tensor] = {}
        vals["period"] = p_lb[:, 0].to(torch.float64)
        vals["memory"] = (gamma_hat * phi).sum(1).to(torch.float64)
        used = torch.zeros((B, t.P), dtype=torch.bool, device=dev).scatter(
            1, core, torch.ones_like(core, dtype=torch.bool)
        )
        vals["core_cost"] = (used * kcost).sum(1)
        wr_vol = prod_rate * phi * hops[core[:, prod_a], q_of]
        rd_vol = (
            read_rate * phi[:, None] * hops[core[:, reader_a], q_of[:, :, None]]
            * reader_mask
        ).sum(-1)
        vals["comm_volume"] = (wr_vol + rd_vol).sum(1).to(torch.float64)

        if want_sim:
            # The simulator's per-phenotype tables, written on the device:
            # durations, the route bitmask of occupied interconnects, the
            # compact core index (first actor on each core, numbered in
            # actor order) and γ̂.
            route = (occ * bits).sum(-1)
            route = torch.where(route >= 1 << 31, route - (1 << 32), route)
            eq = (core[:, :, None] == core[:, None, :]).to(torch.uint8)
            first = eq.argmax(2)                             # (B, A)
            compact = torch.cumsum(first == a_iota, 1) - 1
            tab = SimTables(
                **sim_static,
                dur=dur.to(torch.int32).contiguous(),
                route=route.to(torch.int32).contiguous(),
                core=compact.gather(1, first).to(torch.int32).contiguous(),
                gamma=gamma_hat.to(torch.int32).contiguous(),
                R=st["R"],
                H=H,
            )
            fire, dead, _ = sim_step(tab, sim_iters, sim_iters, mrb_ports)
            vals["sim_period"] = device_period(fire, dead, sim_iters)

        return torch.stack([vals[o] for o in objectives], 1)

    return evaluate


def asap_pass(t: DecodeTables, device) -> Callable:
    """The ASAP pass (the reference's per-actor ``asap`` loop) as
    ``dur (B, A, Tmax) int64 → (rfin, wstart) (B, C)``: per channel the
    latest end of a read and the latest start of a write in one
    uncontended iteration, ``-2**40`` where there is none.

    It works on the (actor, task, channel) triples of the reads and
    writes.  Every channel has one writer (``pack_tables`` checks it), so
    an actor's window starts at ws, the latest finish of its zero-delay
    inputs' writers that come before it in arbitration order (a later
    writer has not run yet and counts 0), and every task time is ws plus
    the actor's running sum of durations.  Only the ws of actors with such
    inputs is a sequential pass; pipelined graphs (δ ≥ 1) have none."""
    st = t.static
    ts_tab = np.asarray(st["ts_tab"])
    C, Tmax = t.C, st["Tmax"]
    valid = np.arange(Tmax)[None, :] < np.asarray(st["n_tasks"])[:, None]
    cidx = (ts_tab[:, :, 2:2 + C] > 0).argmax(-1)
    rd_a, rd_t = np.nonzero((ts_tab[:, :, 0] > 0) & valid)
    wr_a, wr_t = np.nonzero((ts_tab[:, :, 1] > 0) & valid)
    writer = np.full(C, -1)
    writer[cidx[wr_a, wr_t]] = wr_a

    def T(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=device)

    chain = []
    for k in range(t.A):
        cs = [c for c in np.nonzero(t.in0mask[k])[0] if 0 <= writer[c] < k]
        if cs:
            chain.append((k, T(writer[cs]), T(cs)))
    rd_a, rd_t, rd_c = T(rd_a), T(rd_t), T(cidx[rd_a, rd_t])
    wr_a, wr_t, wr_c = T(wr_a), T(wr_t), T(cidx[wr_a, wr_t])

    def asap(dur: torch.Tensor):
        ends = torch.cumsum(dur, 2)                          # ws = 0
        wr_end = ends[:, wr_a, wr_t]
        wr_beg = wr_end - dur[:, wr_a, wr_t]
        rd_end = ends[:, rd_a, rd_t]
        if chain:
            wfin = _scatter_max(wr_end, wr_c, C, 0)
            ws = torch.zeros(dur.shape[:2], dtype=dur.dtype, device=dur.device)
            for k, w, c in chain:
                ws[:, k] = (ws[:, w] + wfin[:, c]).amax(1).clamp(min=0)
            wr_beg = wr_beg + ws[:, wr_a]
            rd_end = rd_end + ws[:, rd_a]
        return _scatter_max(rd_end, rd_c, C, -_BIG), _scatter_max(wr_beg, wr_c, C, -_BIG)

    return asap


def _scatter_max(vals: torch.Tensor, index: torch.Tensor, n: int, empty: int) -> torch.Tensor:
    """(B, n): per column j the max of ``vals[:, i]`` over ``index[i] == j``,
    ``empty`` where no i maps to j."""
    out = torch.full((vals.shape[0], n), empty, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(1, index.expand(vals.shape[0], -1), vals, "amax")


def _div(num: torch.Tensor, den: int) -> torch.Tensor:
    """``num / den`` in float64, rounded as IEEE division (and the host's
    ``measure_period``) round it.  A Python number as divisor would let
    CUDA multiply by its reciprocal instead, one ulp off on some values."""
    num = num.to(torch.float64)
    return num / torch.full_like(num, den)


def device_period(fire: torch.Tensor, dead: torch.Tensor, K: int) -> torch.Tensor:
    """Batched port of :func:`repro_torch.sim.model.measure_period` (and its
    fallback) over ``fire (B, A, ≥K)``: the smallest multiplicity R ≤ 16
    whose last 3 R-strided intervals are one constant D, per actor, after
    a quarter-length drain guard; the period is the worst actor's D/R, the
    host's fallback mean-interval estimate when any actor's tail never
    settled, and ``inf`` on deadlock or on any ``fire < 0`` within the
    first K (a wrapped fire buffer).  float64 (B,)."""
    ts = fire[:, :, :K].to(torch.int64)                    # (B, A, K)
    bad = dead | (ts < 0).any(2).any(1)
    guard = max(2, K // 4)
    L = K - guard
    rate = torch.full(ts.shape[:2], float("inf"), dtype=torch.float64, device=ts.device)
    found = torch.zeros(ts.shape[:2], dtype=torch.bool, device=ts.device)
    checks = 3
    for m in range(1, 17):
        if L < m * checks + 1:
            break
        d = ts[:, :, L - 1] - ts[:, :, L - 1 - m]
        ok = torch.ones_like(found)
        for j in range(2, checks + 1):
            ok = ok & (ts[:, :, L - 1 - (j - 1) * m] - ts[:, :, L - 1 - j * m] == d)
        rate = torch.where(ok & ~found, _div(d, m), rate)
        found = found | ok
    mid = K // 2
    fb = _div(ts[:, :, K - 1] - ts[:, :, mid], max(1, K - 1 - mid))
    period = torch.where(found.all(1), rate.amax(1), fb.amax(1))
    return torch.where(bad, float("inf"), period)
