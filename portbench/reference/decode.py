"""The relaxed decode, frozen: genes → binding, memory, core cost and the
simulator's tables, in plain NumPy over a block of rows.

A copy of the arithmetic of the device explorer's relaxed decode, written
from :mod:`.model` alone:

1. gene layout ξ | C_d | β_A over the original graph's sorted multi-cast
   actors, channels and actors; β_A indexes the actor's allowed cores
   (sorted, of a type the actor runs on), taken modulo their number;
2. Algorithm 2's greedy channel → memory scan in sorted channel order with
   the declared γ, the fallback chains PROD → TILE-PROD → GLOBAL and
   CONS → TILE-CONS → GLOBAL (TILE-* → GLOBAL) and int64 usage;
3. per task the duration (Eq. 11 for reads and writes, τ(a, ϑ) for the
   execution) and the interconnects of its route;
4. the uncontended ASAP pass, the resource lower bound
   P_lb = max(max core load, max link load, 1) and the enlargement
   γ̂ = max(γ, δ + ⌊(F − s_w)/P_lb⌋ + 1) where a channel has both a read
   and a write;
5. the objectives: memory Σ γ̂ φ, core cost Σ K_ϑ over the cores used, and
   the simulator's per-row tables (durations, route bitmasks, compact core
   index, γ̂) for ``sim_period``.

``dtype`` is the float type the objectives are computed in: float64 is
the configuration's precision, float32 the control's.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .model import CHANNEL_DECISIONS, Arch, Graph, arbitration_order, distinct_readers, transformed

__all__ = ["Layout", "RelaxedDecode"]

READ, EXEC, WRITE = 0, 1, 2
BIG = 1 << 40


class Layout:
    """The gene layout of a (graph, architecture) pair."""

    def __init__(self, g: Graph, arch: Arch):
        self.mcast = sorted(g.multicast_actors())
        self.channels = sorted(g.channels)
        self.actors = sorted(g.exec_times)
        self.cores = sorted(arch.cores)
        self.allowed = {a: [p for p in self.cores if arch.cores[p][1] in g.exec_times[a]]
                        for a in self.actors}
        self.n_xi, self.n_cd, self.n_ba = len(self.mcast), len(self.channels), len(self.actors)
        self.n_genes = self.n_xi + self.n_cd + self.n_ba
        self.bounds = np.array([2] * self.n_xi + [len(CHANNEL_DECISIONS)] * self.n_cd
                               + [len(self.allowed[a]) for a in self.actors], np.int64)


class RelaxedDecode:
    """Tables of one ξ pattern and the decode of a block of gene rows."""

    def __init__(self, g: Graph, arch: Arch, xi_bits: Tuple[int, ...], pipelined: bool = True):
        lay = Layout(g, arch)
        self.layout = lay
        gt = transformed(g, dict(zip(lay.mcast, xi_bits)), pipelined)
        order = arbitration_order(gt)
        channels = sorted(gt.channels)
        readers = {c: distinct_readers(gt.channels[c]) for c in channels}
        cores, mems, ics = lay.cores, sorted(arch.memories), sorted(arch.interconnects)
        p_idx = {p: i for i, p in enumerate(cores)}
        q_idx = {q: i for i, q in enumerate(mems)}
        c_idx = {c: i for i, c in enumerate(channels)}
        A, C, P, Q, H = len(order), len(channels), len(cores), len(mems), len(ics)
        R = max(len(readers[c]) for c in channels)
        self.A, self.C, self.P, self.Q, self.H, self.R = A, C, P, Q, H, R

        # Task tables (A, Tmax): kind, channel (-1 none), reader slot (-1 none).
        tasks = {a: [("read", c) for c in gt.in_channels(a)] + [("exec", None)]
                 + [("write", c) for c in gt.out_channels(a)] for a in order}
        Tmax = max(len(v) for v in tasks.values())
        self.Tmax = Tmax
        self.n_tasks = np.array([len(tasks[a]) for a in order], np.int64)
        self.kind = np.full((A, Tmax), EXEC, np.int64)
        self.chan = np.full((A, Tmax), -1, np.int64)
        self.slot = np.full((A, Tmax), -1, np.int64)
        for ai, a in enumerate(order):
            for ti, (k, c) in enumerate(tasks[a]):
                self.kind[ai, ti] = {"read": READ, "exec": EXEC, "write": WRITE}[k]
                if c is not None:
                    self.chan[ai, ti] = c_idx[c]
                if k == "read":
                    self.slot[ai, ti] = readers[c].index(a)
        self.nread = np.array([len(readers[c]) for c in channels], np.int64)
        self.delay = np.array([gt.channels[c].delay for c in channels], np.int64)

        # Genes → actors and channels of the transformed graph.
        gene_pos = {a: i for i, a in enumerate(lay.actors)}
        self.ba_gene_of = np.array([gene_pos[a] for a in order], np.int64)
        jmax = max(len(lay.allowed[a]) for a in order)
        self.allowed_core = np.array([[p_idx[lay.allowed[a][j % len(lay.allowed[a])]]
                                       for j in range(jmax)] for a in order], np.int64)
        self.n_allowed = np.array([len(lay.allowed[a]) for a in order], np.int64)
        cpos = {c: i for i, c in enumerate(lay.channels)}
        # An MRB takes the decision gene of its first (smallest) member.
        self.cd_gene_of = np.array([cpos[c] if c in cpos else cpos[c[4:-1].split(",")[0]]
                                    for c in channels], np.int64)

        # Architecture tables.
        self.exec_time = np.array([[gt.exec_times[a].get(arch.cores[p][1], 0) for p in cores]
                                   for a in order], np.int64)
        self.core_cost = np.array([arch.core_costs.get(arch.cores[p][1], 1.0) for p in cores],
                                  np.float64)
        self.mem_cap = np.array([arch.memories[q][1] for q in mems], np.int64)
        self.mem_sel = np.array([[q_idx[arch.memory_for(d, p)] for p in cores]
                                 for d in CHANNEL_DECISIONS], np.int64)
        self.route_occ = np.zeros((P, Q, H), np.int64)
        h_idx = {h: i for i, h in enumerate(ics)}
        for p in cores:
            for q in mems:
                for h in arch.route_interconnects(p, q):
                    self.route_occ[p_idx[p], q_idx[q], h_idx[h]] = 1
        self.phi = np.array([gt.channels[c].token_bytes for c in channels], np.int64)
        self.tau = np.array([[[arch.comm_time(int(self.phi[ci]), p, q) for q in mems]
                              for p in cores] for ci in range(C)], np.int64)
        self.gamma0 = np.array([gt.channels[c].capacity for c in channels], np.int64)
        a_idx = {a: i for i, a in enumerate(order)}
        self.prod_a = np.array([a_idx[gt.channels[c].src] for c in channels], np.int64)
        self.cons0_a = np.array([a_idx[gt.channels[c].dsts[0]] for c in channels], np.int64)

        # Reads and writes as (actor, task, channel) triples for the ASAP pass,
        # and the zero-delay inputs that chain actor windows within an iteration.
        valid = np.arange(Tmax)[None, :] < self.n_tasks[:, None]
        self.rd = np.nonzero((self.kind == READ) & valid)
        self.wr = np.nonzero((self.kind == WRITE) & valid)
        self.rd_c = self.chan[self.rd]
        self.wr_c = self.chan[self.wr]
        writer = np.full(C, -1)
        writer[self.wr_c] = self.wr[0]
        self.chain = []
        for k in range(A):
            cs = sorted({int(self.chan[k, t]) for t in range(self.n_tasks[k])
                         if self.kind[k, t] == READ and self.delay[self.chan[k, t]] == 0
                         and 0 <= writer[self.chan[k, t]] < k})
            if cs:
                self.chain.append((k, writer[cs], np.array(cs)))
        self.comm = (self.chan >= 0) & valid
        self.exec_slot = valid & (self.chan < 0)
        self.cidx = np.maximum(self.chan, 0)

    def decode(self, genes: np.ndarray, dtype=np.float64) -> Dict[str, np.ndarray]:
        """``genes (B, G)`` → ``memory``, ``core_cost`` (B,) in ``dtype``,
        ``period`` (P_lb) and the simulator tables ``dur``, ``route`` (B, A,
        Tmax), ``core`` (B, A) and ``gamma`` (B, C), int64."""
        lay = self.layout
        genes = np.asarray(genes, np.int64)
        B, A, C = genes.shape[0], self.A, self.C
        rows = np.arange(B)[:, None]
        cd = genes[:, lay.n_xi:lay.n_xi + lay.n_cd]
        ba = genes[:, lay.n_xi + lay.n_cd:]
        j = np.mod(ba[:, self.ba_gene_of], self.n_allowed)
        core = self.allowed_core[np.arange(A)[None, :], j]                 # (B, A)
        d = cd[:, self.cd_gene_of]                                         # (B, C)
        p_rel = np.where(d < 2, core[:, self.prod_a], core[:, self.cons0_a])
        first_q = self.mem_sel[d, p_rel]
        second_q = np.where((d == 0) | (d == 2), self.mem_sel[np.clip(d + 1, 0, 4), p_rel],
                            self.mem_sel[4, p_rel])
        third_q = self.mem_sel[4, p_rel]
        need = self.gamma0 * self.phi
        room1 = self.mem_cap[first_q] - need
        room2 = self.mem_cap[second_q] - need
        usage = np.zeros((B, self.Q), np.int64)
        q_of = np.zeros((B, C), np.int64)
        for c in range(C):
            q1, q2 = first_q[:, c], second_q[:, c]
            u1, u2 = usage[rows[:, 0], q1], usage[rows[:, 0], q2]
            q = np.where(u1 <= room1[:, c], q1, np.where(u2 <= room2[:, c], q2, third_q[:, c]))
            usage[rows[:, 0], q] += need[c]
            q_of[:, c] = q

        q_slot = q_of[:, self.cidx]                                        # (B, A, Tmax)
        dur_comm = self.tau[self.cidx[None], core[:, :, None], q_slot]
        e_a = self.exec_time[np.arange(A)[None, :], core]
        dur = np.where(self.comm[None], dur_comm, np.where(self.exec_slot[None], e_a[:, :, None], 0))

        rfin, wstart = self._asap(dur)
        window = dur.sum(2)
        core_load = np.zeros((B, self.P), np.int64)
        np.add.at(core_load, (np.repeat(np.arange(B), A), core.ravel()), window.ravel())
        occ = self.route_occ[core[:, :, None], q_slot] * self.comm[None, :, :, None]
        link_load = (dur[..., None] * occ).sum((1, 2))
        p_lb = np.maximum(np.maximum(core_load.max(1), link_load.max(1)), 1)[:, None]
        seen = (rfin > -BIG) & (wstart > -BIG)
        gamma_hat = np.where(seen, np.maximum(self.gamma0, self.delay + np.floor_divide(
            rfin - wstart, p_lb) + 1), self.gamma0)
        gamma_hat = np.maximum(gamma_hat, 1)

        used = np.zeros((B, self.P), bool)
        used[np.repeat(np.arange(B), A), core.ravel()] = True
        bits = np.array([1 << h for h in range(self.H)], np.int64)
        route = (occ * bits).sum(-1)
        # Compact core index: cores numbered by their first actor in actor order.
        first = (core[:, :, None] == core[:, None, :]).argmax(2)
        compact = np.cumsum(first == np.arange(A)[None, :], 1) - 1
        return dict(
            memory=(gamma_hat * self.phi).sum(1).astype(dtype),
            core_cost=(used * self.core_cost.astype(dtype)).sum(1, dtype=dtype),
            period=p_lb[:, 0].astype(dtype),
            dur=dur, route=route, core=np.take_along_axis(compact, first, 1), gamma=gamma_hat,
        )

    def _asap(self, dur: np.ndarray):
        """Latest read end and latest write start per channel in one
        uncontended iteration, ``-2**40`` where there is none."""
        B, C = dur.shape[0], self.C
        ends = np.cumsum(dur, 2)
        wr_end = ends[:, self.wr[0], self.wr[1]]
        wr_beg = wr_end - dur[:, self.wr[0], self.wr[1]]
        rd_end = ends[:, self.rd[0], self.rd[1]]
        if self.chain:
            wfin = _scatter_max(wr_end, self.wr_c, C, 0)
            ws = np.zeros(dur.shape[:2], np.int64)
            for k, w, c in self.chain:
                ws[:, k] = np.maximum((ws[:, w] + wfin[:, c]).max(1), 0)
            wr_beg = wr_beg + ws[:, self.wr[0]]
            rd_end = rd_end + ws[:, self.rd[0]]
        return _scatter_max(rd_end, self.rd_c, C, -BIG), _scatter_max(wr_beg, self.wr_c, C, -BIG)


def _scatter_max(vals: np.ndarray, index: np.ndarray, n: int, empty: int) -> np.ndarray:
    out = np.full((vals.shape[0], n), empty, np.int64)
    for i, j in enumerate(index):
        out[:, j] = np.maximum(out[:, j], vals[:, i])
    return out

