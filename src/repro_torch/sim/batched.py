"""Batched self-timed simulator: lowering, the plain batched torch program,
and the wrapper that the evaluation engine calls.

Executes the same dynamical system as :mod:`repro_torch.sim.events` (the
normative spec lives in :mod:`repro_torch.sim.model`) for a batch of
phenotypes that share one (transformed graph, architecture) pair:

* **Lowering.**  :func:`_lower_batch` builds the segment-packed dense
  tables of the JAX package's lowering (graph-derived ``static`` tables and
  binding-derived ``batched`` ones); :func:`compact_tables` turns them into
  the compact form the simulator runs on — per task a kind, a channel index
  and a reader slot; per phenotype and task a duration and a route bitmask
  over the interconnects; per phenotype and actor a compact core index;
  per phenotype the channel capacities γ; :func:`pack_tables` packs the
  graph-derived part for the CUDA kernel (tasks by actor offsets, gate
  masks as bit words).
* **The plain program.**  :func:`simulate_plain` runs the phased-round
  loop of the model with the batch axis written out as torch tensor ops.
  It is the plain version of the CUDA kernel
  (:mod:`repro_torch.kernels.sim_step`): same inputs, same outputs, and
  bit-identical results.  Finished batch elements are frozen, exactly as
  a vmapped ``while_loop`` freezes them.
* **The wrapper.**  :func:`batch_simulate` applies the events backend's
  per-element horizon-doubling policy (so periods are backend-identical),
  buckets the fire buffer to a power of two, and keeps the int32 guard:
  a phenotype whose predicted or measured horizon could overflow int32 is
  simulated by the exact event-driven backend instead, and counted in
  :data:`int32_fallbacks`.  The guard is part of the semantics, not a
  device fallback: any failure of the device path raises.

``backend="cuda"`` runs the kernel (on a CPU tensor its wrapper uses this
module's plain program); ``backend="torch"`` runs the plain program on the
chosen device.

Telemetry carries the JAX package's names: a ``sim.compile`` span per
lowering of a batch into device tables and a ``sim.execute`` span per
simulator call (both with ``backend``), the ``sim.cache_builds`` counter,
``sim.int32_fallbacks`` (``phase`` ``predicted`` or ``wrapped``) and the
``sim.horizon_double`` event.  The port compiles no program per structure:
it lowers the tables on every call and keeps no cache of them, so
``sim.compile`` times that lowering and ``sim.cache_builds`` counts every
table build.  ``sim.execute`` ends after the results are copied to the
host, so it holds the device's work.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import obs
from ..core.architecture import ArchitectureGraph
from ..core.graph import ApplicationGraph
from ..core.schedule import Schedule
from ..device import resolve_device
from .events import SimResult
from .model import (
    EXEC,
    READ,
    WRITE,
    SimConfig,
    SimProgram,
    fallback_period,
    lower_phenotype,
    measure_period,
    predict_horizon,
)

__all__ = [
    "batch_simulate",
    "batch_simulate_periods",
    "compact_tables",
    "pack_tables",
    "simulate_plain",
    "SimTables",
    "INT32_SAFE_HORIZON",
    "BATCH_BACKENDS",
]

I32_INF = 2**31 - 1
# Above this predicted event-time horizon int32 state could overflow; the
# wrapper routes the phenotype to the event-driven backend (Python ints are
# exact).
INT32_SAFE_HORIZON = 2**30

BATCH_BACKENDS = ("cuda", "torch")

# Phenotypes routed to the event-driven backend by the int32 guard.
int32_fallbacks = 0

# Rounds of the plain program between host checks of "every element
# finished"; finished elements are frozen, so extra rounds change nothing.
_CHECK_EVERY = 32


# --------------------------------------------------------------- lowering
def _lower_batch(progs: Sequence[SimProgram]):
    """Static structure arrays (graph-derived, shared) + batched arrays
    (binding-derived, per phenotype), in segment-packed dense layout: every
    per-task table is padded to ``Tmax`` tasks per actor."""
    p0 = progs[0]
    actors = p0.actors
    channels = p0.channels
    ics = sorted(p0.arch.interconnects)
    c_idx = {c: i for i, c in enumerate(channels)}
    h_idx = {h: i for i, h in enumerate(ics)}
    A, C, H = len(actors), len(channels), len(ics)
    R = max((len(p0.readers[c]) for c in channels), default=1)
    Tmax = max(len(p0.tasks[a]) for a in actors)

    n_tasks = np.array([len(p0.tasks[a]) for a in actors], np.int32)
    # Graph-derived per-task fields; columns are
    # [is_read, is_write, chan one-hot (C), reader-slot one-hot (R)].
    ts_tab = np.zeros((A, Tmax, 2 + C + R), np.int32)
    for ai, a in enumerate(actors):
        for ti, t in enumerate(p0.tasks[a]):
            ts_tab[ai, ti, 0] = t.kind == READ
            ts_tab[ai, ti, 1] = t.kind == WRITE
            if t.channel is not None:
                ts_tab[ai, ti, 2 + c_idx[t.channel]] = 1
            if t.reader_slot >= 0:
                ts_tab[ai, ti, 2 + C + t.reader_slot] = 1

    reader_mask = np.zeros((C, R), bool)
    delay = np.zeros(C, np.int32)
    for c in channels:
        reader_mask[c_idx[c], : len(p0.readers[c])] = True
        delay[c_idx[c]] = p0.delay[c]
    # Start-of-firing gates: which (channel, slot) views actor a reads, and
    # which channels it writes (bounded-buffer enabling rule).
    inmask = np.zeros((A, C, R), bool)
    outmask = np.zeros((A, C), bool)
    for ai, a in enumerate(actors):
        for t in p0.tasks[a]:
            if t.kind == READ:
                inmask[ai, c_idx[t.channel], t.reader_slot] = True
            elif t.kind == WRITE:
                outmask[ai, c_idx[t.channel]] = True

    B = len(progs)
    # Binding-derived per-task fields: [duration, route occupancy (H)].
    # Cores are remapped per element to a compact 0..A-1 index space (an
    # element binds at most A distinct cores), so per-round core
    # arbitration stays A-wide instead of |cores|-wide.
    tb_tab = np.zeros((B, A, Tmax, 1 + H), np.int32)
    core_oh = np.zeros((B, A, A), bool)
    gamma = np.ones((B, C), np.int32)
    for b, pr in enumerate(progs):
        cmap: Dict[str, int] = {}
        for ai, a in enumerate(actors):
            core = pr.core_of[a]
            ci = cmap.setdefault(core, len(cmap))
            core_oh[b, ai, ci] = True
            for ti, t in enumerate(pr.tasks[a]):
                tb_tab[b, ai, ti, 0] = t.duration
                for h in t.route:
                    tb_tab[b, ai, ti, 1 + h_idx[h]] = 1
        for c in channels:
            gamma[b, c_idx[c]] = pr.capacity[c]

    static = dict(
        A=A, C=C, P=A, H=H, R=R, Tmax=Tmax,
        n_tasks=n_tasks, ts_tab=ts_tab,
        reader_mask=reader_mask, delay=delay, inmask=inmask, outmask=outmask,
    )
    batched = dict(tb=tb_tab, core_oh=core_oh, gamma=gamma)
    return static, batched


def lower_structure(prog: SimProgram):
    """:func:`_lower_batch` for a single program: ``(static, batched)`` with
    a leading batch axis of 1 on the batched arrays."""
    return _lower_batch([prog])


@dataclass
class SimTables:
    """The compact lowering of a batch, as tensors on one device.

    Graph-derived (shared): ``kind``/``chan``/``slot`` ``(A, Tmax)`` int8 /
    int16 / int8 (``chan``/``slot`` −1 for none), ``n_tasks (A,)``,
    ``nread (C,)`` (readers per channel; slots ``0..nread-1`` are live)
    and ``delay (C,)`` int32.  Binding-derived (batched): ``dur (B, A,
    Tmax)`` int32, ``route (B, A, Tmax)`` int32 holding the bitmask of
    occupied interconnects, ``core (B, A)`` compact core index and
    ``gamma (B, C)`` capacities, int32.  ``pack`` is
    :func:`pack_tables` of the graph-derived tables, int32 on the same
    device, which the CUDA kernel runs on (set by :func:`compact_tables`;
    None on tables built by hand, which only the plain program takes).
    """

    kind: torch.Tensor
    chan: torch.Tensor
    slot: torch.Tensor
    n_tasks: torch.Tensor
    nread: torch.Tensor
    delay: torch.Tensor
    dur: torch.Tensor
    route: torch.Tensor
    core: torch.Tensor
    gamma: torch.Tensor
    R: int
    H: int
    pack: Optional[torch.Tensor] = None

    @property
    def B(self) -> int:
        return self.dur.shape[0]

    @property
    def A(self) -> int:
        return self.kind.shape[0]

    @property
    def C(self) -> int:
        return self.nread.shape[0]

    @property
    def Tmax(self) -> int:
        return self.kind.shape[1]

    @property
    def device(self) -> torch.device:
        return self.dur.device

    def total_tasks(self) -> int:
        if self.pack is not None:  # the pack's length, with no device sync
            return packed_tasks(self.pack.numel(), self.A, self.C, self.R)
        return int(self.n_tasks.sum())

    def max_steps(self, K: int) -> int:
        """The round bound of the loop: every round applies ≥ 1
        micro-transition, advances time past a timed completion, or
        terminates; a window is ≤ 1 + 2·n_tasks transitions and every time
        advance consumes ≥ 1 of the ≤ K·T timed completions, so
        K·(3T + A + 2) + 8 never cuts a run short."""
        return K * (3 * self.total_tasks() + self.A + 2) + 8

    def nbytes(self) -> int:
        return sum(
            getattr(self, f).numel() * getattr(self, f).element_size()
            for f in ("kind", "chan", "slot", "n_tasks", "nread", "delay",
                      "dur", "route", "core", "gamma")
        )

    def select(self, index: Sequence[int]) -> "SimTables":
        """The phenotypes at ``index`` (repeats allowed), as a new batch."""
        idx = torch.as_tensor(list(index), dtype=torch.long, device=self.device)
        pick = lambda x: x.index_select(0, idx).contiguous()
        return SimTables(
            self.kind, self.chan, self.slot, self.n_tasks, self.nread,
            self.delay, pick(self.dur), pick(self.route), pick(self.core),
            pick(self.gamma), self.R, self.H, self.pack,
        )


def _words(bits: np.ndarray) -> np.ndarray:
    """(A, n) bool → (A, ⌈n/32⌉) uint32, bit i of word w = column 32w + i."""
    A, n = bits.shape
    W = (n + 31) // 32
    padded = np.zeros((A, W * 32), np.uint64)
    padded[:, :n] = bits
    shifts = np.arange(32, dtype=np.uint64)
    return (padded.reshape(A, W, 32) << shifts).sum(-1).astype(np.uint32)


def packed_tasks(numel: int, A: int, C: int, R: int) -> int:
    """The task count T of a :func:`pack_tables` result of ``numel`` words."""
    return numel - (A + 1) - A * ((C * R + 31) // 32 + (C + 31) // 32)


def pack_tables(kind, chan, slot, n_tasks, inmask, outmask) -> np.ndarray:
    """The graph-derived tables packed for the CUDA kernel, int32 words:

    * ``off (A + 1)``: actor a's tasks are ``off[a] .. off[a + 1] - 1``;
    * ``desc (T)``: per task ``kind | (slot & 0xff) << 8 | chan << 16``,
      actor by actor (not padded to ``Tmax``);
    * ``gin (A, ⌈C·R/32⌉)``: ``inmask (A, C, R)``, the views ``c·R + s``
      actor a reads, bit ``v % 32`` of word ``v // 32``;
    * ``gout (A, ⌈C/32⌉)``: ``outmask (A, C)``, the channels it writes.

    (The masks are :func:`_lower_batch`'s start-of-firing gates.)  Raises
    ``ValueError`` unless every channel has at most one writer and every
    view at most one reader, which the kernel's MRB arithmetic relies on
    (the model's rule; see ``csrc/sim_step.cu``).
    """
    kind, chan, slot = (np.asarray(x).astype(np.int64) for x in (kind, chan, slot))
    n_tasks = np.asarray(n_tasks).astype(np.int64)
    A, Tmax = kind.shape
    inmask = np.asarray(inmask).reshape(A, -1)
    if (inmask.sum(0) > 1).any() or (np.asarray(outmask).sum(0) > 1).any():
        raise ValueError("pack_tables: a channel with two writers or a view with two readers")
    off = np.zeros(A + 1, np.int64)
    off[1:] = np.cumsum(n_tasks)
    live = np.arange(Tmax)[None, :] < n_tasks[:, None]
    desc = ((kind & 0xFF) | ((slot & 0xFF) << 8) | ((chan & 0xFFFF) << 16))[live]
    words = np.concatenate([
        off, desc, _words(inmask).ravel().astype(np.int64),
        _words(np.asarray(outmask)).ravel().astype(np.int64),
    ])
    return words.astype(np.uint32).view(np.int32)


def compact_tables(static, batched, device) -> SimTables:
    """The compact lowering of :func:`_lower_batch`'s dense tables, as
    contiguous tensors on ``device``."""
    A, C, R, H = static["A"], static["C"], static["R"], static["H"]
    if H > 32:
        raise ValueError(f"route bitmask holds 32 interconnects, got H={H}")
    if C >= 2**15 or R >= 2**7:
        raise ValueError(f"compact task table overflow: C={C}, R={R}")
    ts = static["ts_tab"]
    kind = np.where(ts[..., 0] > 0, READ, np.where(ts[..., 1] > 0, WRITE, EXEC))
    c_oh = ts[..., 2:2 + C] > 0
    s_oh = ts[..., 2 + C:] > 0
    chan = np.where(c_oh.any(-1), c_oh.argmax(-1), -1)
    slot = np.where(s_oh.any(-1), s_oh.argmax(-1), -1)
    tb = batched["tb"]
    bits = np.left_shift(np.uint32(1), np.arange(H, dtype=np.uint32))
    route = (tb[..., 1:].astype(np.uint32) * bits).sum(-1, dtype=np.uint32)
    core = batched["core_oh"].argmax(-1)

    def t(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x).astype(dtype)).to(device)

    return SimTables(
        kind=t(kind, np.int8),
        chan=t(chan, np.int16),
        slot=t(slot, np.int8),
        n_tasks=t(static["n_tasks"], np.int32),
        nread=t(static["reader_mask"].sum(1), np.int32),
        delay=t(static["delay"], np.int32),
        dur=t(tb[..., 0], np.int32),
        route=t(route.view(np.int32), np.int32),
        core=t(core, np.int32),
        gamma=t(batched["gamma"], np.int32),
        R=R,
        H=H,
        pack=t(pack_tables(kind, chan, slot, static["n_tasks"], static["inmask"],
                           static["outmask"]), np.int32),
    )


# --------------------------------------------------------------- simulator
def simulate_plain(
    tab: SimTables,
    K: int,
    k_max: int,
    ports: Optional[int],
    stats: Optional[dict] = None,
):
    """The phased-round simulator as batched torch ops on ``tab``'s device.

    Returns ``(fire (B, A, k_max) int32, dead (B,) bool, horizon (B,)
    int32)``.  Every integer sum is taken in int32 and ``t + duration``
    wraps as int32 arithmetic does, so a run that overflows shows it in its
    outputs (negative horizon or fire times) for the wrapper's post-check.
    A ``stats`` dict receives ``rounds``, the rounds each element ran.
    """
    dev = tab.device
    i32 = torch.int32
    B, A, C, R, H, Tmax = tab.B, tab.A, tab.C, tab.R, tab.H, tab.Tmax
    NEG, BIG = -1, A
    aidx = torch.arange(A, dtype=i32, device=dev)
    a_long = aidx.long()[None, :]
    k_iota = torch.arange(k_max, dtype=i32, device=dev)
    h_iota = torch.arange(H, dtype=i32, device=dev)
    c_iota = torch.arange(C, device=dev)
    lower_tri = aidx[:, None] > aidx[None, :]          # j strictly precedes i
    rmask = torch.arange(R, device=dev)[None, :] < tab.nread[:, None]  # (C,R)
    gamma = tab.gamma                                  # (B,C)
    n_tasks = tab.n_tasks[None, :]                     # (1,A)
    core = tab.core.long()                             # (B,A)
    core_oh = core[:, :, None] == a_long[:, None, :]   # (B,A,P)
    kind_tab = tab.kind.long()
    chan_tab = tab.chan.long()
    slot_tab = tab.slot.long()
    # Start-of-firing gates, per task: the (channel, slot) view a read
    # needs a token from, and the channel a write needs a place in.
    t_live = torch.arange(Tmax, device=dev)[None, :] < tab.n_tasks[:, None]
    read_task = t_live & (kind_tab == READ)
    write_task = t_live & (kind_tab == WRITE)
    cs_task = (chan_tab.clamp(min=0) * R + slot_tab.clamp(min=0))
    ch_task = chan_tab.clamp(min=0)

    def cs_onehot(ch, sl):
        # (B,A,C*R): the (channel, slot) view each actor's task touches.
        ok = (ch >= 0) & (sl >= 0)
        return ok[:, :, None] & (
            (ch * R + sl)[:, :, None] == torch.arange(C * R, device=dev)
        )

    def ch_onehot(ch):
        return ch[:, :, None] == c_iota                # (B,A,C); −1 ⇒ none

    def avail_of(omega, rho):
        a = torch.remainder(omega[:, :, None] - rho - 1, gamma[:, :, None]) + 1
        return torch.where(rmask[None] & (rho != NEG), a, 0)   # (B,C,R)

    def read_adv(ch, sl, gc, avail, rho):
        # Each reader's post-read ρ view (−1 when its window empties).
        m = cs_onehot(ch, sl)
        avail_t = torch.sum(
            torch.where(m, avail.reshape(B, 1, C * R), 0), dim=2, dtype=i32
        )
        rho_cs = torch.sum(
            torch.where(m, rho.reshape(B, 1, C * R), 0), dim=2, dtype=i32
        )
        return avail_t, torch.where(
            avail_t == 1, NEG, torch.remainder(rho_cs + 1, gc)
        )

    def apply_reads(who, ch, sl, rho_adv, rho):
        m = who[:, :, None] & cs_onehot(ch, sl)        # (B,A,C*R)
        new = torch.sum(torch.where(m, rho_adv[:, :, None], 0), dim=1, dtype=i32)
        return torch.where(m.any(1), new, rho.reshape(B, C * R)).reshape(B, C, R)

    def apply_writes(who, ch, omega, rho):
        written = (who[:, :, None] & ch_onehot(ch)).any(1)     # (B,C)
        rho = torch.where(
            written[:, :, None] & rmask[None] & (rho == NEG),
            omega[:, :, None], rho,
        )
        return torch.where(written, torch.remainder(omega + 1, gamma), omega), rho

    def finish_windows(done_now, cur, in_w, iters, owner):
        wdone = done_now & (cur + 1 == n_tasks)
        cur = torch.where(done_now, cur + 1, cur)
        in_w = in_w & ~wdone
        iters = iters + wdone.to(i32)
        released = (wdone[:, :, None] & core_oh).any(1)        # (B,P)
        return cur, in_w, iters, torch.where(released, NEG, owner)

    def descriptor(cur):
        # Current-task fields of every actor; cur == n_tasks between
        # windows yields don't-care fields, gated out by in_w.
        live = cur < n_tasks
        cl = cur.clamp(max=Tmax - 1).long()
        kind = kind_tab[a_long, cl]
        ch = torch.where(live, chan_tab[a_long, cl], -1)
        sl = torch.where(live, slot_tab[a_long, cl], -1)
        dur = torch.where(live, tab.dur.gather(2, cl[:, :, None])[..., 0], 0)
        route = torch.where(live, tab.route.gather(2, cl[:, :, None])[..., 0], 0)
        gc = torch.where(ch >= 0, gamma.gather(1, ch.clamp(min=0)), 1)
        return (live & (kind == READ), live & (kind == WRITE), ch, sl,
                dur, route, gc)

    def route_bits(route):
        return ((route[:, :, None] >> h_iota) & 1) != 0       # (B,A,H)

    def round_fn(s):
        t, omega, rho, active, owner, ic_busy = (
            s["t"], s["omega"], s["rho"], s["active"], s["owner"], s["ic_busy"])
        in_w, running, busy, cur, iters, fire = (
            s["in_w"], s["running"], s["busy"], s["cur"], s["iters"], s["fire"])

        # ---- completion phase: effects of the tasks that were running,
        # from the descriptor fields recorded when they started.  Reads
        # apply before writes; every due task releases its channel port.
        due = running & (busy <= t[:, None])
        running = running & ~due
        active = active - torch.sum(
            due[:, :, None] & ch_onehot(s["run_ch"]), dim=1, dtype=i32
        )
        _, rho_adv = read_adv(
            s["run_ch"], s["run_slot"], s["run_gc"], avail_of(omega, rho), rho
        )
        rho = apply_reads(due & s["run_read"], s["run_ch"], s["run_slot"], rho_adv, rho)
        omega, rho = apply_writes(due & s["run_write"], s["run_ch"], omega, rho)
        cur, in_w, iters, owner = finish_windows(due, cur, in_w, iters, owner)

        # ---- start phase: window starts first (arbitrated per core),
        # then task-start candidates with the winners' windows open.
        avail = avail_of(omega, rho)
        free = gamma - torch.where(rmask[None], avail, 0).amax(dim=2)
        owner_of = owner.gather(1, core)
        av_task = avail.reshape(B, C * R)[:, cs_task]          # (B,A,Tmax)
        in_bad = (read_task[None] & (av_task < 1)).any(2)
        out_bad = (write_task[None] & (free[:, ch_task] < 1)).any(2)
        fire_cand = ~in_w & (iters < K) & (owner_of == NEG) & ~in_bad & ~out_bad
        cand_idx = torch.where(fire_cand[:, :, None] & core_oh, aidx[None, :, None], BIG)
        min_idx = cand_idx.amin(dim=1)                         # (B,P)
        fire_win = fire_cand & (min_idx.gather(1, core) == aidx)
        owner = torch.where(min_idx < BIG, min_idx, owner)
        in_w = in_w | fire_win
        fire = torch.where(
            fire_win[:, :, None] & (k_iota == iters[:, :, None]), t[:, None, None], fire
        )
        cur = torch.where(fire_win, 0, cur)

        is_read, is_write, ch, sl, dur, route, gc = descriptor(cur)
        timed = dur > 0
        rbits = route_bits(route)
        avail_t, rho_adv = read_adv(ch, sl, gc, avail, rho)
        free_c = torch.where(ch >= 0, free.gather(1, ch.clamp(min=0)), 0)
        cand = (
            (in_w & ~running)
            & (~is_read | (avail_t >= 1))
            & (~is_write | (free_c >= 1))
            & ~(rbits & (ic_busy[:, None, :] > t[:, None, None])).any(2)
        )
        if ports is None:
            surv = cand
        else:
            # Port slots go to the highest-ranked timed candidates.
            chan_cand = cand & timed & (ch >= 0)
            same_c = (ch[:, :, None] == ch[:, None, :]) & (ch[:, :, None] >= 0)
            rank = torch.sum(
                lower_tri & chan_cand[:, None, :] & same_c, dim=2, dtype=i32
            )
            active_c = torch.where(ch >= 0, active.gather(1, ch.clamp(min=0)), 0)
            surv = cand & (~chan_cand | (active_c + rank < ports))
        # A start is deferred (next round, same t) when a higher-priority
        # surviving timed candidate shares an interconnect.
        share = (route[:, :, None] & route[:, None, :]) != 0
        blocked = (lower_tri & (surv & timed)[:, None, :] & share).any(2)
        win = surv & ~blocked

        # ---- apply: zero-duration effects (reads before writes), then
        # timed occupations — all disjoint.
        zd = win & ~timed
        rho = apply_reads(zd & is_read, ch, sl, rho_adv, rho)
        omega, rho = apply_writes(zd & is_write, ch, omega, rho)
        cur, in_w, iters, owner = finish_windows(zd, cur, in_w, iters, owner)

        tw = win & timed
        running = running | tw
        end = t[:, None] + dur                                  # wraps as int32
        busy = torch.where(tw, end, busy)
        ic_claim = tw[:, :, None] & rbits
        ic_busy = torch.where(
            ic_claim.any(1),
            torch.sum(torch.where(ic_claim, end[:, :, None], 0), dim=1, dtype=i32),
            ic_busy,
        )
        active = active + torch.sum(tw[:, :, None] & ch_onehot(ch), dim=1, dtype=i32)

        progressed = (due | fire_win | win).any(1)
        # Early quiescence: a round whose winners were all timed and whose
        # candidates all won cannot have enabled anything new at this
        # instant, so time can advance immediately.
        early = ~zd.any(1) & ~(cand & ~win).any(1)
        settled = ~progressed | early
        done = settled & (iters >= K).all(1)
        dead = settled & ~done & ~running.any(1)
        next_t = torch.where(running, busy, I32_INF).amin(1)
        t = torch.where(settled & ~done & ~dead, next_t, t)
        return dict(
            t=t, omega=omega, rho=rho, active=active, owner=owner,
            ic_busy=ic_busy, in_w=in_w, running=running, busy=busy, cur=cur,
            iters=iters, fire=fire,
            run_read=torch.where(tw, is_read, s["run_read"]),
            run_write=torch.where(tw, is_write, s["run_write"]),
            run_ch=torch.where(tw, ch, s["run_ch"]),
            run_slot=torch.where(tw, sl, s["run_slot"]),
            run_gc=torch.where(tw, gc, s["run_gc"]),
            done=done, dead=dead,
        )

    zeros_ba = torch.zeros((B, A), dtype=i32, device=dev)
    false_ba = torch.zeros((B, A), dtype=torch.bool, device=dev)
    delay = tab.delay.to(i32)
    state = dict(
        t=torch.zeros(B, dtype=i32, device=dev),
        omega=torch.remainder(delay[None, :], gamma),
        rho=torch.where(rmask & (delay[:, None] > 0), 0, -1).to(i32)
        .expand(B, C, R).clone(),
        active=torch.zeros((B, C), dtype=i32, device=dev),
        owner=torch.full((B, A), -1, dtype=i32, device=dev),
        ic_busy=torch.zeros((B, H), dtype=i32, device=dev),
        in_w=false_ba, running=false_ba, busy=zeros_ba, cur=zeros_ba,
        iters=zeros_ba,
        fire=torch.full((B, A, k_max), -1, dtype=i32, device=dev),
        run_read=false_ba, run_write=false_ba,
        run_ch=torch.full((B, A), -1, dtype=torch.long, device=dev),
        run_slot=torch.full((B, A), -1, dtype=torch.long, device=dev),
        run_gc=torch.ones((B, A), dtype=i32, device=dev),
        done=torch.zeros(B, dtype=torch.bool, device=dev),
        dead=torch.zeros(B, dtype=torch.bool, device=dev),
    )
    rounds = torch.zeros(B, dtype=i32, device=dev)
    max_steps = tab.max_steps(K)
    for step in range(max_steps):
        if step % _CHECK_EVERY == 0 and bool((state["done"] | state["dead"]).all()):
            break
        live = ~(state["done"] | state["dead"])
        rounds += live.to(i32)
        new = round_fn(state)
        for k, v in new.items():
            m = live.view((B,) + (1,) * (v.dim() - 1))
            state[k] = torch.where(m, v, state[k])
    if stats is not None:
        stats["rounds"] = rounds
    return state["fire"], state["dead"], state["t"]


# ---------------------------------------------------------------- wrappers
def _bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def _run_batch(
    progs: Sequence[SimProgram],
    total_iters: int,
    cfg: SimConfig,
    backend: str,
    device: torch.device,
):
    # The fire buffer is sized to the power-of-two bucket of the requested
    # firing count, not max_iterations.
    k_max = min(_bucket(max(2, total_iters)), cfg.max_iterations)
    with obs.span("sim.compile", backend=backend, k_max=int(k_max)):
        static, batched = _lower_batch(progs)
        tab = compact_tables(static, batched, device)
    obs.counter_add("sim.cache_builds", backend=backend)
    with obs.span("sim.execute", backend=backend, B=len(progs), k_max=int(k_max)):
        if backend == "cuda":
            from ..kernels.sim_step import sim_step

            fire, dead, horizon = sim_step(tab, total_iters, k_max, cfg.mrb_ports)
        else:
            fire, dead, horizon = simulate_plain(tab, total_iters, k_max, cfg.mrb_ports)
        out = fire.cpu().numpy(), dead.cpu().numpy(), horizon.cpu().numpy()
    return out


def batch_simulate(
    g: ApplicationGraph,
    arch: ArchitectureGraph,
    schedules: Sequence[Schedule],
    config: Optional[SimConfig] = None,
    *,
    backend: str = "cuda",
    device="cuda",
) -> List[SimResult]:
    """Simulate a batch of phenotypes sharing one (graph, arch) pair.

    Returns one :class:`~repro_torch.sim.events.SimResult` per schedule (no
    traces).  Each element follows the same horizon-doubling policy as
    ``events.simulate`` — it is measured at the first horizon in the
    sequence ``iterations, 2·iterations, …`` where its tail is periodic —
    so results are backend-identical.  ``backend`` selects the CUDA kernel
    (``"cuda"``) or the plain batched torch program (``"torch"``);
    ``device`` is where either runs (``"cuda"`` unless the caller asks for
    ``"cpu"``).
    """
    global int32_fallbacks
    cfg = config or SimConfig()
    if backend not in BATCH_BACKENDS:
        raise ValueError(f"backend must be one of {BATCH_BACKENDS}")
    dev = resolve_device(device)
    if not schedules:
        return []
    progs = [lower_phenotype(g, arch, s) for s in schedules]
    out: List[Optional[SimResult]] = [None] * len(progs)

    for i, pr in enumerate(progs):
        if predict_horizon(pr, cfg) > INT32_SAFE_HORIZON:
            from .events import simulate as ev_simulate

            int32_fallbacks += 1
            obs.counter_add("sim.int32_fallbacks", phase="predicted")
            out[i] = ev_simulate(g, arch, pr.schedule, _no_trace(cfg))

    remaining = [i for i, r in enumerate(out) if r is None]
    iters = max(2, cfg.iterations)
    while remaining:
        sub = [progs[i] for i in remaining]
        fire, dead, horizon = _run_batch(sub, iters, cfg, backend, dev)
        still: List[int] = []
        at_cap = iters >= cfg.max_iterations
        for j, i in enumerate(remaining):
            # Post-check the int32 guard: the self-timed horizon can exceed
            # the analytic-period prediction (contention slows execution),
            # so a wrapped element is re-run on the exact events backend.
            if (
                int(horizon[j]) < 0
                or int(horizon[j]) >= INT32_SAFE_HORIZON
                or (fire[j] < -1).any()
            ):
                from .events import simulate as ev_simulate

                int32_fallbacks += 1
                obs.counter_add("sim.int32_fallbacks", phase="wrapped")
                out[i] = ev_simulate(g, arch, progs[i].schedule, _no_trace(cfg))
                continue
            ft = {
                a: [int(x) for x in fire[j, ai, :iters] if x >= 0]
                for ai, a in enumerate(progs[i].actors)
            }
            if bool(dead[j]):
                out[i] = SimResult(
                    period=float("inf"), converged=False, deadlocked=True,
                    iterations=iters, horizon=int(horizon[j]), fire_times=ft,
                )
                continue
            period = measure_period(
                ft, max_multiplicity=cfg.max_multiplicity, checks=cfg.checks
            )
            if period is not None:
                out[i] = SimResult(
                    period=period, converged=True, deadlocked=False,
                    iterations=iters, horizon=int(horizon[j]), fire_times=ft,
                )
            elif at_cap:
                out[i] = SimResult(
                    period=fallback_period(ft), converged=False,
                    deadlocked=False, iterations=iters,
                    horizon=int(horizon[j]), fire_times=ft,
                )
            else:
                still.append(i)
        if still:
            obs.event(
                "sim.horizon_double", pending=len(still),
                next_iters=min(cfg.max_iterations, iters * 2),
            )
        remaining = still
        iters = min(cfg.max_iterations, iters * 2)
    return [r for r in out if r is not None]


def batch_simulate_periods(
    g: ApplicationGraph,
    arch: ArchitectureGraph,
    schedules: Sequence[Schedule],
    config: Optional[SimConfig] = None,
    *,
    backend: str = "cuda",
    device="cuda",
) -> List[float]:
    """Measured steady-state period per phenotype (batched backend)."""
    return [
        r.period
        for r in batch_simulate(
            g, arch, schedules, config, backend=backend, device=device
        )
    ]


def _no_trace(cfg: SimConfig) -> SimConfig:
    from dataclasses import replace

    return replace(cfg, trace=False)
