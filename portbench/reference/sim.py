"""The self-timed simulator and period measurement, frozen, in plain NumPy.

One firing of an actor is a window of tasks (reads, the execution, writes)
on its bound core.  Channels follow the exact MRB index semantics (a FIFO
is the one-reader case): a write fills every reader's view, a read drains
its own.  Time advances in synchronous phased rounds, repeated at each
instant until quiescence:

* completion: every running task whose end has come completes, reads'
  effects before writes';
* window starts: an actor that is between windows, has fired fewer than K
  times, finds its core free, a token in every view it reads and a free
  place in every channel it writes, opens a window; per core the first
  such actor in arbitration order wins and its first task competes in the
  same round;
* task starts: a task starts when its read view has a token, its write
  channel a free place and no interconnect of its route is busy; it is
  deferred to the next round when an earlier surviving timed candidate
  shares an interconnect.  Zero-duration tasks take effect at once (reads
  before writes), timed ones hold their route until t + duration;
* a round that changes nothing, or whose winners were all timed and whose
  candidates all won, ends the instant: time jumps to the next completion.

A row ends when every actor has fired K times (``done``) or when nothing
runs and nothing can start (``dead``).  Times are int32 and ``t +
duration`` wraps as int32 does.  The period is measured from the firing
times as the worst actor's D/R over the smallest multiplicity R ≤ 16 whose
last three R-strided intervals agree after a quarter-length drain guard,
the mean interval of the second half where one never settles, and ``inf``
on deadlock or a negative firing time.

Rows are simulated together, gathered by index; a row that ends leaves the
working set, so it is frozen exactly where it ended.
"""
from __future__ import annotations

import numpy as np

__all__ = ["simulate", "period"]

READ, EXEC, WRITE = 0, 1, 2
I32_INF = 2**31 - 1


def simulate(kind, chan, slot, n_tasks, nread, delay, dur, route, core, gamma, K: int):
    """Self-timed execution of every row for ``K`` firings per actor.

    Graph tables ``kind``/``chan``/``slot`` (A, Tmax) (−1 for no channel or
    slot), ``n_tasks`` (A,), ``nread``/``delay`` (C,); row tables ``dur``,
    ``route`` (B, A, Tmax) (route: bitmask of interconnects), ``core`` (B, A)
    compact core index, ``gamma`` (B, C).  Returns ``fire`` (B, A, K) int32,
    ``dead`` (B,) bool and the end time (B,) int32."""
    i32 = np.int32
    kind, chan, slot = (np.asarray(x, np.int64) for x in (kind, chan, slot))
    n_tasks = np.asarray(n_tasks, np.int64)
    nread, delay = np.asarray(nread, np.int64), np.asarray(delay, np.int64)
    dur = np.asarray(dur).astype(i32)
    route = np.asarray(route).astype(np.int64) & 0xFFFFFFFF
    core = np.asarray(core, np.int64)
    gamma = np.asarray(gamma).astype(i32)
    B, A, Tmax = dur.shape
    C = nread.shape[0]
    R = int(nread.max())
    H = int(max(1, int(route.max()).bit_length()))
    V = C * R                                   # views c·R + s; V is a dummy
    rmask = np.arange(R)[None, :] < nread[:, None]                        # (C, R)
    live_t = np.arange(Tmax)[None, :] < n_tasks[:, None]
    # Window-start gates: the views an actor reads and the channels it writes,
    # padded with the dummy view / channel, which always passes.
    rd_views = [[int(chan[a, t] * R + slot[a, t]) for t in range(Tmax)
                 if live_t[a, t] and kind[a, t] == READ] for a in range(A)]
    wr_chans = [[int(chan[a, t]) for t in range(Tmax) if live_t[a, t] and kind[a, t] == WRITE]
                for a in range(A)]
    gin = _pad(rd_views, V)
    gout = _pad(wr_chans, C)
    earlier = np.arange(A)[:, None] > np.arange(A)[None, :]              # j before i
    total_tasks = int(n_tasks.sum())
    max_steps = K * (3 * total_tasks + A + 2) + 8

    # State of the working rows.
    rows = np.arange(B)
    t = np.zeros(B, i32)
    omega = np.broadcast_to(np.mod(delay, gamma), (B, C)).astype(i32)
    rho = np.where(rmask & (delay[:, None] > 0), 0, -1).astype(i32)
    rho = np.broadcast_to(rho, (B, C, R)).copy()
    owner = np.full((B, A), -1, np.int64)
    ic_busy = np.zeros((B, H), i32)
    in_w = np.zeros((B, A), bool)
    running = np.zeros((B, A), bool)
    busy = np.zeros((B, A), i32)
    cur = np.zeros((B, A), np.int64)
    iters = np.zeros((B, A), np.int64)
    fire = np.full((B, A, K), -1, i32)
    run_read = np.zeros((B, A), bool)
    run_write = np.zeros((B, A), bool)
    run_view = np.full((B, A), V, np.int64)
    run_ch = np.zeros((B, A), np.int64)
    out_fire = np.full((B, A, K), -1, i32)
    out_dead = np.zeros(B, bool)
    out_t = np.zeros(B, i32)
    h_bits = np.array([1 << h for h in range(H)], np.int64)
    aa = np.arange(A)[None, :]
    big_v = np.int32(1 << 30)
    # Per-row tables of the working rows, cut down when rows end.
    g, core_w, conflict, dur_w, route_w = (gamma, core, earlier[None] & (
        core[:, :, None] == core[:, None, :]), dur, route)

    def read(b, v, avail_flat):
        """Reads of views ``v`` of working rows ``b`` complete: the view's
        token is consumed (ρ := −1 when it was the last)."""
        c, s = v // R, v % R
        rho[b, c, s] = np.where(avail_flat[b, v] == 1, -1,
                                np.mod(rho[b, c, s] + 1, g[b, c])).astype(i32)

    def write(b, c):
        """Writes of channels ``c`` of rows ``b`` complete: every empty view
        starts at ω, then ω advances."""
        rw = rho[b, c]                                                      # (k, R)
        rho[b, c] = np.where(rmask[c] & (rw == -1), omega[b, c][:, None], rw)
        omega[b, c] = np.mod(omega[b, c] + 1, g[b, c])

    def advance(b, a):
        """Tasks of (row, actor) pairs completed: the next task, or the end
        of the window (one more firing, the core released)."""
        cur[b, a] += 1
        end = cur[b, a] == n_tasks[a]
        be, ae = b[end], a[end]
        in_w[be, ae] = False
        iters[be, ae] += 1
        owner[be, core_w[be, ae]] = -1

    for _ in range(max_steps):
        n = rows.size
        if n == 0:
            break
        bi = np.arange(n)[:, None]
        progressed = np.zeros(n, bool)

        # ---- completion phase: reads before writes
        due = running & (busy <= t[:, None])
        if due.any():
            running &= ~due
            b, a = np.nonzero(due)
            progressed[b] = True
            av = np.where(rmask[None] & (rho != -1),
                          np.mod(omega[:, :, None] - rho - 1, g[:, :, None]) + 1, 0).reshape(n, V)
            m = run_read[b, a]
            if m.any():
                read(b[m], run_view[b[m], a[m]], av)
            m = run_write[b, a]
            if m.any():
                write(b[m], run_ch[b[m], a[m]])
            advance(b, a)

        # ---- window starts
        av = np.where(rmask[None] & (rho != -1),
                      np.mod(omega[:, :, None] - rho - 1, g[:, :, None]) + 1, 0).reshape(n, V)
        av = np.concatenate([av, np.full((n, 1), big_v, av.dtype)], 1)       # dummy view
        free = g - av[:, :V].reshape(n, C, R).max(2)
        free = np.concatenate([free, np.full((n, 1), big_v, free.dtype)], 1)  # dummy channel
        fire_cand = (~in_w & (iters < K) & (owner[bi, core_w] == -1)
                     & (av[:, gin] >= 1).all(2) & (free[:, gout] >= 1).all(2))
        if fire_cand.any():
            fire_win = fire_cand & ~(conflict & fire_cand[:, None, :]).any(2)
            b, a = np.nonzero(fire_win)
            progressed[b] = True
            owner[b, core_w[b, a]] = a
            fire[b, a, iters[b, a]] = t[b]
            in_w[b, a] = True
            cur[b, a] = 0

        # ---- task starts
        act = in_w & ~running
        early = np.ones(n, bool)
        if act.any():
            b, a = np.nonzero(act)
            c_ = cur[b, a]
            kd, ch, sl = kind[a, c_], chan[a, c_], slot[a, c_]
            d_, rt = dur_w[b, a, c_], route_w[b, a, c_]
            is_read, is_write = kd == READ, kd == WRITE
            view = np.where(is_read, ch * R + sl, V)
            busy_mask = ((ic_busy > t[:, None]) * h_bits).sum(1)
            cand = ((av[b, view] >= 1) & (free[b, np.where(is_write, ch, C)] >= 1)
                    & ((rt & busy_mask[b]) == 0))
            timed = d_ > 0
            # Deferral: an earlier surviving timed candidate of the row shares
            # an interconnect (exclusive prefix OR of routes in actor order).
            claims = np.zeros((n, A), np.int64)
            claims[b, a] = np.where(cand & timed, rt, 0)
            before = np.bitwise_or.accumulate(claims, 1)
            before = np.concatenate([np.zeros((n, 1), np.int64), before[:, :-1]], 1)[b, a]
            win = cand & ((rt & before) == 0)
            progressed[b[win]] = True
            early[b[win & ~timed]] = False
            early[b[cand & ~win]] = False
            zd = win & ~timed
            if zd.any():
                m = zd & is_read
                if m.any():
                    read(b[m], view[m], av)
                m = zd & is_write
                if m.any():
                    write(b[m], ch[m])
                advance(b[zd], a[zd])
            tw = win & timed
            if tw.any():
                bt, at = b[tw], a[tw]
                end = (t[bt] + d_[tw]).astype(i32)
                running[bt, at] = True
                busy[bt, at] = end
                k, h = np.nonzero((rt[tw][:, None] & h_bits) != 0)
                ic_busy[bt[k], h] = end[k]
                run_read[bt, at] = is_read[tw]
                run_write[bt, at] = is_write[tw]
                run_view[bt, at] = view[tw]
                run_ch[bt, at] = np.maximum(ch[tw], 0)

        settled = ~progressed | early
        done = settled & (iters >= K).all(1)
        dead = settled & ~done & ~running.any(1)
        next_t = np.where(running, busy, I32_INF).min(1).astype(i32)
        t = np.where(settled & ~done & ~dead, next_t, t).astype(i32)

        ended = done | dead
        if ended.any():
            e = rows[ended]
            out_fire[e], out_dead[e], out_t[e] = fire[ended], dead[ended], t[ended]
            keep = ~ended
            rows = rows[keep]
            (t, omega, rho, owner, ic_busy, in_w, running, busy, cur, iters, fire, run_read,
             run_write, run_view, run_ch, g, core_w, conflict, dur_w, route_w) = (x[keep] for x in (
                t, omega, rho, owner, ic_busy, in_w, running, busy, cur, iters, fire, run_read,
                run_write, run_view, run_ch, g, core_w, conflict, dur_w, route_w))
    if rows.size:          # rows cut by the round bound keep their state
        out_fire[rows], out_t[rows] = fire, t
    return out_fire, out_dead, out_t


def _pad(lists, dummy: int) -> np.ndarray:
    width = max(1, max(len(x) for x in lists))
    return np.array([x + [dummy] * (width - len(x)) for x in lists], np.int64)


def period(fire: np.ndarray, dead: np.ndarray, K: int, dtype=np.float64) -> np.ndarray:
    """Steady-state period per row, ``inf`` on deadlock or a negative firing
    time among the first K; the divisions are taken in ``dtype`` (float64,
    or float32 for the control) and returned as float64."""
    ts = fire[:, :, :K].astype(np.int64)
    bad = dead | (ts < 0).any(2).any(1)
    guard = max(2, K // 4)
    L = K - guard
    rate = np.full(ts.shape[:2], np.inf)
    found = np.zeros(ts.shape[:2], bool)
    for m in range(1, 17):
        if L < m * 3 + 1:
            break
        d = ts[:, :, L - 1] - ts[:, :, L - 1 - m]
        ok = np.ones_like(found)
        for j in range(2, 4):
            ok &= ts[:, :, L - 1 - (j - 1) * m] - ts[:, :, L - 1 - j * m] == d
        rate = np.where(ok & ~found, (d.astype(dtype) / dtype(m)).astype(np.float64), rate)
        found |= ok
    mid = K // 2
    fb = ((ts[:, :, K - 1] - ts[:, :, mid]).astype(dtype) / dtype(max(1, K - 1 - mid))).astype(np.float64)
    out = np.where(found.all(1), rate.max(1), fb.max(1))
    return np.where(bad, np.inf, out)
