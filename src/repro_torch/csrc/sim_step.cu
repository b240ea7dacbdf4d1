// Self-timed actor-step simulation of a batch of phenotypes, one CTA each.
//
// Replaces src/repro/kernels/sim_step.py::build_pallas_sim, whose body is
// src/repro/sim/vectorized.py::build_simulate_one.  The plain version with
// the same contract is repro_torch/sim/batched.py::simulate_plain; the
// outputs of the two are bit-identical.
//
// What bounds it.  Not bytes: a phenotype's tables are a few KB, read once.
// The bound is the serial round loop, several hundred to a few thousand
// dependent rounds per phenotype with one or two warps per SM, so nothing
// hides a round's latency: every instruction and every barrier of a round
// is on the critical path.  The design therefore makes a round short:
//
// * Tables on chip, loaded once.  Each CTA copies its phenotype's tasks
//   into shared memory packed by actor offsets (12 B a task: a descriptor
//   word of kind, slot and channel, the duration and the route bitmask),
//   with γ and the reader counts.  No global load is left in the round
//   loop; the only global access is the firing-time store.  Each actor
//   keeps its current task, decoded, in registers and reloads it when it
//   moves to the next task, off the round's critical path.
// * No integer division in the round loop.  The MRB state of a view
//   (channel c, reader slot s) is kept as its available-token count
//   avail = floor_mod(ω − ρ − 1, γ) + 1 (0 for a dead view, ρ = −1).
//   ω is set once to floor_mod(δ, γ) and afterwards advances by
//   ω + 1 == γ ? 0 : ω + 1; a live ρ likewise.  So ω and every live ρ stay
//   in [0, γ), ω − ρ − 1 lies in [−γ, γ − 2], and the floored modulo is one
//   compare-and-add (tests/test_torch_sim_plan.py holds both replacements
//   against floor_mod).  In those terms a read takes avail to avail − 1
//   (1 → 0 is ρ := −1), and a write takes every view of its channel to
//   avail + 1 (a dead view's ρ := ω gives 1).  A write never meets a full
//   view (avail == γ, where the wrap would give 1): it starts only when
//   every view has a free place, and with one writer per channel (checked
//   on the host, `pack_tables`) only reads touch the channel until the
//   write completes.  The initial count floor_mod(δ − 1, γ) + 1 is the one
//   modulo, taken before the loop.  Reads and writes now add and subtract,
//   so their effects commute: they are shared-memory atomics, and no
//   barrier orders reads before writes.
// * Gates as counters, kept, never rescanned.  nfull[c] counts the full
//   views of channel c (a write may start iff it is 0: the free places);
//   blocked[a] counts actor a's unmet window-start conditions, its dead
//   read views plus its write channels with nfull > 0 (the packed gate
//   masks, `_lower_batch`'s inmask/outmask, give them once at the start).
//   A read or write sees the crossings it causes in the value its atomic
//   returns (avail 1 → 0, 0 → 1, γ → γ − 1, γ − 1 → γ; nfull 1 → 0,
//   0 → 1) and moves the counters of the view's reader and the channel's
//   writer by one.  Counting crossings of a ±1 walk is order-free, so the
//   counters are exact after the barrier whatever order the atomics took.
//   The window-start gate is then one load, blocked[a] == 0, and a task
//   start's is one load, avail[view] > 0 or nfull[c] == 0.  (A bitmask
//   gate, rebuilt by ballots every round and ANDed word by word, cost
//   more on the card than the counters' atomics.)
// * Interconnects as masks.  A ballot over icbusy[h] > t gives the busy
//   word; a task is blocked when its route meets it.  The deferral rule ("a
//   lower-index surviving timed candidate shares an interconnect") is an
//   exclusive prefix-OR over actor index of the surviving timed
//   candidates' routes: inside a group of 32 actors a ballot gives the
//   (few) claiming lanes and a shuffle each one's route, walked in index
//   order; the lower groups' routes are ORed in.  (A __shfl_up_sync scan
//   costs five dependent shuffles every round; the walk costs one per
//   claimant, and rounds have few.)
// * Arbitration by warp intrinsics.  Per core the lowest-index window
//   candidate wins.  In one warp the (few) candidates of a round are
//   walked in index order, a ballot giving them and a shuffle each one's
//   core; with several warps candidates take atomicMin on a per-core claim
//   word behind a __syncthreads_or that also says whether anyone claimed.
//   The port rank (timed candidates on the same channel before this one)
//   is counted the same way in the warp, plus the lower warps' candidates
//   through shared memory.  (__match_any_sync cost more than these walks
//   on the card.)
// * Flags by reductions.  progressed, zd_any, cand_lost, not_done and
//   any_running are bits of one word, ORed over the warp by
//   __reduce_or_sync; next_t is a __reduce_min_sync, taken in one warp
//   only when time advances; with several warps one word each per warp.
//   No thread resets a flag block.  (Five __any_sync votes in place of the
//   OR were miscompiled by ptxas at -O1 and above in the one-warp
//   instance: its settle test took the cand_lost and zd_any votes
//   inverted, PERF.md §7.  The round counts that chip_smoke.py and the
//   card tests hold against the plain program catch such a fault.)
//
// Barriers per round, with more than one warp (A > 32): four block
// barriers (X1 after the completion effects, X2 after the window claims,
// X4 after the prefix-OR totals, X5 after the flag words), a fifth (X3,
// after the port candidates) only with mrb_ports.  With one warp (A ≤ 32)
// X1, X2 and X4 are __syncwarp() (the warp's shuffles and ballots order
// its lanes' steps but not their shared-memory accesses), and X3 and X5
// are not needed.  The effects of a round's zero-duration tasks and the
// next round's completions fall between the same two barriers: both are
// atomics.
//
// Layout.  Actor a of a CTA is thread a, so a group of 32 consecutive
// actors is one warp, and warps are ordered by actor index.  (Two warps
// ran 6-9% faster on the card than one warp of two actors per lane, the
// other way to hold 33-64 actors with no block barriers, at A = 39 and
// 62, PERF.md; that form is not kept.)
//
// Integer semantics follow the reference exactly: t + duration wraps as
// two's-complement int32 (added in uint32), so the wrapper's overflow
// post-check sees the same outputs.
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kRead = 0;
constexpr int kWrite = 2;
constexpr int kI32Inf = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

// Flag bits of a round.
constexpr unsigned kProgressed = 1u, kZdAny = 2u, kCandLost = 4u, kNotDone = 8u,
                   kAnyRunning = 16u;

using repro_torch::floor_mod;

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

// Shared-memory layout in 4-byte words; kernels/sim_step.py::launch_plan
// computes the same.
struct Layout {
  int desc, dur, route, gam, nrd, avail, nfull, rdr, wrt, blocked, active, owner, claim, icbusy,
      gx, fw, fm, chcand, total;
};

__host__ __device__ inline Layout make_layout(int A, int C, int R, int H, int T, int warps) {
  Layout L;
  int o = 0;
  L.desc = o;    o += T;
  L.dur = o;     o += T;
  L.route = o;   o += T;
  L.gam = o;     o += C;
  L.nrd = o;     o += C;
  L.avail = o;   o += C * R;
  L.nfull = o;   o += C;
  L.rdr = o;     o += C * R;
  L.wrt = o;     o += C;
  L.blocked = o; o += A;
  L.active = o;  o += C;
  L.owner = o;   o += A;
  L.claim = o;   o += A;
  L.icbusy = o;  o += H;
  L.gx = o;      o += warps;
  L.fw = o;      o += warps;
  L.fm = o;      o += warps;
  L.chcand = o;  o += A;
  L.total = o;
  return L;
}

// One actor's state (registers).
struct Actor {
  int a, core, off, n;
  bool valid, in_w, running;
  int busy, cur, iters;
  // The current task (also the running one: cur moves only when it ends):
  // kind, channel, view read, duration, route, and its channel's γ and
  // reader count.
  int kd, ch, view, dd;
  unsigned dr;
  int g, nr;
};

// The MRB state and the gate counters in shared memory.
struct Mrb {
  int* avail;      // [C·R] tokens each view can read
  int* nfull;      // [C] full views of each channel
  int* blocked;    // [A] unmet window-start conditions of each actor
  const int* rdr;  // [C·R] reader of each view, or −1
  const int* wrt;  // [C] writer of each channel, or −1
  int R;
};

struct Tables {
  const int* desc;
  const int* dur;
  const unsigned* route;
  const int* gam;
  const int* nrd;
};

__device__ __forceinline__ void load_task(Actor& s, const Tables& tb, int R) {
  if (s.cur < s.n) {
    const int p = s.off + s.cur;
    const int d = tb.desc[p];
    s.kd = d & 0xff;
    s.ch = d >> 16;
    s.view = s.ch * R + static_cast<int8_t>((d >> 8) & 0xff);
    s.dd = tb.dur[p];
    s.dr = tb.route[p];
    s.g = s.ch >= 0 ? tb.gam[s.ch] : 1;
    s.nr = s.ch >= 0 ? tb.nrd[s.ch] : 0;
  } else {  // between windows: no task
    s.kd = 1;
    s.ch = -1;
    s.view = -1;
    s.dd = 0;
    s.dr = 0u;
    s.g = 1;
    s.nr = 0;
  }
}

// The task at `cur` completed (or took effect): next task, or window end.
__device__ __forceinline__ void finish_task(Actor& s, int* owner, int BIG, const Tables& tb,
                                            int R) {
  const bool wdone = s.cur + 1 == s.n;
  s.cur += 1;
  if (wdone) {
    s.in_w = false;
    s.iters += 1;
    owner[s.core] = BIG;
  }
  load_task(s, tb, R);
}

// Actor s's current task takes effect on the MRB state: a read takes a
// token from its view, a write puts one into every view of its channel.
__device__ __forceinline__ void take_effect(const Mrb& m, const Actor& s) {
  if (s.kd == kRead) {
    const int old = atomicSub(&m.avail[s.view], 1);
    if (old == 1) atomicAdd(&m.blocked[s.a], 1);  // the view died
    if (old == s.g && atomicSub(&m.nfull[s.ch], 1) == 1) {  // a free place again
      const int w = m.wrt[s.ch];
      if (w >= 0) atomicSub(&m.blocked[w], 1);
    }
  } else if (s.kd == kWrite) {
    const int v0 = s.ch * m.R;
    for (int s0 = 0; s0 < s.nr; s0 += 4) {  // four views' atomics in flight at once
      int old[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) old[k] = s0 + k < s.nr ? atomicAdd(&m.avail[v0 + s0 + k], 1) : -1;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (old[k] == 0) {  // the view came alive
          const int r = m.rdr[v0 + s0 + k];
          if (r >= 0) atomicSub(&m.blocked[r], 1);
        }
        if (old[k] + 1 == s.g && atomicAdd(&m.nfull[s.ch], 1) == 0) atomicAdd(&m.blocked[s.a], 1);
      }
    }
  }
}

template <bool ONE_WARP>
__device__ __forceinline__ void cta_sync() {
  if constexpr (ONE_WARP) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// ONE_WARP: the CTA is one warp (A ≤ 32).  Otherwise: blockDim.x / 32 > 1
// warps, at most MAX_THREADS threads.  CTAs of up to 8 warps take the
// instance bounded at 256 threads: at two warps it ran faster on the card
// than the one bounded at 1,024, with the same register count.
template <bool ONE_WARP, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS)
sim_step_kernel(const int32_t* __restrict__ pack, const int32_t* __restrict__ dur_g,
                const uint32_t* __restrict__ route_g, const int32_t* __restrict__ core_g,
                const int32_t* __restrict__ gamma_g, const int32_t* __restrict__ nread_g,
                const int32_t* __restrict__ delay_g, int32_t* __restrict__ fire,
                uint8_t* __restrict__ dead_out, int32_t* __restrict__ horizon_out,
                int32_t* __restrict__ rounds_out, int A, int C, int R, int H, int Tmax, int T,
                int k_max, int K, int max_steps, int ports) {
  extern __shared__ int smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int nwarps = ONE_WARP ? 1 : nthreads >> 5;
  const int b = blockIdx.x;
  const int BIG = A;
  const int wv = (C * R + 31) >> 5, wc = (C + 31) >> 5;
  const Layout L = make_layout(A, C, R, H, T, nwarps);
  int* s_desc = smem + L.desc;
  int* s_dur = smem + L.dur;
  unsigned* s_route = reinterpret_cast<unsigned*>(smem + L.route);
  int* s_gam = smem + L.gam;
  int* s_nrd = smem + L.nrd;
  int* s_avail = smem + L.avail;
  int* s_nfull = smem + L.nfull;
  int* s_rdr = smem + L.rdr;
  int* s_wrt = smem + L.wrt;
  int* s_blocked = smem + L.blocked;
  int* s_active = smem + L.active;
  int* s_owner = smem + L.owner;
  int* s_claim = smem + L.claim;
  int* s_icbusy = smem + L.icbusy;
  unsigned* s_gx = reinterpret_cast<unsigned*>(smem + L.gx);
  unsigned* s_fw = reinterpret_cast<unsigned*>(smem + L.fw);
  int* s_fm = smem + L.fm;
  int* s_chcand = smem + L.chcand;
  const Tables tb{s_desc, s_dur, s_route, s_gam, s_nrd};
  const Mrb mrb{s_avail, s_nfull, s_blocked, s_rdr, s_wrt, R};

  // ---- load: the −1 fill of this phenotype's fire rows, tables, state.
  int32_t* fire_b = fire + static_cast<size_t>(b) * A * k_max;
  for (int i = tid; i < A * k_max; i += nthreads) fire_b[i] = -1;
  const int* g_off = pack;
  const int* g_desc = pack + A + 1;
  const unsigned* g_gin = reinterpret_cast<const unsigned*>(g_desc + T);
  const unsigned* g_gout = g_gin + A * wv;
  for (int i = tid; i < T; i += nthreads) s_desc[i] = g_desc[i];
  const int32_t* gamma_b = gamma_g + static_cast<size_t>(b) * C;
  for (int c = tid; c < C; c += nthreads) {
    s_gam[c] = gamma_b[c];
    s_nrd[c] = nread_g[c];
    s_wrt[c] = -1;
    s_active[c] = 0;
  }
  for (int v = tid; v < C * R; v += nthreads) {
    const int c = v / R;  // once, before the round loop
    const int d = delay_g[c];
    s_avail[v] = (v - c * R < nread_g[c] && d > 0) ? floor_mod(d - 1, gamma_b[c]) + 1 : 0;
    s_rdr[v] = -1;
  }
  for (int p = tid; p < A; p += nthreads) {
    s_owner[p] = BIG;
    s_claim[p] = BIG;
  }
  for (int h = tid; h < H; h += nthreads) s_icbusy[h] = 0;

  Actor s;
  s.a = tid;
  s.valid = s.a < A;
  {
    const int a = s.valid ? s.a : 0;
    s.off = s.valid ? g_off[a] : 0;
    s.n = s.valid ? g_off[a + 1] - s.off : 0;
    const size_t row = static_cast<size_t>(b) * A + a;
    s.core = s.valid ? core_g[row] : 0;
    for (int k = 0; k < s.n; ++k) {
      s_dur[s.off + k] = dur_g[row * Tmax + k];
      s_route[s.off + k] = route_g[row * Tmax + k];
    }
  }
  s.in_w = s.running = false;
  s.busy = s.cur = s.iters = 0;
  __syncthreads();
  // Gate counters from the packed gate masks: each view's reader and
  // each channel's writer, the full views per channel, then per actor
  // its dead read views and full write channels.
  for (int c = tid; c < C; c += nthreads) {
    int nf = 0;
    for (int v = 0; v < s_nrd[c]; ++v) nf += s_avail[c * R + v] >= s_gam[c];
    s_nfull[c] = nf;
  }
  if (s.valid) {
    for (int w = 0; w < wv; ++w)
      for (unsigned m = g_gin[s.a * wv + w]; m; m &= m - 1) s_rdr[(w << 5) + __ffs(m) - 1] = s.a;
    for (int w = 0; w < wc; ++w)
      for (unsigned m = g_gout[s.a * wc + w]; m; m &= m - 1) s_wrt[(w << 5) + __ffs(m) - 1] = s.a;
  }
  __syncthreads();
  if (s.valid) {
    int unmet = 0;
    for (int w = 0; w < wv; ++w)
      for (unsigned m = g_gin[s.a * wv + w]; m; m &= m - 1)
        unmet += s_avail[(w << 5) + __ffs(m) - 1] == 0;
    for (int w = 0; w < wc; ++w)
      for (unsigned m = g_gout[s.a * wc + w]; m; m &= m - 1)
        unmet += s_nfull[(w << 5) + __ffs(m) - 1] > 0;
    s_blocked[s.a] = unmet;
  }
  load_task(s, tb, R);
  __syncthreads();

  int t = 0;
  bool dead = false;
  int step = 0;
  for (; step < max_steps; ++step) {
    // ---- completion phase: the task due at t takes effect (atomics,
    // which commute with each other and with the last round's
    // zero-duration effects), then window ends.
    const bool due = s.running && s.busy <= t;
    if (due) {
      s.running = false;
      if (ports >= 0 && s.ch >= 0) atomicSub(&s_active[s.ch], 1);
      take_effect(mrb, s);
      finish_task(s, s_owner, BIG, tb, R);
    }
    cta_sync<ONE_WARP>();  // X1

    // ---- window starts: per core the lowest-index candidate wins.
    const unsigned icmask = __ballot_sync(kFull, lane < H && s_icbusy[lane < H ? lane : 0] > t);
    const bool fcand = s.valid && !s.in_w && s.iters < K && s_owner[s.core] == BIG &&
                       s_blocked[s.a] == 0;
    bool fwin = false;
    if constexpr (ONE_WARP) {
      __syncwarp();  // X2: every gate read before any winner's write
      // A candidate loses to a lower-index candidate on its core: walk the
      // (few) candidates in index order, their cores by shuffles.
      bool lose = false;
      for (unsigned m = __ballot_sync(kFull, fcand); m; m &= m - 1) {
        const int src = __ffs(m) - 1;
        lose |= __shfl_sync(kFull, s.core, src) == s.core && src < lane;
      }
      fwin = fcand && !lose;
    } else {
      // Candidates take atomicMin on their core's claim word; the winner
      // reads its own index back.  X2 also tells whether anyone claimed.
      if (fcand) atomicMin(&s_claim[s.core], s.a);
      if (__syncthreads_or(fcand)) {  // X2
        fwin = fcand && s_claim[s.core] == s.a;
        if (fwin) s_claim[s.core] = BIG;  // a loser reading BIG or a loses all the same
      }
    }
    if (fwin) {
      s_owner[s.core] = s.a;
      s.in_w = true;
      fire_b[s.a * k_max + s.iters] = t;
      s.cur = 0;
      load_task(s, tb, R);
    }

    // ---- task-start candidates, from the state with the new windows open.
    bool cand = s.in_w && !s.running && (s.dr & icmask) == 0u;
    if (cand && s.kd == kRead) cand = s_avail[s.view] > 0;
    if (cand && s.kd == kWrite) cand = s_nfull[s.ch] == 0;
    const bool timed = s.dd > 0;
    bool surv = cand;
    if (ports >= 0) {
      // Port slots go to the lowest-index timed candidates per channel:
      // rank = candidates on the same channel before this one, this
      // warp's in index order by shuffles ...
      const bool pc = cand && timed && s.ch >= 0;
      int rank = 0;
      for (unsigned m = __ballot_sync(kFull, pc); m; m &= m - 1) {
        const int src = __ffs(m) - 1;
        rank += __shfl_sync(kFull, s.ch, src) == s.ch && src < lane;
      }
      if constexpr (!ONE_WARP) {
        // ... and the lower warps' ones, through shared memory.
        if (s.valid) s_chcand[s.a] = pc ? s.ch : -1;
        __syncthreads();  // X3
        for (int w = 0; w < warp; ++w) {
          const int x = s_chcand[(w << 5) + lane];
          for (unsigned m = __ballot_sync(kFull, x >= 0); m; m &= m - 1)
            rank += __shfl_sync(kFull, x, __ffs(m) - 1) == s.ch;
        }
      }
      if (pc) surv = s_active[s.ch] + rank < ports;
    }

    // ---- deferral: a lower-index surviving timed candidate shares an
    // interconnect.  The (few) claiming lanes are walked in index order,
    // their routes by shuffles: the exclusive prefix-OR of the warp.
    const unsigned r = surv && timed ? s.dr : 0u;
    bool deferred = false;
    unsigned tot = 0u;
    for (unsigned m = __ballot_sync(kFull, r != 0u); m; m &= m - 1) {
      const int src = __ffs(m) - 1;
      const unsigned rs = __shfl_sync(kFull, r, src);
      tot |= rs;
      deferred |= src < lane && (s.dr & rs) != 0u;
    }
    unsigned carry = 0u;
    if constexpr (ONE_WARP) {
      __syncwarp();  // X4: every candidate read before any effect
    } else {
      if (lane == 0) s_gx[warp] = tot;
      __syncthreads();  // X4
      for (int w = 0; w < warp; ++w) carry |= s_gx[w];
    }

    // ---- winners apply: zero-duration effects, timed claims; flags.
    const bool win = surv && !deferred && (s.dr & carry) == 0u;
    unsigned bits = 0u;
    if (win && !timed) {
      take_effect(mrb, s);
      finish_task(s, s_owner, BIG, tb, R);
      bits |= kZdAny;
    }
    if (win && timed) {
      s.running = true;
      s.busy = wrap_add(t, s.dd);
      for (unsigned m = s.dr; m; m &= m - 1) s_icbusy[__ffs(static_cast<int>(m)) - 1] = s.busy;
      if (ports >= 0 && s.ch >= 0) atomicAdd(&s_active[s.ch], 1);
    }
    if (due || fwin || win) bits |= kProgressed;
    if (cand && !win) bits |= kCandLost;
    if (s.valid && s.iters < K) bits |= kNotDone;
    if (s.running) bits |= kAnyRunning;
    int next_t = s.running ? s.busy : kI32Inf;
    bits = __reduce_or_sync(kFull, bits);
    if constexpr (!ONE_WARP) {
      next_t = __reduce_min_sync(kFull, next_t);
      if (lane == 0) {
        s_fw[warp] = bits;
        s_fm[warp] = next_t;
      }
      __syncthreads();  // X5
      bits = 0u;
      next_t = kI32Inf;
      for (int w = 0; w < nwarps; ++w) {
        bits |= s_fw[w];
        next_t = min(next_t, s_fm[w]);
      }
    }

    // ---- end of round: quiescence, termination, time advance.
    const bool early = (bits & (kZdAny | kCandLost)) == 0u;
    const bool settled = (bits & kProgressed) == 0u || early;
    const bool done = settled && (bits & kNotDone) == 0u;
    dead = settled && !done && (bits & kAnyRunning) == 0u;
    if (settled && !done && !dead) t = ONE_WARP ? __reduce_min_sync(kFull, next_t) : next_t;
    if (done || dead) break;
  }
  if (tid == 0) {
    dead_out[b] = dead ? 1 : 0;
    horizon_out[b] = t;
    rounds_out[b] = step < max_steps ? step + 1 : max_steps;
  }
}

// Calibration of the round floor (not the simulator): one CTA of the
// simulator's block size runs `rounds` dependent rounds of the least work
// a round needs, one shared-memory write, one __syncthreads() and one
// shared-memory read-reduce (each thread adds its neighbour's value).
// Two buffers alternate, so one barrier per round suffices: the buffer a
// round writes was last read two rounds before, behind the barrier
// between.  Timed by chip_smoke.py, its time per round times a
// phenotype's round count bounds sim_step_kernel from below.
__global__ void sim_round_floor_kernel(unsigned* __restrict__ out, int rounds) {
  extern __shared__ unsigned buf[];  // [2][blockDim.x]
  const int i = threadIdx.x;
  const int n = blockDim.x;
  const int nb = i + 1 < n ? i + 1 : 0;
  unsigned x = i;
  for (int r = 0; r < rounds; ++r) {
    unsigned* cur = buf + (r & 1) * n;
    cur[i] = x;
    __syncthreads();
    x += cur[nb];
  }
  out[i] = x;
}

template <bool ONE_WARP, int MAX_THREADS>
cudaError_t launch(const void* pack, const void* dur, const void* route, const void* core,
                   const void* gamma, const void* nread, const void* delay, void* fire,
                   void* dead, void* horizon, void* rounds, int B, int A, int C, int R, int H,
                   int Tmax, int T, int k_max, int K, int max_steps, int ports, int threads,
                   size_t smem, cudaStream_t stream) {
  auto kernel = sim_step_kernel<ONE_WARP, MAX_THREADS>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<B, threads, smem, stream>>>(
      static_cast<const int32_t*>(pack), static_cast<const int32_t*>(dur),
      static_cast<const uint32_t*>(route), static_cast<const int32_t*>(core),
      static_cast<const int32_t*>(gamma), static_cast<const int32_t*>(nread),
      static_cast<const int32_t*>(delay), static_cast<int32_t*>(fire),
      static_cast<uint8_t*>(dead), static_cast<int32_t*>(horizon),
      static_cast<int32_t*>(rounds), A, C, R, H, Tmax, T, k_max, K, max_steps, ports);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out: int32 [threads] on the device; threads <= 1024.
int sim_round_floor_launch(void* out, int threads, int rounds, void* stream) {
  sim_round_floor_kernel<<<1, threads, 2 * threads * sizeof(unsigned),
                           static_cast<cudaStream_t>(stream)>>>(static_cast<unsigned*>(out), rounds);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of one CTA, in bytes (as launch_plan's smem_bytes).
size_t sim_step_smem_bytes(int A, int C, int R, int H, int T, int warps) {
  return sizeof(int) * static_cast<size_t>(make_layout(A, C, R, H, T, warps).total);
}

// warps as kernels/sim_step.py::launch_plan gives them: ⌈A/32⌉, 1..32.
int sim_step_launch(const void* pack, const void* dur, const void* route, const void* core,
                    const void* gamma, const void* nread, const void* delay, void* fire,
                    void* dead, void* horizon, void* rounds, int B, int A, int C, int R, int H,
                    int Tmax, int T, int k_max, int K, int max_steps, int ports, int warps,
                    void* stream) {
  const size_t smem = sim_step_smem_bytes(A, C, R, H, T, warps);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 32 * warps;
  if (warps == 1)
    return static_cast<int>(launch<true, 32>(pack, dur, route, core, gamma, nread, delay, fire,
                                             dead, horizon, rounds, B, A, C, R, H, Tmax, T,
                                             k_max, K, max_steps, ports, threads, smem, s));
  if (warps > 1 && warps <= 8)
    return static_cast<int>(launch<false, 256>(pack, dur, route, core, gamma, nread, delay, fire,
                                               dead, horizon, rounds, B, A, C, R, H, Tmax, T,
                                               k_max, K, max_steps, ports, threads, smem, s));
  if (warps > 8 && warps <= 32)
    return static_cast<int>(launch<false, 1024>(pack, dur, route, core, gamma, nread, delay,
                                                fire, dead, horizon, rounds, B, A, C, R, H,
                                                Tmax, T, k_max, K, max_steps, ports, threads,
                                                smem, s));
  return static_cast<int>(cudaErrorInvalidConfiguration);
}

const char* sim_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
