// Self-timed actor-step simulation of a batch of phenotypes, one CTA each.
//
// Replaces src/repro/kernels/sim_step.py::build_pallas_sim, whose body is
// src/repro/sim/vectorized.py::build_simulate_one.  The plain version with
// the same contract is repro_torch/sim/batched.py::simulate_plain; the
// outputs of the two are bit-identical.
//
// Design.  The grid is (B,): block b simulates phenotype b to the end of
// its own round loop (done, deadlocked, or max_steps), so no lockstep
// across the batch is needed.  One thread per actor (blockDim is A rounded
// up to a warp).  Round state lives in shared memory: the MRB write index
// omega[C], read views rho[C*R], active timed accesses per channel, the
// core owners (cores remapped to a compact 0..A-1 index per phenotype) and
// the interconnect busy-until times; per-actor state lives in registers.
// Per-core window arbitration, the "blocked by a lower-index surviving
// timed candidate on a shared interconnect" rule, the port rank and the
// next event time are block reductions in shared memory (atomicMin / a
// prefix count).  Each phase of a round is separated by __syncthreads(),
// in the order the model prescribes: completions (reads, then writes),
// window starts, task-start candidates, zero-duration effects (reads, then
// writes), timed claims.  Firing times go straight to global memory.
//
// What bounds it.  Not bytes: a phenotype's inputs are a few tens of KB,
// re-read through L1 each round (the actor's current task, and its task
// list for the start-of-firing gates).  The bound is the serial round
// loop — several hundred to a few thousand dependent rounds per phenotype,
// each about ten block barriers — so the kernel is latency-bound per CTA
// and its throughput comes from running B CTAs side by side on the SMs.
//
// Integer semantics follow the reference exactly: modulo is floored (jnp
// `%`), and t + duration wraps as two's-complement int32 (added in
// uint32), so the wrapper's overflow post-check sees the same outputs.
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kRead = 0;
constexpr int kWrite = 2;
constexpr int kNeg = -1;
constexpr int kI32Inf = 0x7fffffff;

using repro_torch::floor_mod;

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

struct Flags {
  int progressed;   // any completion, window start or task start this round
  int zd_any;       // any zero-duration task started
  int cand_lost;    // any task candidate that did not start
  int not_done;     // any actor below K firings
  int any_running;  // any timed task in flight
  int next_t;       // earliest completion among running tasks
};

__global__ void sim_step_kernel(
    const int8_t* __restrict__ kind, const int16_t* __restrict__ chan,
    const int8_t* __restrict__ slot, const int32_t* __restrict__ n_tasks,
    const int32_t* __restrict__ nread, const int32_t* __restrict__ delay,
    const int32_t* __restrict__ dur, const uint32_t* __restrict__ route,
    const int32_t* __restrict__ core, const int32_t* __restrict__ gamma,
    int32_t* __restrict__ fire, uint8_t* __restrict__ dead_out,
    int32_t* __restrict__ horizon_out, int A, int C, int R, int H, int Tmax,
    int k_max, int K, int max_steps, int ports) {
  extern __shared__ int smem[];
  int* omega = smem;           // [C]
  int* gam = omega + C;        // [C]
  int* nrd = gam + C;          // [C]
  int* active = nrd + C;       // [C]
  int* freec = active + C;     // [C]
  int* rho = freec + C;        // [C*R]
  int* owner = rho + C * R;    // [A] per compact core
  int* cmin = owner + A;       // [A] per compact core
  int* chcand = cmin + A;      // [A] channel of each port candidate, or -1
  int* icbusy = chcand + A;    // [H]
  int* icmin = icbusy + H;     // [H]
  Flags* fl = reinterpret_cast<Flags*>(icmin + H);

  const int b = blockIdx.x;
  const int i = threadIdx.x;
  const int nthreads = blockDim.x;
  const bool actor = i < A;
  const int BIG = A;

  for (int c = i; c < C; c += nthreads) {
    const int g = gamma[static_cast<size_t>(b) * C + c];
    const int nr = nread[c];
    const int d = delay[c];
    gam[c] = g;
    nrd[c] = nr;
    omega[c] = floor_mod(d, g);
    active[c] = 0;
    for (int s = 0; s < R; ++s) rho[c * R + s] = (s < nr && d > 0) ? 0 : kNeg;
  }
  for (int p = i; p < A; p += nthreads) owner[p] = kNeg;
  for (int h = i; h < H; h += nthreads) icbusy[h] = 0;

  const size_t row = static_cast<size_t>(b) * A + (actor ? i : 0);
  const int my_core = actor ? core[row] : 0;
  const int my_ntasks = actor ? n_tasks[i] : 0;
  const int8_t* my_kind = kind + static_cast<size_t>(actor ? i : 0) * Tmax;
  const int16_t* my_chan = chan + static_cast<size_t>(actor ? i : 0) * Tmax;
  const int8_t* my_slot = slot + static_cast<size_t>(actor ? i : 0) * Tmax;
  const int32_t* my_dur = dur + row * Tmax;
  const uint32_t* my_route = route + row * Tmax;
  int32_t* my_fire = fire + row * k_max;

  bool in_w = false, running = false, run_read = false, run_write = false;
  int busy = 0, cur = 0, iters = 0, run_ch = -1, run_slot = -1, run_gc = 1;
  int t = 0;
  bool dead = false;
  __syncthreads();

  for (int step = 0; step < max_steps; ++step) {
    // ---- completion phase: reads first (each touches only its own view).
    if (i == 0) {
      fl->progressed = 0;
      fl->zd_any = 0;
      fl->cand_lost = 0;
      fl->not_done = 0;
      fl->any_running = 0;
      fl->next_t = kI32Inf;
    }
    const bool due = actor && running && busy <= t;
    if (due) {
      running = false;
      if (run_ch >= 0) atomicSub(&active[run_ch], 1);
      if (run_read) {
        const int rv = rho[run_ch * R + run_slot];
        const int av = rv != kNeg ? floor_mod(omega[run_ch] - rv - 1, gam[run_ch]) + 1 : 0;
        rho[run_ch * R + run_slot] = av == 1 ? kNeg : floor_mod(rv + 1, run_gc);
      }
    }
    __syncthreads();
    // ... then writes (one writer per channel), then window ends.
    if (due && run_write) {
      const int om = omega[run_ch];
      for (int s = 0; s < nrd[run_ch]; ++s)
        if (rho[run_ch * R + s] == kNeg) rho[run_ch * R + s] = om;
      omega[run_ch] = floor_mod(om + 1, gam[run_ch]);
    }
    if (due) {
      const bool wdone = cur + 1 == my_ntasks;
      cur += 1;
      if (wdone) {
        in_w = false;
        iters += 1;
        owner[my_core] = kNeg;
      }
    }
    __syncthreads();

    // ---- start phase: free places per channel, arbitration scratch.
    for (int c = i; c < C; c += nthreads) {
      int m = 0;
      for (int s = 0; s < nrd[c]; ++s) {
        const int rv = rho[c * R + s];
        if (rv != kNeg) m = max(m, floor_mod(omega[c] - rv - 1, gam[c]) + 1);
      }
      freec[c] = gam[c] - m;
    }
    for (int p = i; p < A; p += nthreads) cmin[p] = BIG;
    for (int h = i; h < H; h += nthreads) icmin[h] = BIG;
    __syncthreads();

    // Window starts: per core the lowest-index candidate wins.
    bool fire_cand = false;
    if (actor && !in_w && iters < K && owner[my_core] == kNeg) {
      bool ok = true;
      for (int k = 0; k < my_ntasks && ok; ++k) {
        const int kd = my_kind[k];
        const int c = my_chan[k];
        if (kd == kRead) {
          const int rv = rho[c * R + my_slot[k]];
          ok = rv != kNeg;  // a live view holds >= 1 token
        } else if (kd == kWrite) {
          ok = freec[c] >= 1;
        }
      }
      fire_cand = ok;
    }
    if (fire_cand) atomicMin(&cmin[my_core], i);
    __syncthreads();
    const bool fire_win = fire_cand && cmin[my_core] == i;
    if (fire_win) {
      owner[my_core] = i;
      in_w = true;
      my_fire[iters] = t;
      cur = 0;
    }

    // Task-start candidates from the state with the winners' windows open.
    int kd = -1, ch = -1, sl = -1, d = 0;
    unsigned rt = 0u;
    if (actor && cur < my_ntasks) {
      kd = my_kind[cur];
      ch = my_chan[cur];
      sl = my_slot[cur];
      d = my_dur[cur];
      rt = my_route[cur];
    }
    const bool is_read = kd == kRead, is_write = kd == kWrite, timed = d > 0;
    const int gc = ch >= 0 ? gam[ch] : 1;
    int avail_t = 0, rho_cs = 0;
    if (is_read) {
      rho_cs = rho[ch * R + sl];
      avail_t = rho_cs != kNeg ? floor_mod(omega[ch] - rho_cs - 1, gam[ch]) + 1 : 0;
    }
    const int rho_adv = avail_t == 1 ? kNeg : floor_mod(rho_cs + 1, gc);
    bool ic_blocked = false;
    for (unsigned m = rt; m; m &= m - 1)
      if (icbusy[__ffs(static_cast<int>(m)) - 1] > t) ic_blocked = true;
    const bool cand = actor && in_w && !running && (!is_read || avail_t >= 1) &&
                      (!is_write || freec[ch] >= 1) && !ic_blocked;
    bool surv = cand;
    if (ports >= 0) {
      // Port slots go to the highest-ranked timed candidates per channel.
      const bool chan_cand = cand && timed && ch >= 0;
      if (actor) chcand[i] = chan_cand ? ch : -1;
      __syncthreads();
      if (chan_cand) {
        int rank = 0;
        for (int j = 0; j < i; ++j) rank += chcand[j] == ch;
        surv = active[ch] + rank < ports;
      }
    }
    // Deferred when a lower-index surviving timed candidate shares an
    // interconnect: per interconnect, the least such index.
    if (surv && timed)
      for (unsigned m = rt; m; m &= m - 1) atomicMin(&icmin[__ffs(static_cast<int>(m)) - 1], i);
    __syncthreads();
    bool blocked = false;
    for (unsigned m = rt; m; m &= m - 1)
      if (icmin[__ffs(static_cast<int>(m)) - 1] < i) blocked = true;
    const bool win = surv && !blocked;
    const bool zd = win && !timed;
    if (due || fire_win || win) fl->progressed = 1;
    if (zd) fl->zd_any = 1;
    if (cand && !win) fl->cand_lost = 1;

    // ---- apply: zero-duration reads, then writes, then timed claims.
    if (zd && is_read) rho[ch * R + sl] = rho_adv;
    __syncthreads();
    if (zd && is_write) {
      const int om = omega[ch];
      for (int s = 0; s < nrd[ch]; ++s)
        if (rho[ch * R + s] == kNeg) rho[ch * R + s] = om;
      omega[ch] = floor_mod(om + 1, gam[ch]);
    }
    if (zd) {
      const bool wdone = cur + 1 == my_ntasks;
      cur += 1;
      if (wdone) {
        in_w = false;
        iters += 1;
        owner[my_core] = kNeg;
      }
    }
    if (win && timed) {
      running = true;
      busy = wrap_add(t, d);
      for (unsigned m = rt; m; m &= m - 1) icbusy[__ffs(static_cast<int>(m)) - 1] = busy;
      if (ch >= 0) atomicAdd(&active[ch], 1);
      run_read = is_read;
      run_write = is_write;
      run_ch = ch;
      run_slot = sl;
      run_gc = gc;
    }
    if (actor) {
      if (iters < K) fl->not_done = 1;
      if (running) {
        fl->any_running = 1;
        atomicMin(&fl->next_t, busy);
      }
    }
    __syncthreads();

    // ---- end of round: quiescence, termination, time advance.
    const bool early = !fl->zd_any && !fl->cand_lost;
    const bool settled = !fl->progressed || early;
    const bool done = settled && !fl->not_done;
    dead = settled && !done && !fl->any_running;
    if (settled && !done && !dead) t = fl->next_t;
    __syncthreads();  // every thread has read the flags before the reset
    if (done || dead) break;
  }
  if (i == 0) {
    dead_out[b] = dead ? 1 : 0;
    horizon_out[b] = t;
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

}  // namespace

extern "C" {

// out: int32 [threads] on the device; threads <= 1024.
int sim_round_floor_launch(void* out, int threads, int rounds, void* stream) {
  sim_round_floor_kernel<<<1, threads, 2 * threads * sizeof(unsigned),
                           static_cast<cudaStream_t>(stream)>>>(static_cast<unsigned*>(out), rounds);
  return static_cast<int>(cudaGetLastError());
}

size_t sim_step_smem_bytes(int A, int C, int R, int H) {
  return sizeof(int) * (5 * static_cast<size_t>(C) + static_cast<size_t>(C) * R +
                        3 * static_cast<size_t>(A) + 2 * static_cast<size_t>(H)) +
         sizeof(Flags);
}

int sim_step_launch(const void* kind, const void* chan, const void* slot,
                    const void* n_tasks, const void* nread, const void* delay,
                    const void* dur, const void* route, const void* core,
                    const void* gamma, void* fire, void* dead, void* horizon,
                    int B, int A, int C, int R, int H, int Tmax, int k_max, int K,
                    int max_steps, int ports, void* stream) {
  const int threads = 32 * ((A + 31) / 32);
  const size_t smem = sim_step_smem_bytes(A, C, R, H);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sim_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  sim_step_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(kind), static_cast<const int16_t*>(chan),
      static_cast<const int8_t*>(slot), static_cast<const int32_t*>(n_tasks),
      static_cast<const int32_t*>(nread), static_cast<const int32_t*>(delay),
      static_cast<const int32_t*>(dur), static_cast<const uint32_t*>(route),
      static_cast<const int32_t*>(core), static_cast<const int32_t*>(gamma),
      static_cast<int32_t*>(fire), static_cast<uint8_t*>(dead),
      static_cast<int32_t*>(horizon), A, C, R, H, Tmax, k_max, K, max_steps, ports);
  return static_cast<int>(cudaGetLastError());
}

const char* sim_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
