// Multi-reader GQA decode attention over the MRB ring KV cache.
//
// Replaces src/repro/kernels/decode_attention.py::mrb_decode_attention.
// The plain version with the same contract is
// repro_torch/kernels/ref.py::decode_attention_ref; the split-and-merge
// arithmetic of this kernel is written out in plain torch as
// repro_torch/kernels/ref.py::decode_attention_split_ref.
//
// What it computes.  q [B, H, d], K/V rings [B, C, kv, d], H = kv * G.
// For batch row b and kv head h, the G query heads h*G .. h*G+G-1 are the
// readers of ring (b, h).  The readable positions are [lo, t] with
// lo = max(0, t - min(W, C) + 1), W the window (C when window = 0);
// position p lives in slot p mod C.  Scores are q.k / sqrt(d), soft-capped
// as cap * tanh(s / cap) when cap > 0; softmax over the readable positions;
// out = P.V in q's type, everything in between in float32.
//
// What bounds it.  Bytes: each readable K/V row is used for about 2*G
// flops, far below the card's ~295 flop/byte ridge.  The paper's design
// point is kept: each K/V tile is read from device memory once and shared
// in shared memory by all G readers of its kv head.  On an H100 at G=2
// the kernel streams at about two thirds to three quarters of the
// 3.35 TB/s rate (chip_smoke.py's long shapes): each tile's float32 work
// is only partly hidden behind the next tiles' copies, two CTAs per SM
// overlapping each other's.  At G=16 the math, not the bytes, is the
// limit.  What the design does about the bytes:
//
// 1. Positions, not slots.  Each CTA reads t from device memory (the ring
//    state never leaves the card) and walks only its share of [lo, t],
//    mapped to slots (p mod C, wrapping at most once).  A window smaller
//    than the capacity, or a partly filled ring, costs only the bytes it
//    reads; only the ragged ends of a tile are masked.
// 2. A thread-block cluster of S CTAs per (b, kv head) splits the
//    positions (S <= 8, or 16 where the non-portable size is granted).  The
//    host picks S once per shape from B*kv, the readable span and the
//    card's resident-cluster count (cudaOccupancyMaxActiveClusters), so
//    that the launch fills the card.  Each CTA keeps its partial
//    (m, l, acc[G][d]) in float32 in its own shared memory; after
//    cluster.sync() the CTAs read each other's partials over distributed
//    shared memory, each merging a share of the G*d outputs.  One launch
//    per call, no global scratch, no atomics.  A split with no readable
//    position has m = -inf and weight exactly 0: the merge never forms
//    -inf - (-inf).
// 3. Bytes in flight: a ring of kStages shared-memory stages of K and V
//    tiles (32 slots, or 64 for rows of at most 256 bytes: a stage holds
//    16 KB of K and 16 KB of V in bf16) is filled with cp.async.cg 16-byte
//    copies (commit / wait groups), so kStages - 1 tiles are in flight
//    while one is consumed; three stages keep two CTAs per SM at d=256.
//    Rows past the CTA's share are zero-filled by the copy (src-size 0),
//    so no stale or uninitialised value reaches P.V.
// 4. One barrier per tile.  Warps split the readers into groups of at
//    most kGw and each tile's slots among themselves; each warp runs its
//    own online softmax over its own slots for its readers, and the warps
//    merge once at the end.  Per tile the CTA needs only the stage
//    barrier.  Inside a warp the scalar work per slot is not repeated on
//    every lane: for the scores, sub-groups of `lps` lanes each take one
//    slot (several slots at once, q read from shared memory in float32),
//    so the reduction is log2(lps) shuffles and the scale, softcap and exp
//    run once per slot; for P.V the lanes split d, weights fetched by one
//    shuffle, accumulators in registers.
// 5. Dot products on the CUDA cores in float32 (no tensor cores).
//
// Invalid slots get exactly zero weight: running maxima start at -inf, a
// rescale is exp(m_old - m_new) only when the maximum moved, and masked
// slots contribute 0.  With no readable position at all (t < 0) the
// reference's softmax is uniform over its C masked scores, so the kernel
// then walks all C slots with the score 0 and returns the mean of V.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <array>
#include <map>
#include <mutex>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;      // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTileBytes = 16384;  // bytes of K (and of V) per stage: 32 slots at d=256 bf16
constexpr int kMaxTile = 64;       // ring slots per stage, at most
constexpr int kStages = 3;         // shared-memory stages: kStages - 1 tiles in flight
constexpr int kMaxG = 16;          // readers per kv head
constexpr int kMaxD = 256;         // head dim
constexpr int kMaxSplits = 16;     // CTAs per cluster (non-portable above 8)

using repro_torch::from_f32;
using repro_torch::to_f32;

__device__ __forceinline__ float neg_inf() { return __int_as_float(static_cast<int>(0xff800000u)); }

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) / 16 * 16; }

// How a CTA's threads cover the readers, the slots of a tile and a row of
// d elements.  Warps split the readers into rg groups of gw; the sg warps
// of a group split each tile's slots, spw each.  Scores: lanes form
// sub-groups of lps lanes, one slot each (subs slots at once, `rounds`
// times), each lane at most kScoreChunks 16-byte chunks of the row.  P.V:
// lanes form pv_subs sub-groups of pv_lps lanes, one slot each, each lane
// pv_nc chunks of the row.
struct Geometry {
  int vec;      // elements per 16-byte chunk
  int chunks;   // 16-byte chunks per row
  int tile;     // ring slots per stage: 32, or 64 for rows of at most 256 bytes
  int gw;       // readers per warp (kGw)
  int rg;       // reader groups
  int sg;       // warps per reader group
  int spw;      // slots per warp and tile
  int lps;      // score phase: lanes per slot (power of two)
  int subs;     // score phase: slots at once, 32 / lps
  int rounds;   // score phase: spw / subs
  int pv_lps;   // P.V phase: lanes per slot
  int pv_subs;  // P.V phase: slots at once, 32 / pv_lps (divides subs)
  int pv_nc;    // P.V phase: chunks per lane (kPNC)
};

constexpr int kScoreChunks = 4;  // score phase: 16-byte chunks per lane, at most
constexpr int kMaxRounds = 8;    // score phase: rounds per tile, at most

__host__ __device__ inline int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

__host__ __device__ inline Geometry geometry(int G, int d, int kv_elt) {
  Geometry g;
  g.vec = 16 / kv_elt;
  g.chunks = d / g.vec;
  g.tile = d * kv_elt <= kTileBytes / kMaxTile ? kMaxTile : kMaxTile / 2;
  g.gw = G <= 2 ? 2 : 4;
  g.rg = (G + g.gw - 1) / g.gw;
  g.sg = kWarps / g.rg;
  g.spw = g.tile / g.sg;
  g.lps = pow2_at_least((g.chunks + kScoreChunks - 1) / kScoreChunks);
  if (g.lps < 32 / g.spw) g.lps = 32 / g.spw;
  g.subs = 32 / g.lps;
  g.rounds = g.spw / g.subs;
  const int pv = pow2_at_least(g.chunks) < 32 ? pow2_at_least(g.chunks) : 32;
  g.pv_subs = 32 / pv < g.subs ? 32 / pv : g.subs;
  g.pv_lps = 32 / g.pv_subs;
  g.pv_nc = (g.chunks + g.pv_lps - 1) / g.pv_lps;
  return g;
}

// The CTA's partial (acc[G][d], m[G], l[G]) that the cluster reads; acc
// takes the place of q (float32, [G][d]) once the last tile is consumed.
__host__ __device__ inline size_t partial_bytes(int G, int d) {
  return align16(sizeof(float) * (2 * static_cast<size_t>(G) + static_cast<size_t>(G) * d));
}

__host__ __device__ inline size_t stage_bytes(int G, int d, int kv_elt) {
  return static_cast<size_t>(kStages) * 2 * geometry(G, d, kv_elt).tile * d * kv_elt;
}

// The warps' partials (m, l [sg][G], acc [sg][G][d]), written over the
// stages once the last tile is consumed.
__host__ __device__ inline size_t stream_bytes(int G, int d, int kv_elt) {
  const Geometry geo = geometry(G, d, kv_elt);
  return sizeof(float) * static_cast<size_t>(geo.sg) * G * (d + 2);
}

__host__ __device__ inline size_t smem_bytes(int G, int d, int kv_elt) {
  const size_t work = stage_bytes(G, d, kv_elt) > stream_bytes(G, d, kv_elt)
                          ? stage_bytes(G, d, kv_elt) : stream_bytes(G, d, kv_elt);
  return partial_bytes(G, d) + align16(work);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int src_bytes = fill ? 16 : 0;  // 0: write 16 zero bytes, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr), "l"(src),
               "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One 16-byte chunk of shared memory as floats.
__device__ __forceinline__ void load_chunk(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}

__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, float* out) {
  union { uint4 u; __nv_bfloat162 h[4]; } x;
  x.u = *reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(x.h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <typename TQ, typename TKV, int kGw, int kPNC>
__global__ void __launch_bounds__(kThreads, 2) decode_attention_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k, const TKV* __restrict__ v,
    const int32_t* __restrict__ t_ptr, TQ* __restrict__ out, int C, int kv, int G, int d,
    int window, float softcap, float sqrt_d) {
  constexpr int kVec = 16 / sizeof(TKV);
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int H = kv * G;
  const int GD = G * d;
  const Geometry geo = geometry(G, d, sizeof(TKV));
  const float inv_sqrt_d = 1.f / sqrt_d;
  const float inv_softcap = softcap > 0.f ? 1.f / softcap : 0.f;

  extern __shared__ __align__(16) unsigned char smem[];
  // The CTA's partial, read by the cluster: acc [G][d] first (16-byte
  // aligned: it holds q in float32 while the tiles are consumed), then m, l.
  float* pacc = reinterpret_cast<float*>(smem);
  float* pm = pacc + G * d;
  float* pl = pm + G;
  float* qs = pacc;
  unsigned char* work = smem + partial_bytes(G, d);
  TKV* stages = reinterpret_cast<TKV*>(work);

  // This CTA's share of the readable positions [lo, t].  With none
  // (t < 0) every slot is walked with the score 0: the reference masks
  // all C scores to the same value, so its softmax is uniform over C.
  const int64_t t = *t_ptr;
  const bool none = t < 0;
  const int64_t span = window > 0 && window < C ? window : C;
  const int64_t n = none ? C : (t + 1 < span ? t + 1 : span);
  const int64_t lo = none ? 0 : t - n + 1;
  const int tile = geo.tile;
  int64_t per = (n + S - 1) / S;
  per = (per + tile - 1) / tile * tile;
  const int64_t first = static_cast<int64_t>(rank) * per;
  const int cnt = static_cast<int>(first < n ? (n - first < per ? n - first : per) : 0);
  const int s0 = cnt > 0 ? static_cast<int>((lo + first) % C) : 0;  // lo + first >= 0
  const int ntiles = (cnt + tile - 1) / tile;

  const int64_t slot_stride = static_cast<int64_t>(kv) * d;
  const TKV* kbase = k + (static_cast<int64_t>(b) * C * kv + h) * d;
  const TKV* vbase = v + (static_cast<int64_t>(b) * C * kv + h) * d;
  const int row_chunks = geo.chunks;

  // Each thread copies one 16-byte chunk of rows j0, j0 + row_step, ...
  // of every tile (computed once: no division per tile).
  const int row_step = kThreads / row_chunks;
  const int j0 = tid / row_chunks;
  const int off0 = (tid - j0 * row_chunks) * kVec;
  auto load_tile = [&](int it) {
    if (it < ntiles) {
      TKV* ks = stages + (it % kStages) * 2 * tile * d;
      TKV* vs = ks + tile * d;
      if (j0 < row_step) {
        for (int j = j0; j < tile; j += row_step) {
          const int pos = it * tile + j;  // offset into this CTA's share
          const bool fill = pos < cnt;
          int slot = s0 + pos;
          if (slot >= C) slot -= C;
          const int64_t g_off = fill ? slot * slot_stride + off0 : 0;
          cp_async16(ks + j * d + off0, kbase + g_off, fill);
          cp_async16(vs + j * d + off0, vbase + g_off, fill);
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load_tile(s);

  const TQ* qrow = q + (static_cast<int64_t>(b) * H + h * G) * d;
  for (int i = tid; i < GD; i += kThreads) qs[i] = to_f32(qrow[i]);  // visible after the first tile's barrier

  // Warp roles: reader group rgi (readers g0 .. g0+kGw-1, clamped to G-1
  // where G is not a multiple of kGw), slot warp sgi (slots base ..
  // base+spw-1 of each tile).
  const int rgi = warp % geo.rg;
  const int sgi = warp / geo.rg;
  const bool active = sgi < geo.sg;
  const int g0 = rgi * kGw;
  const int base = sgi * geo.spw;
  const int li = lane & (geo.lps - 1);      // score phase: lane in its slot's sub-group
  const int gi = lane / geo.lps;            // score phase: sub-group
  const int pli = lane & (geo.pv_lps - 1);  // P.V phase: lane in its slot's sub-group
  const int pgi = lane / geo.pv_lps;        // P.V phase: sub-group
  const float* qg[kGw];
#pragma unroll
  for (int g = 0; g < kGw; ++g) qg[g] = qs + min(g0 + g, G - 1) * d;

  float acc[kGw][kPNC * kVec];
  float m[kGw];
  float l[kGw];
#pragma unroll
  for (int g = 0; g < kGw; ++g) {
    m[g] = neg_inf();
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kPNC * kVec; ++e) acc[g][e] = 0.f;
  }

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile i have landed
    __syncthreads();               // everyone's have; tile i-1's stage is free
    load_tile(i + kStages - 1);
    if (!active) continue;
    const TKV* ks = stages + (i % kStages) * 2 * tile * d;
    const TKV* vs = ks + tile * d;
    const int rows = min(tile, cnt - i * tile);

    // Scores of this warp's slots: sub-group gi scores slot
    // base + r * subs + gi in round r, for all kGw readers at once.
    float s[kMaxRounds][kGw];
#pragma unroll
    for (int r = 0; r < kMaxRounds; ++r) {
      if (r < geo.rounds) {
        const int j = base + r * geo.subs + gi;
        float part[kGw];
#pragma unroll
        for (int g = 0; g < kGw; ++g) part[g] = 0.f;
#pragma unroll
        for (int nn = 0; nn < kScoreChunks; ++nn) {
          const int c = li + geo.lps * nn;
          if (!none && c < row_chunks) {  // t < 0: no q.k, every score is 0
            float kf[kVec];
            load_chunk(ks + j * d + c * kVec, kf);
#pragma unroll
            for (int g = 0; g < kGw; ++g) {
              float qf[kVec];
#pragma unroll
              for (int e = 0; e < kVec; e += 4) load_chunk(qg[g] + c * kVec + e, qf + e);
#pragma unroll
              for (int e = 0; e < kVec; ++e) part[g] += qf[e] * kf[e];
            }
          }
        }
#pragma unroll
        for (int g = 0; g < kGw; ++g) {
          float x = part[g];
          for (int o = geo.lps >> 1; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
          x *= inv_sqrt_d;
          if (softcap > 0.f) x = softcap * tanhf(x * inv_softcap);
          s[r][g] = j < rows ? x : neg_inf();
        }
      }
    }

    // Online softmax over the warp's slots of this tile: one max and one
    // sum across the sub-groups per reader; s becomes the weights.
    float alpha[kGw];
#pragma unroll
    for (int g = 0; g < kGw; ++g) {
      float mx = neg_inf();
#pragma unroll
      for (int r = 0; r < kMaxRounds; ++r)
        if (r < geo.rounds) mx = fmaxf(mx, s[r][g]);
      for (int o = geo.lps; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[g], mx);
      alpha[g] = m_new == m[g] ? 1.f : expf(m[g] - m_new);  // never -inf - (-inf)
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxRounds; ++r) {
        if (r < geo.rounds) {
          const float p = s[r][g] == neg_inf() ? 0.f : expf(s[r][g] - m_new);
          s[r][g] = p;
          sum += p;
        }
      }
      for (int o = geo.lps; o < 32; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[g] = l[g] * alpha[g] + sum;
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < kPNC * kVec; ++e) acc[g][e] *= alpha[g];
    }

    // P.V: sub-group pgi takes slot base + r * subs + jq + pgi, its weights
    // from the score sub-group that holds them.
#pragma unroll
    for (int r = 0; r < kMaxRounds; ++r) {
      if (r < geo.rounds) {
        for (int jq = 0; jq < geo.subs; jq += geo.pv_subs) {
          const int src = jq + pgi;
          const int j = base + r * geo.subs + src;
          float pj[kGw];
#pragma unroll
          for (int g = 0; g < kGw; ++g) pj[g] = __shfl_sync(0xffffffffu, s[r][g], src * geo.lps);
#pragma unroll
          for (int nn = 0; nn < kPNC; ++nn) {
            const int c = pli + geo.pv_lps * nn;
            if (c < row_chunks) {
              float vf[kVec];
              load_chunk(vs + j * d + c * kVec, vf);
#pragma unroll
              for (int g = 0; g < kGw; ++g)
#pragma unroll
                for (int e = 0; e < kVec; ++e) acc[g][nn * kVec + e] += pj[g] * vf[e];
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the stages and q are free: the warps' partials go there

  // One partial per warp: sum its P.V sub-groups (they share m and l).
#pragma unroll
  for (int g = 0; g < kGw; ++g)
#pragma unroll
    for (int e = 0; e < kPNC * kVec; ++e)
      for (int o = geo.pv_lps; o < 32; o <<= 1)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);

  const int ns = geo.sg;
  float* wm = reinterpret_cast<float*>(work);  // [ns][G]
  float* wl = wm + ns * G;                     // [ns][G]
  float* wacc = wl + ns * G;                   // [ns][G][d]
  if (active) {
#pragma unroll
    for (int g = 0; g < kGw; ++g) {
      const int gg = g0 + g;
      if (gg < G) {
        if (lane == 0) {
          wm[sgi * G + gg] = m[g];
          wl[sgi * G + gg] = l[g];
        }
        if (pgi == 0) {
#pragma unroll
          for (int nn = 0; nn < kPNC; ++nn) {
            const int c = pli + geo.pv_lps * nn;
            if (c < row_chunks) {
#pragma unroll
              for (int e = 0; e < kVec; ++e)
                wacc[(sgi * G + gg) * d + c * kVec + e] = acc[g][nn * kVec + e];
            }
          }
        }
      }
    }
  }
  __syncthreads();

  // The CTA's partial: merge its warps.
  for (int i = tid; i < GD; i += kThreads) {
    const int g = i / d;
    float M = neg_inf();
    for (int w = 0; w < ns; ++w) M = fmaxf(M, wm[w * G + g]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < ns; ++w) {
      const float mw = wm[w * G + g];
      const float c = mw == neg_inf() ? 0.f : expf(mw - M);
      L += c * wl[w * G + g];
      A += c * wacc[(w * G + g) * d + (i - g * d)];
    }
    pacc[i] = A;
    if (i - g * d == 0) {
      pm[g] = M;
      pl[g] = L;
    }
  }
  cluster.sync();  // every CTA's partial is written and visible to the cluster

  // Merge the cluster's partials over distributed shared memory; rank r
  // writes outputs r*kThreads + tid, r*kThreads + tid + S*kThreads, ...
  TQ* orow = out + (static_cast<int64_t>(b) * H + h * G) * d;
  for (int i = rank * kThreads + tid; i < GD; i += S * kThreads) {
    const int g = i / d;
    float M = neg_inf();
    for (int r = 0; r < S; ++r) M = fmaxf(M, cluster.map_shared_rank(pm, r)[g]);
    float L = 0.f, A = 0.f;
    for (int r = 0; r < S; ++r) {
      const float* racc = cluster.map_shared_rank(pacc, r);  // acc, then m, then l
      const float mr = racc[GD + g];
      const float c = mr == neg_inf() ? 0.f : expf(mr - M);
      L += c * racc[GD + G + g];
      A += c * racc[i];
    }
    orow[i] = from_f32<TQ>(L > 0.f ? A / L : 0.f);
  }
  cluster.sync();  // no CTA leaves while another still reads its shared memory
}

// ---------------------------------------------------------------- host side
template <typename T> struct Type { using type = T; };
template <int N> struct Int { static constexpr int value = N; };

// Calls f(Type<TQ>, Type<TKV>, Int<kGw>, Int<kPNC>) for the instantiation
// that serves these dtypes and shape.
template <typename F>
cudaError_t dispatch(int q_dtype, int kv_dtype, int G, int d, F&& f) {
  const Geometry geo = geometry(G, d, kv_dtype == 0 ? 4 : 2);
  auto with_kv = [&](auto tq) -> cudaError_t {
    if (kv_dtype == 1) {
      if (geo.gw == 2) return f(tq, Type<__nv_bfloat16>{}, Int<2>{}, Int<1>{});
      return f(tq, Type<__nv_bfloat16>{}, Int<4>{}, Int<1>{});
    }
    if (kv_dtype == 0) {
      if (geo.gw == 2)
        return geo.pv_nc == 1 ? f(tq, Type<float>{}, Int<2>{}, Int<1>{})
                           : f(tq, Type<float>{}, Int<2>{}, Int<2>{});
      return geo.pv_nc == 1 ? f(tq, Type<float>{}, Int<4>{}, Int<1>{})
                         : f(tq, Type<float>{}, Int<4>{}, Int<2>{});
    }
    return cudaErrorInvalidValue;
  };
  if (q_dtype == 0) return with_kv(Type<float>{});
  if (q_dtype == 1) return with_kv(Type<__nv_bfloat16>{});
  return cudaErrorInvalidValue;
}

cudaLaunchConfig_t launch_config(int B, int kv, int splits, size_t smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, kv, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = splits;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

struct Plan {
  int splits;
  size_t smem;
  int tile;
};

// Per instantiation: shared-memory opt-in, the non-portable cluster size,
// and the split chosen for each shape (computed once, then looked up).
template <typename TQ, typename TKV, int kGw, int kPNC>
struct Planner {
  std::mutex mu;
  size_t opted_in = 48 * 1024;
  int nonportable = -1;  // -1 unknown, 0 refused, 1 granted
  std::map<std::array<int, 5>, Plan> plans;

  static Planner& get() {
    static Planner p;
    return p;
  }

  // Picks the cluster size S minimising waves / S, where waves is the
  // number of rounds of resident clusters the B*kv clusters need: each
  // CTA's work is 1/S of the span.  S is at most half the span's tiles
  // (so each CTA keeps kStages - 1 tiles in flight) and ties go to the
  // smaller S (less merging).
  cudaError_t plan(int B, int C, int kv, int G, int d, int window, Plan* out) {
    auto kernel = decode_attention_kernel<TQ, TKV, kGw, kPNC>;
    const std::array<int, 5> key{B, kv, G, d, window > 0 && window < C ? window : C};
    std::lock_guard<std::mutex> lock(mu);
    auto it = plans.find(key);
    if (it != plans.end()) {
      *out = it->second;
      return cudaSuccess;
    }
    const size_t smem = smem_bytes(G, d, sizeof(TKV));
    if (smem > opted_in) {
      cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
      if (e != cudaSuccess) return e;
      opted_in = smem;
    }
    if (nonportable < 0) {
      cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      nonportable = e == cudaSuccess ? 1 : 0;
      if (e != cudaSuccess) (void)cudaGetLastError();  // refused: clusters stay at <= 8
    }
    const int tile = geometry(G, d, sizeof(TKV)).tile;
    const int tiles = (key[4] + tile - 1) / tile;
    const int max_splits = tiles / (kStages - 1) > 1 ? tiles / (kStages - 1) : 1;
    const double work = static_cast<double>(B) * kv;
    Plan best{0, smem, tile};
    double best_cost = 0.0;
    for (int s = 1; s <= kMaxSplits && s <= max_splits; s *= 2) {
      if (s > 8 && nonportable != 1) break;
      cudaLaunchAttribute attr;
      cudaLaunchConfig_t cfg = launch_config(B, kv, s, smem, nullptr, &attr);
      int clusters = 0;
      cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
      if (e != cudaSuccess) {
        if (s > 8) {  // the non-portable size was granted but does not fit
          (void)cudaGetLastError();
          break;
        }
        return e;
      }
      if (clusters <= 0) continue;
      const double waves = static_cast<double>(static_cast<int64_t>((work + clusters - 1) / clusters));
      const double cost = waves / s;
      if (best.splits == 0 || cost < best_cost * (1.0 - 1e-9)) {
        best.splits = s;
        best_cost = cost;
      }
    }
    if (best.splits == 0) return cudaErrorInvalidConfiguration;  // not even one cluster fits
    plans[key] = best;
    *out = best;
    return cudaSuccess;
  }
};

}  // namespace

extern "C" {

int decode_attention_max_readers() { return kMaxG; }
int decode_attention_max_head_dim() { return kMaxD; }

// Dynamic shared memory of one CTA; kv_elt is the byte size of a K/V element.
size_t decode_attention_smem_bytes(int G, int d, int kv_elt) { return smem_bytes(G, d, kv_elt); }

// The cluster size, shared memory per CTA and ring slots per stage that a
// launch at this shape uses (chosen on the first call, then cached).
int decode_attention_plan(int B, int C, int kv, int G, int d, int window, int q_dtype,
                          int kv_dtype, int* splits, size_t* smem, int* tile) {
  Plan p{0, 0, 0};
  cudaError_t e = dispatch(q_dtype, kv_dtype, G, d, [&](auto tq, auto tkv, auto gw, auto nc) {
    using TQ = typename decltype(tq)::type;
    using TKV = typename decltype(tkv)::type;
    return Planner<TQ, TKV, decltype(gw)::value, decltype(nc)::value>::get().plan(
        B, C, kv, G, d, window, &p);
  });
  *splits = p.splits;
  *smem = p.smem;
  *tile = p.tile;
  return static_cast<int>(e);
}

// dtype codes: 0 = float32, 1 = bfloat16.  q/out [B, kv*G, d], k/v
// [B, C, kv, d], all contiguous and 16-byte aligned; t is a device pointer
// to one int32.  The caller checks G <= kMaxG, d <= kMaxD and d * elt % 16.
// A refused shared-memory opt-in or cluster launch returns its CUDA error.
int decode_attention_launch(const void* q, const void* k, const void* v, const void* t,
                            void* out, int B, int C, int kv, int G, int d, int window,
                            float softcap, int q_dtype, int kv_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dispatch(q_dtype, kv_dtype, G, d, [&](auto tq, auto tkv, auto gw, auto nc) {
    using TQ = typename decltype(tq)::type;
    using TKV = typename decltype(tkv)::type;
    constexpr int kGw = decltype(gw)::value;
    constexpr int kPNC = decltype(nc)::value;
    Plan p;
    cudaError_t pe = Planner<TQ, TKV, kGw, kPNC>::get().plan(B, C, kv, G, d, window, &p);
    if (pe != cudaSuccess) return pe;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = launch_config(B, kv, p.splits, p.smem, s, &attr);
    cudaError_t le = cudaLaunchKernelEx(
        &cfg, decode_attention_kernel<TQ, TKV, kGw, kPNC>, static_cast<const TQ*>(q),
        static_cast<const TKV*>(k), static_cast<const TKV*>(v), static_cast<const int32_t*>(t),
        static_cast<TQ*>(out), C, kv, G, d, window, softcap, sqrtf(static_cast<float>(d)));
    if (le != cudaSuccess) {
      (void)cudaGetLastError();
      return le;
    }
    return cudaGetLastError();
  });
  return static_cast<int>(e);
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
