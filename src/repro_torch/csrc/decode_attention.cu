// Multi-reader GQA decode attention over the MRB ring KV cache.
//
// Replaces src/repro/kernels/decode_attention.py::mrb_decode_attention.
// The plain version with the same contract is
// repro_torch/kernels/ref.py::decode_attention_ref.
//
// What it computes.  q [B, H, d], K/V rings [B, C, kv, d], H = kv * G.
// For batch row b and kv head h, the G query heads h*G .. h*G+G-1 are the
// readers of ring (b, h).  Slot s holds absolute position
// p = t - ((t - s) mod C) (floored mod) and is valid iff p >= 0 and, when
// window > 0, p > t - window.  Scores are q.k / sqrt(d), soft-capped as
// cap * tanh(s / cap) when cap > 0, then masked; softmax over the valid
// slots; out = P.V in q's type, everything in between in float32.
//
// What bounds it.  Bytes: K and V are 2*B*C*kv*d elements and each is
// used for about 2*G flops, far below the card's ~295 flop/byte ridge.
// The paper's design point is kept: one CTA per (b, kv head) stages each
// K/V tile in shared memory ONCE and all G readers consume it there, so
// device-memory traffic is that of one reader, not G.  The CTA walks the
// capacity in tiles of kTile slots with an online softmax whose running
// (m, l) and the G x d accumulators stay in float32 (m, l in shared
// memory, the accumulators in registers: each thread owns (reader, dim)
// pairs).  t is read from device memory, so the ring state never leaves
// the card; window is a runtime int (0 = no window test).  The last tile
// may be ragged: any C >= 1 is taken, no C % tile requirement.
//
// Invalid slots get exactly zero weight: the running max starts at -inf,
// a tile with no valid slot seen so far leaves (m, l, acc) untouched, and
// masked slots contribute exp(-inf) = 0 rather than a sentinel weight
// that a later rescale has to erase.
//
// Deliberately simple: no split over the capacity (a (b, h) pair is one
// CTA, so B*kv CTAs fill the card only at large batch), no overlap of the
// next tile's loads with this tile's math, no tensor cores.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;              // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                  // ring slots per shared-memory tile
constexpr int kMaxG = 16;                  // readers per kv head
constexpr int kMaxD = 256;                 // head dim
constexpr int kMaxPairs = kMaxG * kMaxD / kThreads;  // (reader, dim) pairs per thread

__device__ __forceinline__ float neg_inf() { return __int_as_float(static_cast<int>(0xff800000u)); }

using repro_torch::floor_mod;
using repro_torch::from_f32;
using repro_torch::to_f32;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Floats ahead of the K/V tiles: q [G][d], scores/probabilities [G][kTile],
// running max, running sum and this tile's rescale, [G] each.
__host__ __device__ inline size_t float_region_bytes(int G, int d) {
  size_t bytes = sizeof(float) * (static_cast<size_t>(G) * d + G * kTile + 3 * G);
  return (bytes + 15) / 16 * 16;
}

__host__ __device__ inline size_t smem_bytes(int G, int d, int kv_elt) {
  return float_region_bytes(G, d) + 2 * static_cast<size_t>(kTile) * d * kv_elt;
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k, const TKV* __restrict__ v,
    const int32_t* __restrict__ t_ptr, TQ* __restrict__ out, int C, int kv, int G, int d,
    int window, float softcap, float sqrt_d) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ps = qs + G * d;
  float* ms = ps + G * kTile;
  float* ls = ms + G;
  float* as = ls + G;
  TKV* ks = reinterpret_cast<TKV*>(smem + float_region_bytes(G, d));
  TKV* vs = ks + kTile * d;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int H = kv * G;
  const int GD = G * d;
  const int t = *t_ptr;

  const TQ* qrow = q + (static_cast<int64_t>(b) * H + h * G) * d;  // G rows of d
  for (int i = tid; i < GD; i += kThreads) qs[i] = to_f32(qrow[i]);
  if (tid < G) {
    ms[tid] = neg_inf();
    ls[tid] = 0.f;
  }

  float acc[kMaxPairs];
#pragma unroll
  for (int p = 0; p < kMaxPairs; ++p) acc[p] = 0.f;

  constexpr int kVec = 16 / sizeof(TKV);   // elements per 16-byte load
  const int row_vecs = d / kVec;
  const int64_t slot_stride = static_cast<int64_t>(kv) * d;  // elements between slots
  const TKV* kbase = k + (static_cast<int64_t>(b) * C * kv + h) * d;
  const TKV* vbase = v + (static_cast<int64_t>(b) * C * kv + h) * d;
  __syncthreads();

  for (int tile0 = 0; tile0 < C; tile0 += kTile) {
    const int n = min(kTile, C - tile0);

    // Stage the tile of K and V once; every reader below uses these copies.
    for (int c = tid; c < n * row_vecs; c += kThreads) {
      const int j = c / row_vecs;
      const int off = (c - j * row_vecs) * kVec;
      const int64_t g_off = (tile0 + j) * slot_stride + off;
      *reinterpret_cast<uint4*>(ks + j * d + off) = *reinterpret_cast<const uint4*>(kbase + g_off);
      *reinterpret_cast<uint4*>(vs + j * d + off) = *reinterpret_cast<const uint4*>(vbase + g_off);
    }
    __syncthreads();

    // Scores: one warp per slot, lanes split d, all G readers at once.
    for (int j = warp; j < n; j += kWarps) {
      float part[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) part[g] = 0.f;
      for (int dd = lane; dd < d; dd += 32) {
        const float kf = to_f32(ks[j * d + dd]);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) part[g] += qs[g * d + dd] * kf;
      }
      const int slot = tile0 + j;
      const int pos = t - floor_mod(t - slot, C);
      const bool valid = pos >= 0 && (window <= 0 || pos > t - window);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          float s = warp_sum(part[g]);
          if (lane == g) {
            s = s / sqrt_d;
            if (softcap > 0.f) s = softcap * tanhf(s / softcap);
            ps[g * kTile + j] = valid ? s : neg_inf();
          }
        }
      }
    }
    __syncthreads();

    // Online softmax: one warp per reader.
    for (int g = warp; g < G; g += kWarps) {
      float mx = neg_inf();
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, ps[g * kTile + j]);
      mx = warp_max(mx);
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, mx);
      float alpha = 1.f;
      float sum = 0.f;
      if (m_new == neg_inf()) {  // nothing valid yet: zero weights, no rescale
        for (int j = lane; j < n; j += 32) ps[g * kTile + j] = 0.f;
      } else {
        alpha = expf(m_old - m_new);
        for (int j = lane; j < n; j += 32) {
          const float s = ps[g * kTile + j];
          const float p = (s == neg_inf()) ? 0.f : expf(s - m_new);
          ps[g * kTile + j] = p;
          sum += p;
        }
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        ms[g] = m_new;
        ls[g] = ls[g] * alpha + sum;
        as[g] = alpha;
      }
    }
    __syncthreads();

    // P.V: each thread owns (reader, dim) pairs i = tid + p * kThreads.
#pragma unroll
    for (int p = 0; p < kMaxPairs; ++p) {
      const int i = tid + p * kThreads;
      if (i < GD) {
        const int g = i / d;
        const int dd = i - g * d;
        const float* pg = ps + g * kTile;
        float a = acc[p] * as[g];
        for (int j = 0; j < n; ++j) a += pg[j] * to_f32(vs[j * d + dd]);
        acc[p] = a;
      }
    }
    __syncthreads();
  }

  TQ* orow = out + (static_cast<int64_t>(b) * H + h * G) * d;
#pragma unroll
  for (int p = 0; p < kMaxPairs; ++p) {
    const int i = tid + p * kThreads;
    if (i < GD) {
      const float l = ls[i / d];
      orow[i] = from_f32<TQ>(l > 0.f ? acc[p] / l : 0.f);
    }
  }
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* t, void* out, int B,
                   int C, int kv, int G, int d, int window, float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes(G, d, sizeof(TKV));
  static size_t opted_in = 48 * 1024;  // per instantiation: the largest size allowed so far
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(decode_attention_kernel<TQ, TKV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    opted_in = smem;
  }
  dim3 grid(kv, B);
  decode_attention_kernel<TQ, TKV><<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<const int32_t*>(t), static_cast<TQ*>(out), C, kv, G, d, window, softcap,
      sqrtf(static_cast<float>(d)));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int decode_attention_max_readers() { return kMaxG; }
int decode_attention_max_head_dim() { return kMaxD; }

// Dynamic shared memory of one CTA; kv_elt is the byte size of a K/V element.
size_t decode_attention_smem_bytes(int G, int d, int kv_elt) { return smem_bytes(G, d, kv_elt); }

// dtype codes: 0 = float32, 1 = bfloat16.  q/out [B, kv*G, d], k/v
// [B, C, kv, d], all contiguous and 16-byte aligned; t is a device pointer
// to one int32.  The caller checks G <= kMaxG, d <= kMaxD and d * elt % 16.
int decode_attention_launch(const void* q, const void* k, const void* v, const void* t,
                            void* out, int B, int C, int kv, int G, int d, int window,
                            float softcap, int q_dtype, int kv_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float, float>(q, k, v, t, out, B, C, kv, G, d, window, softcap, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch<float, __nv_bfloat16>(q, k, v, t, out, B, C, kv, G, d, window, softcap, s);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch<__nv_bfloat16, float>(q, k, v, t, out, B, C, kv, G, d, window, softcap, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, t, out, B, C, kv, G, d, window,
                                                softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
