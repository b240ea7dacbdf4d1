// MRB ring append: write one token into slot omega of a KV ring, in place;
// and the decode step's fused ring write: K and V into slot omega of their
// rings, then omega <- (omega + 1) mod C, in one launch.
//
// Replaces src/repro/kernels/mrb_ring.py::mrb_append, and also fuses the
// ring update of the reference's decode step
// (src/repro/models/layers.py::attention_decode, which writes K and V and
// sets "omega": (omega + 1) % C together).  The plain versions with the
// same contracts are repro_torch/kernels/ref.py::mrb_append_ref and
// ::mrb_append_kv_ref.
//
// The TPU kernel scalar-prefetches omega, brings the whole (block, H, d)
// capacity tile that holds slot omega into VMEM, overwrites one row and
// writes the tile back through an aliased output.  Here a block loads its
// own index: omega is read from device memory (no host round trip, so the
// ring state never leaves the card) and brought into [0, C) as
// dynamic_update_slice does (a negative index counts from the end, then
// clamp), and the block copies the B*H*d token elements into buf[:, omega]
// and nothing else.  The buffers are updated in place; no other slot is
// read or written.  Both entries run the same device routine, write_slot.
//
// What bounds it.  Not bytes: at the served shape (B=4, H=8, d=256, bf16)
// the fused launch reads and writes 2 x 16 KB, about 0.02 us at
// 3.35 TB/s.  The cost is the launch and the host's path to it, paid once
// per layer and step.  So:
// - One launch per layer.  The decode step used to make four: a K append,
//   a V append, then add_ and remainder_ on omega.  mrb_append_kv_kernel
//   does all of it.  It is one CTA of up to 1,024 threads with 16-byte
//   copies (8 elements a thread per pass): 32 KB is two passes.  Every
//   thread reads omega, copies, and after a __syncthreads() thread 0
//   writes floor_mod(omega + 1, C), so no thread reads omega after it has
//   moved.  A multi-CTA grid would need a last-block ticket (a fence, an
//   atomic on a counter kept between launches) to advance omega once; at
//   a few tens of KB the one CTA is not the limit, so it is not done.
// - A lean host path (kernels/mrb_ring.py): each wrapper runs its full
//   checks once per signature (shapes, strides, dtypes, device) and after
//   that only reads the pointers and the stream and makes the call.
//   Pointer alignment is not part of that signature, so the kernel picks
//   the 16-byte path or the element path itself, per launch.
//
// Any C >= 1 works: the TPU kernel's C % block assert is a tiling
// constraint that a one-slot write does not have.  The token is cast to
// the buffer's type (float32 and bfloat16, either way round); a token of
// the buffer's own type is copied bit for bit.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kVec = 8;             // elements per 16-byte store of bf16
constexpr int kThreads = 256;       // single-tensor append: threads per CTA
constexpr int kMaxThreads = 1024;   // fused append: its one CTA

using repro_torch::floor_mod;
using repro_torch::from_f32;
using repro_torch::to_f32;

// omega brought into [0, C) as dynamic_update_slice does.
__device__ __forceinline__ int ring_slot(int w, int C) {
  if (w < 0) w += C;
  return w < 0 ? 0 : (w >= C ? C - 1 : w);
}

__device__ __forceinline__ void load8(const float* p, float (&x)[kVec]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    x[2 * j] = f.x;
    x[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&x)[kVec]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&x)[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(x[2 * j], x[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// buf[b, w, :] = token[b, 0, :] for every batch row b (row = H * d
// elements), work item i of `step` starting at `first`.  A work item is
// kVec elements when both sides allow 16-byte accesses, else one element.
template <typename TB, typename TT>
__device__ __forceinline__ void write_slot(TB* __restrict__ buf, const TT* __restrict__ token,
                                           int B, int C, int row, int w, int first, int step) {
  const bool vec = row % kVec == 0 && reinterpret_cast<uintptr_t>(buf) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(token) % 16 == 0;
  if (vec) {
    const int per_row = row / kVec;
    const int n = B * per_row;
    for (int c = first; c < n; c += step) {
      const int b = c / per_row;
      const int i = (c - b * per_row) * kVec;
      TB* dst = buf + (static_cast<int64_t>(b) * C + w) * row + i;
      const TT* src = token + static_cast<int64_t>(b) * row + i;
      if constexpr (std::is_same<TB, TT>::value) {
#pragma unroll
        for (int j = 0; j < static_cast<int>(sizeof(TB)) * kVec / 16; ++j)
          reinterpret_cast<uint4*>(dst)[j] = reinterpret_cast<const uint4*>(src)[j];
      } else {
        float x[kVec];
        load8(src, x);
        store8(dst, x);
      }
    }
  } else {
    const int64_t n = static_cast<int64_t>(B) * row;
    for (int64_t e = first; e < n; e += step) {
      const int64_t b = e / row;
      buf[(b * C + w) * row + (e - b * row)] = from_f32<TB>(to_f32(token[e]));
    }
  }
}

template <typename TB, typename TT>
__global__ void mrb_append_kernel(TB* __restrict__ buf, const int32_t* __restrict__ omega,
                                  const TT* __restrict__ token, int B, int C, int row) {
  write_slot(buf, token, B, C, row, ring_slot(*omega, C),
             blockIdx.x * blockDim.x + threadIdx.x, gridDim.x * blockDim.x);
}

template <typename TB, typename TT>
__global__ void __launch_bounds__(kMaxThreads) mrb_append_kv_kernel(
    TB* __restrict__ buf_k, TB* __restrict__ buf_v, int32_t* __restrict__ omega,
    const TT* __restrict__ k, const TT* __restrict__ v, int B, int C, int row) {
  const int raw = *omega;
  const int w = ring_slot(raw, C);
  write_slot(buf_k, k, B, C, row, w, threadIdx.x, blockDim.x);
  write_slot(buf_v, v, B, C, row, w, threadIdx.x, blockDim.x);
  __syncthreads();  // every thread has read omega before it moves
  if (threadIdx.x == 0) {
    // (omega + 1) % C of the reference: int32 wraps, the modulo is floored
    *omega = floor_mod(static_cast<int>(static_cast<unsigned>(raw) + 1u), C);
  }
}

int work_items(int B, int row) {
  return row % kVec == 0 ? B * (row / kVec) : B * row;
}

template <typename TB, typename TT>
cudaError_t launch(void* buf, const void* omega, const void* token, int B, int C, int row,
                   cudaStream_t stream) {
  const int blocks = (work_items(B, row) + kThreads - 1) / kThreads;
  mrb_append_kernel<TB, TT><<<blocks < 1 ? 1 : blocks, kThreads, 0, stream>>>(
      static_cast<TB*>(buf), static_cast<const int32_t*>(omega),
      static_cast<const TT*>(token), B, C, row);
  return cudaGetLastError();
}

template <typename TB, typename TT>
cudaError_t launch_kv(void* buf_k, void* buf_v, void* omega, const void* k, const void* v, int B,
                      int C, int row, cudaStream_t stream) {
  int threads = (work_items(B, row) + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  mrb_append_kv_kernel<TB, TT><<<1, threads, 0, stream>>>(
      static_cast<TB*>(buf_k), static_cast<TB*>(buf_v), static_cast<int32_t*>(omega),
      static_cast<const TT*>(k), static_cast<const TT*>(v), B, C, row);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16.  buf [B, C, H, d], token
// [B, 1, H, d], row = H * d; omega is a device pointer to one int32.
int mrb_append_launch(void* buf, const void* omega, const void* token, int B, int C, int row,
                      int buf_dtype, int token_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (buf_dtype == 0 && token_dtype == 0) return launch<float, float>(buf, omega, token, B, C, row, s);
  if (buf_dtype == 0 && token_dtype == 1)
    return launch<float, __nv_bfloat16>(buf, omega, token, B, C, row, s);
  if (buf_dtype == 1 && token_dtype == 0)
    return launch<__nv_bfloat16, float>(buf, omega, token, B, C, row, s);
  if (buf_dtype == 1 && token_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(buf, omega, token, B, C, row, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The fused write: buf_k/buf_v [B, C, H, d] of one dtype, k/v [B, 1, H, d]
// of one dtype, omega advanced on the device.
int mrb_append_kv_launch(void* buf_k, void* buf_v, void* omega, const void* k, const void* v,
                         int B, int C, int row, int buf_dtype, int token_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (buf_dtype == 0 && token_dtype == 0)
    return launch_kv<float, float>(buf_k, buf_v, omega, k, v, B, C, row, s);
  if (buf_dtype == 0 && token_dtype == 1)
    return launch_kv<float, __nv_bfloat16>(buf_k, buf_v, omega, k, v, B, C, row, s);
  if (buf_dtype == 1 && token_dtype == 0)
    return launch_kv<__nv_bfloat16, float>(buf_k, buf_v, omega, k, v, B, C, row, s);
  if (buf_dtype == 1 && token_dtype == 1)
    return launch_kv<__nv_bfloat16, __nv_bfloat16>(buf_k, buf_v, omega, k, v, B, C, row, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* mrb_ring_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
