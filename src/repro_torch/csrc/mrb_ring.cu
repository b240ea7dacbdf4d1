// MRB ring append: write one token into slot omega of a KV ring, in place.
//
// Replaces src/repro/kernels/mrb_ring.py::mrb_append.  The plain version
// with the same contract is repro_torch/kernels/ref.py::mrb_append_ref.
//
// The TPU kernel scalar-prefetches omega, brings the whole (block, H, d)
// capacity tile that holds slot omega into VMEM, overwrites one row and
// writes the tile back through an aliased output.  Here a block loads its
// own index: omega is read from device memory (no host round trip, so the
// ring state never leaves the card) and brought into [0, C) as
// dynamic_update_slice does (a negative index counts from the end, then
// clamp), and the block copies its batch row's
// H*d token elements into buf[b, omega] and nothing else.  The buffer is
// updated in place; no other slot is read or written.
//
// What bounds it.  It moves 2*B*H*d elements (a few KB to a few hundred
// KB), well under a microsecond at 3.35 TB/s: it is bound by launch
// latency.  The design keeps it to one launch per write with grid (B,
// ceil(H*d / (threads*vec))) so a wide token still spreads over SMs.
//
// Any C >= 1 works: the TPU kernel's C % block assert is a tiling
// constraint that a one-slot write does not have.  The token is cast to
// the buffer's type (float32 and bfloat16, either way round).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

using repro_torch::from_f32;
using repro_torch::to_f32;

template <typename TB, typename TT>
__global__ void mrb_append_kernel(TB* __restrict__ buf, const int32_t* __restrict__ omega,
                                  const TT* __restrict__ token, int C, int row) {
  const int b = blockIdx.x;
  int w = *omega;
  if (w < 0) w += C;
  w = w < 0 ? 0 : (w >= C ? C - 1 : w);
  TB* dst = buf + (static_cast<int64_t>(b) * C + w) * row;
  const TT* src = token + static_cast<int64_t>(b) * row;
  for (int i = blockIdx.y * blockDim.x + threadIdx.x; i < row; i += gridDim.y * blockDim.x) {
    dst[i] = from_f32<TB>(to_f32(src[i]));
  }
}

template <typename TB, typename TT>
cudaError_t launch(void* buf, const void* omega, const void* token, int B, int C, int row,
                   cudaStream_t stream) {
  const int chunks = (row + kThreads * 4 - 1) / (kThreads * 4);
  dim3 grid(B, chunks < 1 ? 1 : chunks);
  mrb_append_kernel<TB, TT><<<grid, kThreads, 0, stream>>>(
      static_cast<TB*>(buf), static_cast<const int32_t*>(omega),
      static_cast<const TT*>(token), C, row);
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

const char* mrb_ring_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
