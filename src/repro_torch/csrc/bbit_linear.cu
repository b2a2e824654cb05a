// Packed-input b-bit linear forward for Hopper (sm_90a).
//
// B5 bbit_linear_packed_fwd replaces
// src/repro/kernels/bbit_linear.py::bbit_linear_packed_fwd_pallas:
//   logits[n, c] = sum_j W[j, code(n, j), c], the codes unpacked in
//   registers from the LSB-first packed row, bins marked in the optional
//   MSB-first empty mask skipped.
// Bound: device-memory bytes -- the packed rows, the mask and the table
//   entries the codes select, each read once; one float add per
//   (row, bin, class).  Design: a gather-sum like an embedding bag, one warp
//   per row, lanes over the k bins.  The TPU kernel's one-hot MXU
//   contraction streams the whole (k, 2^b, C) table per row block; here each
//   lane reads only the entries its codes select, through L2 (at k=256, b=8
//   the table is 256*C KB, more than a block's shared memory).  Each lane
//   sums its bins in order and the warp reduces in a fixed shuffle tree,
//   with no float atomics, so a row's logits are the same bits on every run.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kRowsPerBlock = 8;   // one warp per row

__global__ void __launch_bounds__(kRowsPerBlock * 32)
bbit_linear_packed_fwd_kernel(const uint8_t* __restrict__ packed,
                              const float* __restrict__ w,
                              const uint8_t* __restrict__ empty,
                              float* __restrict__ out,
                              int n, int k, int bits, int v, int c,
                              int p_w, int e_w) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // whole warp: row is uniform across it
  const uint8_t* prow = packed + static_cast<size_t>(row) * p_w;
  const uint8_t* erow =
      empty == nullptr ? nullptr : empty + static_cast<size_t>(row) * e_w;
  const int per = 8 / bits;
  const uint32_t mask = (1u << bits) - 1u;
  for (int cc = 0; cc < c; ++cc) {
    float acc = 0.f;
    for (int j = lane; j < k; j += 32) {
      if (erow != nullptr && ((erow[j >> 3] >> (7 - (j & 7))) & 1)) continue;
      const uint32_t code = (prow[j / per] >> ((j % per) * bits)) & mask;
      acc += w[(static_cast<size_t>(j) * v + code) * c + cc];
    }
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_down_sync(0xFFFFFFFFu, acc, off);
    }
    if (lane == 0) out[static_cast<size_t>(row) * c + cc] = acc;
  }
}

}  // namespace
}  // namespace repro_torch

using repro_torch::kRowsPerBlock;

extern "C" int repro_bbit_linear_packed_fwd(const void* packed, const void* w,
                                            const void* empty, void* out,
                                            int n, int k, int bits, int v,
                                            int c, int p_w, int e_w,
                                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  repro_torch::bbit_linear_packed_fwd_kernel<<<
      blocks, kRowsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), static_cast<const float*>(w),
      static_cast<const uint8_t*>(empty), static_cast<float*>(out), n, k,
      bits, v, c, p_w, e_w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_bbit_linear_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
