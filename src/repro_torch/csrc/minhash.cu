// Raw minwise minima for Hopper (sm_90a).
//
// B3 minhash replaces src/repro/kernels/minhash.py::minhash_pallas.
//   out[i, j] = the min over row i's first nnz ids t of fmix32(a_j*t + b_j),
//   compared as uint32_t, for j < k; 0xFFFFFFFF for a row with no id.
//   uint32 (n, k), row stride k.
// Bound: 32-bit integer ALU work, about 10 operations per (nonzero, lane)
//   pair -- n*nnz*k hashes; the ids are read once from device memory (L2
//   serves the ceil(k/32) blocks of a row) and 4*k bytes a row written.
// Design: B1's hash loop (encode.cuh::minhash_block, one body for both): a
//   block owns 32 hash lanes of one row, 8 warps split the row's ids staged
//   in shared memory, minima in registers.  Instead of B1's mask and pack,
//   the first warp writes its 32 raw words, coalesced, for the live lanes
//   j < k only: the TPU kernel pads k to 128 lanes with a=1, b=0 and slices;
//   here the last chunk (20 live lanes at k=500) does no work for the rest
//   and the output has row stride k.
#include "encode.cuh"

namespace repro_torch {
namespace {

__global__ void __launch_bounds__(kLanes * kSlices)
minhash_kernel(const int32_t* __restrict__ idx,
               const int32_t* __restrict__ nnz,
               const uint32_t* __restrict__ a,
               const uint32_t* __restrict__ b,
               uint32_t* __restrict__ out, int m, int k) {
  __shared__ MinhashSmem sm;
  __shared__ uint32_t mins[kLanes];
  minhash_block(idx, nnz, a, b, m, k, sm, mins);
  const int j = blockIdx.y * kLanes + threadIdx.x;
  if (threadIdx.x < kLanes && j < k) {
    out[static_cast<size_t>(blockIdx.x) * k + j] = mins[threadIdx.x];
  }
}

}  // namespace
}  // namespace repro_torch

using repro_torch::kLanes;
using repro_torch::kSlices;

extern "C" int repro_minhash(const void* idx, const void* nnz, const void* a,
                             const void* b, void* out, int n, int m, int k,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0 || k == 0) return 0;
  const dim3 grid(n, (k + kLanes - 1) / kLanes);
  repro_torch::minhash_kernel<<<grid, kLanes * kSlices, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(nnz),
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(out), m, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_minhash_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
