// Raw one-permutation-hashing bin minima for Hopper (sm_90a).
//
// B4 oph replaces src/repro/kernels/oph.py::oph_pallas.
//   h = fmix32(a*t + b) once per nonzero of row i's first nnz ids; bin =
//   h >> (32 - log2 k), k a power of two; out[i, j] = the min of h over bin
//   j, compared as uint32_t, 0xFFFFFFFF for an empty bin.  No densify: the
//   caller densifies or zero-codes.  uint32 (n, k).
// Bound: device-memory bytes -- 4 per nonzero read once and 4*k per row
//   written; about 11 integer operations per nonzero.
// Design: B2's scatter (encode.cuh::oph_block, one body for both): one block
//   per row holds its k bins in shared memory, threads stride over the ids
//   (coalesced) and atomicMin into the bins, exact in any order.  Where the
//   TPU compares every nonzero with a k-lane iota (O(nnz*k) selects per
//   row), this is one shared-memory atomic per nonzero.  Then the block
//   writes its k words, coalesced.
#include "encode.cuh"

namespace repro_torch {
namespace {

__global__ void __launch_bounds__(kOphThreads)
oph_kernel(const int32_t* __restrict__ idx, const int32_t* __restrict__ nnz,
           const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
           uint32_t* __restrict__ out, int m, int k, int shift) {
  extern __shared__ uint32_t bins[];  // k words
  oph_block(idx, nnz, a[0], b[0], m, k, shift, bins);
  uint32_t* row = out + static_cast<size_t>(blockIdx.x) * k;
  for (int j = threadIdx.x; j < k; j += blockDim.x) row[j] = bins[j];
}

}  // namespace
}  // namespace repro_torch

using repro_torch::kOphThreads;

extern "C" int repro_oph(const void* idx, const void* nnz, const void* a,
                         const void* b, void* out, int n, int m, int k,
                         int shift, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  const size_t smem = static_cast<size_t>(k) * sizeof(uint32_t);
  err = repro_torch::allow_smem(repro_torch::oph_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  repro_torch::oph_kernel<<<n, kOphThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(nnz),
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(out), m, k, shift);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_oph_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
