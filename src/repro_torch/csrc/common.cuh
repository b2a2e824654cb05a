// Shared helpers for the port's kernels (built for sm_90a by kernels/_build.py).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro_torch {

constexpr uint32_t kSentinel = 0xFFFFFFFFu;

// Murmur3 finalizer; the same word as core/universal_hash.py::fmix32.
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// Opts a kernel in to `bytes` of dynamic shared memory above the 48 KiB
// default; cudaSuccess when nothing was needed or it worked.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro_torch
