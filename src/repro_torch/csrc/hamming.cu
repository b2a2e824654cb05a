// Packed-code Hamming distances for Hopper (sm_90a).
//
// B10 hamming_distance replaces
//   src/repro/kernels/hamming.py::hamming_distance_pallas.
//   dist[i] = sum over the w bytes of popcount(cands[i, c] XOR query[c]),
//   int32 (n,), from a uint8 query (w,) and candidate rows (n, w).  Both
//   rows pad their last byte with zeros, so no bit is masked.
// Bound: device-memory bytes -- n*w read once, 4*n written; about 3
//   integer operations per 32-bit word.
// Design: the TPU kernel popcounts bytes with a SWAR ladder over (BN, W)
//   blocks.  Here one warp takes one candidate row: its lanes read the row
//   as 32-bit words (w % 4 == 0 and an aligned base) or as bytes otherwise,
//   coalesced, XOR them with the query held in shared memory, count with
//   __popc and fold the 32 partial counts with warp shuffles.  Integer sums,
//   exact in any order, so the distances equal hamming_distance_xla's.
//   Top-k stays outside the kernel, in the wrapper, as in the reference.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kHamWarps = 8;  // candidate rows per block

__global__ void __launch_bounds__(kHamWarps * 32)
hamming_kernel(const uint8_t* __restrict__ query,
               const uint8_t* __restrict__ cands, int32_t* __restrict__ out,
               int n, int w, int aligned) {
  extern __shared__ uint32_t qs[];  // ceil(w/4) words, zero padded
  const int nwords = (w + 3) / 4;
  for (int i = threadIdx.x; i < nwords; i += blockDim.x) {
    uint32_t v = 0;
    for (int t = 0; t < 4; ++t) {
      const int c = 4 * i + t;
      if (c < w) v |= static_cast<uint32_t>(query[c]) << (8 * t);
    }
    qs[i] = v;
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kHamWarps + threadIdx.x / 32;
  if (row >= n) return;
  const uint8_t* r = cands + static_cast<size_t>(row) * w;
  int acc = 0;
  if (aligned) {
    const uint32_t* rw = reinterpret_cast<const uint32_t*>(r);
    for (int i = lane; i < nwords; i += 32) acc += __popc(rw[i] ^ qs[i]);
  } else {
    const uint8_t* qb = reinterpret_cast<const uint8_t*>(qs);
    for (int c = lane; c < w; c += 32) {
      acc += __popc(static_cast<uint32_t>(r[c] ^ qb[c]));
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xFFFFFFFFu, acc, off);
  }
  if (lane == 0) out[row] = acc;
}

}  // namespace
}  // namespace repro_torch

using repro_torch::kHamWarps;

extern "C" int repro_hamming_distance(const void* query, const void* cands,
                                      void* out, int n, int w, int aligned,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  const size_t smem = static_cast<size_t>((w + 3) / 4) * sizeof(uint32_t);
  err = repro_torch::allow_smem(repro_torch::hamming_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kHamWarps - 1) / kHamWarps;
  repro_torch::hamming_kernel<<<blocks, kHamWarps * 32, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(query), static_cast<const uint8_t*>(cands),
      static_cast<int32_t*>(out), n, w, aligned);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_hamming_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
