// Packed-code Hamming distances for Hopper (sm_90a).
//
// B10 hamming_distance replaces
//   src/repro/kernels/hamming.py::hamming_distance_pallas.
//   dist[i] = sum over the w bytes of popcount(cands[i, c] XOR query[c]),
//   int32 (n,), from a uint8 query (w,) and candidate rows (n, w).  Both
//   rows pad their last byte with zeros, so no bit is masked.
// Bound: device-memory bytes -- n*w read once, 4*n written; about 3
//   integer operations per 32-bit word.  A typical search call scans a few
//   rows, so one launch and one memory round trip set its time.
// Design: the TPU kernel popcounts bytes with a SWAR ladder over (BN, W)
//   blocks.  Here L lanes take one candidate row (L a power of two up to
//   32, 32 / L rows a warp, and 1, 2 or 4 such groups a warp so that a
//   large scan fits the card's resident warps): each lane loads its words
//   of the rows and the same words of the query together, into registers
//   -- no shared memory and no barrier, so the loads overlap -- XORs them,
//   counts with __popc and the L partial counts fold with a shuffle tree.
//   The words are 16 bytes where w % 16 == 0 and both bases are 16-byte
//   aligned (a 256-byte row is 16 lanes, two rows a warp), 4 bytes where
//   w % 4 == 0 and both are 4-byte aligned, else bytes.  Integer sums, exact in any
//   order, so the distances equal hamming_distance_xla's.  Top-k stays
//   outside the kernel, in the wrapper, as in the reference.
#include "common.cuh"

namespace repro_torch {
namespace {

__device__ __forceinline__ int popc_xor(uint4 a, uint4 b) {
  return __popc(a.x ^ b.x) + __popc(a.y ^ b.y) + __popc(a.z ^ b.z) +
         __popc(a.w ^ b.w);
}
__device__ __forceinline__ int popc_xor(uint32_t a, uint32_t b) {
  return __popc(a ^ b);
}
__device__ __forceinline__ int popc_xor(uint8_t a, uint8_t b) {
  return __popc(static_cast<uint32_t>(a ^ b));
}

// grid (blocks); block (threads); `lanes` lanes a row, W the word type; a
// warp takes kReps groups of 32 / lanes rows, all their loads in flight.
template <typename W, int kReps>
__global__ void hamming_kernel(const W* __restrict__ query,
                               const W* __restrict__ cands,
                               int32_t* __restrict__ out, int n, int words,
                               int lanes) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int per_warp = 32 / lanes;
  const int first = warp * per_warp * kReps + lane / lanes;
  if (warp * per_warp * kReps >= n) return;  // the whole warp is past n
  const int part = lane & (lanes - 1);
  int acc[kReps];
#pragma unroll
  for (int k = 0; k < kReps; ++k) acc[k] = 0;
  for (int i = part; i < words; i += lanes) {
    const W q = query[i];
#pragma unroll
    for (int k = 0; k < kReps; ++k) {
      const int row = first + k * per_warp;
      if (row < n) {
        acc[k] += popc_xor(cands[static_cast<size_t>(row) * words + i], q);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kReps; ++k) {
    for (int off = lanes >> 1; off > 0; off >>= 1) {
      acc[k] += __shfl_xor_sync(0xFFFFFFFFu, acc[k], off);
    }
    const int row = first + k * per_warp;
    if (row < n && part == 0) out[row] = acc[k];
  }
}

template <typename W>
int launch(const void* query, const void* cands, void* out, int n, int w,
           int lanes, int reps, int threads, int blocks,
           cudaStream_t stream) {
  const auto* q = static_cast<const W*>(query);
  const auto* c = static_cast<const W*>(cands);
  auto* o = static_cast<int32_t*>(out);
  const int words = w / static_cast<int>(sizeof(W));
  switch (reps) {
    case 1:
      hamming_kernel<W, 1><<<blocks, threads, 0, stream>>>(q, c, o, n, words,
                                                           lanes);
      break;
    case 2:
      hamming_kernel<W, 2><<<blocks, threads, 0, stream>>>(q, c, o, n, words,
                                                           lanes);
      break;
    case 4:
      hamming_kernel<W, 4><<<blocks, threads, 0, stream>>>(q, c, o, n, words,
                                                           lanes);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// word: bytes a load (16, 4 or 1; w % word == 0, both bases aligned to
// it); lanes a row, row groups a warp (1, 2 or 4), threads a block and
// blocks from the wrapper's kernels/hamming.py::hamming_layout.
extern "C" int repro_hamming_distance(const void* query, const void* cands,
                                      void* out, int n, int w, int word,
                                      int lanes, int reps, int threads,
                                      int blocks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (word) {
    case 16:
      return repro_torch::launch<uint4>(query, cands, out, n, w, lanes, reps,
                                        threads, blocks, st);
    case 4:
      return repro_torch::launch<uint32_t>(query, cands, out, n, w, lanes,
                                           reps, threads, blocks, st);
    case 1:
      return repro_torch::launch<uint8_t>(query, cands, out, n, w, lanes,
                                          reps, threads, blocks, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_hamming_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
