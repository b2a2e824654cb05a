// The hash loops of the raw-minima kernels (B3 in minhash.cu, B4 in
// oph.cu); the fused encode kernels (B1, B2 in fused_encode.cu) have loops
// of their own.
#pragma once

#include "common.cuh"

namespace repro_torch {

constexpr int kLanes = 32;    // hash lanes per minwise block: one per thread of a warp
constexpr int kSlices = 8;    // warps per minwise block, each over 1/8 of the nonzeros
constexpr int kTile = 2048;   // ids staged in shared memory per pass
constexpr int kOphThreads = 256;

// Shared memory of one minwise block.
struct MinhashSmem {
  uint32_t tile[kTile];
  uint32_t part[kSlices][kLanes];
};

// Minwise: the block (kLanes * kSlices threads) owns row blockIdx.x and hash
// lanes j = blockIdx.y * kLanes + [0, kLanes).  Leaves in mins[lane] the min
// over the row's first nnz ids of fmix32(a_j * t + b_j), compared as
// uint32_t; lanes j >= k and rows with no id keep the sentinel.  Ids are
// staged in shared memory in coalesced tiles and read as broadcasts; each
// warp takes every kSlices-th id of a tile, so the minima stay in registers
// until the final fold over the warps.  Ends with a __syncthreads.
__device__ __forceinline__ void minhash_block(
    const int32_t* __restrict__ idx, const int32_t* __restrict__ nnz,
    const uint32_t* __restrict__ a, const uint32_t* __restrict__ b, int m,
    int k, MinhashSmem& sm, uint32_t* mins) {
  const int row = blockIdx.x;
  const int lane = threadIdx.x % kLanes;
  const int slice = threadIdx.x / kLanes;
  const int j = blockIdx.y * kLanes + lane;
  const bool live = j < k;
  const uint32_t aj = live ? a[j] : 0u;
  const uint32_t bj = live ? b[j] : 0u;
  const int len = min(max(nnz[row], 0), m);
  const int32_t* ids = idx + static_cast<size_t>(row) * m;

  uint32_t acc = kSentinel;
  for (int base = 0; base < len; base += kTile) {
    const int cnt = min(kTile, len - base);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
      sm.tile[i] = static_cast<uint32_t>(ids[base + i]);
    }
    __syncthreads();
    if (live) {
      for (int i = slice; i < cnt; i += kSlices) {
        acc = min(acc, fmix32(aj * sm.tile[i] + bj));
      }
    }
  }
  sm.part[slice][lane] = acc;
  __syncthreads();
  if (slice == 0) {
    uint32_t v = sm.part[0][lane];
    for (int s = 1; s < kSlices; ++s) v = min(v, sm.part[s][lane]);
    mins[lane] = v;
  }
  __syncthreads();
}

// OPH: the block owns row blockIdx.x.  Leaves in bins[0, k) the per-bin
// minimum of h = fmix32(a * t + b) over the row's first nnz ids, bin =
// h >> shift; empty bins keep the sentinel.  Threads stride over the ids
// (coalesced) and atomicMin into the shared bins: an integer min is exact in
// any order, so the result does not depend on scheduling.  Ends with a
// __syncthreads.
__device__ __forceinline__ void oph_block(
    const int32_t* __restrict__ idx, const int32_t* __restrict__ nnz,
    uint32_t ha, uint32_t hb, int m, int k, int shift, uint32_t* bins) {
  const int row = blockIdx.x;
  for (int j = threadIdx.x; j < k; j += blockDim.x) bins[j] = kSentinel;
  __syncthreads();
  const int len = min(max(nnz[row], 0), m);
  const int32_t* ids = idx + static_cast<size_t>(row) * m;
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const uint32_t h = fmix32(ha * static_cast<uint32_t>(ids[i]) + hb);
    atomicMin(&bins[h >> shift], h);
  }
  __syncthreads();
}

}  // namespace repro_torch
