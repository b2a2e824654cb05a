// Fused hash -> b-bit -> pack encode kernels for Hopper (sm_90a).
//
// B1 minhash_pack replaces src/repro/kernels/fused_encode.py::minhash_pack_pallas.
//   Per row: the min over the first nnz ids of fmix32(a_j*t + b_j) for each
//   of k hash lanes, masked to b bits and packed 8/b codes per byte,
//   LSB-first.  Bound: 32-bit integer ALU work, about 10 operations per
//   (nonzero, lane) pair -- n*nnz*k hashes; the ids are read once from
//   device memory (L2 serves the k/32 blocks of a row).  Design: a block
//   owns 32 hash lanes of one row (one lane per thread of a warp, minima in
//   registers) and 8 warps split the row's nonzeros between them; ids are
//   staged in shared memory in coalesced tiles and read as broadcasts.  No
//   work is done for lanes >= k.  Rows x lane-chunks give the card
//   n*ceil(k/32) blocks.
//
// B2 oph_pack replaces src/repro/kernels/fused_encode.py::oph_pack_pallas.
//   One hash per nonzero; bin = h >> (32 - log2 k); per-bin min; then
//   rotation densification or zero-coding, b-bit mask, pack, and the
//   MSB-first empty-bin mask.  Bound: device-memory bytes (4 per nonzero
//   read once, the packed row written once); about 11 integer operations
//   per nonzero.  Design: one block per row holds its k bins in shared
//   memory; threads stride over the nonzeros (coalesced) and atomicMin into
//   the bins -- an integer min is exact in any order, so the result does not
//   depend on scheduling.  Densify is one thread per bin searching forward
//   for the next non-empty bin, a direct shared-memory gather in place of
//   the TPU's O(k^2) lane compare-select.
//
// The hash loops of both live in encode.cuh, shared with the raw-minima
// kernels B3 (minhash.cu) and B4 (oph.cu); only the finish is this file's.
#include "encode.cuh"

namespace repro_torch {
namespace {

constexpr uint32_t kRotC = 0x9E3779B1u;  // core/oph.py::_ROT_C

__global__ void __launch_bounds__(kLanes * kSlices)
minhash_pack_kernel(const int32_t* __restrict__ idx,
                    const int32_t* __restrict__ nnz,
                    const uint32_t* __restrict__ a,
                    const uint32_t* __restrict__ b,
                    uint8_t* __restrict__ out,
                    int m, int k, int bits, int out_w) {
  __shared__ MinhashSmem sm;
  __shared__ uint32_t mins[kLanes];
  minhash_block(idx, nnz, a, b, m, k, sm, mins);

  // kLanes is a multiple of 8, so this block's codes fill whole bytes;
  // lanes >= k pack as code 0.
  const uint32_t mask = (1u << bits) - 1u;
  const int bytes = kLanes * bits / 8;
  const int per = 8 / bits;
  if (threadIdx.x < bytes) {
    const int col = blockIdx.y * bytes + threadIdx.x;
    if (col < out_w) {
      uint32_t byte = 0;
      for (int i = 0; i < per; ++i) {
        const int lane = threadIdx.x * per + i;
        const int j = blockIdx.y * kLanes + lane;
        const uint32_t c = j < k ? (mins[lane] & mask) : 0u;
        byte |= c << (i * bits);
      }
      out[static_cast<size_t>(blockIdx.x) * out_w + col] =
          static_cast<uint8_t>(byte);
    }
  }
}

__global__ void __launch_bounds__(kOphThreads)
oph_pack_kernel(const int32_t* __restrict__ idx,
                const int32_t* __restrict__ nnz,
                const uint32_t* __restrict__ a,
                const uint32_t* __restrict__ b,
                uint8_t* __restrict__ out,
                uint8_t* __restrict__ eout,
                int m, int k, int shift, int bits, int densify,
                int out_w, int e_w) {
  extern __shared__ uint32_t smem[];
  uint32_t* bins = smem;                                   // k words
  uint8_t* codes = reinterpret_cast<uint8_t*>(smem + k);   // k bytes

  const int row = blockIdx.x;
  oph_block(idx, nnz, a[0], b[0], m, k, shift, bins);

  const uint32_t mask = (1u << bits) - 1u;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    uint32_t v = bins[j];
    uint32_t c;
    if (densify) {
      if (v == kSentinel) {
        // nearest non-empty bin to the right, circularly; an all-empty row
        // keeps the sentinel, whose low bits are all ones
        for (int d = 1; d < k; ++d) {
          const uint32_t s = bins[(j + d) & (k - 1)];
          if (s != kSentinel) {
            v = s + static_cast<uint32_t>(d) * kRotC;
            break;
          }
        }
      }
      c = v & mask;
    } else {
      c = (v == kSentinel) ? 0u : (v & mask);
    }
    codes[j] = static_cast<uint8_t>(c);
  }
  __syncthreads();

  const int per = 8 / bits;
  for (int t = threadIdx.x; t < out_w; t += blockDim.x) {
    uint32_t byte = 0;
    for (int i = 0; i < per; ++i) {
      const int j = t * per + i;
      if (j < k) byte |= static_cast<uint32_t>(codes[j]) << (i * bits);
    }
    out[static_cast<size_t>(row) * out_w + t] = static_cast<uint8_t>(byte);
  }
  for (int t = threadIdx.x; t < e_w; t += blockDim.x) {
    uint32_t byte = 0;
    for (int i = 0; i < 8; ++i) {
      const int j = t * 8 + i;
      if (j < k && bins[j] == kSentinel) byte |= 1u << (7 - i);
    }
    eout[static_cast<size_t>(row) * e_w + t] = static_cast<uint8_t>(byte);
  }
}

}  // namespace
}  // namespace repro_torch

using repro_torch::kLanes;
using repro_torch::kOphThreads;
using repro_torch::kSlices;

extern "C" int repro_minhash_pack(const void* idx, const void* nnz,
                                  const void* a, const void* b, void* out,
                                  int n, int m, int k, int bits, int out_w,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0 || k == 0) return 0;
  const dim3 grid(n, (k + kLanes - 1) / kLanes);
  repro_torch::minhash_pack_kernel<<<grid, kLanes * kSlices, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(nnz),
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint8_t*>(out), m, k, bits, out_w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_oph_pack(const void* idx, const void* nnz,
                              const void* a, const void* b, void* out,
                              void* eout, int n, int m, int k, int shift,
                              int bits, int densify, int out_w, int e_w,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  const size_t smem = static_cast<size_t>(k) * (sizeof(uint32_t) + 1);
  err = repro_torch::allow_smem(repro_torch::oph_pack_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  repro_torch::oph_pack_kernel<<<n, kOphThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(nnz),
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint8_t*>(out), static_cast<uint8_t*>(eout), m, k, shift,
      bits, densify, out_w, e_w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_fused_encode_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
