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
//   per nonzero.  At serving's 64 rows of about 3,000 ids both come to a
//   fraction of a launch, so what the kernel costs is its chain of
//   dependent steps.  Design: a row's block starts every id load of a
//   pass before any hash -- 8 ids a thread, as two 16-byte int4 loads
//   where the rows start 16-byte aligned (kVec), else 8 scalar loads --
//   with threads enough for two passes over the padded row and one a bin
//   (kernels/fused_encode.py::oph_pack_layout), then hashes them into its
//   k bins in shared memory with atomicMin: an integer min is exact in
//   any order, so the result does not depend on scheduling.  The finish
//   is one pass of warps over the bins, compiled for each b: a ballot per
//   32 bins gives the row's bitmap of non-empty bins and the empty mask
//   (4 bytes a warp, bit-reversed); densify finds an empty bin's nearest
//   non-empty bin to the right, circularly, from that bitmap a word at a
//   time (k / 32 words at most); the codes are packed by an OR over the
//   lanes of each 32-bit word and stored 4 bytes a thread.  B2's hash loop
//   is its own; encode.cuh's oph_block stays B4's.
//
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

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kPackMaxThreads = 1024;  // B2: threads of a row's block, at most
constexpr int kPackIds = 8;            // B2: ids a thread loads in one pass

// B2's bin for an empty bin j of a densified row: the nearest non-empty
// bin to the right, circularly, read from the row's bitmap `ne` (bit i of
// word w: bin 32w + i is not empty), its minimum plus the distance times
// kRotC; the sentinel when the whole row is empty.
__device__ __forceinline__ uint32_t densify_bin(const uint32_t* bins,
                                                const uint32_t* ne, int j,
                                                int k) {
  const int words = (k + 31) >> 5;
  int w = j >> 5;
  uint32_t word = ne[w] & ~((2u << (j & 31)) - 1u);  // bins above j
  for (int s = 0; s < words && word == 0; ++s) {
    w = w + 1 == words ? 0 : w + 1;
    word = ne[w];
  }
  if (word == 0) return kSentinel;
  const int src = 32 * w + __ffs(word) - 1;
  const uint32_t d = static_cast<uint32_t>((src - j + k) & (k - 1));
  return bins[src] + d * kRotC;
}

// B2.  A block a row.  Dynamic shared memory: the k bins and the bitmap
// of ceil(k / 32) words.
template <bool kVec, int kBits>
__global__ void __launch_bounds__(kPackMaxThreads)
oph_pack_kernel(const int32_t* __restrict__ idx,
                const int32_t* __restrict__ nnz,
                const uint32_t* __restrict__ a,
                const uint32_t* __restrict__ b,
                uint8_t* __restrict__ out, uint8_t* __restrict__ eout,
                int m, int k, int shift, int densify, int out_w,
                int e_w) {
  extern __shared__ uint32_t smem[];
  uint32_t* bins = smem;      // k words
  uint32_t* ne = smem + k;    // ceil(k / 32) words
  const int row = blockIdx.x;
  const int threads = blockDim.x;
  const int step = threads * kPackIds;  // ids of the row a pass
  const int32_t* ids = idx + static_cast<size_t>(row) * m;
  const uint32_t ha = __ldg(a), hb = __ldg(b);
  const int len = min(max(__ldg(nnz + row), 0), m);

  // this pass's ids: kVec, int4 q = threadIdx.x + u * threads covers ids
  // [4q, 4q + 4); else id threadIdx.x + u * threads.  0 from len on.
  int32_t got[kPackIds];
  auto load = [&](int base) {
    if (kVec) {
      const int4* src = reinterpret_cast<const int4*>(ids + base);
#pragma unroll
      for (int u = 0; u < kPackIds / 4; ++u) {
        const int q = threadIdx.x + u * threads;
        int4 t = make_int4(0, 0, 0, 0);
        if (base + 4 * q < len) t = __ldg(src + q);
        got[4 * u] = t.x;
        got[4 * u + 1] = t.y;
        got[4 * u + 2] = t.z;
        got[4 * u + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int u = 0; u < kPackIds; ++u) {
        const int i = base + threadIdx.x + u * threads;
        got[u] = i < len ? __ldg(ids + i) : 0;
      }
    }
  };
  auto hash = [&](int base) {
#pragma unroll
    for (int u = 0; u < kPackIds; ++u) {
      const int i = kVec ? base + 4 * (threadIdx.x + (u / 4) * threads) + u % 4
                         : base + threadIdx.x + u * threads;
      if (i < len) {
        const uint32_t h = fmix32(ha * static_cast<uint32_t>(got[u]) + hb);
        atomicMin(&bins[h >> shift], h);
      }
    }
  };

  load(0);  // in flight while the bins are set
  for (int j = threadIdx.x; j < k; j += threads) bins[j] = kSentinel;
  __syncthreads();
  hash(0);
  for (int base = step; base < len; base += step) {
    load(base);
    hash(base);
  }
  __syncthreads();

  // the finish: warps over the bins, 32 at a time
  const int lane = threadIdx.x & 31;
  const int first = (threadIdx.x >> 5) * 32;
  const int stride = threads;
  if (densify) {
    for (int j0 = first; j0 < k; j0 += stride) {
      const int j = j0 + lane;
      const unsigned live = __ballot_sync(kFull, j < k && bins[j] != kSentinel);
      if (lane == 0) ne[j0 >> 5] = live;
    }
    __syncthreads();
  }
  constexpr uint32_t kCodeMask = (1u << kBits) - 1u;
  constexpr int kPerWord = 32 / kBits;  // codes a 32-bit word of the row
  for (int j0 = first; j0 < k; j0 += stride) {
    const int j = j0 + lane;
    uint32_t v = j < k ? bins[j] : 0u;
    const bool empty = j < k && v == kSentinel;
    uint32_t code;
    if (densify) {
      if (empty) v = densify_bin(bins, ne, j, k);
      code = v & kCodeMask;
    } else {
      code = empty ? 0u : (v & kCodeMask);
    }
    if (j >= k) code = 0u;
    // the 32-bit word of the packed row that holds this code, in each of
    // its kPerWord lanes
    uint32_t word = code << ((lane % kPerWord) * kBits);
#pragma unroll
    for (int off = 1; off < kPerWord; off <<= 1) {
      word |= __shfl_xor_sync(kFull, word, off);
    }
    if (k % 32 == 0) {  // whole words, 4-byte aligned rows
      if (lane % kPerWord == 0) {
        reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row) * out_w)
            [(j0 + lane) / kPerWord] = word;
      }
    } else {  // k < 32: the row's bytes alone
      const int byte = lane * kBits / 8;
      if ((lane * kBits) % 8 == 0 && byte < out_w) {
        out[static_cast<size_t>(row) * out_w + byte] = static_cast<uint8_t>(
            word >> ((lane % kPerWord) * kBits));
      }
    }
    // the empty mask, MSB-first: byte q of these 32 bins is byte 3 - q of
    // the bit-reversed ballot
    const unsigned flags = __brev(__ballot_sync(kFull, empty));
    const int t = (j0 >> 3) + lane;
    if (lane < 4 && t < e_w) {
      eout[static_cast<size_t>(row) * e_w + t] =
          static_cast<uint8_t>(flags >> (8 * (3 - lane)));
    }
  }
}

// B2's kernel for b bits and the load width.
template <bool kVec>
auto oph_pack_for(int bits) {
  switch (bits) {
    case 1: return oph_pack_kernel<kVec, 1>;
    case 2: return oph_pack_kernel<kVec, 2>;
    case 4: return oph_pack_kernel<kVec, 4>;
    default: return oph_pack_kernel<kVec, 8>;
  }
}

}  // namespace
}  // namespace repro_torch

using repro_torch::kLanes;
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

// Launches B2: `threads` a block; vec: m % 4 == 0 and idx 16-byte aligned.
extern "C" int repro_oph_pack(const void* idx, const void* nnz,
                              const void* a, const void* b, void* out,
                              void* eout, int n, int m, int k, int shift,
                              int bits, int densify, int out_w, int e_w,
                              int threads, int vec, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  if (threads < 32 || threads > repro_torch::kPackMaxThreads ||
      threads % 32 != 0 || (vec && m % 4 != 0) ||
      (bits != 1 && bits != 2 && bits != 4 && bits != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      sizeof(uint32_t) * (static_cast<size_t>(k) + (k + 31) / 32);
  auto kernel = vec ? repro_torch::oph_pack_for<true>(bits)
                    : repro_torch::oph_pack_for<false>(bits);
  err = repro_torch::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(nnz),
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint8_t*>(out), static_cast<uint8_t*>(eout), m, k, shift,
      densify, out_w, e_w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_fused_encode_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
