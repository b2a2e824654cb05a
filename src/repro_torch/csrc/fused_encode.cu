// Fused hash -> b-bit -> pack encode kernels for Hopper (sm_90a).
//
// B1 minhash_pack replaces src/repro/kernels/fused_encode.py::minhash_pack_pallas.
//   Per row: the min over the first nnz ids of fmix32(a_j*t + b_j) for each
//   of k hash lanes, masked to b bits and packed 8/b codes per byte,
//   LSB-first.  Bound: 32-bit integer work, about 10 operations per
//   (nonzero, lane) pair -- n*nnz*k hashes; the ids are read once from
//   device memory.  What holds the loop back is the integer ALU pipe, at
//   half the issue rate: a hash is 3 multiplies (IMAD, on the FMA pipe)
//   and 3 shifts, 3 xors and its share of a min on the ALU pipe, so the
//   loop cannot pass about 2/3 of the issue-rate bound (taking shifts to
//   the FMA pipe as umulhi was slower on the H100).  Design: a thread owns
//   L consecutive hash lanes (1-8) and loads its ids 4 at a time (one
//   16-byte load where the rows start 16-byte aligned, kVec), every load
//   of a pass in flight before any hash; each id feeds L independent hash
//   chains, and two hashes share one three-input min (VIMNMX3).  A block
//   takes L lt lanes of one row (whole bytes of codes); the 32 / lt threads
//   of a warp that share lanes and the warps take different 4-id groups of
//   the row, then fold their minima by shuffles and through shared memory,
//   and the block packs its bytes.  The grid is rows x lane slices: few
//   lanes a block where there are few rows, so that one row spreads over
//   the card (kernels/fused_encode.py::minhash_pack_layout).  An integer
//   min is exact in any order, so the result does not depend on
//   scheduling.
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
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr uint32_t kRotC = 0x9E3779B1u;  // core/oph.py::_ROT_C

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMinMaxWarps = 16;  // B1: warps a block, at most

// B1.  grid (n, ceil(k / (L lt))): block (row, slice) takes hash lanes
// [L lt slice, + L lt) of its row, L a thread (t = lane % lt); the 32 / lt
// threads of a warp that share lanes and the warps take different 4-id
// groups of the row (id slice s = lane / lt, then the warp: groups s, s +
// slices, ...).  Dynamic shared memory: (warps + 1) x L lt minima.
template <int L, bool kVec>
__global__ void __launch_bounds__(kMinMaxWarps * 32)
minhash_pack_kernel(const int32_t* __restrict__ idx,
                    const int32_t* __restrict__ nnz,
                    const uint32_t* __restrict__ a,
                    const uint32_t* __restrict__ b,
                    uint8_t* __restrict__ out, int m, int k, int bits,
                    int out_w, int lt) {
  // 4-id groups a thread loads in one pass, by its hash lanes: every load
  // of a pass in flight, in few enough registers
  constexpr int U = L <= 2 ? 4 : (L == 4 ? 2 : 1);
  extern __shared__ uint32_t smem[];
  const int lanes = lt * L;               // hash lanes of the block
  const int warps = blockDim.x >> 5;
  uint32_t* part = smem;                  // [warp][lane of the block]
  uint32_t* fin = smem + warps * lanes;   // the block's minima
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = lane & (lt - 1);
  const int subs = 32 / lt;
  const int slices = warps * subs;
  const int s = warp * subs + lane / lt;
  const int row = blockIdx.x;
  const int j0 = blockIdx.y * lanes + t * L;
  const int len = min(max(__ldg(nnz + row), 0), m);
  const int groups = (len + 3) >> 2;
  const int32_t* ids = idx + static_cast<size_t>(row) * m;

  uint32_t acc[L], ha[L], hb[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int j = j0 + l;
    acc[l] = kSentinel;
    ha[l] = j < k ? __ldg(a + j) : 0u;
    hb[l] = j < k ? __ldg(b + j) : 0u;
  }
  if (j0 < k) {
    for (int g0 = s; g0 < groups; g0 += slices * U) {
      // every load of the pass in flight before any hash; an id past len
      // repeats the first of its group, which leaves the minima as they are
      uint32_t id[U][4];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int g = g0 + u * slices;
        int4 q = make_int4(0, 0, 0, 0);
        if (g < groups) {
          if (kVec) {
            q = __ldg(reinterpret_cast<const int4*>(ids) + g);
          } else {
            q.x = __ldg(ids + 4 * g);
            if (4 * g + 1 < len) q.y = __ldg(ids + 4 * g + 1);
            if (4 * g + 2 < len) q.z = __ldg(ids + 4 * g + 2);
            if (4 * g + 3 < len) q.w = __ldg(ids + 4 * g + 3);
          }
        }
        id[u][0] = static_cast<uint32_t>(q.x);
        id[u][1] = static_cast<uint32_t>(4 * g + 1 < len ? q.y : q.x);
        id[u][2] = static_cast<uint32_t>(4 * g + 2 < len ? q.z : q.x);
        id[u][3] = static_cast<uint32_t>(4 * g + 3 < len ? q.w : q.x);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (g0 + u * slices < groups) {
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
#pragma unroll
            for (int l = 0; l < L; ++l) {
              // two hashes a min: one three-input VIMNMX3 for both
              acc[l] = min(acc[l],
                           min(fmix32(ha[l] * id[u][e] + hb[l]),
                               fmix32(ha[l] * id[u][e + 1] + hb[l])));
            }
          }
        }
      }
    }
  }
  // fold the id slices: the warp's by shuffles, then the warps
#pragma unroll
  for (int off = lt; off < 32; off <<= 1) {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      acc[l] = min(acc[l], __shfl_xor_sync(kFull, acc[l], off));
    }
  }
  if (lane < lt) {
#pragma unroll
    for (int l = 0; l < L; ++l) part[warp * lanes + t * L + l] = acc[l];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < lanes; i += blockDim.x) {
    uint32_t v = part[i];
    for (int w = 1; w < warps; ++w) v = min(v, part[w * lanes + i]);
    fin[i] = v;
  }
  __syncthreads();
  // the block's lanes are lanes * bits / 8 whole bytes of the row; a byte
  // a thread, LSB-first; lanes >= k pack as code 0
  const int per = 8 / bits;
  const uint32_t mask = (1u << bits) - 1u;
  const int bytes = lanes * bits / 8;
  for (int q = threadIdx.x; q < bytes; q += blockDim.x) {
    const int col = blockIdx.y * bytes + q;
    if (col >= out_w) break;
    uint32_t byte = 0;
    for (int i = 0; i < per; ++i) {
      const int l = q * per + i;
      if (blockIdx.y * lanes + l < k) byte |= (fin[l] & mask) << (i * bits);
    }
    out[static_cast<size_t>(row) * out_w + col] = static_cast<uint8_t>(byte);
  }
}

// B1's kernel for the hash lanes a thread and the load width.
template <bool kVec>
auto minhash_pack_for(int lanes_per_thread) {
  switch (lanes_per_thread) {
    case 1: return minhash_pack_kernel<1, kVec>;
    case 2: return minhash_pack_kernel<2, kVec>;
    case 4: return minhash_pack_kernel<4, kVec>;
    default: return minhash_pack_kernel<8, kVec>;
  }
}

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

// Launches B1: `lpt` hash lanes a thread (1, 2, 4 or 8), lt threads'
// lanes a block (a power of two in [1, 32]; lpt * lt * bits a multiple of
// 8, whole bytes), `warps` warps; vec: m % 4 == 0 and idx 16-byte aligned.
extern "C" int repro_minhash_pack(const void* idx, const void* nnz,
                                  const void* a, const void* b, void* out,
                                  int n, int m, int k, int bits, int out_w,
                                  int lpt, int lt, int warps, int vec,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0 || k == 0) return 0;
  const int lanes = lpt * lt;
  if ((lpt != 1 && lpt != 2 && lpt != 4 && lpt != 8) || lt < 1 || lt > 32 ||
      (lt & (lt - 1)) != 0 || warps < 1 ||
      warps > repro_torch::kMinMaxWarps || (vec && m % 4 != 0) ||
      (bits != 1 && bits != 2 && bits != 4 && bits != 8) ||
      lanes * bits % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(n, (k + lanes - 1) / lanes);
  const size_t smem = sizeof(uint32_t) * lanes * (warps + 1);
  auto kernel = vec ? repro_torch::minhash_pack_for<true>(lpt)
                    : repro_torch::minhash_pack_for<false>(lpt);
  kernel<<<grid, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(nnz),
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint8_t*>(out), m, k, bits, out_w, lt);
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
