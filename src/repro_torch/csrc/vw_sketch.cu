// VW signed feature hashing for Hopper (sm_90a).
//
// B9 vw_sketch replaces src/repro/kernels/vw_sketch.py::vw_sketch_pallas:
//   out[n, fmix32(t * 0x9E3779B1 + 2 seed + 1) & (m - 1)] += sign * val over
//   each row's first nnz ids t, sign = +1 where bit 31 of
//   fmix32(t ^ (0x7FEB352D + seed)) is set, else -1; m a power of two.
// Bound: device-memory bytes -- 8 per nonzero (id and value) read once and
//   the (n, m) sketch written once; about 20 integer operations per nonzero
//   for the two hashes.  The TPU kernel has no scatter, so it compares every
//   nonzero with a lane iota of bucket ids (O(nnz * m) per row).  Here two
//   designs, chosen by the wrapper (kernels/vw_sketch.py::vw_layout):
//
//   lanes (small m): a block of G threads owns one row, and each thread owns
//     a private column of the row's sketch in shared memory, laid out
//     [bucket][G] so a warp's read-modify-writes fall in 32 distinct banks
//     whatever their buckets.  Thread g adds ids g, g + G, g + 2G, ... in
//     order, eight loads in flight, with no match, no atomic and no barrier
//     in the loop.  Then each bucket sums its G columns in a fixed order
//     (four running sums a thread, the threads of a bucket by a fixed
//     shuffle tree).
//   slice (large m): a block of 256 threads owns a slice of mb buckets of
//     one row in shared memory.  It hashes a window of 512 ids at a time
//     into a stage (the next window's loads in flight meanwhile), two
//     barriers a window.  Warp w owns an eighth of the slice: it picks its
//     own entries out of the stage by ballot, in stage order, and adds them
//     32 at a time.  Where the 32 buckets differ -- the common case, seen
//     from a byte of shared memory a bucket that each lane claims -- each
//     lane adds its own term; else __match_any_sync groups equal buckets
//     and the lowest lane adds each group's sum in lane order.  The block
//     then writes its slice with 16-byte stores.
//
// Both add each bucket's terms in an order fixed by the row, with no float
// atomics, so the sketch is the same bits on every run.  With values of ones
// every sum is a small integer, exact in any order, so the sketch equals any
// correct version byte for byte.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr uint32_t kBucketMul = 0x9E3779B1u;
constexpr uint32_t kSignXor = 0x7FEB352Du;
constexpr int kLanesUnroll = 8;      // ids in flight a thread (lanes)
constexpr int kSliceWarps = 8;
constexpr int kSliceThreads = kSliceWarps * 32;
constexpr int kWindow = 2;           // ids a thread hashes a window (slice)
constexpr int kStage = kSliceThreads * kWindow;

struct VwHash {
  uint32_t add, sign_xor, mask;
  __device__ __forceinline__ uint32_t bucket(uint32_t id) const {
    return fmix32(id * kBucketMul + add) & mask;
  }
  __device__ __forceinline__ float signed_val(uint32_t id, float v) const {
    return (fmix32(id ^ sign_xor) >> 31) ? v : -v;
  }
};

__device__ __forceinline__ VwHash make_hash(uint32_t seed, int m) {
  return VwHash{2u * seed + 1u, kSignXor + seed,
                static_cast<uint32_t>(m - 1)};
}

__device__ __forceinline__ int row_len(const int32_t* nnz, int row, int mx) {
  return min(max(nnz[row], 0), mx);
}

// grid (n); block (G); dynamic shared memory m * G floats.
__global__ void vw_lanes_kernel(const int32_t* __restrict__ idx,
                                const float* __restrict__ val,
                                const int32_t* __restrict__ nnz,
                                float* __restrict__ out, int mx, int m,
                                uint32_t seed) {
  extern __shared__ float4 acc4[];
  float* acc = reinterpret_cast<float*>(acc4);  // [bucket][G]
  const int G = blockDim.x;
  const int g = threadIdx.x;
  const int row = blockIdx.x;
  const VwHash h = make_hash(seed, m);
  const int len = row_len(nnz, row, mx);
  const int32_t* ri = idx + static_cast<size_t>(row) * mx;
  const float* rv = val + static_cast<size_t>(row) * mx;

  for (int i = g; i < m * G / 4; i += G) acc4[i] = make_float4(0, 0, 0, 0);
  __syncthreads();
  int t = g;
  for (; t + (kLanesUnroll - 1) * G < len; t += kLanesUnroll * G) {
    uint32_t id[kLanesUnroll];
    float v[kLanesUnroll];
#pragma unroll
    for (int u = 0; u < kLanesUnroll; ++u) {
      id[u] = static_cast<uint32_t>(ri[t + u * G]);
      v[u] = rv[t + u * G];
    }
#pragma unroll
    for (int u = 0; u < kLanesUnroll; ++u) {
      acc[h.bucket(id[u]) * G + g] += h.signed_val(id[u], v[u]);
    }
  }
  for (; t < len; t += G) {
    const uint32_t id = static_cast<uint32_t>(ri[t]);
    acc[h.bucket(id) * G + g] += h.signed_val(id, rv[t]);
  }
  __syncthreads();

  // P threads a bucket, each summing `cols` columns from a lane-rotated
  // start (32 distinct banks a step), then a fixed xor tree over the P
  const int P = min(32, max(1, G / m));
  const int cols = G / P;
  const int part = g % P;
  const int lane = g & 31;
  float* orow = out + static_cast<size_t>(row) * m;
  for (int j = g / P; j < m; j += G / P) {
    const float* col = acc + j * G + part * cols;
    const int wrap = cols - 1;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
    int r = 0;
    for (; r + 4 <= cols; r += 4) {
      s0 += col[(r + lane) & wrap];
      s1 += col[(r + 1 + lane) & wrap];
      s2 += col[(r + 2 + lane) & wrap];
      s3 += col[(r + 3 + lane) & wrap];
    }
    for (; r < cols; ++r) s0 += col[(r + lane) & wrap];
    float s = (s0 + s1) + (s2 + s3);
    for (int off = 1; off < P; off <<= 1) {
      s += __shfl_xor_sync(0xFFFFFFFFu, s, off);
    }
    if (part == 0) orow[j] = s;
  }
}

// grid (n, m / mb); block (kSliceThreads); dynamic shared memory mb floats
// and mb bytes.
__global__ void __launch_bounds__(kSliceThreads)
vw_slice_kernel(const int32_t* __restrict__ idx,
                const float* __restrict__ val,
                const int32_t* __restrict__ nnz, float* __restrict__ out,
                int mx, int m, int mb, uint32_t seed) {
  extern __shared__ float4 acc4[];
  float* acc = reinterpret_cast<float*>(acc4);  // buckets [b0, b0 + mb)
  // tag[b]: the last lane of a batch to claim bucket b (never cleared)
  uint8_t* tag = reinterpret_cast<uint8_t*>(acc + mb);
  __shared__ int stage_b[kStage];  // local bucket, or -1
  __shared__ float stage_x[kStage];
  __shared__ uint16_t queue[kSliceWarps][kStage];  // this warp's entries
  const int row = blockIdx.x;
  const int b0 = blockIdx.y * mb;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const unsigned below = (1u << lane) - 1u;
  const VwHash h = make_hash(seed, m);
  const int len = row_len(nnz, row, mx);
  const int32_t* ri = idx + static_cast<size_t>(row) * mx;
  const float* rv = val + static_cast<size_t>(row) * mx;
  for (int i = tid; i < mb / 4; i += kSliceThreads) {
    acc4[i] = make_float4(0, 0, 0, 0);
  }
  const int own_lo = (warp * mb) >> 3;  // this warp's eighth of the slice
  const int own_hi = ((warp + 1) * mb) >> 3;
  uint16_t* q = queue[warp];

  uint32_t id[kWindow];
  float v[kWindow];
#pragma unroll
  for (int u = 0; u < kWindow; ++u) {
    const int t = u * kSliceThreads + tid;
    if (t < len) {
      id[u] = static_cast<uint32_t>(ri[t]);
      v[u] = rv[t];
    }
  }
  __syncthreads();  // acc zeroed
  for (int base = 0; base < len; base += kStage) {
#pragma unroll
    for (int u = 0; u < kWindow; ++u) {
      const int e = u * kSliceThreads + tid;
      int b = -1;
      float x = 0.f;
      if (base + e < len) {
        const int local = static_cast<int>(h.bucket(id[u])) - b0;
        if (local >= 0 && local < mb) {
          b = local;
          x = h.signed_val(id[u], v[u]);
        }
      }
      stage_b[e] = b;
      stage_x[e] = x;
    }
#pragma unroll
    for (int u = 0; u < kWindow; ++u) {  // the next window, in flight
      const int t = base + kStage + u * kSliceThreads + tid;
      if (t < len) {
        id[u] = static_cast<uint32_t>(ri[t]);
        v[u] = rv[t];
      }
    }
    __syncthreads();
    int count = 0;
#pragma unroll
    for (int g = 0; g < kWindow; ++g) {
      int bb[kSliceWarps];
#pragma unroll
      for (int r = 0; r < kSliceWarps; ++r) {
        bb[r] = stage_b[(g * kSliceWarps + r) * 32 + lane];
      }
#pragma unroll
      for (int r = 0; r < kSliceWarps; ++r) {
        const bool mine = bb[r] >= own_lo && bb[r] < own_hi;
        const unsigned ballot = __ballot_sync(0xFFFFFFFFu, mine);
        if (mine) {
          q[count + __popc(ballot & below)] = (g * kSliceWarps + r) * 32 + lane;
        }
        count += __popc(ballot);
      }
    }
    __syncwarp();
    for (int first = 0; first < count; first += 32) {
      const bool live = first + lane < count;
      const int e = live ? q[first + lane] : 0;
      const int b = live ? stage_b[e] : -1;
      if (live) tag[b] = static_cast<uint8_t>(lane);
      __syncwarp();
      const bool alone = !live || tag[b] == lane;
      if (__all_sync(0xFFFFFFFFu, alone)) {
        if (live) acc[b] += stage_x[e];
      } else {
        const unsigned peers = __match_any_sync(0xFFFFFFFFu, b);
        if (live && lane == __ffs(peers) - 1) {
          float sum = 0.f;
          for (unsigned rest = peers; rest != 0u; rest &= rest - 1u) {
            sum += stage_x[q[first + __ffs(rest) - 1]];
          }
          acc[b] += sum;
        }
      }
      __syncwarp();
    }
    __syncthreads();  // the stage is consumed
  }
  float4* orow4 = reinterpret_cast<float4*>(out + static_cast<size_t>(row) * m
                                            + b0);
  for (int i = tid; i < mb / 4; i += kSliceThreads) orow4[i] = acc4[i];
}

}  // namespace
}  // namespace repro_torch

// design 0: lanes, `param` = G threads a row (a power of two, 32..1024);
// design 1: slice, `param` = mb buckets a block (a power of two dividing m,
// at least 4).
extern "C" int repro_vw_sketch(const void* idx, const void* val,
                               const void* nnz, void* out, int n, int mx,
                               int m, int design, int param, unsigned seed,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* i32 = static_cast<const int32_t*>(idx);
  const auto* f32 = static_cast<const float*>(val);
  const auto* cnt = static_cast<const int32_t*>(nnz);
  auto* o = static_cast<float*>(out);
  if (design == 0) {
    const size_t smem = static_cast<size_t>(m) * param * sizeof(float);
    err = repro_torch::allow_smem(repro_torch::vw_lanes_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    repro_torch::vw_lanes_kernel<<<n, param, smem, st>>>(i32, f32, cnt, o, mx,
                                                          m, seed);
  } else {
    const size_t smem = static_cast<size_t>(param) * (sizeof(float) + 1);
    // the kernel's static shared memory comes on top: always opt in
    err = cudaFuncSetAttribute(repro_torch::vw_slice_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(n, m / param);
    repro_torch::vw_slice_kernel<<<grid, repro_torch::kSliceThreads, smem,
                                   st>>>(i32, f32, cnt, o, mx, m, param,
                                         seed);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_vw_sketch_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
