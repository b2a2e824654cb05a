// VW signed feature hashing for Hopper (sm_90a).
//
// B9 vw_sketch replaces src/repro/kernels/vw_sketch.py::vw_sketch_pallas:
//   out[n, fmix32(t * 0x9E3779B1 + 2 seed + 1) & (m - 1)] += sign * val over
//   each row's first nnz ids t, sign = +1 where bit 31 of
//   fmix32(t ^ (0x7FEB352D + seed)) is set, else -1; m a power of two.
// Bound: device-memory bytes -- 8 per nonzero (id and value) read once and
//   the (n, m) sketch written once; about 20 integer operations per nonzero
//   for the two hashes.  Design: the TPU kernel has no scatter, so it
//   compares every nonzero with a lane iota of bucket ids (O(nnz * m) per
//   row).  Here one block per row keeps the row's m-float sketch in shared
//   memory (m = 2^14 is 64 KiB, dynamic shared memory); for a larger m the
//   bucket range is split over blocks of at most 2^14 buckets, each of which
//   walks all of the row's ids.  256 threads hash 256 ids at a time into
//   shared memory; then warp w adds the ids whose bucket falls in its own
//   eighth of the range: __match_any_sync groups a warp's lanes with equal
//   buckets and the lowest lane adds their sum, in lane order.  There are no
//   float atomics, so each bucket sums in one fixed order and the sketch is
//   the same bits on every run.  With values of ones every sum is a small
//   integer, exact in any order, so the sketch equals any correct version
//   byte for byte.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kVwWarps = 8;
constexpr int kVwChunk = kVwWarps * 32;  // ids hashed per step
constexpr uint32_t kBucketMul = 0x9E3779B1u;
constexpr uint32_t kSignXor = 0x7FEB352Du;

// grid (n, m / mb); block (kVwChunk); dynamic shared memory mb floats.
__global__ void __launch_bounds__(kVwChunk)
vw_sketch_kernel(const int32_t* __restrict__ idx,
                 const float* __restrict__ val,
                 const int32_t* __restrict__ nnz, float* __restrict__ out,
                 int mx, int m, int mb, uint32_t seed) {
  extern __shared__ float acc[];  // buckets [b0, b0 + mb) of this row
  __shared__ int bkt[kVwChunk];   // local bucket of each hashed id, or -1
  __shared__ float con[kVwChunk];
  const int row = blockIdx.x;
  const int b0 = blockIdx.y * mb;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int span = (mb + kVwWarps - 1) / kVwWarps;
  const int own_lo = warp * span;
  const int own_hi = min(mb, own_lo + span);
  const uint32_t add = 2u * seed + 1u;
  const uint32_t sign_xor = kSignXor + seed;
  const size_t base_in = static_cast<size_t>(row) * mx;
  const int len = min(max(nnz[row], 0), mx);

  for (int i = threadIdx.x; i < mb; i += kVwChunk) acc[i] = 0.f;
  for (int base = 0; base < len; base += kVwChunk) {
    __syncthreads();  // the previous chunk is consumed (and acc zeroed)
    const int t = base + threadIdx.x;
    int b = -1;
    float x = 0.f;
    if (t < len) {
      const uint32_t id = static_cast<uint32_t>(idx[base_in + t]);
      const int local =
          static_cast<int>(fmix32(id * kBucketMul + add) & (m - 1)) - b0;
      if (local >= 0 && local < mb) {
        const float v = val[base_in + t];
        b = local;
        x = (fmix32(id ^ sign_xor) >> 31) ? v : -v;
      }
    }
    bkt[threadIdx.x] = b;
    con[threadIdx.x] = x;
    __syncthreads();
    for (int s = 0; s < kVwChunk; s += 32) {
      const int bb = bkt[s + lane];
      const int mine = (bb >= own_lo && bb < own_hi) ? bb : -1;
      const unsigned peers = __match_any_sync(0xFFFFFFFFu, mine);
      if (mine >= 0 && lane == __ffs(peers) - 1) {
        float sum = 0.f;
        for (unsigned rest = peers; rest != 0u; rest &= rest - 1u) {
          sum += con[s + __ffs(rest) - 1];
        }
        acc[mine] += sum;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  float* orow = out + static_cast<size_t>(row) * m + b0;
  for (int i = threadIdx.x; i < mb; i += kVwChunk) orow[i] = acc[i];
}

}  // namespace
}  // namespace repro_torch

// mb: buckets per block, a power of two dividing m.
extern "C" int repro_vw_sketch(const void* idx, const void* val,
                               const void* nnz, void* out, int n, int mx,
                               int m, int mb, unsigned seed, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  const size_t smem = static_cast<size_t>(mb) * sizeof(float);
  err = cudaFuncSetAttribute(repro_torch::vw_sketch_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n, m / mb);
  repro_torch::vw_sketch_kernel<<<grid, repro_torch::kVwChunk, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const float*>(val),
      static_cast<const int32_t*>(nnz), static_cast<float*>(out), mx, m, mb,
      static_cast<uint32_t>(seed));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_vw_sketch_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
