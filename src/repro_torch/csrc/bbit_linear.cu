// b-bit linear layer kernels for Hopper (sm_90a): the forward from packed
// (B5) or widened (B7) codes, and dW from widened (B8) or packed (B6) codes.
//
// B5 bbit_linear_packed_fwd replaces
// src/repro/kernels/bbit_linear.py::bbit_linear_packed_fwd_pallas:
//   logits[n, c] = sum_j W[j, code(n, j), c], the codes unpacked in
//   registers from the LSB-first packed row, bins marked in the optional
//   MSB-first empty mask skipped.
// B7 bbit_linear_fwd replaces bbit_linear.py::bbit_linear_fwd_pallas: the
//   same sum from widened int32 (n, k) codes.
// Bound (both): device-memory bytes -- the codes, the mask and the table
//   entries the codes select, each read once; one float add per
//   (row, bin, class).  Design: a gather-sum like an embedding bag, one warp
//   per row, lanes over the k bins.  The TPU kernels' one-hot MXU
//   contraction streams the whole (k, 2^b, C) table per row block; here each
//   lane reads only the entries its codes select, through L2 (at k=256, b=8
//   the table is 256*C KB, more than a block's shared memory).  Each lane
//   sums its bins in order and the warp reduces in a fixed shuffle tree,
//   with no float atomics, so a row's logits are the same bits on every run.
//   A widened code outside [0, V) adds nothing, as the TPU kernel's one-hot
//   compare of such a code matches no column.
//
// B8 bbit_linear_bwd_dw replaces bbit_linear.py::bbit_linear_bwd_dw_pallas:
//   dW[j, v, c] = sum_n 1{codes[n, j] = v} * dout[n, c].
// B6 bbit_linear_packed_bwd_dw replaces
//   bbit_linear.py::bbit_linear_packed_bwd_dw_pallas: the same from packed
//   codes, bins marked in the empty mask contributing nothing.
// Bound (both): device-memory bytes -- the codes (or packed rows and mask)
//   and dout read once, dW written once; one float add per (row, bin,
//   class).  Design: a histogram per bin j.  A block owns 8 consecutive j
//   (one warp each, its (V,) histogram of one class in shared memory) and a
//   range of rows.  It stages 256 rows x 8 codes at a time (8 loads in
//   flight per thread), read as whole 32-byte row segments (8 packed codes
//   are b whole bytes, 8 mask bits one byte), then takes them in groups of
//   32 rows.  In each warp __match_any_sync groups the lanes (rows) that
//   hold the same code; the group's lowest lane sums their dout in lane order and
//   adds it to the bin the warp owns alone.  There are no float atomics, so
//   every bin sums in one fixed order.  The rows are split over blocks so
//   that a (k / 8)-block grid still fills the card; each split writes its
//   partial table and a second kernel adds the splits in split order.  The
//   split count depends on the shapes only, so dW is the same bits on every
//   run (ROADMAP B6: the streaming trainer's bit-identical resume).
//   A histogram tile holds up to kDwVTile = 4096 values of v (8 x 4096
//   floats = 128 KiB of dynamic shared memory); a wider table (b = 16:
//   V = 65536) is cut into V tiles, a third grid axis: each block keeps
//   the codes in its tile and skips the rest, so every bin is still summed
//   by one warp in row order and dW stays the same bits on every run, at
//   the price of reading the codes once per tile.  The classes are taken
//   one after another, so any C works.  Neither the forward nor dW has a
//   limit on V.
#include <algorithm>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kRowsPerBlock = 8;   // forward: one warp per row
constexpr int kDwWarps = 8;        // dW: bins j per block, one warp each
constexpr int kDwRows = 32;        // dW: rows per group, one per lane
constexpr int kDwGroups = 8;       // dW: 32-row groups staged per pass
constexpr int kDwVTile = 4096;     // dW: histogram values per V tile

__device__ __forceinline__ float warp_sum(float acc) {
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xFFFFFFFFu, acc, off);
  }
  return acc;
}

__global__ void __launch_bounds__(kRowsPerBlock * 32)
bbit_linear_packed_fwd_kernel(const uint8_t* __restrict__ packed,
                              const float* __restrict__ w,
                              const uint8_t* __restrict__ empty,
                              float* __restrict__ out,
                              int n, int k, int bits, int v, int c,
                              int p_w, int e_w) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // whole warp: row is uniform across it
  const uint8_t* prow = packed + static_cast<size_t>(row) * p_w;
  const uint8_t* erow =
      empty == nullptr ? nullptr : empty + static_cast<size_t>(row) * e_w;
  const int per = 8 / bits;
  const uint32_t mask = (1u << bits) - 1u;
  for (int cc = 0; cc < c; ++cc) {
    float acc = 0.f;
    for (int j = lane; j < k; j += 32) {
      if (erow != nullptr && ((erow[j >> 3] >> (7 - (j & 7))) & 1)) continue;
      const uint32_t code = (prow[j / per] >> ((j % per) * bits)) & mask;
      acc += w[(static_cast<size_t>(j) * v + code) * c + cc];
    }
    acc = warp_sum(acc);
    if (lane == 0) out[static_cast<size_t>(row) * c + cc] = acc;
  }
}

__global__ void __launch_bounds__(kRowsPerBlock * 32)
bbit_linear_fwd_kernel(const int32_t* __restrict__ codes,
                       const float* __restrict__ w,
                       float* __restrict__ out, int n, int k, int v, int c) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // whole warp
  const int32_t* crow = codes + static_cast<size_t>(row) * k;
  for (int cc = 0; cc < c; ++cc) {
    float acc = 0.f;
    for (int j = lane; j < k; j += 32) {
      const int code = crow[j];
      if (static_cast<unsigned>(code) < static_cast<unsigned>(v)) {
        acc += w[(static_cast<size_t>(j) * v + code) * c + cc];
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) out[static_cast<size_t>(row) * c + cc] = acc;
  }
}

// Code of (row, j) for the dW kernel, or -1 where it adds nothing.
struct WidenedCodes {
  const int32_t* codes;
  int k, v;
  __device__ int operator()(int row, int j) const {
    const int code = codes[static_cast<size_t>(row) * k + j];
    return static_cast<unsigned>(code) < static_cast<unsigned>(v) ? code : -1;
  }
};

struct PackedCodes {
  const uint8_t* packed;
  const uint8_t* empty;  // nullptr: no mask
  int bits, p_w, e_w;
  __device__ int operator()(int row, int j) const {
    if (empty != nullptr &&
        ((empty[static_cast<size_t>(row) * e_w + (j >> 3)] >> (7 - (j & 7))) &
         1)) {
      return -1;
    }
    const int per = 8 / bits;
    const uint8_t byte = packed[static_cast<size_t>(row) * p_w + j / per];
    return (byte >> ((j % per) * bits)) & ((1 << bits) - 1);
  }
};

// grid (ceil(k / kDwWarps), splits, ceil(v / v_tile)); part is
// (splits, k, v, c).  Block z owns the values [z * v_tile, + v_tile).
template <typename Codes>
__global__ void __launch_bounds__(kDwWarps * 32)
bbit_linear_dw_kernel(Codes code_at, const float* __restrict__ dout,
                      float* __restrict__ part, int n, int k, int v, int c,
                      int rows_per_split, int v_tile) {
  constexpr int kStage = kDwRows * kDwGroups;  // rows staged per pass
  extern __shared__ float hist[];              // kDwWarps x v_tile
  __shared__ int tile[kStage][kDwWarps + 1];   // rows x 8 bins (+1: banks)
  __shared__ float vals[kStage];               // dout of the staged rows
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j0 = blockIdx.x * kDwWarps;
  const int j = j0 + warp;
  const int lo = blockIdx.y * rows_per_split;
  const int hi = min(n, lo + rows_per_split);
  const int v0 = blockIdx.z * v_tile;
  const int vt = min(v_tile, v - v0);
  float* h = hist + warp * v_tile;
  float* dst = part + static_cast<size_t>(blockIdx.y) * k * v * c;
  for (int cc = 0; cc < c; ++cc) {
    for (int i = lane; i < vt; i += 32) h[i] = 0.f;
    for (int r0 = lo; r0 < hi; r0 += kStage) {
      __syncthreads();  // the previous stage is consumed
      // each thread loads kDwGroups codes at once, so their latencies
      // overlap; consecutive threads read consecutive bins of a row
#pragma unroll
      for (int e = 0; e < kDwGroups; ++e) {
        const int slot = threadIdx.x + e * kDwWarps * 32;
        const int r = slot / kDwWarps;
        const int jj = slot % kDwWarps;
        const int row = r0 + r;
        // this V tile's offset of the code, -1 outside the tile
        const int code =
            (row < hi && j0 + jj < k) ? code_at(row, j0 + jj) - v0 : -1;
        tile[r][jj] = (code >= 0 && code < vt) ? code : -1;
      }
      for (int r = threadIdx.x; r < kStage; r += kDwWarps * 32) {
        vals[r] = r0 + r < hi ? dout[static_cast<size_t>(r0 + r) * c + cc]
                              : 0.f;
      }
      __syncthreads();
      // 32-row groups in row order: a bin sums its rows in row order
      for (int g = 0; g < kStage; g += kDwRows) {
        const int code = tile[g + lane][warp];
        const unsigned peers = __match_any_sync(0xFFFFFFFFu, code);
        if (code >= 0 && lane == __ffs(peers) - 1) {
          float s = 0.f;
          for (unsigned rest = peers; rest != 0u; rest &= rest - 1u) {
            s += vals[g + __ffs(rest) - 1];
          }
          h[code] += s;
        }
      }
    }
    __syncwarp();
    if (j < k) {
      for (int i = lane; i < vt; i += 32) {
        dst[(static_cast<size_t>(j) * v + v0 + i) * c + cc] = h[i];
      }
    }
    __syncwarp();  // read out before the next class zeroes the histogram
  }
}

// out[i] = sum over splits s, in order, of part[s][i].
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, size_t total,
                                  int splits) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += part[sp * total + i];
    out[i] = s;
  }
}

template <typename Codes>
int launch_dw(Codes code_at, const void* dout, void* part, void* out, int n,
              int k, int v, int c, int splits, int rows_per_split,
              cudaStream_t stream) {
  const int v_tile = std::min(v, kDwVTile);
  const size_t smem = static_cast<size_t>(kDwWarps) * v_tile * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      bbit_linear_dw_kernel<Codes>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((k + kDwWarps - 1) / kDwWarps, splits,
                  (v + v_tile - 1) / v_tile);
  float* dst = static_cast<float*>(splits == 1 ? out : part);
  bbit_linear_dw_kernel<Codes><<<grid, kDwWarps * 32, smem, stream>>>(
      code_at, static_cast<const float*>(dout), dst, n, k, v, c,
      rows_per_split, v_tile);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(k) * v * c;
  const int blocks = static_cast<int>(std::min((total + 255) / 256, size_t{4096}));
  sum_splits_kernel<<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(out), total,
      splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

using repro_torch::kRowsPerBlock;

extern "C" int repro_bbit_linear_packed_fwd(const void* packed, const void* w,
                                            const void* empty, void* out,
                                            int n, int k, int bits, int v,
                                            int c, int p_w, int e_w,
                                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  repro_torch::bbit_linear_packed_fwd_kernel<<<
      blocks, kRowsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), static_cast<const float*>(w),
      static_cast<const uint8_t*>(empty), static_cast<float*>(out), n, k,
      bits, v, c, p_w, e_w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_bbit_linear_fwd(const void* codes, const void* w,
                                     void* out, int n, int k, int v, int c,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  repro_torch::bbit_linear_fwd_kernel<<<
      blocks, kRowsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(codes), static_cast<const float*>(w),
      static_cast<float*>(out), n, k, v, c);
  return static_cast<int>(cudaGetLastError());
}

// part: (splits, k, v, c) scratch, unused when splits == 1.
extern "C" int repro_bbit_linear_bwd_dw(const void* codes, const void* dout,
                                        void* part, void* out, int n, int k,
                                        int v, int c, int splits,
                                        int rows_per_split, int device,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  repro_torch::WidenedCodes code_at{static_cast<const int32_t*>(codes), k, v};
  return repro_torch::launch_dw(code_at, dout, part, out, n, k, v, c, splits,
                                rows_per_split,
                                static_cast<cudaStream_t>(stream));
}

extern "C" int repro_bbit_linear_packed_bwd_dw(
    const void* packed, const void* empty, const void* dout, void* part,
    void* out, int n, int k, int bits, int v, int c, int p_w, int e_w,
    int splits, int rows_per_split, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  repro_torch::PackedCodes code_at{static_cast<const uint8_t*>(packed),
                                   static_cast<const uint8_t*>(empty), bits,
                                   p_w, e_w};
  return repro_torch::launch_dw(code_at, dout, part, out, n, k, v, c, splits,
                                rows_per_split,
                                static_cast<cudaStream_t>(stream));
}

extern "C" const char* repro_bbit_linear_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
