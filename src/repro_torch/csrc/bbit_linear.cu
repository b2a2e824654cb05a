// b-bit linear layer kernels for Hopper (sm_90a): the forward from packed
// (B5) or widened (B7) codes, and dW from widened (B8) or packed (B6) codes.
// A widened code outside [0, V) adds nothing, in the forward and in dW, as
// the TPU kernels' one-hot compare of such a code matches no column.
//
// B5 bbit_linear_packed_fwd replaces
// src/repro/kernels/bbit_linear.py::bbit_linear_packed_fwd_pallas:
//   logits[n, c] = sum_j W[j, code(n, j), c], the codes unpacked in
//   registers from the LSB-first packed row, bins marked in the optional
//   MSB-first empty mask skipped.  Bound: device-memory bytes -- the
//   packed rows, the mask and the table entries the codes select, each
//   read once; one float add per (row, bin, class).  At serving's 64 rows
//   of k=256 that is about 15 ns, far below a launch, so what the kernel
//   costs is its chain of dependent loads.  Design: a warp a row, a lane 8
//   consecutive bins at a time: their 8 codes are exactly `bits` whole
//   bytes (one 8-, 4-, 2- or 1-byte load where the rows start aligned,
//   kVec, chosen by the wrapper from the shapes and the pointer) and their
//   8 mask bits exactly one mask byte.  The lane unpacks in registers and
//   starts its 8 table gathers before any add, so a row of k=256 costs one
//   wave of packed loads and one of gathers; wider k steps 256 bins at a
//   time, in order.  A lane sums its 8 values in a fixed tree, its steps
//   in order, and the warp in a fixed shuffle tree: no float atomics, so
//   a row's logits are the same bits on every run.  Blocks hold 1-8 rows
//   (kernels/bbit_linear.py::packed_fwd_layout), so a few rows spread over
//   as many SMs.  Classes are taken one after another.
//
// B5 and B7 read a float32 or a bfloat16 table in place (the table type T
// a template argument): a lane gathers its values' bits, widens them to
// float32 (exactly: a bfloat16 is a float32's high 16 bits) and sums them
// in the same order as from a float32 table, so a bfloat16 table's logits
// are the bits of the same kernel on that table widened.  B6 and B8 sum
// in float32 and write dW as float32 or, for a bfloat16 table, as
// bfloat16 rounded to nearest even (the output type a template argument):
// the bits of the float32 dW rounded by torch's .to(torch.bfloat16).  The
// 2-byte table halves the table and dW's bytes; B7's gathers gain from it
// only where the rows gather each table value many times, as a smaller
// table keeps more of itself in L2 (PERF.md section 6).
//
// B7 bbit_linear_fwd replaces bbit_linear.py::bbit_linear_fwd_pallas: the
//   same sum from widened int32 (n, k) codes.  Bound: bytes -- the codes
//   and the table entries they select, read once, and the logits.  What
//   holds a gather back is where the table lies: at b=16 the (500, 65536)
//   table is 131 MB, 2.6x the L2, and gathers that miss it at random pull
//   a whole DRAM sector for 4 useful bytes; at b=8 the (256, 256) table
//   sits in L2, and a gather that misses L1 still costs an L2 sector.  At
//   541,919 rows every table value is gathered 8.3 times a call: one pass
//   over all bins gathers 58 G values/s on an H100, a table inside L2 124
//   G/s (PERF.md section 6).  Design, after the TPU kernel's own grid (row
//   blocks, bin blocks, the bins the accumulation axis): a grid of (row
//   tiles, bin groups), the group the slower index, so the blocks resident
//   together read one group's slice of the table.  Where a 32-bin slice
//   fits L1 (V x C <= 512) a group is 32 bins, and each group writes its
//   partial logits, which a second kernel adds in group order.  Else one
//   group of all k, and where the table passes a sixth of the L2 and the
//   rows gather each value 1.75 times or more, the bins are walked in slices
//   whose part of the table fits that sixth: one launch a slice, in bin
//   order, so the whole card gathers from one slice at a time, from L2;
//   each launch carries on from the sums the last one left in out
//   (kernels/bbit_linear.py::fwd_layout and fwd_slices, from the shapes
//   and the card's L2 alone).  A thread takes one row of one group or
//   slice, 32 bins at a time: it loads the 32 codes (16 bytes at a time
//   where rows are 16-byte aligned) before any of their gathers, so 32
//   gathers are in flight, sums each chunk in a fixed tree and adds the
//   chunks to its sum in bin order.  A slice ends on a chunk's edge, so a
//   row's logits are the same bits at any slice width.  No float atomics:
//   the same bits on every run.
//
// B8 bbit_linear_bwd_dw replaces bbit_linear.py::bbit_linear_bwd_dw_pallas:
//   dW[j, v, c] = sum_n 1{codes[n, j] = v} * dout[n, c].  Bound: bytes --
//   the codes and dout read once, dW written once.  What holds it back: at
//   V=65536 dW is 131 MB and mostly zeros, and a histogram per bin does not
//   fit a block's shared memory.  Design: what depends on the codes alone
//   is a plan, built once per codes tensor (TRON calls B8 about 51 times
//   on the same training codes, and the wrapper caches the plan): for each
//   bin j, the rows whose code lies in [0, V), ordered by (code, row).
//   dw_plan_kernel is one pass of a stable LSD radix sort on 8-bit digits
//   (one pass for V <= 256, two for V <= 65536), one block per bin: tiles
//   of 256 rows are taken in row order, and a row's place among its tile's
//   rows of the same digit is its rank in its warp (__match_any_sync) plus
//   the counts of the warps before it.  The plan is perm (k, n), the rows,
//   and scode (k, n), their codes (past a bin's kept entries, -1 and V),
//   and offsets (k, 257), where each value of the last pass's digit starts
//   (for V <= 256, each value's run).  dw_sum_kernel then runs on every
//   call: a block owns a slice of up to 2,048 of one bin's values, about
//   8,192 entries, and takes the slice's entries from the offsets.  It
//   walks them in windows of 2,048, eight consecutive entries a thread
//   with all their loads in flight, so a long run of one value (real
//   codes hold long runs of rows sharing a code) is spread over the
//   block like any other entries.  A
//   segmented scan (a fixed shuffle tree in each warp, then the warps in
//   order, after the carry of the run open at the window's start) gives
//   each thread the sum of its first run's entries before it; the thread
//   holding a run's last entry writes the run's sum to shared memory, and
//   the slice, zeros included, is stored once.  Every sum's order depends
//   on the shapes and the codes only, so dW is the same bytes from a plan
//   just built or one cached.
//
// B6 bbit_linear_packed_bwd_dw replaces
//   bbit_linear.py::bbit_linear_packed_bwd_dw_pallas: the same dW from
//   packed codes, bins marked in the empty mask contributing nothing.  The
//   streaming trainer calls it on new codes every batch, where a plan
//   would not pay back, so it keeps histograms.  Bound: bytes -- the packed
//   rows and mask and dout read once, dW written once; at the stream
//   batch's 1,024 rows that is far below a launch, so what the kernel
//   costs is its chain of dependent steps.  Design: one launch.  A block
//   owns 8 consecutive bins, whose codes are `bits` whole bytes of a row
//   (one load where rows start aligned, kVec) and whose mask bits one byte,
//   and a span of the rows; the span is cut over a thread-block cluster of
//   `parts` blocks (kernels/bbit_linear.py::packed_dw_layout, from the
//   shapes alone).  The block first stages its rows' bytes, mask bytes and
//   dout in shared memory, every load in flight at once.  A b-bit code
//   takes 2^b values, so a bin's histogram has 2^b entries whatever V is,
//   and dW's values from 2^b on are stored as zeros.  Each warp keeps its
//   own histograms of the 8 bins and walks 32-row groups in 8 steps of 4
//   rows: lane 4e + q takes bin e of row 4i + q at step i, reading the
//   codes and douts of all 4 rows of the step (16-byte loads the bin's 4
//   lanes share); the lowest lane of each code adds their douts in lane
//   order and adds the sum to the warp's histogram.  No warp-wide match,
//   no shuffles and no float atomics: the adds that may meet are a step
//   apart, in order.  The warps' histograms are then added
//   in warp order, and the cluster's blocks read each other's through
//   distributed shared memory and add them in rank order.  Every sum's
//   order depends on the shapes and codes only, so dW is the same bits on
//   every run (the streaming trainer's bit-identical resume).  The classes
//   are taken one after another, so any C works.
#include <algorithm>

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace repro_torch {
namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kPackedFwdMaxRows = 8;  // B5: rows (warps) a block, at most
constexpr int kFwdThreads = 256;     // B7: threads per block
constexpr int kFwdChunk = 32;        // B7: bins a thread gathers at once
constexpr int kPlanThreads = 256;    // B8 plan: threads of a bin's block
constexpr int kPlanWarps = kPlanThreads / 32;
constexpr int kRadix = 256;          // B8 plan: values of an 8-bit digit
constexpr int kSumThreads = 256;     // B8 sum: threads per block
constexpr int kSumWarps = kSumThreads / 32;
constexpr int kSumPer = 8;           // B8 sum: a thread's entries a window
constexpr int kSumWindow = kSumThreads * kSumPer;
constexpr int kSumMaxSpan = 2048;    // B8 sum: values of a block, at most
constexpr int kDwBins = 8;           // B6: bins a block
constexpr int kDwSteps = 8;          // B6: 4-row steps of a 32-row group
constexpr int kDwLoads = 8;          // B6: rows a thread stages a pass
constexpr int kDwStage = 1024;       // B6: rows a block stages at a time
constexpr int kDwMaxWarps = 16;      // B6: warps a block, at most
constexpr int kDwMaxParts = 8;       // B6: blocks a cluster along the rows
static_assert(kRadix == kPlanThreads, "a plan thread owns one digit");

#ifdef REPRO_DW_STAGES
// B6's stage probe, built only with -DREPRO_DW_STAGES (a library apart,
// scripts/sweep_bbit_linear.py --stages): each block's thread 0 writes its
// clock64 at marks 0-6, counted from the block's start, and the global
// timer (ns) at its start (8) and end (9); the last launch's marks are
// read back by repro_bbit_linear_dw_stages
constexpr int kDwProbeBlocks = 4096;
constexpr int kDwProbeMarks = 10;
__device__ long long dw_stage_marks[kDwProbeBlocks][kDwProbeMarks];
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define DW_PROBE_START                                        \
  const long long dw_t0 = clock64();                          \
  const int dw_blk = blockIdx.y * gridDim.x + blockIdx.x;     \
  if (threadIdx.x == 0 && dw_blk < kDwProbeBlocks) {          \
    dw_stage_marks[dw_blk][8] = global_ns();                  \
  }
#define DW_MARK(s)                                            \
  if (threadIdx.x == 0 && dw_blk < kDwProbeBlocks) {          \
    dw_stage_marks[dw_blk][s] = clock64() - dw_t0;            \
  }
#define DW_PROBE_END                                          \
  if (threadIdx.x == 0 && dw_blk < kDwProbeBlocks) {          \
    dw_stage_marks[dw_blk][9] = global_ns();                  \
  }
#else
#define DW_PROBE_START
#define DW_MARK(s)
#define DW_PROBE_END
#endif

// A table value's bits, and the bits widened to float32 (exact for
// bfloat16: its 16 bits are a float's high half; 0 bits widen to +0).  A
// lane gathers all its values' bits first and widens them after: widening
// each value as it is loaded let the compiler wait on every bfloat16
// gather in turn (B5 at 64 rows took 4.17 us on an H100, float32 2.95).
__device__ __forceinline__ uint32_t table_bits(const float* p) {
  return __float_as_uint(__ldg(p));
}
__device__ __forceinline__ uint32_t table_bits(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}
__device__ __forceinline__ float widen_bits(const float*, uint32_t u) {
  return __uint_as_float(u);
}
__device__ __forceinline__ float widen_bits(const __nv_bfloat16*,
                                            uint32_t u) {
  return __uint_as_float(u << 16);
}

// A dW value stored as float32, or as bfloat16 rounded to nearest even.
__device__ __forceinline__ void store_value(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_value(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Four consecutive dW values at p, aligned to 4 of them: one 16-byte
// store of floats, or one 8-byte store of bfloat16s.
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float warp_sum(float acc) {
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(kFull, acc, off);
  }
  return acc;
}

// The packed bytes of B5's bin group g (bins 8g .. 8g+7 of a row), as a
// little-endian word: code e of the group is bits [e * BITS, (e+1) * BITS).
// A whole group (full) is BITS bytes, one aligned load with kVec; the last
// group of a k that is not a multiple of 8 reads only its bytes in the row.
template <int BITS, bool kVec>
__device__ __forceinline__ uint64_t packed_group(const uint8_t* prow, int g,
                                                 bool full, int p_w) {
  const uint8_t* src = prow + g * BITS;
  if (kVec && full) {
    if constexpr (BITS == 8) {
      const uint2 t = __ldg(reinterpret_cast<const uint2*>(src));
      return static_cast<uint64_t>(t.x) | (static_cast<uint64_t>(t.y) << 32);
    } else if constexpr (BITS == 4) {
      return __ldg(reinterpret_cast<const unsigned*>(src));
    } else if constexpr (BITS == 2) {
      return __ldg(reinterpret_cast<const unsigned short*>(src));
    } else {
      return __ldg(src);
    }
  }
  uint64_t word = 0;
#pragma unroll
  for (int q = 0; q < BITS; ++q) {
    if (full || g * BITS + q < p_w) {
      word |= static_cast<uint64_t>(__ldg(src + q)) << (8 * q);
    }
  }
  return word;
}

// B5.  blockDim.x / 32 rows a block, one warp a row; T the table's type.
template <int BITS, bool kVec, typename T>
__global__ void __launch_bounds__(kPackedFwdMaxRows * 32)
bbit_linear_packed_fwd_kernel(const uint8_t* __restrict__ packed,
                              const T* __restrict__ w,
                              const uint8_t* __restrict__ empty,
                              float* __restrict__ out, int n, int k, int v,
                              int c, int p_w, int e_w) {
  constexpr uint32_t kMask = (1u << BITS) - 1u;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= n) return;  // whole warp: row is uniform across it
  const uint8_t* prow = packed + static_cast<size_t>(row) * p_w;
  const uint8_t* erow =
      empty == nullptr ? nullptr : empty + static_cast<size_t>(row) * e_w;
  const int groups = (k + 7) >> 3;
  for (int cc = 0; cc < c; ++cc) {
    float acc = 0.f;
    for (int g = lane; g < groups; g += 32) {
      const int j0 = 8 * g;
      const bool full = j0 + 8 <= k;
      const uint64_t word = packed_group<BITS, kVec>(prow, g, full, p_w);
      const uint32_t drop = erow == nullptr ? 0u : __ldg(erow + g);
      const T* wj = w + static_cast<size_t>(j0) * v * c + cc;
      uint32_t raw[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const uint32_t code = static_cast<uint32_t>(word >> (e * BITS)) & kMask;
        const bool live = (full || j0 + e < k) && !((drop >> (7 - e)) & 1u);
        raw[e] = live ? table_bits(wj + (static_cast<size_t>(e) * v + code) * c)
                      : 0u;
      }
      float x[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = widen_bits(wj, raw[e]);
      acc += ((x[0] + x[1]) + (x[2] + x[3])) + ((x[4] + x[5]) + (x[6] + x[7]));
    }
    acc = warp_sum(acc);
    if (lane == 0) out[static_cast<size_t>(row) * c + cc] = acc;
  }
}

template <int BITS, typename T>
cudaError_t launch_packed_fwd(int blocks, int rows, bool vec,
                              cudaStream_t st, const uint8_t* packed,
                              const T* w, const uint8_t* empty, float* out,
                              int n, int k, int v, int c, int p_w, int e_w) {
  if (vec) {
    bbit_linear_packed_fwd_kernel<BITS, true, T>
        <<<blocks, rows * 32, 0, st>>>(packed, w, empty, out, n, k, v, c,
                                       p_w, e_w);
  } else {
    bbit_linear_packed_fwd_kernel<BITS, false, T>
        <<<blocks, rows * 32, 0, st>>>(packed, w, empty, out, n, k, v, c,
                                       p_w, e_w);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_packed_fwd_bits(int bits, int blocks, int rows, bool vec,
                                   cudaStream_t st, const uint8_t* packed,
                                   const void* w, const uint8_t* empty,
                                   float* out, int n, int k, int v, int c,
                                   int p_w, int e_w) {
  const T* wp = static_cast<const T*>(w);
  switch (bits) {
    case 1:
      return launch_packed_fwd<1, T>(blocks, rows, vec, st, packed, wp, empty,
                                     out, n, k, v, c, p_w, e_w);
    case 2:
      return launch_packed_fwd<2, T>(blocks, rows, vec, st, packed, wp, empty,
                                     out, n, k, v, c, p_w, e_w);
    case 4:
      return launch_packed_fwd<4, T>(blocks, rows, vec, st, packed, wp, empty,
                                     out, n, k, v, c, p_w, e_w);
    case 8:
      return launch_packed_fwd<8, T>(blocks, rows, vec, st, packed, wp, empty,
                                     out, n, k, v, c, p_w, e_w);
    default:
      return cudaErrorInvalidValue;
  }
}

// B7.  grid (ceil(n / kFwdThreads), ceil(k / group)), the bin group on y,
// the bins from j_base on: out is (groups, n, c), each group's partial
// logits (the logits themselves when there is one group).  A thread takes
// one row's bins of its group, 32 at a time, in order.  With j_base > 0
// (a later bin slice, one group) the thread carries on from the sums that
// out holds.  kVec: rows start 16-byte aligned.  T: the table's type.
template <bool kVec, typename T>
__global__ void __launch_bounds__(kFwdThreads)
bbit_linear_fwd_kernel(const int32_t* __restrict__ codes,
                       const T* __restrict__ w, float* __restrict__ out,
                       int n, int k, int v, int c, int j_base, int group) {
  const int row = blockIdx.x * kFwdThreads + threadIdx.x;
  if (row >= n) return;
  const int j_lo = j_base + blockIdx.y * group;
  const int j_hi = min(k, j_lo + group);
  const int32_t* crow = codes + static_cast<size_t>(row) * k;
  float* dst = out + (static_cast<size_t>(blockIdx.y) * n + row) * c;
  for (int cc = 0; cc < c; ++cc) {
    float acc = j_base > 0 ? dst[cc] : 0.f;
    for (int j0 = j_lo; j0 < j_hi; j0 += kFwdChunk) {
      const int len = min(kFwdChunk, j_hi - j0);
      int code[kFwdChunk];
      if (kVec) {
        const int4* src = reinterpret_cast<const int4*>(crow + j0);
#pragma unroll
        for (int q = 0; q < kFwdChunk / 4; ++q) {
          int4 t = make_int4(-1, -1, -1, -1);
          if (4 * q < len) t = __ldg(src + q);
          code[4 * q] = t.x;
          code[4 * q + 1] = t.y;
          code[4 * q + 2] = t.z;
          code[4 * q + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < kFwdChunk; ++e) {
          code[e] = e < len ? __ldg(crow + j0 + e) : -1;
        }
      }
      const T* wj = w + static_cast<size_t>(j0) * v * c + cc;
      uint32_t raw[kFwdChunk];
#pragma unroll
      for (int e = 0; e < kFwdChunk; ++e) {
        const int cd = code[e];
        raw[e] = static_cast<unsigned>(cd) < static_cast<unsigned>(v)
                     ? table_bits(wj + (static_cast<size_t>(e) * v + cd) * c)
                     : 0u;
      }
      float x[kFwdChunk];
#pragma unroll
      for (int e = 0; e < kFwdChunk; ++e) x[e] = widen_bits(wj, raw[e]);
#pragma unroll
      for (int w = kFwdChunk / 2; w > 0; w >>= 1) {
#pragma unroll
        for (int e = 0; e < w; ++e) x[e] += x[e + w];
      }
      acc += x[0];
    }
    dst[cc] = acc;
  }
}

template <typename T>
void launch_fwd(dim3 grid, bool vec, cudaStream_t st, const int32_t* codes,
                const T* w, float* out, int n, int k, int v, int c,
                int j_base, int group) {
  if (vec) {
    bbit_linear_fwd_kernel<true, T><<<grid, kFwdThreads, 0, st>>>(
        codes, w, out, n, k, v, c, j_base, group);
  } else {
    bbit_linear_fwd_kernel<false, T><<<grid, kFwdThreads, 0, st>>>(
        codes, w, out, n, k, v, c, j_base, group);
  }
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Exclusive prefix sum of one int per thread over a kPlanThreads block.
__device__ int block_exclusive_sum(int x, int* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = x;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int t = lane < kPlanWarps ? warp_tot[lane] : 0;
    int ti = t;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, ti, off);
      if (lane >= off) ti += y;
    }
    if (lane < kPlanWarps) warp_tot[lane] = ti - t;
  }
  __syncthreads();
  return incl - x + warp_tot[warp];
}

// Entry i of one bin for a plan pass, false past the bin's m_in entries or
// for a code outside [0, v).  The first pass (icode == nullptr) reads the
// bin's column of the (n, k) codes, row i at entry i; a later pass the
// previous pass's output for the bin.
__device__ __forceinline__ bool plan_entry(const int32_t* codes,
                                           const int32_t* icode,
                                           const int32_t* iperm, int i,
                                           int m_in, int j, int k, int v,
                                           int& code, int& row) {
  if (i >= m_in) return false;
  if (icode == nullptr) {
    code = __ldg(codes + static_cast<size_t>(i) * k + j);
    row = i;
    return static_cast<unsigned>(code) < static_cast<unsigned>(v);
  }
  code = icode[i];
  row = iperm[i];
  return true;
}

// One pass of the plan's stable radix sort, block j for bin j: the bin's
// entries ordered by the digit (code >> shift) & 255, ties in their input
// order.  The first pass (in_code == nullptr) writes count[j], the number
// of codes in [0, v); a later pass reads count[j] entries of in_*.  The
// last pass fills the bin's tail past its entries with code v and row -1
// and writes offsets[j] (257): where each digit's entries start, and
// their count.
__global__ void __launch_bounds__(kPlanThreads)
dw_plan_kernel(const int32_t* __restrict__ codes,
               const int32_t* __restrict__ in_code,
               const int32_t* __restrict__ in_perm, int* __restrict__ count,
               int32_t* __restrict__ out_code, int32_t* __restrict__ out_perm,
               int32_t* __restrict__ offsets, int n, int k, int v, int shift,
               int last) {
  __shared__ int hist[kRadix];
  __shared__ int run[kRadix];
  __shared__ int wcnt[kPlanWarps][kRadix];
  __shared__ int warp_tot[kPlanWarps];
  __shared__ int total;
  const int j = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool first = in_code == nullptr;
  const int m_in = first ? n : count[j];
  const size_t base = static_cast<size_t>(j) * n;
  const int32_t* icode = first ? nullptr : in_code + base;
  const int32_t* iperm = first ? nullptr : in_perm + base;
  int32_t* ocode = out_code + base;
  int32_t* operm = out_perm + base;

  hist[threadIdx.x] = 0;
  for (int w = 0; w < kPlanWarps; ++w) wcnt[w][threadIdx.x] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < m_in; i += kPlanThreads) {
    int code, row;
    if (plan_entry(codes, icode, iperm, i, m_in, j, k, v, code, row)) {
      atomicAdd(&hist[(code >> shift) & (kRadix - 1)], 1);
    }
  }
  __syncthreads();
  const int h = hist[threadIdx.x];  // thread d owns digit d
  const int start = block_exclusive_sum(h, warp_tot);
  run[threadIdx.x] = start;
  if (threadIdx.x == kPlanThreads - 1) total = start + h;
  __syncthreads();

  const unsigned lt = lanemask_lt();
  for (int t0 = 0; t0 < m_in; t0 += kPlanThreads) {
    int code = 0, row = 0;
    const bool ok = plan_entry(codes, icode, iperm, t0 + threadIdx.x, m_in,
                               j, k, v, code, row);
    const int d = ok ? (code >> shift) & (kRadix - 1) : -1;
    const unsigned peers = __match_any_sync(kFull, d);
    const bool leader = lane == __ffs(peers) - 1;
    if (ok && leader) wcnt[warp][d] = __popc(peers);
    __syncthreads();
    if (ok) {
      int pos = run[d] + __popc(peers & lt);
      for (int w = 0; w < warp; ++w) pos += wcnt[w][d];
      ocode[pos] = code;
      operm[pos] = row;
    }
    __syncthreads();  // every place is taken before the runs move on
    if (ok && leader) {
      atomicAdd(&run[d], __popc(peers));
      wcnt[warp][d] = 0;
    }
    __syncthreads();
  }
  if (first && threadIdx.x == 0) count[j] = total;
  if (last) {
    int32_t* off = offsets + static_cast<size_t>(j) * (kRadix + 1);
    off[threadIdx.x] = start;
    if (threadIdx.x == 0) off[kRadix] = total;
    for (int i = total + threadIdx.x; i < n; i += kPlanThreads) {
      ocode[i] = v;
      operm[i] = -1;
    }
  }
}

// The first entry in [lo, hi) of the sorted sc that is >= target (hi if
// none), found by the whole block: each round probes kSumThreads evenly
// spaced entries and keeps the stretch between the last one below target
// and the next.
__device__ int block_lower_bound(const int32_t* sc, int lo, int hi,
                                 int target) {
  while (lo < hi) {  // lo and hi are the same in every thread
    const int step = (hi - lo + kSumThreads - 1) / kSumThreads;
    const int p = lo + static_cast<int>(threadIdx.x) * step;
    const int below = __syncthreads_count(p < hi && __ldg(sc + p) < target);
    if (below == 0) {
      hi = lo;
    } else {
      const int next = lo + (below - 1) * step + 1;
      hi = min(hi, lo + below * step);
      lo = next;
    }
  }
  return lo;
}

// B8's sum.  grid (k, ceil(v / span)): block (j, y) owns
// dW[j, y * span : (y + 1) * span, :] and writes each of its values once.
// Its entries [s, e) (the bin's sorted entries with codes in the slice)
// come from the offsets of the plan's last radix digit (code >> shift),
// searched within a digit where the slice does not start or end on a
// digit's boundary.  They are taken in windows of kSumWindow, thread t
// the kSumPer consecutive entries from t * kSumPer, all loads in flight.
// A run (a value's entries) may cross threads and windows: each thread sums
// its entries of a run in order; a segmented scan over the threads (a
// fixed shuffle tree in each warp, then the warps in order, after the
// run's carry from earlier windows) gives each thread the sum of its
// first run's entries before it.  The thread that holds a run's last
// entry writes the run's sum to res; res, zeros included, is stored once.
// Every sum's order depends on the shapes and the codes only.  OutT: dW's
// type, float or bfloat16 (each float32 sum rounded as it is stored).
template <typename OutT>
__global__ void __launch_bounds__(kSumThreads)
dw_sum_kernel(const int32_t* __restrict__ scode,
              const int32_t* __restrict__ perm,
              const int32_t* __restrict__ offsets,
              const float* __restrict__ dout, OutT* __restrict__ out, int n,
              int v, int c, int span, int shift) {
  __shared__ __align__(16) float res[kSumMaxSpan];    // the slice's sums
  __shared__ int first_key[kSumThreads + 1];  // [kSumThreads]: the next one
  __shared__ int last_key[kSumThreads];
  __shared__ float upto[kSumThreads];  // a thread's last run's sum so far
  __shared__ int warp_head[kSumWarps];
  __shared__ float warp_tail[kSumWarps];
  __shared__ int carry_key;            // the run open at a window's end
  __shared__ float carry;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j = blockIdx.x;
  const int v0 = blockIdx.y * span;
  const int nv = min(span, v - v0);
  const int v1 = v0 + nv;
  const int32_t* sc = scode + static_cast<size_t>(j) * n;
  const int32_t* pm = perm + static_cast<size_t>(j) * n;
  const int32_t* off = offsets + static_cast<size_t>(j) * (kRadix + 1);
  const int digit = (1 << shift) - 1;
  int s, e;
  if ((v0 & digit) == 0) {
    s = __ldg(off + (v0 >> shift));
  } else {
    const int r = v0 >> shift;
    s = block_lower_bound(sc, __ldg(off + r), __ldg(off + r + 1), v0);
  }
  if (v1 == v) {
    e = __ldg(off + kRadix);
  } else if ((v1 & digit) == 0) {
    e = __ldg(off + (v1 >> shift));
  } else {
    const int r = v1 >> shift;
    e = block_lower_bound(sc, max(s, __ldg(off + r)), __ldg(off + r + 1),
                          v1);
  }
  for (int cc = 0; cc < c; ++cc) {
    for (int t = threadIdx.x; t < nv; t += kSumThreads) res[t] = 0.f;
    if (threadIdx.x == 0) {
      carry_key = -1;
      carry = 0.f;
    }
    for (int w0 = s; w0 < e; w0 += kSumWindow) {
      // this thread's entries; past e, key v (no value) and 0
      const int base = w0 + threadIdx.x * kSumPer;
      int key[kSumPer];
      float x[kSumPer];
#pragma unroll
      for (int q = 0; q < kSumPer; ++q) {
        const bool in = base + q < e;
        key[q] = in ? __ldg(sc + base + q) : v;
        x[q] = in ? __ldg(dout + static_cast<size_t>(__ldg(pm + base + q)) *
                                     c + cc)
                  : 0.f;
      }
      first_key[threadIdx.x] = key[0];
      last_key[threadIdx.x] = key[kSumPer - 1];
      if (threadIdx.x == 0) {
        first_key[kSumThreads] =
            w0 + kSumWindow < e ? __ldg(sc + w0 + kSumWindow) : v;
      }
      __syncthreads();  // keys and the carry are in
      const int before =
          threadIdx.x == 0 ? carry_key : last_key[threadIdx.x - 1];
      // the thread's last run: its sum here, and whether it starts here
      int head = 0;
      float tail = 0.f;
#pragma unroll
      for (int q = 0; q < kSumPer; ++q) {
        if (key[q] != (q == 0 ? before : key[q - 1])) {
          head = 1;
          tail = 0.f;
        }
        tail += x[q];
      }
      // segmented inclusive scan of (head, tail) over the warp
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int h = __shfl_up_sync(kFull, head, d);
        const float t = __shfl_up_sync(kFull, tail, d);
        if (lane >= d) {
          if (!head) tail = t + tail;
          head |= h;
        }
      }
      if (lane == 31) {
        warp_head[warp] = head;
        warp_tail[warp] = tail;
      }
      __syncthreads();
      if (warp == 0) {
        // the warps' prefixes, in order, after the window's carry
        int h = lane < kSumWarps ? warp_head[lane] : 1;
        float t = lane < kSumWarps ? warp_tail[lane] : 0.f;
        if (lane == 0 && !h) t = carry + t;
#pragma unroll
        for (int d = 1; d < kSumWarps; d <<= 1) {
          const int hu = __shfl_up_sync(kFull, h, d);
          const float tu = __shfl_up_sync(kFull, t, d);
          if (lane >= d) {
            if (!h) t = tu + t;
            h |= hu;
          }
        }
        const float before_sum = __shfl_up_sync(kFull, t, 1);
        if (lane < kSumWarps) warp_tail[lane] = lane == 0 ? carry : before_sum;
      }
      __syncthreads();
      if (!head) tail = warp_tail[warp] + tail;
      upto[threadIdx.x] = tail;
      __syncthreads();
      // each run's sum, written by the thread with its last entry
      float acc = key[0] == before
                      ? (threadIdx.x == 0 ? carry : upto[threadIdx.x - 1])
                      : 0.f;
#pragma unroll
      for (int q = 0; q < kSumPer; ++q) {
        if (q > 0 && key[q] != key[q - 1]) acc = 0.f;
        acc += x[q];
        const int next =
            q + 1 < kSumPer ? key[q + 1] : first_key[threadIdx.x + 1];
        if (key[q] != next && key[q] < v1) res[key[q] - v0] = acc;
      }
      __syncthreads();  // the carry is read before it moves on
      if (threadIdx.x == kSumThreads - 1) {
        carry_key = key[kSumPer - 1];
        carry = tail;
      }
    }
    __syncthreads();  // res is complete
    OutT* dst = out + (static_cast<size_t>(j) * v + v0) * c + cc;
    if (c == 1 &&
        (reinterpret_cast<uintptr_t>(dst) & (4 * sizeof(OutT) - 1)) == 0) {
      const int n4 = nv >> 2;
      for (int q = threadIdx.x; q < n4; q += kSumThreads) {
        store4(dst + 4 * q, reinterpret_cast<const float4*>(res)[q]);
      }
      for (int t = 4 * n4 + threadIdx.x; t < nv; t += kSumThreads) {
        store_value(dst + t, res[t]);
      }
    } else {
      for (int t = threadIdx.x; t < nv; t += kSumThreads) {
        store_value(dst + static_cast<size_t>(t) * c, res[t]);
      }
    }
    __syncthreads();  // res is stored before the next class clears it
  }
}

// B6.  grid (ceil(k / 8), parts), a cluster of parts blocks along y: block
// (x, rank) owns bins [8x, 8x + 8) and the rank-th of `parts` spans of the
// 32-row groups.  It stages up to kDwStage rows of the span at a time --
// each row's `bits` bytes of the 8 bins, its mask byte and dout, every
// load of the stage in flight at once -- then warp w takes the stage's
// groups w, w + warps, ... in 8 steps of 4 rows: lane 4e + q takes bin e
// of row 4i + q at step i and reads the codes and douts of all 4 rows of
// the step; the lowest lane of each code adds their douts in lane order
// and adds the sum to the warp's histogram of the bin.
// Dynamic shared memory: warps x 8 x 2^BITS floats ([warp][bin][value]),
// then the stage.  OutT: dW's type, float or bfloat16.
template <int BITS, bool kVec, typename OutT>
__global__ void __launch_bounds__(kDwMaxWarps * 32)
bbit_linear_packed_dw_kernel(const uint8_t* __restrict__ packed,
                             const uint8_t* __restrict__ empty,
                             const float* __restrict__ dout,
                             OutT* __restrict__ out, int n, int k, int v,
                             int c, int p_w, int e_w) {
  constexpr int kVals = 1 << BITS;
  constexpr int kCells = kDwBins * kVals;
  constexpr uint32_t kMask = kVals - 1u;
  DW_PROBE_START
  extern __shared__ float hist[];
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int e = lane >> 2;          // the lane's bin of the block's 8
  const int q = lane & 3;           // its row of each 4-row step
  const int g8 = blockIdx.x;
  const int j0 = kDwBins * g8;
  const bool full = j0 + kDwBins <= k;
  const bool live = j0 + e < k;
  const int rank = blockIdx.y;
  const int parts = gridDim.y;
  const int groups = (n + 31) >> 5;
  const int lo = groups / parts * rank + min(rank, groups % parts);
  const int hi = lo + groups / parts + (rank < groups % parts ? 1 : 0);
  float* h = hist + warp * kCells + e * kVals;  // the warp's bin e
  uint64_t* s_word = reinterpret_cast<uint64_t*>(hist + warps * kCells);
  float* s_d = reinterpret_cast<float*>(s_word + kDwStage);
  uint8_t* s_mb = reinterpret_cast<uint8_t*>(s_d + kDwStage);
  for (int cc = 0; cc < c; ++cc) {
    DW_MARK(0)
    for (int r0 = 32 * lo; r0 < 32 * hi; r0 += kDwStage) {
      const int rows = min(kDwStage, min(n, 32 * hi) - r0);
      __syncthreads();  // the last stage (or class) is consumed
      // kDwLoads rows a thread a pass, every load in flight before
      // any store; the first pass's loads also before the histograms are
      // cleared
      for (int base = 0; base < rows; base += kDwLoads * blockDim.x) {
        uint64_t word[kDwLoads];
        uint32_t mb[kDwLoads];
        float d[kDwLoads];
#pragma unroll
        for (int u = 0; u < kDwLoads; ++u) {
          const int i = base + u * blockDim.x + threadIdx.x;
          const int row = r0 + i;
          const bool ok = i < rows;
          word[u] = ok ? packed_group<BITS, kVec>(
                             packed + static_cast<size_t>(row) * p_w, g8,
                             full, p_w)
                       : 0u;
          mb[u] = ok && empty != nullptr
                      ? __ldg(empty + static_cast<size_t>(row) * e_w + g8)
                      : 0u;
          d[u] = ok ? __ldg(dout + static_cast<size_t>(row) * c + cc) : 0.f;
        }
        if (r0 == 32 * lo && base == 0) {
          for (int i = threadIdx.x; i < warps * kCells / 4; i += blockDim.x) {
            reinterpret_cast<float4*>(hist)[i] =
                make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
#pragma unroll
        for (int u = 0; u < kDwLoads; ++u) {
          const int i = base + u * blockDim.x + threadIdx.x;
          if (i < rows) {
            s_word[i] = word[u];
            s_mb[i] = static_cast<uint8_t>(mb[u]);
            s_d[i] = d[u];
          }
        }
      }
      __syncthreads();
      DW_MARK(1)
      for (int g = warp; 32 * g < rows; g += warps) {
        // first every step's code and sum, which need no histogram: step i
        // takes rows 32g + 4i .. + 3, row 4i + q this lane's, and each
        // lane reads all 4 (16-byte loads the bin's 4 lanes share).  A row
        // past the stage, a bin past k or one the mask drops gets a code of
        // its own, below 0, so that it shares no code; the lowest lane of
        // each code sums the douts of its code in lane order
        int code[kDwSteps];
        float sum[kDwSteps];
        bool lead[kDwSteps];
#pragma unroll
        for (int i = 0; i < kDwSteps; ++i) {
          const int r = 32 * g + 4 * i;  // + 3 < kDwStage, a multiple of 32
          const ulonglong2 w01 =
              *reinterpret_cast<const ulonglong2*>(s_word + r);
          const ulonglong2 w23 =
              *reinterpret_cast<const ulonglong2*>(s_word + r + 2);
          const float4 d4 = *reinterpret_cast<const float4*>(s_d + r);
          const uint32_t m4 = *reinterpret_cast<const uint32_t*>(s_mb + r);
          const uint64_t w[4] = {w01.x, w01.y, w23.x, w23.y};
          const float d[4] = {d4.x, d4.y, d4.z, d4.w};
          int pc[4];
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const bool keep =
                live && r + p < rows && !((m4 >> (8 * p + 7 - e)) & 1u);
            pc[p] = keep ? static_cast<int>(
                               static_cast<uint32_t>(w[p] >> (e * BITS)) &
                               kMask)
                         : -1 - p;
          }
          code[i] = q == 0 ? pc[0] : q == 1 ? pc[1] : q == 2 ? pc[2] : pc[3];
          sum[i] = 0.f;
          lead[i] = code[i] >= 0;
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            if (pc[p] == code[i]) {
              sum[i] += d[p];
              lead[i] = lead[i] && p >= q;
            }
          }
        }
        // then the adds, a step at a time: a later step may add to a value
        // an earlier one did
#pragma unroll
        for (int i = 0; i < kDwSteps; ++i) {
          if (lead[i]) h[code[i]] += sum[i];
          __syncwarp();
        }
      }
    }
    if (lo >= hi) {  // no rows: the histograms are still to be cleared
      for (int i = threadIdx.x; i < warps * kCells / 4; i += blockDim.x) {
        reinterpret_cast<float4*>(hist)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    __syncthreads();
    DW_MARK(2)
    // the block's histograms: the warps added in warp order, into warp 0's
    for (int i = threadIdx.x; i < kCells / 4; i += blockDim.x) {
      float4 p[kDwMaxWarps];  // every warp's load in flight, then the sum
#pragma unroll
      for (int w = 0; w < kDwMaxWarps; ++w) {
        p[w] = w < warps
                   ? reinterpret_cast<const float4*>(hist + w * kCells)[i]
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float4 acc = p[0];
#pragma unroll
      for (int w = 1; w < kDwMaxWarps; ++w) {
        if (w < warps) {
          acc.x += p[w].x;
          acc.y += p[w].y;
          acc.z += p[w].z;
          acc.w += p[w].w;
        }
      }
      reinterpret_cast<float4*>(hist)[i] = acc;
    }
    DW_MARK(3)
    cluster.sync();
    DW_MARK(4)
    // dW: this rank's share of the cells (4 a thread), the cluster's blocks
    // added in rank order, every rank's load in flight before the sum; and
    // its share of the values from 2^BITS on, zeros
    for (int i = rank * blockDim.x + threadIdx.x; i < kCells / 4;
         i += parts * blockDim.x) {
      float4 p[kDwMaxParts];
#pragma unroll
      for (int r = 0; r < kDwMaxParts; ++r) {
        p[r] = r < parts ? reinterpret_cast<const float4*>(
                               cluster.map_shared_rank(hist, r))[i]
                         : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float4 acc = p[0];
#pragma unroll
      for (int r = 1; r < kDwMaxParts; ++r) {
        if (r < parts) {
          acc.x += p[r].x;
          acc.y += p[r].y;
          acc.z += p[r].z;
          acc.w += p[r].w;
        }
      }
      const float vals[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int be = (4 * i + t) / kVals;
        const int x = (4 * i + t) % kVals;
        if (j0 + be < k) {
          store_value(out + (static_cast<size_t>(j0 + be) * v + x) * c + cc,
                      vals[t]);
        }
      }
    }
    DW_MARK(5)
    const int rest = v - kVals;
    for (int i = rank * blockDim.x + threadIdx.x; i < kDwBins * rest;
         i += parts * blockDim.x) {
      const int be = i / rest;
      if (j0 + be < k) {
        store_value(
            out + (static_cast<size_t>(j0 + be) * v + kVals + i % rest) * c +
                cc,
            0.f);
      }
    }
    cluster.sync();  // the histograms are read before the next class clears them
    DW_MARK(6)
  }
  DW_PROBE_END
}

template <int BITS, typename OutT>
int launch_packed_dw(const uint8_t* packed, const uint8_t* empty,
                     const float* dout, OutT* out, int n, int k, int v,
                     int c, int p_w, int e_w, int warps, int parts, bool vec,
                     cudaStream_t stream) {
  auto kernel = vec ? bbit_linear_packed_dw_kernel<BITS, true, OutT>
                    : bbit_linear_packed_dw_kernel<BITS, false, OutT>;
  const size_t smem = sizeof(float) * static_cast<size_t>(warps) * kDwBins *
                          (1 << BITS) +
                      kDwStage * (sizeof(uint64_t) + sizeof(float) + 1);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((k + kDwBins - 1) / kDwBins, parts);
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = parts;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, packed, empty, dout, out, n, k, v, c,
                           p_w, e_w);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int launch_packed_dw_bits(int bits, const uint8_t* packed,
                          const uint8_t* empty, const float* dout, void* out,
                          int n, int k, int v, int c, int p_w, int e_w,
                          int warps, int parts, bool vec,
                          cudaStream_t stream) {
  OutT* op = static_cast<OutT*>(out);
  switch (bits) {
    case 1:
      return launch_packed_dw<1, OutT>(packed, empty, dout, op, n, k, v, c,
                                       p_w, e_w, warps, parts, vec, stream);
    case 2:
      return launch_packed_dw<2, OutT>(packed, empty, dout, op, n, k, v, c,
                                       p_w, e_w, warps, parts, vec, stream);
    case 4:
      return launch_packed_dw<4, OutT>(packed, empty, dout, op, n, k, v, c,
                                       p_w, e_w, warps, parts, vec, stream);
    case 8:
      return launch_packed_dw<8, OutT>(packed, empty, dout, op, n, k, v, c,
                                       p_w, e_w, warps, parts, vec, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
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

}  // namespace
}  // namespace repro_torch

// Launches B5 with `rows` rows (warps) a block; vec: every row starts
// aligned to `bits` bytes, so a whole group of 8 codes is one load;
// bf16: the table w is bfloat16 (else float32).
extern "C" int repro_bbit_linear_packed_fwd(const void* packed, const void* w,
                                            const void* empty, void* out,
                                            int n, int k, int bits, int v,
                                            int c, int p_w, int e_w,
                                            int rows, int vec, int bf16,
                                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  if (rows < 1 || rows > repro_torch::kPackedFwdMaxRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (n + rows - 1) / rows;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* pp = static_cast<const uint8_t*>(packed);
  const uint8_t* ep = static_cast<const uint8_t*>(empty);
  float* op = static_cast<float*>(out);
  err = bf16 ? repro_torch::launch_packed_fwd_bits<__nv_bfloat16>(
                   bits, blocks, rows, vec, st, pp, w, ep, op, n, k, v, c,
                   p_w, e_w)
             : repro_torch::launch_packed_fwd_bits<float>(
                   bits, blocks, rows, vec, st, pp, w, ep, op, n, k, v, c,
                   p_w, e_w);
  return static_cast<int>(err);
}

// Launches B7: out (n, c), part (groups, n, c) scratch (unused when there
// is one group); with one group (group >= k), one launch a slice of
// `width` bins, in bin order, each carrying on from the sums of the one
// before in out; bf16: the table w is bfloat16 (else float32).
extern "C" int repro_bbit_linear_fwd(const void* codes, const void* w,
                                     void* part, void* out, int n, int k,
                                     int v, int c, int group, int width,
                                     int vec, int bf16, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0 || c == 0) return 0;
  if (k == 0) {  // no bins: the logits are zeros
    return static_cast<int>(cudaMemsetAsync(
        out, 0, static_cast<size_t>(n) * c * sizeof(float), st));
  }
  if (group < 1 || width < 1 ||
      (width < k && (group < k || width % repro_torch::kFwdChunk != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int groups = (k + group - 1) / group;
  const int slices = groups == 1 ? (k + width - 1) / width : 1;
  const dim3 grid((n + repro_torch::kFwdThreads - 1) / repro_torch::kFwdThreads,
                  groups);
  float* dst = static_cast<float*>(groups == 1 ? out : part);
  const int32_t* cp = static_cast<const int32_t*>(codes);
  for (int s = 0; s < slices; ++s) {
    const int j_base = s * width;
    const int bins = slices == 1 ? group : width;
    if (bf16) {
      repro_torch::launch_fwd(grid, vec, st, cp,
                              static_cast<const __nv_bfloat16*>(w), dst, n,
                              k, v, c, j_base, bins);
    } else {
      repro_torch::launch_fwd(grid, vec, st, cp,
                              static_cast<const float*>(w), dst, n, k, v, c,
                              j_base, bins);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (groups == 1) return 0;
  const size_t total = static_cast<size_t>(n) * c;
  const int blocks =
      static_cast<int>(std::min((total + 255) / 256, size_t{4096}));
  repro_torch::sum_splits_kernel<<<blocks, 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(out), total,
      groups);
  return static_cast<int>(cudaGetLastError());
}

// Builds B8's plan of int32 (n, k) codes: out_perm and out_code (k, n)
// and offsets (k, 257) (the last pass's digit starts), in `passes` radix
// passes (count (k,) and tmp_* (k, n) scratch, tmp_* unused with one
// pass).  The passes alternate between out_* and tmp_* so that the last
// one writes out_*.
extern "C" int repro_bbit_linear_dw_plan(const void* codes, void* tmp_code,
                                         void* tmp_perm, void* count,
                                         void* out_code, void* out_perm,
                                         void* offsets, int n, int k, int v,
                                         int passes, int device,
                                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k == 0) return 0;
  if (passes < 1 || passes > 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* outs[2] = {static_cast<int32_t*>(out_code),
                      static_cast<int32_t*>(tmp_code)};
  int32_t* perms[2] = {static_cast<int32_t*>(out_perm),
                       static_cast<int32_t*>(tmp_perm)};
  for (int p = 0; p < passes; ++p) {
    const int to = (passes - 1 - p) & 1;  // 0: out_*, 1: tmp_*
    const int32_t* in_code = p == 0 ? nullptr : outs[to ^ 1];
    const int32_t* in_perm = p == 0 ? nullptr : perms[to ^ 1];
    repro_torch::dw_plan_kernel<<<k, repro_torch::kPlanThreads, 0, st>>>(
        static_cast<const int32_t*>(codes), in_code, in_perm,
        static_cast<int*>(count), outs[to], perms[to],
        static_cast<int32_t*>(offsets), n, k, v, 8 * p, p == passes - 1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// B8's sum over a plan: out (k, v, c), span values of dW per block; shift
// is the plan's last radix digit's, 8 x (passes - 1); bf16: out is
// bfloat16 (else float32).
extern "C" int repro_bbit_linear_dw_sum(const void* scode, const void* perm,
                                        const void* offsets,
                                        const void* dout, void* out, int n,
                                        int k, int v, int c, int span,
                                        int shift, int bf16, int device,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k == 0 || v == 0 || c == 0) return 0;
  if (span < 1 || span > repro_torch::kSumMaxSpan || shift < 0 ||
      shift > 24) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(k, (v + span - 1) / span);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* sp = static_cast<const int32_t*>(scode);
  const int32_t* pp = static_cast<const int32_t*>(perm);
  const int32_t* op = static_cast<const int32_t*>(offsets);
  const float* dp = static_cast<const float*>(dout);
  if (bf16) {
    repro_torch::dw_sum_kernel<<<grid, repro_torch::kSumThreads, 0, st>>>(
        sp, pp, op, dp, static_cast<__nv_bfloat16*>(out), n, v, c, span,
        shift);
  } else {
    repro_torch::dw_sum_kernel<<<grid, repro_torch::kSumThreads, 0, st>>>(
        sp, pp, op, dp, static_cast<float*>(out), n, v, c, span, shift);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches B6: out (k, v, c); `warps` warps a block, `parts` blocks a
// cluster along the rows; vec: every row starts aligned to `bits` bytes;
// bf16: out is bfloat16 (else float32).
extern "C" int repro_bbit_linear_packed_bwd_dw(
    const void* packed, const void* empty, const void* dout, void* out, int n,
    int k, int bits, int v, int c, int p_w, int e_w, int warps, int parts,
    int vec, int bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k == 0 || c == 0) return 0;
  if (warps < 1 || warps > repro_torch::kDwMaxWarps || parts < 1 ||
      parts > repro_torch::kDwMaxParts ||
      (bits != 1 && bits != 2 && bits != 4 && bits != 8) || v < (1 << bits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint8_t* pp = static_cast<const uint8_t*>(packed);
  const uint8_t* ep = static_cast<const uint8_t*>(empty);
  const float* dp = static_cast<const float*>(dout);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? repro_torch::launch_packed_dw_bits<__nv_bfloat16>(
                    bits, pp, ep, dp, out, n, k, v, c, p_w, e_w, warps,
                    parts, vec, st)
              : repro_torch::launch_packed_dw_bits<float>(
                    bits, pp, ep, dp, out, n, k, v, c, p_w, e_w, warps,
                    parts, vec, st);
}

#ifdef REPRO_DW_STAGES
// Copies the stage marks of the first `blocks` blocks of the last B6
// launch (block y * gridDim.x + x; 10 int64 each) to host memory `dst`.
extern "C" int repro_bbit_linear_dw_stages(void* dst, int blocks) {
  const size_t n = std::max(0, std::min(blocks, repro_torch::kDwProbeBlocks));
  return static_cast<int>(cudaMemcpyFromSymbol(
      dst, repro_torch::dw_stage_marks,
      n * repro_torch::kDwProbeMarks * sizeof(long long)));
}
#endif

extern "C" const char* repro_bbit_linear_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
