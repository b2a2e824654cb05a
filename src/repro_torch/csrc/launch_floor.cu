// An empty kernel, for measuring what a launch costs at least: the same
// arguments as B2's kernel (six pointers, six ints) and the grid, block
// and dynamic shared memory of the design being timed, launched through
// the same ctypes path as every kernel of the port
// (scripts/sweep_serving_kernels.py times it beside torch.cuda._sleep(0)).
// Replaces no TPU kernel.
#include "common.cuh"

namespace repro_torch {
namespace {

__global__ void empty_kernel(const void*, const void*, const void*,
                             const void*, void*, void*, int, int, int, int,
                             int, int) {}

}  // namespace
}  // namespace repro_torch

extern "C" int repro_empty_launch(const void* p0, const void* p1,
                                  const void* p2, const void* p3, void* p4,
                                  void* p5, int grid, int threads, int smem,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (grid < 1 || threads < 1 || smem < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = repro_torch::allow_smem(repro_torch::empty_kernel,
                                static_cast<size_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  repro_torch::empty_kernel<<<grid, threads, static_cast<size_t>(smem),
                              static_cast<cudaStream_t>(stream)>>>(
      p0, p1, p2, p3, p4, p5, 0, 0, 0, 0, 0, 0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_launch_floor_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
