// Shared by the float64 pure-path scans (classic_pure64.cu,
// simplified_pure64.cu): the pairwise logsumexp of the pure path and the
// block shape of one CTA per row.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace ctc {

// Threads of a CTA: one per lane up to this many, each then strided over
// the lanes.  __launch_bounds__ holds the scans to it, so that a CTA of
// 1024 threads never asks for more registers than an SM has.
constexpr int kPure64Threads = 1024;

inline int pure64_threads(int lp1) {
  const int warps = (lp1 + 31) / 32;
  return warps * 32 < kPure64Threads ? warps * 32 : kPure64Threads;
}

// utils/numerics.py:logsumexp in float64, operation for operation: a tie
// of -inf (or of +inf) gives it exactly; else max + log1p(exp(min - max)),
// where max and min propagate a NaN as torch.maximum and torch.minimum do.
// The same precise exp and log1p as torch's CUDA float64 kernels; no
// product, so no contraction can change a rounding.
__device__ __forceinline__ double lse64(double x, double y) {
  if (x == -CUDART_INF && y == -CUDART_INF) return -CUDART_INF;
  if (x == CUDART_INF && y == CUDART_INF) return CUDART_INF;
  const bool x_nan = x != x;
  const double mx = (x > y || x_nan) ? x : y;
  const double mn = (x < y || x_nan) ? x : y;
  return mx + log1p(exp(mn - mx));
}

// Launch one CTA of pure64_threads(lp1) threads a row with smem bytes of
// shared memory; returns the CUDA error.  Setting the shared-memory limit
// first also loads the kernel before its first launch, which may be
// captured into a graph.
template <typename Kernel, typename... Args>
int launch_pure64(Kernel kernel, int batch, int lp1, size_t smem, cudaStream_t st,
                  Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<batch, pure64_threads(lp1), smem, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace ctc
