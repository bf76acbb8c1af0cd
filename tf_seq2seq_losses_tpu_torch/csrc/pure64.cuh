// Shared by the pure-path scans (classic_pure64.cu, simplified_pure64.cu:
// the float64 scans of the guard's repair, the float32 forward of the
// sampler and the tangent scans of the HVP), the max-plus scans
// (viterbi.cu) and the sampling walks (walk.cu): the pairwise logsumexp of
// the pure path and its tangent, torch's maximum and argmax rules, the
// block shape of one CTA per row and the launch.
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

// The same in float32, as utils/numerics.py:logsumexp runs on float32
// tensors: torch's CUDA float32 exp and log1p are expf and log1pf.
__device__ __forceinline__ float lse32(float x, float y) {
  if (x == -CUDART_INF_F && y == -CUDART_INF_F) return -CUDART_INF_F;
  if (x == CUDART_INF_F && y == CUDART_INF_F) return CUDART_INF_F;
  const bool x_nan = x != x;
  const float mx = (x > y || x_nan) ? x : y;
  const float mn = (x < y || x_nan) ? x : y;
  return mx + log1pf(expf(mn - mx));
}

// A value and its tangent: an entry of the tangent scans' lattices.
struct Dual64 {
  double v, t;
};

// utils/numerics.py:logsumexp_jvp in float64: lse64's value, and the
// tangent that forward-mode AD gives it, operation for operation.  The max
// and the min take ty + w * (tx - ty), w 1/2 at a tie, else 1 or 0 (torch's
// maximum and minimum); exp's tangent t * result, log1p's t / (x + 1); a
// tie of infinities gives a zero tangent.  Built with -fmad=false, so each
// product and sum rounds on its own, as torch's tensor operations do.
__device__ __forceinline__ Dual64 lse64_jvp(double x, double y, double tx, double ty) {
  if (x == -CUDART_INF && y == -CUDART_INF) return {-CUDART_INF, 0.0};
  if (x == CUDART_INF && y == CUDART_INF) return {CUDART_INF, 0.0};
  const bool x_nan = x != x;
  const double mx = (x > y || x_nan) ? x : y;
  const double mn = (x < y || x_nan) ? x : y;
  const double d = tx - ty;
  const double t_mx = ty + (x == y ? 0.5 : (x > y ? 1.0 : 0.0)) * d;
  const double t_mn = ty + (x == y ? 0.5 : (x < y ? 1.0 : 0.0)) * d;
  const double e = exp(mn - mx);
  const double t_e = (t_mn - t_mx) * e;
  return {mx + log1p(e), t_mx + t_e / (e + 1.0)};
}

// The pure path's logsumexp in the scan's scalar type.
__device__ __forceinline__ double pure_lse(double x, double y) { return lse64(x, y); }
__device__ __forceinline__ float pure_lse(float x, float y) { return lse32(x, y); }

// torch.maximum of two floats: a NaN of either operand propagates, else
// the larger (fmaxf would drop the NaN)
__device__ __forceinline__ float max_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

// torch.amax of two floats: the larger, a NaN propagating
__device__ __forceinline__ float amax2(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

// torch.argmax of two floats: the first maximum, a NaN the maximum
__device__ __forceinline__ int argmax2(float a, float b) {
  if (a != a) return 0;
  if (b != b) return 1;
  return b > a ? 1 : 0;
}

// Launch kernel on grid x threads with smem bytes of shared memory;
// returns the CUDA error.  Setting the shared-memory limit first also
// loads the kernel before its first launch, which may be captured into a
// graph.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int grid, int threads, size_t smem, cudaStream_t st,
           Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

// Launch one CTA of pure64_threads(lp1) threads a row.
template <typename Kernel, typename... Args>
int launch_pure64(Kernel kernel, int batch, int lp1, size_t smem, cudaStream_t st,
                  Args... args) {
  return launch(kernel, batch, pure64_threads(lp1), smem, st, args...);
}

}  // namespace ctc
