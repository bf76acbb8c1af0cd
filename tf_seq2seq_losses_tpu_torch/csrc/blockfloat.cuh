// Block-float primitives shared by the lattice kernels (classic_fwd.cu,
// classic_bwd.cuh for classic_bwd.cu and classic_bwd_half.cu,
// classic_bwd_rf.cu, classic_log.cu, simplified_fwd.cu, simplified_bwd.cu,
// simplified_bwd_rf.cu, simplified_log.cu).
//
// Counterparts of the in-kernel helpers of
// tf_seq2seq_losses_tpu/ops/pallas_lattice.py (_expfield, _pow2, _true_exp,
// _open_window, _act_factor).  A lattice carry is an f32 mantissa per lane
// plus a per-lane int32 exponent (value = mantissa * 2^exponent).  Every
// `window` steps a frame opens: each lane's frame is the max of the true
// exponents over the window+1 lanes its mass can come from, the carries
// are rescaled into it, and the steps inside the window are plain f32
// multiply-adds.
//
// Subnormal rule: a mantissa whose IEEE exponent field is 0 is set to 0
// when a window opens.  A TPU flushes subnormal f32 to zero; without this
// rule a surviving subnormal in a lane whose whole neighbourhood is dead
// would be rescaled by 2^127 and give a huge finite loss instead of the
// +inf that the saturation guard repairs.  The plain PyTorch versions in
// ops/cuda_lattice.py apply the same rule.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ctc {

// "minus infinity" for int exponents (dead lanes)
constexpr int kEBig = 1 << 30;

__device__ __forceinline__ int expfield(float x) {
  return (__float_as_int(x) >> 23) & 0xFF;
}

// 2^k as f32 for k in [-126, 127]; k <= -127 gives exactly 0.
__device__ __forceinline__ float pow2i(int k) {
  if (k <= -127) return 0.0f;
  int kc = k > 127 ? 127 : k;
  return __int_as_float((kc + 127) << 23);
}

__device__ __forceinline__ float flush_subnormal(float x) {
  return expfield(x) == 0 ? 0.0f : x;
}

// True exponent of a lane: e + floor(log2 m); -2^30 if dead.
__device__ __forceinline__ int true_exp(float m, int e) {
  int ef = expfield(m);
  return ef == 0 ? -kEBig : e + (ef - 127);
}

// The same for a two-state carry: the larger of its mantissas.
__device__ __forceinline__ int true_exp(float m0, float m1, int e) {
  return true_exp(fmaxf(m0, m1), e);
}

// Act scale 2^(fa + fb - ebi) as two power-of-two factors (|s| <= 252).
// The sum is taken in f32: dead-lane markers (-2^30 each) would overflow
// an int32 sum.
__device__ __forceinline__ void act_factor(int fa, int fb, float ebi,
                                           float* s_hi, float* s_lo) {
  float s = (float)fa + (float)fb - ebi;
  s = fminf(fmaxf(s, -252.0f), 252.0f);
  int si = (int)s;
  int h = (si >= 0) ? si / 2 : -((-si + 1) / 2);  // floor(si / 2)
  *s_hi = pow2i(h);
  *s_lo = pow2i(si - h);
}

// An act: the product of two or three f32 factors (mantissas in their own
// frames, and transition probabilities) scaled by s_hi * s_lo =
// 2^(fa + fb - ebi), taken in float64 and rounded once to f32.  A lane far
// below its window's frame in both scans has mantissas near 2^-126 whose
// f32 product underflows where the scaled act is a posterior of order one
// (a nearly forced alignment at V=128 lost 0.06 of a frame's posterior so).
// The product of two f32 and the powers of two are exact in float64.
__device__ __forceinline__ float scaled_act(float x, float y, float s_hi,
                                            float s_lo) {
  return (float)((double)x * (double)y * ((double)s_hi * (double)s_lo));
}

__device__ __forceinline__ float scaled_act(float x, float y, float z,
                                            float s_hi, float s_lo) {
  return (float)((double)x * (double)y * (double)z *
                 ((double)s_hi * (double)s_lo));
}

// The same acts with the scale s_hi * s_lo taken once (act_scale, exact:
// a power of two), for a scan that reuses it over a window: the same bits,
// two float64 conversions and a multiply fewer an act (classic_bwd_rf.cu,
// simplified_bwd_rf.cu, classic_bwd.cuh).
__device__ __forceinline__ double act_scale(float s_hi, float s_lo) {
  return (double)s_hi * (double)s_lo;
}

__device__ __forceinline__ float scaled_act_by(float x, float y, double s) {
  return (float)((double)x * (double)y * s);
}

__device__ __forceinline__ float scaled_act_by(float x, float y, float z,
                                               double s) {
  return (float)((double)x * (double)y * (double)z * s);
}

// -inf-safe logaddexp: lae(-inf, -inf) = -inf.
__device__ __forceinline__ float lae(float x, float y) {
  float m = fmaxf(x, y);
  if (m == -INFINITY) return -INFINITY;
  return m + log1pf(expf(fminf(x, y) - m));
}

// Threads per block: one lane per thread up to 512 lanes, a strided lane
// loop beyond.
__host__ __device__ inline int block_threads(int lpad) {
  return lpad < 512 ? lpad : 512;
}

}  // namespace ctc
