// The beta scan that emits the combined, loss-normalised act pc, shared by
// classic_bwd.cu (B3: over streamed alpha residuals) and classic_bwd_half.cu
// (B13: over the half-stream residuals, rebuilding a0 first).
//
// Per step t (descending) and lane l it emits
//   pc[t, l] = pd[l] + ph[l + 1],
//   pd[l] = (a0 dc + a1 do)[l] * beta_open[t + 1, l + 1],
//   ph[l] = a1[l] * pt[l] * beta_open[t + 1, l],
// each scaled by 2^(Fa + Fb - Ebi) (alpha frame, beta frame, per-sample
// normaliser Ebi = floor(-loss / ln2)), so every act is a posterior in
// [0, 2] and needs no exponent of its own.  It also emits the final beta
// carry; the host turns it into the fast loss, the guard's flush signal.
//
// Design: one CTA per sample, one thread per lane (strided beyond 512).
// The scan starts at the sample's own logit_length (the beta init, one-hot
// at label_length in both states, is already the forced-blank fixed point
// (b0, b1) -> (b0, b0)) and runs the windows in reverse; the frame of a
// backward window opens over lanes l .. l+K.  Acts at t >= logit_length
// are written as zeros.  The lane roll is a read of lane l+1 from a
// double-buffered beta_open array: one __syncthreads per step.  The thread
// of lane l computes ph[l+1] itself from lane l+1's residual, its own
// transition (pt[l+1] = dcu[l]) and lane l+1's act factors, which are fixed
// for the window, so the act needs no second exchange.  Each window's
// transitions and residuals are staged into shared memory with one
// coalesced load.
//
// kHalf: the residuals are the half-stream pack of classic_fwd.cu mode
// "resid1": a1 [B, Tp, L] and a0 at each window's first step [B, Tp / K, L].
// The window's a1 is staged into the a1 slots of sa_w, and each lane then
// rebuilds its a0 slots with a0' = (a0 + a1) * blank, the forward's own
// float operations (no contraction under -fmad=false), so the staged window
// is the one B3 stages and pc and the beta carry are B3's bit for bit.
#pragma once

#include "blockfloat.cuh"

namespace ctc {

struct BwdSmem {
  float *b0, *b1, *sarr, *shi, *slo, *lm, *nb, *rep, *dcu_w, *sa_w, *blank_w;
  int *e, *et, *f;
};

__host__ __device__ inline size_t bwd_smem_bytes(int lpad, int k) {
  // floats: b0 b1[2] sarr shi slo lm nb rep dcu_w[k] sa_w[2k]; blank_w[k];
  // ints: e et f (B3 and B13 alike)
  return sizeof(float) * ((size_t)lpad * (9 + 3 * k) + k) +
         sizeof(int) * (size_t)lpad * 3;
}

__device__ inline BwdSmem bwd_carve(float* base, int lpad, int k) {
  BwdSmem s;
  s.b0 = base;
  s.b1 = s.b0 + lpad;
  s.sarr = s.b1 + 2 * lpad;
  s.shi = s.sarr + lpad;
  s.slo = s.shi + lpad;
  s.lm = s.slo + lpad;
  s.nb = s.lm + lpad;
  s.rep = s.nb + lpad;
  s.dcu_w = s.rep + lpad;
  s.sa_w = s.dcu_w + (size_t)k * lpad;
  s.blank_w = s.sa_w + (size_t)2 * k * lpad;
  s.e = reinterpret_cast<int*>(s.blank_w + k);
  s.et = s.e + lpad;
  s.f = s.et + lpad;
  return s;
}

template <bool kHalf>
__global__ void classic_bwd_streamed_kernel(
    const float* __restrict__ blank,   // [B, Tp]
    const float* __restrict__ dcu,     // [B, Tp, L]
    const float* __restrict__ lm,      // [B, L]
    const float* __restrict__ nb,      // [B, L]
    const float* __restrict__ rep,     // [B, L]
    const int* __restrict__ lens,      // [B] logit_length, clamped to [0, T]
    const int* __restrict__ lab_len,   // [B] label_length
    const float* __restrict__ ebi,     // [B] act normaliser
    const float* __restrict__ sa,      // [B, Tp, 2, L] alpha mantissas; kHalf: a1 [B, Tp, L]
    const int* __restrict__ saf,       // [B, Tp / K, L] alpha frames
    const float* __restrict__ a0_open, // kHalf: [B, Tp / K, L] a0 opening each window
    int tpad, int lpad, int k_win,
    float* __restrict__ pc,            // [B, Tp, L]
    float* __restrict__ f0, float* __restrict__ f1, int* __restrict__ fe) {
  extern __shared__ float smem[];
  BwdSmem s = bwd_carve(smem, lpad, k_win);
  const int b = blockIdx.x;
  const int len = lens[b];
  const int ll = lab_len[b];
  const float eb = ebi[b];
  const int n_win_all = tpad / k_win;
  const size_t row = (size_t)b * lpad;

  for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
    const float hot = l == ll ? 1.0f : 0.0f;
    s.b0[l] = hot;
    s.b1[l] = hot;
    s.e[l] = 0;
    s.lm[l] = lm[row + l];
    s.nb[l] = nb[row + l];
    s.rep[l] = rep[row + l];
  }
  // acts past logit_length are zero
  for (size_t i = (size_t)len * lpad + threadIdx.x; i < (size_t)tpad * lpad;
       i += blockDim.x) {
    pc[(size_t)b * tpad * lpad + i] = 0.0f;
  }
  int cur = 0;
  const int n_win = (len + k_win - 1) / k_win;
  for (int w = n_win - 1; w >= 0; --w) {
    const int t0 = w * k_win;
    const int kend = min(k_win, len - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < kend * lpad; i += blockDim.x) {
      s.dcu_w[i] = dcu[((size_t)b * tpad + t0) * lpad + i];
    }
    if (kHalf) {
      for (int i = threadIdx.x; i < kend * lpad; i += blockDim.x) {
        s.sa_w[(size_t)(2 * (i / lpad) + 1) * lpad + i % lpad] =
            sa[((size_t)b * tpad + t0) * lpad + i];
      }
    } else {
      for (int i = threadIdx.x; i < 2 * kend * lpad; i += blockDim.x) {
        s.sa_w[i] = sa[((size_t)b * tpad + t0) * 2 * lpad + i];
      }
    }
    for (int i = threadIdx.x; i < kend; i += blockDim.x) {
      s.blank_w[i] = blank[(size_t)b * tpad + t0 + i];
    }
    float* b1c = s.b1 + cur * lpad;
    for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
      const float m0 = flush_subnormal(s.b0[l]);
      const float m1 = flush_subnormal(b1c[l]);
      s.b0[l] = m0;
      b1c[l] = m1;
      s.et[l] = true_exp(m0, m1, s.e[l]);
    }
    __syncthreads();
    if (kHalf) {
      // rebuild a0 across the window from its first step's value
      for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
        float a0 = a0_open[((size_t)b * n_win_all + w) * lpad + l];
        for (int kk = 0; kk < kend; ++kk) {
          float* a0s = s.sa_w + (size_t)kk * 2 * lpad;
          a0s[l] = a0;
          a0 = (a0 + a0s[lpad + l]) * s.blank_w[kk];
        }
      }
    }
    // backward frame: max over the source lanes l .. l+K
    for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
      int f = s.et[l];
      for (int j = 1; j <= k_win && l + j < lpad; ++j) f = max(f, s.et[l + j]);
      s.f[l] = f;
    }
    __syncthreads();
    for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
      const int f = s.f[l];
      const float r = pow2i(s.e[l] - f);
      s.b0[l] *= r;
      b1c[l] *= r;
      const int f_src = l == lpad - 1 ? -kEBig : s.f[l + 1];
      s.sarr[l] = pow2i(f_src - f);
      s.e[l] = f;
      act_factor(saf[((size_t)b * n_win_all + w) * lpad + l], f, eb, &s.shi[l],
                 &s.slo[l]);
    }
    __syncthreads();
    for (int kk = kend - 1; kk >= 0; --kk) {
      const int t = t0 + kk;
      const float* dw = s.dcu_w + (size_t)kk * lpad;
      const float* a0w = s.sa_w + (size_t)kk * 2 * lpad;
      const float* a1w = a0w + lpad;
      const float bl = s.blank_w[kk];
      const float* b1now = s.b1 + cur * lpad;
      float* b1next = s.b1 + (cur ^ 1) * lpad;
      for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
        const float b0 = s.b0[l], b1 = b1now[l];
        const bool edge = l + 1 >= lpad;
        const float b1n = edge ? 0.0f : b1now[l + 1];
        const float arr = b1n * s.sarr[l];
        const float dc = dw[l] * s.lm[l];
        const float dov = dc * s.rep[l];
        const float pt = l == 0 ? 0.0f : dw[l - 1];
        const float pm = pt * s.nb[l];
        const float d = a0w[l] * dc + a1w[l] * dov;
        const float pd = scaled_act(d, arr, s.shi[l], s.slo[l]);
        const float ph_n = edge ? 0.0f
                                : scaled_act(a1w[l + 1], dw[l], b1n, s.shi[l + 1],
                                             s.slo[l + 1]);
        pc[((size_t)b * tpad + t) * lpad + l] = pd + ph_n;
        const float hc = bl * b0;
        s.b0[l] = hc + dc * arr;
        b1next[l] = hc + pm * b1 + dov * arr;
      }
      __syncthreads();
      cur ^= 1;
    }
  }
  __syncthreads();
  for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
    f0[row + l] = s.b0[l];
    f1[row + l] = s.b1[cur * lpad + l];
    fe[row + l] = s.e[l];
  }
}

}  // namespace ctc
