// Classic CTC alpha scan in block-float probability space (modes "final",
// "resid", "bound" and "resid1").
//
// Replaces tf_seq2seq_losses_tpu/ops/pallas_lattice.py:_classic_fwd_kernel
// (launched by _classic_fwd_call).  Mode "final" emits the last carry, from
// which the host picks the loss (forward-only classic_ctc_loss, and each
// chunk of the chunked training forward); mode "resid" also streams every
// step's mantissas and every window's frames, the residual pack that
// classic_bwd.cu reads (the streamed training forward); mode "bound" also
// writes the carry entering each window, [n_windows, B, L] x (a0, a1, e),
// from which classic_bwd_rf.cu re-expands alpha (the residual-free scheme);
// mode "resid1" (the half-stream scheme, config.half_stream) streams only the
// open mantissas a1 of every step, [B, Tp, L], the frames as mode "resid"
// does, and a0 at each window's first step in that window's frame,
// [B, Tp / K, L] (what mode "resid" stores at sa[:, w K, 0]), from which
// classic_bwd_half.cu rebuilds the window's a0 with the forward's own
// operations: (1 + 1/K) / 2 of mode resid's residual mantissa bytes.
// The time block of the residual-free scheme is one window: the TPU's
// blocks of several windows existed to fill its grid cells.  An optional
// initial carry (null: unit mass at lane 0) lets a chunk of a long time
// axis start where the previous chunk ended.
//
// What bounds it on the H100: the scan is sequential in time, so one
// sample's 500 steps are a chain of dependent shared-memory exchanges and
// barriers; the bytes (the [B, T, L] transition stream in, and in "resid"
// mode the [B, T, 2, L] residual stream out, in "resid1" mode [B, T, L] plus
// 2 / K a cell, in "bound" mode 3 / K floats a cell) would take a few tens
// of microseconds at full HBM rate.  It is latency-bound.
//
// Design: one CTA per sample, one thread per label lane (a strided lane loop
// beyond 512 lanes).  The TPU grid's sequential (batch block, time block)
// axes become a time loop inside the CTA that stops at the sample's own
// logit_length (past it the carry is at its forced-blank fixed point
// (a0, a1) -> (a0 + a1, 0), which the host's loss pick reproduces), so no
// batch sort or whole-cell skip is needed.  State lives in shared memory;
// the lane roll becomes a read of lane l-1 from a double-buffered exchange
// array, one __syncthreads per step.  Each window's K steps of transitions
// are staged into shared memory with one coalesced load, so the loop waits
// on device memory once per window instead of once per step.
#include "blockfloat.cuh"

namespace ctc {

enum FwdMode { kFinal = 0, kResid = 1, kBound = 2, kResid1 = 3 };

struct FwdSmem {
  float *a0, *a1, *sarr, *d, *lm, *nb, *rep, *dcu_w, *blank_w;
  int *e, *et, *f;
};

__host__ __device__ inline size_t fwd_smem_bytes(int lpad, int k) {
  // floats: a0 a1 sarr d[2] lm nb rep dcu_w[k]; ints: e et f; blank_w[k]
  return sizeof(float) * ((size_t)lpad * (8 + k) + k) +
         sizeof(int) * (size_t)lpad * 3;
}

__device__ inline FwdSmem fwd_carve(float* base, int lpad, int k) {
  FwdSmem s;
  s.a0 = base;
  s.a1 = s.a0 + lpad;
  s.sarr = s.a1 + lpad;
  s.d = s.sarr + lpad;
  s.lm = s.d + 2 * lpad;
  s.nb = s.lm + lpad;
  s.rep = s.nb + lpad;
  s.dcu_w = s.rep + lpad;
  s.blank_w = s.dcu_w + (size_t)k * lpad;
  s.e = reinterpret_cast<int*>(s.blank_w + k);
  s.et = s.e + lpad;
  s.f = s.et + lpad;
  return s;
}

template <int kMode>
__global__ void classic_fwd_kernel(
    const float* __restrict__ blank,  // [B, Tp]
    const float* __restrict__ dcu,    // [B, Tp, L] unmasked expected-token probs
    const float* __restrict__ lm,     // [B, L] label-length mask
    const float* __restrict__ nb,     // [B, L] preceding label is not blank
    const float* __restrict__ rep,    // [B, L] label differs from its predecessor
    const int* __restrict__ lens,     // [B] steps to run, within [0, Tp]
    const float* __restrict__ i0,     // [B, L] initial carry (null: the t=0 one)
    const float* __restrict__ i1,
    const int* __restrict__ ie,
    int tpad, int lpad, int k_win,
    float* __restrict__ sa,           // [B, Tp, 2, L] (resid); a1 [B, Tp, L] (resid1)
    int* __restrict__ saf,            // [B, Tp / K, L] (resid, resid1)
    float* __restrict__ a0w,          // [B, Tp / K, L] a0 opening a window (resid1)
    float* __restrict__ bd0,          // [Tp / K, B, L] carry entering a window (bound)
    float* __restrict__ bd1,
    int* __restrict__ bde,
    float* __restrict__ f0, float* __restrict__ f1, int* __restrict__ fe) {
  extern __shared__ float smem[];
  FwdSmem s = fwd_carve(smem, lpad, k_win);
  const int b = blockIdx.x;
  const int batch = gridDim.x;
  const int len = lens[b];
  const int n_win_all = tpad / k_win;
  const size_t row = (size_t)b * lpad;

  for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
    if (i0 != nullptr) {
      s.a0[l] = i0[row + l];
      s.a1[l] = i1[row + l];
      s.e[l] = ie[row + l];
    } else {
      s.a0[l] = l == 0 ? 1.0f : 0.0f;
      s.a1[l] = 0.0f;
      s.e[l] = 0;
    }
    s.lm[l] = lm[row + l];
    s.nb[l] = nb[row + l];
    s.rep[l] = rep[row + l];
  }
  const int n_win = (len + k_win - 1) / k_win;
  int buf = 0;
  for (int w = 0; w < n_win; ++w) {
    const int t0 = w * k_win;
    const int kend = min(k_win, len - t0);
    __syncthreads();  // the previous window's reads of the staging area are done
    for (int i = threadIdx.x; i < kend * lpad; i += blockDim.x) {
      s.dcu_w[i] = dcu[((size_t)b * tpad + t0) * lpad + i];
    }
    for (int i = threadIdx.x; i < kend; i += blockDim.x) {
      s.blank_w[i] = blank[(size_t)b * tpad + t0 + i];
    }
    // open the window: true exponents (subnormal mantissas flushed) ...
    for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
      if (kMode == kBound) {
        const size_t o = ((size_t)w * batch + b) * lpad + l;
        bd0[o] = s.a0[l];
        bd1[o] = s.a1[l];
        bde[o] = s.e[l];
      }
      float m0 = flush_subnormal(s.a0[l]);
      float m1 = flush_subnormal(s.a1[l]);
      s.a0[l] = m0;
      s.a1[l] = m1;
      s.et[l] = true_exp(m0, m1, s.e[l]);
    }
    __syncthreads();
    // ... frame = max over the source lanes l-K .. l (mass flows upward) ...
    for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
      int f = s.et[l];
      for (int j = 1; j <= k_win && j <= l; ++j) f = max(f, s.et[l - j]);
      s.f[l] = f;
    }
    __syncthreads();
    // ... rescale into the frame, neighbour alignment factor
    for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
      const int f = s.f[l];
      const float r = pow2i(s.e[l] - f);
      s.a0[l] *= r;
      s.a1[l] *= r;
      const int f_src = l == 0 ? -kEBig : s.f[l - 1];
      s.sarr[l] = pow2i(f_src - f);
      s.e[l] = f;
      const size_t ow = ((size_t)b * n_win_all + w) * lpad + l;
      if (kMode == kResid || kMode == kResid1) saf[ow] = f;
      if (kMode == kResid1) a0w[ow] = s.a0[l];
    }
    for (int kk = 0; kk < kend; ++kk) {
      const int t = t0 + kk;
      const float* dw = s.dcu_w + (size_t)kk * lpad;
      float* dnow = s.d + buf * lpad;
      for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
        const float a0 = s.a0[l], a1 = s.a1[l];
        if (kMode == kResid) {
          const size_t o = (((size_t)b * tpad + t) * 2) * lpad + l;
          sa[o] = a0;
          sa[o + lpad] = a1;
        }
        if (kMode == kResid1) sa[((size_t)b * tpad + t) * lpad + l] = a1;
        const float dc = dw[l] * s.lm[l];
        const float dov = dc * s.rep[l];
        dnow[l] = a0 * dc + a1 * dov;
      }
      __syncthreads();
      const float bl = s.blank_w[kk];
      for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
        const float a0 = s.a0[l], a1 = s.a1[l];
        const float pt = l == 0 ? 0.0f : dw[l - 1];
        const float pm = pt * s.nb[l];
        const float arr = l == 0 ? 0.0f : dnow[l - 1] * s.sarr[l];
        s.a0[l] = (a0 + a1) * bl;
        s.a1[l] = a1 * pm + arr;
      }
      buf ^= 1;
    }
  }
  __syncthreads();
  for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
    f0[row + l] = s.a0[l];
    f1[row + l] = s.a1[l];
    fe[row + l] = s.e[l];
    // the windows past the sample's length hold its final carry
    for (int w = n_win; kMode == kBound && w < n_win_all; ++w) {
      const size_t o = ((size_t)w * batch + b) * lpad + l;
      bd0[o] = s.a0[l];
      bd1[o] = s.a1[l];
      bde[o] = s.e[l];
    }
  }
}

template <int kMode>
void launch_fwd(const float* blank, const float* dcu, const float* lm,
                const float* nb, const float* rep, const int* lens,
                const float* i0, const float* i1, const int* ie, int batch,
                int tpad, int lpad, int k_win, float* sa, int* saf, float* a0w,
                float* bd0, float* bd1, int* bde, float* f0, float* f1, int* fe,
                cudaStream_t st) {
  const size_t smem = fwd_smem_bytes(lpad, k_win);
  cudaFuncSetAttribute(classic_fwd_kernel<kMode>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  classic_fwd_kernel<kMode><<<batch, block_threads(lpad), smem, st>>>(
      blank, dcu, lm, nb, rep, lens, i0, i1, ie, tpad, lpad, k_win, sa, saf,
      a0w, bd0, bd1, bde, f0, f1, fe);
}

}  // namespace ctc

extern "C" {

size_t ctc_classic_fwd_smem_bytes(int lpad, int k_win) {
  return ctc::fwd_smem_bytes(lpad, k_win);
}

// mode: 0 final, 1 resid, 2 bound, 3 resid1; i0, i1, ie null for the t=0 carry
int ctc_classic_fwd(const float* blank, const float* dcu, const float* lm,
                    const float* nb, const float* rep, const int* lens,
                    const float* i0, const float* i1, const int* ie,
                    int batch, int tpad, int lpad, int k_win, int mode,
                    float* sa, int* saf, float* a0w, float* bd0, float* bd1,
                    int* bde, float* f0, float* f1, int* fe, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == ctc::kResid1) {
    ctc::launch_fwd<ctc::kResid1>(blank, dcu, lm, nb, rep, lens, i0, i1, ie,
                                  batch, tpad, lpad, k_win, sa, saf, a0w, bd0,
                                  bd1, bde, f0, f1, fe, st);
  } else if (mode == ctc::kResid) {
    ctc::launch_fwd<ctc::kResid>(blank, dcu, lm, nb, rep, lens, i0, i1, ie,
                                 batch, tpad, lpad, k_win, sa, saf, a0w, bd0,
                                 bd1, bde, f0, f1, fe, st);
  } else if (mode == ctc::kBound) {
    ctc::launch_fwd<ctc::kBound>(blank, dcu, lm, nb, rep, lens, i0, i1, ie,
                                 batch, tpad, lpad, k_win, sa, saf, a0w, bd0,
                                 bd1, bde, f0, f1, fe, st);
  } else {
    ctc::launch_fwd<ctc::kFinal>(blank, dcu, lm, nb, rep, lens, i0, i1, ie,
                                 batch, tpad, lpad, k_win, sa, saf, a0w, bd0,
                                 bd1, bde, f0, f1, fe, st);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
