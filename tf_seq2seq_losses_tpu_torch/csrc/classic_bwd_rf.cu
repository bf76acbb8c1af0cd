// Classic CTC residual-free beta scan: re-expands alpha over each window
// from its boundary carry, then scans beta back over the window, emitting
// the combined, loss-normalised act pc.
//
// Replaces tf_seq2seq_losses_tpu/ops/pallas_lattice.py:_classic_bwd_kernel
// (launched by _classic_bwd_call), the backward of the residual-free scheme
// that serves the chunked long-T path and stream_residuals=False.  Its
// inputs are the window boundaries [Tp / K, B, L] x (a0, a1, e) that
// classic_fwd.cu writes in mode "bound", and the beta carry entering the
// span (null: one-hot at label_length, the end of the lattice); it emits the
// beta carry leaving it, which the host chains into the previous chunk.
//
// Output layout, the port's own: the JAX kernel emits the acts ph and pd
// separately and scatters them against two one-hot matrices.  This kernel
// emits the combined act pc[t, l] = pd[l] + ph[l + 1], as classic_bwd.cu
// does over streamed residuals, so both schemes share the act scatter and
// the gradient assembly.  The re-expanded mantissas and frames are those
// classic_fwd.cu streams in mode "resid" (the same operations on the same
// carry, each rounded on its own under -fmad=false), so pc equals
// classic_bwd.cu's bit for bit.
//
// What bounds it on the H100: like the other scans, a chain of dependent
// steps per sample, here two of them per window (the alpha re-expansion and
// the beta scan), each a shared-memory exchange plus a barrier; its bytes
// (the [B, T, L] transition stream and boundaries in, pc out) would take a
// few tens of microseconds at full HBM rate.  It is latency-bound.
//
// Design: one CTA per sample, one thread per lane (strided beyond 512), the
// time block one window, so the re-expanded alpha of a block is K steps.  It
// does not sit in shared memory: [K, 2, L] floats for the wide labels of long
// utterances (2016 lanes at 2000 labels) would not fit beside the rest.  Each
// CTA writes it to its own slice of a global workspace [B, K, 2, L] that the
// wrapper allocates, and reads it back in the beta phase; the slice stays in
// L2.  The thread of lane l writes lane l's residuals and reads lane l's and
// l+1's (the ph term), after the barrier that opens the beta window.  The
// alpha phase's exchange buffers hold the act factors in the beta phase,
// and the two phases share the alignment factor array.  The rest is
// classic_bwd.cu: the scan starts at the sample's own length, acts past it
// are zero, and each window's transitions are staged with one coalesced
// load, which both phases read.
#include "blockfloat.cuh"

namespace ctc {

__host__ __device__ inline size_t bwd_rf_smem_bytes(int lpad, int k) {
  // floats: a0 a1 sarr d[2] (shi, slo in the beta phase) b0 b1[2] lm nb rep
  // dcu_w[k]; blank_w[k]; ints: fa et eb f
  return sizeof(float) * ((size_t)lpad * (11 + k) + k) +
         sizeof(int) * (size_t)lpad * 4;
}

__global__ void classic_bwd_rf_kernel(
    const float* __restrict__ blank,   // [B, Tp]
    const float* __restrict__ dcu,     // [B, Tp, L]
    const float* __restrict__ lm,      // [B, L]
    const float* __restrict__ nb,      // [B, L]
    const float* __restrict__ rep,     // [B, L]
    const int* __restrict__ lens,      // [B] steps to run, within [0, Tp]
    const int* __restrict__ lab_len,   // [B] label_length
    const float* __restrict__ ebi,     // [B] act normaliser
    const float* __restrict__ bd0,     // [Tp / K, B, L] alpha entering a window
    const float* __restrict__ bd1,
    const int* __restrict__ bde,
    const float* __restrict__ i0,      // [B, L] beta carry in (null: one-hot)
    const float* __restrict__ i1,
    const int* __restrict__ ie,
    int tpad, int lpad, int k_win,
    float* __restrict__ ws,            // [B, K, 2, L] re-expanded alpha
    float* __restrict__ pc,            // [B, Tp, L]
    float* __restrict__ f0, float* __restrict__ f1, int* __restrict__ fe) {
  extern __shared__ float smem[];
  float* a0s = smem;
  float* a1s = a0s + lpad;
  float* sarr = a1s + lpad;
  float* d = sarr + lpad;  // [2, L]
  float* shi = d;
  float* slo = d + lpad;
  float* b0s = d + 2 * lpad;
  float* b1s = b0s + lpad;  // [2, L]
  float* lms = b1s + 2 * lpad;
  float* nbs = lms + lpad;
  float* reps = nbs + lpad;
  float* dcu_w = reps + lpad;  // [K, L]
  float* blank_w = dcu_w + (size_t)k_win * lpad;
  int* fa = reinterpret_cast<int*>(blank_w + k_win);
  int* et = fa + lpad;
  int* eb = et + lpad;
  int* fs = eb + lpad;
  const int b = blockIdx.x;
  const int batch = gridDim.x;
  const int len = lens[b];
  const int ll = lab_len[b];
  const float ebv = ebi[b];
  const size_t row = (size_t)b * lpad;
  float* wsb = ws + (size_t)b * k_win * 2 * lpad;

  for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
    if (i0 != nullptr) {
      b0s[l] = i0[row + l];
      b1s[l] = i1[row + l];
      eb[l] = ie[row + l];
    } else {
      const float hot = l == ll ? 1.0f : 0.0f;
      b0s[l] = hot;
      b1s[l] = hot;
      eb[l] = 0;
    }
    lms[l] = lm[row + l];
    nbs[l] = nb[row + l];
    reps[l] = rep[row + l];
  }
  // acts past the sample's length are zero
  for (size_t i = (size_t)len * lpad + threadIdx.x; i < (size_t)tpad * lpad;
       i += blockDim.x) {
    pc[(size_t)b * tpad * lpad + i] = 0.0f;
  }
  int cur = 0;
  const int n_win = (len + k_win - 1) / k_win;
  for (int w = n_win - 1; w >= 0; --w) {
    const int t0 = w * k_win;
    const int kend = min(k_win, len - t0);
    __syncthreads();  // the previous window's reads are done
    for (int i = threadIdx.x; i < kend * lpad; i += blockDim.x) {
      dcu_w[i] = dcu[((size_t)b * tpad + t0) * lpad + i];
    }
    for (int i = threadIdx.x; i < kend; i += blockDim.x) {
      blank_w[i] = blank[(size_t)b * tpad + t0 + i];
    }
    // ---- alpha: open the window on its boundary carry (classic_fwd.cu) ----
    const size_t bo = ((size_t)w * batch + b) * lpad;
    for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
      const float m0 = flush_subnormal(bd0[bo + l]);
      const float m1 = flush_subnormal(bd1[bo + l]);
      const int e = bde[bo + l];
      a0s[l] = m0;
      a1s[l] = m1;
      fa[l] = e;
      et[l] = true_exp(m0, m1, e);
    }
    __syncthreads();
    for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
      int f = et[l];
      for (int j = 1; j <= k_win && j <= l; ++j) f = max(f, et[l - j]);
      fs[l] = f;
    }
    __syncthreads();
    for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
      const int f = fs[l];
      const float r = pow2i(fa[l] - f);
      a0s[l] *= r;
      a1s[l] *= r;
      const int f_src = l == 0 ? -kEBig : fs[l - 1];
      sarr[l] = pow2i(f_src - f);
      fa[l] = f;
    }
    // ... and re-expand its steps into the workspace
    int buf = 0;
    for (int kk = 0; kk < kend; ++kk) {
      const float* dw = dcu_w + (size_t)kk * lpad;
      float* dnow = d + buf * lpad;
      for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
        const float a0 = a0s[l], a1 = a1s[l];
        wsb[(size_t)kk * 2 * lpad + l] = a0;
        wsb[((size_t)kk * 2 + 1) * lpad + l] = a1;
        const float dc = dw[l] * lms[l];
        const float dov = dc * reps[l];
        dnow[l] = a0 * dc + a1 * dov;
      }
      __syncthreads();
      const float bl = blank_w[kk];
      for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
        const float a0 = a0s[l], a1 = a1s[l];
        const float pt = l == 0 ? 0.0f : dw[l - 1];
        const float pm = pt * nbs[l];
        const float arr = l == 0 ? 0.0f : dnow[l - 1] * sarr[l];
        a0s[l] = (a0 + a1) * bl;
        a1s[l] = a1 * pm + arr;
      }
      buf ^= 1;
    }
    // ---- beta: open the backward window (classic_bwd.cu) ------------------
    float* b1c = b1s + cur * lpad;
    for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
      const float m0 = flush_subnormal(b0s[l]);
      const float m1 = flush_subnormal(b1c[l]);
      b0s[l] = m0;
      b1c[l] = m1;
      et[l] = true_exp(m0, m1, eb[l]);
    }
    __syncthreads();  // also publishes the workspace to the whole CTA
    for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
      int f = et[l];
      for (int j = 1; j <= k_win && l + j < lpad; ++j) f = max(f, et[l + j]);
      fs[l] = f;
    }
    __syncthreads();
    for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
      const int f = fs[l];
      const float r = pow2i(eb[l] - f);
      b0s[l] *= r;
      b1c[l] *= r;
      const int f_src = l == lpad - 1 ? -kEBig : fs[l + 1];
      sarr[l] = pow2i(f_src - f);
      eb[l] = f;
      act_factor(fa[l], f, ebv, &shi[l], &slo[l]);
    }
    __syncthreads();
    for (int kk = kend - 1; kk >= 0; --kk) {
      const int t = t0 + kk;
      const float* dw = dcu_w + (size_t)kk * lpad;
      const float* a0w = wsb + (size_t)kk * 2 * lpad;
      const float* a1w = a0w + lpad;
      const float bl = blank_w[kk];
      const float* b1now = b1s + cur * lpad;
      float* b1next = b1s + (cur ^ 1) * lpad;
      for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
        const float b0 = b0s[l], b1 = b1now[l];
        const bool edge = l + 1 >= lpad;
        const float b1n = edge ? 0.0f : b1now[l + 1];
        const float arr = b1n * sarr[l];
        const float dc = dw[l] * lms[l];
        const float dov = dc * reps[l];
        const float pt = l == 0 ? 0.0f : dw[l - 1];
        const float pm = pt * nbs[l];
        const float dd = a0w[l] * dc + a1w[l] * dov;
        const float pd = scaled_act(dd, arr, shi[l], slo[l]);
        const float ph_n = edge ? 0.0f
                                : scaled_act(a1w[l + 1], dw[l], b1n, shi[l + 1],
                                             slo[l + 1]);
        pc[((size_t)b * tpad + t) * lpad + l] = pd + ph_n;
        const float hc = bl * b0;
        b0s[l] = hc + dc * arr;
        b1next[l] = hc + pm * b1 + dov * arr;
      }
      __syncthreads();
      cur ^= 1;
    }
  }
  __syncthreads();
  for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
    f0[row + l] = b0s[l];
    f1[row + l] = b1s[cur * lpad + l];
    fe[row + l] = eb[l];
  }
}

}  // namespace ctc

extern "C" {

size_t ctc_classic_bwd_rf_smem_bytes(int lpad, int k_win) {
  return ctc::bwd_rf_smem_bytes(lpad, k_win);
}

// i0, i1, ie null for the beta carry at the end of the lattice
int ctc_classic_bwd_rf(const float* blank, const float* dcu, const float* lm,
                       const float* nb, const float* rep, const int* lens,
                       const int* lab_len, const float* ebi, const float* bd0,
                       const float* bd1, const int* bde, const float* i0,
                       const float* i1, const int* ie, int batch, int tpad,
                       int lpad, int k_win, float* ws, float* pc, float* f0,
                       float* f1, int* fe, void* stream) {
  const size_t smem = ctc::bwd_rf_smem_bytes(lpad, k_win);
  cudaFuncSetAttribute(ctc::classic_bwd_rf_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  ctc::classic_bwd_rf_kernel<<<batch, ctc::block_threads(lpad), smem,
                               static_cast<cudaStream_t>(stream)>>>(
      blank, dcu, lm, nb, rep, lens, lab_len, ebi, bd0, bd1, bde, i0, i1, ie,
      tpad, lpad, k_win, ws, pc, f0, f1, fe);
  return (int)cudaGetLastError();
}

}  // extern "C"
