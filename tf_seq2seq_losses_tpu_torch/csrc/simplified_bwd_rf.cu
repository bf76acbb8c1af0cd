// Simplified CTC residual-free beta scan: re-expands alpha over each window
// from its boundary carry, then scans beta back over the window, emitting
// the loss-normalised act pd.
//
// Replaces the inner kernel of tf_seq2seq_losses_tpu/ops/pallas_lattice.py:
// _simplified_bwd_call, the backward of the residual-free scheme that
// serves the chunked long-T path and stream_residuals=False.  Its inputs are
// the window boundaries [Tp / K, B, L] x (a, e) that simplified_fwd.cu writes
// in mode "bound", and the beta carry entering the span (null: one-hot at
// label_length); it emits the beta carry leaving it, which the host chains
// into the previous chunk.  The re-expanded mantissas and frames are those
// simplified_fwd.cu streams in mode "resid" (the same operations on the same
// carry, each rounded on its own under -fmad=false), so pd equals
// simplified_bwd.cu's bit for bit.
//
// What bounds it on the H100: a chain of dependent steps per sample, two per
// window (alpha re-expansion, beta scan), each a shared-memory exchange plus
// a barrier; its bytes (the [B, T, L] transition stream and boundaries in,
// pd out) would take a few tens of microseconds at full HBM rate.  It is
// latency-bound.
//
// Design: that of classic_bwd_rf.cu with a single state.  One CTA per
// sample, one thread per lane (strided beyond 512), the time block one
// window; the re-expanded alpha of a window goes to the CTA's slice of a
// global workspace [B, K, L] (it stays in L2) and each thread reads back only
// its own lanes, so the simplified act needs no neighbour's residual.  The
// alpha phase's exchange buffers hold the act factors in the beta phase.
#include "blockfloat.cuh"

namespace ctc {

__host__ __device__ inline size_t sbwd_rf_smem_bytes(int lpad, int k) {
  // floats: a sarr d[2] (shi, slo in the beta phase) b[2] dg_w[k]; blank_w[k];
  // ints: fa et eb f
  return sizeof(float) * ((size_t)lpad * (6 + k) + k) +
         sizeof(int) * (size_t)lpad * 4;
}

__global__ void simplified_bwd_rf_kernel(
    const float* __restrict__ blank,   // [B, Tp]
    const float* __restrict__ dg,      // [B, Tp, L]
    const int* __restrict__ lens,      // [B] steps to run, within [0, Tp]
    const int* __restrict__ lab_len,   // [B] label_length
    const float* __restrict__ ebi,     // [B] act normaliser
    const float* __restrict__ bd,      // [Tp / K, B, L] alpha entering a window
    const int* __restrict__ bde,
    const float* __restrict__ ib,      // [B, L] beta carry in (null: one-hot)
    const int* __restrict__ ie,
    int tpad, int lpad, int k_win,
    float* __restrict__ ws,            // [B, K, L] re-expanded alpha
    float* __restrict__ pd,            // [B, Tp, L]
    float* __restrict__ fo, int* __restrict__ fe) {
  extern __shared__ float smem[];
  float* as = smem;
  float* sarr = as + lpad;
  float* ds = sarr + lpad;  // [2, L]
  float* shi = ds;
  float* slo = ds + lpad;
  float* bs = ds + 2 * lpad;  // [2, L]
  float* dgw = bs + 2 * lpad;  // [K, L]
  float* blw = dgw + (size_t)k_win * lpad;
  int* fa = reinterpret_cast<int*>(blw + k_win);
  int* ets = fa + lpad;
  int* es = ets + lpad;
  int* fs = es + lpad;
  const int b = blockIdx.x;
  const int batch = gridDim.x;
  const int len = lens[b];
  const int ll = lab_len[b];
  const float ebv = ebi[b];
  const size_t row = (size_t)b * lpad;
  float* wsb = ws + (size_t)b * k_win * lpad;

  for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
    if (ib != nullptr) {
      bs[l] = ib[row + l];
      es[l] = ie[row + l];
    } else {
      bs[l] = l == ll ? 1.0f : 0.0f;
      es[l] = 0;
    }
  }
  // acts past the sample's length are zero
  for (size_t i = (size_t)len * lpad + threadIdx.x; i < (size_t)tpad * lpad;
       i += blockDim.x) {
    pd[(size_t)b * tpad * lpad + i] = 0.0f;
  }
  int cur = 0;
  const int n_win = (len + k_win - 1) / k_win;
  for (int w = n_win - 1; w >= 0; --w) {
    const int t0 = w * k_win;
    const int kend = min(k_win, len - t0);
    __syncthreads();  // the previous window's reads are done
    const size_t base = ((size_t)b * tpad + t0) * lpad;
    for (int i = threadIdx.x; i < kend * lpad; i += blockDim.x) {
      dgw[i] = dg[base + i];
    }
    for (int i = threadIdx.x; i < kend; i += blockDim.x) {
      blw[i] = blank[(size_t)b * tpad + t0 + i];
    }
    // ---- alpha: open the window on its boundary carry (simplified_fwd.cu)
    const size_t bo = ((size_t)w * batch + b) * lpad;
    for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
      const float m = flush_subnormal(bd[bo + l]);
      const int e = bde[bo + l];
      as[l] = m;
      fa[l] = e;
      ets[l] = true_exp(m, e);
    }
    __syncthreads();
    for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
      int f = ets[l];
      for (int j = 1; j <= k_win && j <= l; ++j) f = max(f, ets[l - j]);
      fs[l] = f;
    }
    __syncthreads();
    for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
      const int f = fs[l];
      as[l] *= pow2i(fa[l] - f);
      const int f_src = l == 0 ? -kEBig : fs[l - 1];
      sarr[l] = pow2i(f_src - f);
      fa[l] = f;
    }
    // ... and re-expand its steps into the workspace
    int buf = 0;
    for (int kk = 0; kk < kend; ++kk) {
      const float* dw = dgw + (size_t)kk * lpad;
      float* dnow = ds + buf * lpad;
      for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
        const float a = as[l];
        wsb[(size_t)kk * lpad + l] = a;
        dnow[l] = a * dw[l];
      }
      __syncthreads();
      const float bl = blw[kk];
      for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
        const float arr = l == 0 ? 0.0f : dnow[l - 1] * sarr[l];
        as[l] = as[l] * bl + arr;
      }
      buf ^= 1;
    }
    // ---- beta: open the backward window (simplified_bwd.cu) ---------------
    float* bc = bs + cur * lpad;
    for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
      const float m = flush_subnormal(bc[l]);
      bc[l] = m;
      ets[l] = true_exp(m, es[l]);
    }
    __syncthreads();
    for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
      int f = ets[l];
      for (int j = 1; j <= k_win && l + j < lpad; ++j) f = max(f, ets[l + j]);
      fs[l] = f;
    }
    __syncthreads();
    for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
      const int f = fs[l];
      bc[l] *= pow2i(es[l] - f);
      const int f_src = l == lpad - 1 ? -kEBig : fs[l + 1];
      sarr[l] = pow2i(f_src - f);
      es[l] = f;
      act_factor(fa[l], f, ebv, &shi[l], &slo[l]);
    }
    __syncthreads();
    for (int kk = kend - 1; kk >= 0; --kk) {
      const size_t o = (size_t)kk * lpad;
      const float bl = blw[kk];
      const float* bnow = bs + cur * lpad;
      float* bnext = bs + (cur ^ 1) * lpad;
      for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
        const float bn = l + 1 >= lpad ? 0.0f : bnow[l + 1];
        const float arr = bn * sarr[l];
        const float d = dgw[o + l];
        pd[((size_t)b * tpad + t0 + kk) * lpad + l] =
            scaled_act(wsb[o + l], d, arr, shi[l], slo[l]);
        bnext[l] = bl * bnow[l] + d * arr;
      }
      __syncthreads();
      cur ^= 1;
    }
  }
  __syncthreads();
  for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
    fo[row + l] = bs[cur * lpad + l];
    fe[row + l] = es[l];
  }
}

}  // namespace ctc

extern "C" {

size_t ctc_simplified_bwd_rf_smem_bytes(int lpad, int k_win) {
  return ctc::sbwd_rf_smem_bytes(lpad, k_win);
}

// ib, ie null for the beta carry at the end of the lattice
int ctc_simplified_bwd_rf(const float* blank, const float* dg, const int* lens,
                          const int* lab_len, const float* ebi,
                          const float* bd, const int* bde, const float* ib,
                          const int* ie, int batch, int tpad, int lpad,
                          int k_win, float* ws, float* pd, float* fo, int* fe,
                          void* stream) {
  const size_t smem = ctc::sbwd_rf_smem_bytes(lpad, k_win);
  cudaFuncSetAttribute(ctc::simplified_bwd_rf_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  ctc::simplified_bwd_rf_kernel<<<batch, ctc::block_threads(lpad), smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      blank, dg, lens, lab_len, ebi, bd, bde, ib, ie, tpad, lpad, k_win, ws,
      pd, fo, fe);
  return (int)cudaGetLastError();
}

}  // extern "C"
