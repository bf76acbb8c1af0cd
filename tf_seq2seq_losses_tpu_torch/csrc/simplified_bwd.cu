// Simplified CTC beta scan over streamed alpha residuals, emitting the
// loss-normalised act pd.
//
// Replaces the inner kernel of tf_seq2seq_losses_tpu/ops/pallas_lattice.py:
// _simplified_bwd_call_streamed.  Per step t (descending) and lane l:
//   arr[l] = b[l + 1] * s_arr[l],
//   pd[t, l] = (a[t, l] * dg[t, l]) * arr[l] * s_hi[l] * s_lo[l],
//   b'[l] = blank * b[l] + dg[t, l] * arr[l],
// where a is the forward's residual mantissa and s_hi * s_lo = 2^(Fa + Fb -
// Ebi) (alpha frame, beta frame, per-sample normaliser Ebi = floor(-loss /
// ln2)), so every act is a posterior in [0, 1] and needs no exponent of its
// own.  The simplified act is pd alone: a non-blank token is emitted only
// by a diagonal step, so there is no horizontal term and no second lane
// exchange.  It also emits the final beta carry; the host turns it into the
// fast loss, the guard's flush signal.
//
// What bounds it on the H100: a chain of 500 dependent steps per sample
// (a shared-memory exchange plus a barrier each); its bytes (the transition
// stream and the [B, T, L] residuals in, pd out) would take a few tens of
// microseconds at full HBM rate.  It is latency-bound.
//
// Design: that of classic_bwd.cu with a single state.  One CTA per sample,
// one thread per lane (strided beyond 512).  The scan starts at the
// sample's own logit_length (the beta init, one-hot at label_length, is a
// fixed point of the forced-blank step) and runs the windows in reverse; the
// frame of a backward window opens over lanes l .. l+K.  Acts at t >=
// logit_length are written as zeros.  The lane roll is a read of lane l+1
// from a double-buffered carry array: one __syncthreads per step.  Each
// window's transitions and residuals are staged into shared memory with one
// coalesced load.
#include "blockfloat.cuh"

namespace ctc {

__host__ __device__ inline size_t sbwd_smem_bytes(int lpad, int k) {
  // floats: b[2] sarr shi slo dg_w[k] sa_w[k]; blank_w[k]; ints: e et f
  return sizeof(float) * ((size_t)lpad * (5 + 2 * k) + k) +
         sizeof(int) * (size_t)lpad * 3;
}

__global__ void simplified_bwd_streamed_kernel(
    const float* __restrict__ blank,   // [B, Tp]
    const float* __restrict__ dg,      // [B, Tp, L]
    const int* __restrict__ lens,      // [B] logit_length, clamped to [0, T]
    const int* __restrict__ lab_len,   // [B] label_length
    const float* __restrict__ ebi,     // [B] act normaliser
    const float* __restrict__ sa,      // [B, Tp, L] alpha mantissas
    const int* __restrict__ saf,       // [B, Tp / K, L] alpha frames
    int tpad, int lpad, int k_win,
    float* __restrict__ pd,            // [B, Tp, L]
    float* __restrict__ fo, int* __restrict__ fe) {
  extern __shared__ float smem[];
  float* bs = smem;                           // [2, L]
  float* sarr = bs + 2 * lpad;
  float* shi = sarr + lpad;
  float* slo = shi + lpad;
  float* dgw = slo + lpad;                    // [K, L]
  float* saw = dgw + (size_t)k_win * lpad;    // [K, L]
  float* blw = saw + (size_t)k_win * lpad;    // [K]
  int* es = reinterpret_cast<int*>(blw + k_win);
  int* ets = es + lpad;
  int* fs = ets + lpad;
  const int b = blockIdx.x;
  const int len = lens[b];
  const int ll = lab_len[b];
  const float eb = ebi[b];
  const int n_win_all = tpad / k_win;
  const size_t row = (size_t)b * lpad;

  for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
    bs[l] = l == ll ? 1.0f : 0.0f;
    es[l] = 0;
  }
  // acts past logit_length are zero
  for (size_t i = (size_t)len * lpad + threadIdx.x; i < (size_t)tpad * lpad;
       i += blockDim.x) {
    pd[(size_t)b * tpad * lpad + i] = 0.0f;
  }
  int cur = 0;
  const int n_win = (len + k_win - 1) / k_win;
  for (int w = n_win - 1; w >= 0; --w) {
    const int t0 = w * k_win;
    const int kend = min(k_win, len - t0);
    __syncthreads();
    const size_t base = ((size_t)b * tpad + t0) * lpad;
    for (int i = threadIdx.x; i < kend * lpad; i += blockDim.x) {
      dgw[i] = dg[base + i];
      saw[i] = sa[base + i];
    }
    for (int i = threadIdx.x; i < kend; i += blockDim.x) {
      blw[i] = blank[(size_t)b * tpad + t0 + i];
    }
    float* bc = bs + cur * lpad;
    for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
      const float m = flush_subnormal(bc[l]);
      bc[l] = m;
      ets[l] = true_exp(m, es[l]);
    }
    __syncthreads();
    // backward frame: max over the source lanes l .. l+K
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
      act_factor(saf[((size_t)b * n_win_all + w) * lpad + l], f, eb, &shi[l],
                 &slo[l]);
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
            scaled_act(saw[o + l], d, arr, shi[l], slo[l]);
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

size_t ctc_simplified_bwd_smem_bytes(int lpad, int k_win) {
  return ctc::sbwd_smem_bytes(lpad, k_win);
}

int ctc_simplified_bwd_streamed(const float* blank, const float* dg,
                                const int* lens, const int* lab_len,
                                const float* ebi, const float* sa,
                                const int* saf, int batch, int tpad, int lpad,
                                int k_win, float* pd, float* fo, int* fe,
                                void* stream) {
  const size_t smem = ctc::sbwd_smem_bytes(lpad, k_win);
  const int threads = ctc::block_threads(lpad);
  cudaFuncSetAttribute(ctc::simplified_bwd_streamed_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  ctc::simplified_bwd_streamed_kernel<<<batch, threads, smem,
                                        static_cast<cudaStream_t>(stream)>>>(
      blank, dg, lens, lab_len, ebi, sa, saf, tpad, lpad, k_win, pd, fo, fe);
  return (int)cudaGetLastError();
}

}  // extern "C"
