// Simplified CTC alpha scan in block-float probability space (modes "final",
// "resid" and "bound").
//
// Replaces tf_seq2seq_losses_tpu/ops/pallas_lattice.py:_simplified_fwd_kernel
// (launched by _simplified_fwd_call), modes "final", "resid" and "bound".
// The carry is one mantissa per lane (no closed/open state): per step
//   a'[l] = a[l] * blank + (a * dg)[l - 1] * s_arr[l],
// with the frame of each window opened over the source lanes l-K .. l.
// Mode "final" emits the last carry, from which the host picks the loss
// (forward-only simplified_ctc_loss, and each chunk of the chunked training
// forward); mode "resid" also streams every step's mantissas and every
// window's frames, the residual pack that simplified_bwd.cu reads (the
// streamed training forward); mode "bound" also writes the carry entering
// each window, [n_windows, B, L] x (a, e), from which simplified_bwd_rf.cu
// re-expands alpha (the residual-free scheme).  An optional initial carry
// (null: unit mass at lane 0) lets a chunk start where the previous one
// ended.
//
// What bounds it on the H100: the scan is sequential in time, so one
// sample's 500 steps are a chain of dependent shared-memory exchanges and
// barriers; its bytes (the [B, T, L] transition stream in and, in "resid"
// mode, the [B, T, L] residual stream out) would take a few tens of
// microseconds at full HBM rate.  It is latency-bound.
//
// Design: that of classic_fwd.cu with a single state.  One CTA per sample,
// one thread per label lane (a strided lane loop beyond 512 lanes); the time
// loop stops at the sample's own logit_length (past it the forced-blank step
// a' = a * 1 + (a * 0)[l - 1] is the identity); the lane roll is a read of
// lane l-1 from a double-buffered shared array, one __syncthreads per step;
// each window's K steps of transitions are staged into shared memory with
// one coalesced load.
#include "blockfloat.cuh"

namespace ctc {

enum SFwdMode { kSFinal = 0, kSResid = 1, kSBound = 2 };

__host__ __device__ inline size_t sfwd_smem_bytes(int lpad, int k) {
  // floats: a sarr d[2] dg_w[k]; blank_w[k]; ints: e et f
  return sizeof(float) * ((size_t)lpad * (4 + k) + k) +
         sizeof(int) * (size_t)lpad * 3;
}

template <int kMode>
__global__ void simplified_fwd_kernel(
    const float* __restrict__ blank,  // [B, Tp]
    const float* __restrict__ dg,     // [B, Tp, L] p[label[l]], 0 past label_length
    const int* __restrict__ lens,     // [B] steps to run, within [0, Tp]
    const float* __restrict__ ia,     // [B, L] initial carry (null: the t=0 one)
    const int* __restrict__ ie,
    int tpad, int lpad, int k_win,
    float* __restrict__ sa,           // [B, Tp, L] (resid)
    int* __restrict__ saf,            // [B, Tp / K, L] (resid)
    float* __restrict__ bd,           // [Tp / K, B, L] carry entering a window (bound)
    int* __restrict__ bde,
    float* __restrict__ fo, int* __restrict__ fe) {
  extern __shared__ float smem[];
  float* as = smem;
  float* sarr = as + lpad;
  float* ds = sarr + lpad;                    // [2, L]
  float* dgw = ds + 2 * lpad;                 // [K, L]
  float* blw = dgw + (size_t)k_win * lpad;    // [K]
  int* es = reinterpret_cast<int*>(blw + k_win);
  int* ets = es + lpad;
  int* fs = ets + lpad;
  const int b = blockIdx.x;
  const int batch = gridDim.x;
  const int len = lens[b];
  const int n_win_all = tpad / k_win;
  const size_t row = (size_t)b * lpad;

  for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
    if (ia != nullptr) {
      as[l] = ia[row + l];
      es[l] = ie[row + l];
    } else {
      as[l] = l == 0 ? 1.0f : 0.0f;
      es[l] = 0;
    }
  }
  const int n_win = (len + k_win - 1) / k_win;
  int buf = 0;
  for (int w = 0; w < n_win; ++w) {
    const int t0 = w * k_win;
    const int kend = min(k_win, len - t0);
    __syncthreads();  // the previous window's reads of the staging area are done
    for (int i = threadIdx.x; i < kend * lpad; i += blockDim.x) {
      dgw[i] = dg[((size_t)b * tpad + t0) * lpad + i];
    }
    for (int i = threadIdx.x; i < kend; i += blockDim.x) {
      blw[i] = blank[(size_t)b * tpad + t0 + i];
    }
    // open the window: true exponents (subnormal mantissas flushed) ...
    for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
      if (kMode == kSBound) {
        const size_t o = ((size_t)w * batch + b) * lpad + l;
        bd[o] = as[l];
        bde[o] = es[l];
      }
      const float m = flush_subnormal(as[l]);
      as[l] = m;
      ets[l] = true_exp(m, es[l]);
    }
    __syncthreads();
    // ... frame = max over the source lanes l-K .. l (mass flows upward) ...
    for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
      int f = ets[l];
      for (int j = 1; j <= k_win && j <= l; ++j) f = max(f, ets[l - j]);
      fs[l] = f;
    }
    __syncthreads();
    // ... rescale into the frame, neighbour alignment factor
    for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
      const int f = fs[l];
      as[l] *= pow2i(es[l] - f);
      const int f_src = l == 0 ? -kEBig : fs[l - 1];
      sarr[l] = pow2i(f_src - f);
      es[l] = f;
      if (kMode == kSResid) saf[((size_t)b * n_win_all + w) * lpad + l] = f;
    }
    for (int kk = 0; kk < kend; ++kk) {
      const float* dw = dgw + (size_t)kk * lpad;
      float* dnow = ds + buf * lpad;
      for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
        const float a = as[l];
        if (kMode == kSResid) sa[((size_t)b * tpad + t0 + kk) * lpad + l] = a;
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
  }
  __syncthreads();
  for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
    fo[row + l] = as[l];
    fe[row + l] = es[l];
    // the windows past the sample's length hold its final carry
    for (int w = n_win; kMode == kSBound && w < n_win_all; ++w) {
      const size_t o = ((size_t)w * batch + b) * lpad + l;
      bd[o] = as[l];
      bde[o] = es[l];
    }
  }
}

template <int kMode>
void launch_sfwd(const float* blank, const float* dg, const int* lens,
                 const float* ia, const int* ie, int batch, int tpad, int lpad,
                 int k_win, float* sa, int* saf, float* bd, int* bde, float* fo,
                 int* fe, cudaStream_t st) {
  const size_t smem = sfwd_smem_bytes(lpad, k_win);
  cudaFuncSetAttribute(simplified_fwd_kernel<kMode>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  simplified_fwd_kernel<kMode><<<batch, block_threads(lpad), smem, st>>>(
      blank, dg, lens, ia, ie, tpad, lpad, k_win, sa, saf, bd, bde, fo, fe);
}

}  // namespace ctc

extern "C" {

size_t ctc_simplified_fwd_smem_bytes(int lpad, int k_win) {
  return ctc::sfwd_smem_bytes(lpad, k_win);
}

// mode: 0 final, 1 resid, 2 bound; ia, ie null for the t=0 carry
int ctc_simplified_fwd(const float* blank, const float* dg, const int* lens,
                       const float* ia, const int* ie, int batch, int tpad,
                       int lpad, int k_win, int mode, float* sa, int* saf,
                       float* bd, int* bde, float* fo, int* fe, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == ctc::kSResid) {
    ctc::launch_sfwd<ctc::kSResid>(blank, dg, lens, ia, ie, batch, tpad, lpad,
                                   k_win, sa, saf, bd, bde, fo, fe, st);
  } else if (mode == ctc::kSBound) {
    ctc::launch_sfwd<ctc::kSBound>(blank, dg, lens, ia, ie, batch, tpad, lpad,
                                   k_win, sa, saf, bd, bde, fo, fe, st);
  } else {
    ctc::launch_sfwd<ctc::kSFinal>(blank, dg, lens, ia, ie, batch, tpad, lpad,
                                   k_win, sa, saf, bd, bde, fo, fe, st);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
