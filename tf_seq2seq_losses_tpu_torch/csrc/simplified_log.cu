// Exact log-space simplified CTC scans: the saturation guard's repair path
// for the simplified topology.
//
// simplified_log_fwd_kernel replaces
// tf_seq2seq_losses_tpu/ops/log_lattice.py:_simplified_log_fwd_kernel
// (launched by _simplified_log_fwd_call), modes "final" and "resid":
//   a'[l] = lae(a[l] + blank, (a + dg)[l - 1]).
// simplified_log_bwd_kernel replaces the inner kernel of
// tf_seq2seq_losses_tpu/ops/log_lattice.py:_simplified_log_grad_impl:
//   pd[t, l] = exp(loss + a[t, l] + dg[t, l] + b[l + 1]),
//   b'[l] = lae(blank + b[l], dg[t, l] + b[l + 1]).
//
// The carries are log-probabilities, so nothing can flush: these kernels
// recompute the rows whose block-float loss flushed to +inf.
//
// What bounds them on the H100: the same dependent chain of steps as the
// block-float kernels, plus precise expf/log1pf on it (the build passes no
// fast-math flag: the repair must hold 1e-5).  Latency-bound.
//
// Design: that of classic_log.cu with a single state.  One CTA per sample,
// one thread per lane (strided beyond 512), the time loop stops at the
// sample's logit_length (past it the carries sit at their forced-blank
// fixed points), lane rolls are reads of lane l-1 (forward) or l+1
// (backward) from double-buffered shared arrays, one __syncthreads per
// step, and each chunk of kChunk steps of inputs is staged into shared
// memory with one coalesced load.
#include "blockfloat.cuh"

namespace ctc {

constexpr int kSChunk = 8;

__host__ __device__ inline size_t slog_fwd_smem_bytes(int lpad) {
  // a d[2] dg_w[c]; blank_w[c]
  return sizeof(float) * ((size_t)lpad * (3 + kSChunk) + kSChunk);
}

__host__ __device__ inline size_t slog_bwd_smem_bytes(int lpad) {
  // b[2] dg_w[c] sa_w[c]; blank_w[c]
  return sizeof(float) * ((size_t)lpad * (2 + 2 * kSChunk) + kSChunk);
}

template <bool kResid>
__global__ void simplified_log_fwd_kernel(
    const float* __restrict__ blank_l,  // [B, Tp] log blank prob
    const float* __restrict__ dg_l,     // [B, Tp, L] log p[label[l]], -inf masked
    const int* __restrict__ lens,       // [B]
    int tpad, int lpad,
    float* __restrict__ sa,             // [B, Tp, L] (resid)
    float* __restrict__ fo) {
  extern __shared__ float smem[];
  float* as = smem;
  float* ds = as + lpad;                      // [2, L]
  float* dgw = ds + 2 * lpad;                 // [c, L]
  float* blw = dgw + (size_t)kSChunk * lpad;  // [c]
  const int b = blockIdx.x;
  const int len = lens[b];
  const size_t row = (size_t)b * lpad;

  for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
    as[l] = l == 0 ? 0.0f : -INFINITY;
  }
  int buf = 0;
  for (int t0 = 0; t0 < len; t0 += kSChunk) {
    const int kend = min(kSChunk, len - t0);
    __syncthreads();
    const size_t base = ((size_t)b * tpad + t0) * lpad;
    for (int i = threadIdx.x; i < kend * lpad; i += blockDim.x) {
      dgw[i] = dg_l[base + i];
    }
    for (int i = threadIdx.x; i < kend; i += blockDim.x) {
      blw[i] = blank_l[(size_t)b * tpad + t0 + i];
    }
    __syncthreads();
    for (int kk = 0; kk < kend; ++kk) {
      const float* dw = dgw + (size_t)kk * lpad;
      float* dnow = ds + buf * lpad;
      for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
        const float a = as[l];
        if (kResid) sa[base + (size_t)kk * lpad + l] = a;
        dnow[l] = a + dw[l];
      }
      __syncthreads();
      const float bl = blw[kk];
      for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
        const float arr = l == 0 ? -INFINITY : dnow[l - 1];
        as[l] = lae(as[l] + bl, arr);
      }
      buf ^= 1;
    }
  }
  __syncthreads();
  for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
    fo[row + l] = as[l];
  }
}

__global__ void simplified_log_bwd_kernel(
    const float* __restrict__ blank_l,  // [B, Tp]
    const float* __restrict__ dg_l,     // [B, Tp, L]
    const int* __restrict__ lens,       // [B]
    const int* __restrict__ lab_len,    // [B]
    const float* __restrict__ loss,     // [B] finite-masked loss
    const float* __restrict__ sa,       // [B, Tp, L] log alpha
    int tpad, int lpad,
    float* __restrict__ pd,             // [B, Tp, L]
    float* __restrict__ fo) {
  extern __shared__ float smem[];
  float* bs = smem;                           // [2, L]
  float* dgw = bs + 2 * lpad;                 // [c, L]
  float* saw = dgw + (size_t)kSChunk * lpad;  // [c, L]
  float* blw = saw + (size_t)kSChunk * lpad;  // [c]
  const int b = blockIdx.x;
  const int len = lens[b];
  const int ll = lab_len[b];
  const float lo = loss[b];
  const size_t row = (size_t)b * lpad;

  for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
    bs[l] = l == ll ? 0.0f : -INFINITY;
  }
  for (size_t i = (size_t)len * lpad + threadIdx.x; i < (size_t)tpad * lpad;
       i += blockDim.x) {
    pd[(size_t)b * tpad * lpad + i] = 0.0f;
  }
  int cur = 0;
  const int n_chunk = (len + kSChunk - 1) / kSChunk;
  for (int c = n_chunk - 1; c >= 0; --c) {
    const int t0 = c * kSChunk;
    const int kend = min(kSChunk, len - t0);
    __syncthreads();
    const size_t base = ((size_t)b * tpad + t0) * lpad;
    for (int i = threadIdx.x; i < kend * lpad; i += blockDim.x) {
      dgw[i] = dg_l[base + i];
      saw[i] = sa[base + i];
    }
    for (int i = threadIdx.x; i < kend; i += blockDim.x) {
      blw[i] = blank_l[(size_t)b * tpad + t0 + i];
    }
    __syncthreads();
    for (int kk = kend - 1; kk >= 0; --kk) {
      const size_t o = (size_t)kk * lpad;
      const float bl = blw[kk];
      const float* bnow = bs + cur * lpad;
      float* bnext = bs + (cur ^ 1) * lpad;
      for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
        const float arr = l + 1 >= lpad ? -INFINITY : bnow[l + 1];
        const float d = dgw[o + l];
        pd[base + o + l] = expf(lo + saw[o + l] + d + arr);
        bnext[l] = lae(bl + bnow[l], d + arr);
      }
      __syncthreads();
      cur ^= 1;
    }
  }
  __syncthreads();
  for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
    fo[row + l] = bs[cur * lpad + l];
  }
}

}  // namespace ctc

extern "C" {

size_t ctc_simplified_log_fwd_smem_bytes(int lpad) {
  return ctc::slog_fwd_smem_bytes(lpad);
}

size_t ctc_simplified_log_bwd_smem_bytes(int lpad) {
  return ctc::slog_bwd_smem_bytes(lpad);
}

int ctc_simplified_log_fwd(const float* blank_l, const float* dg_l,
                           const int* lens, int batch, int tpad, int lpad,
                           int resid, float* sa, float* fo, void* stream) {
  const size_t smem = ctc::slog_fwd_smem_bytes(lpad);
  const int threads = ctc::block_threads(lpad);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (resid) {
    cudaFuncSetAttribute(ctc::simplified_log_fwd_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    ctc::simplified_log_fwd_kernel<true><<<batch, threads, smem, st>>>(
        blank_l, dg_l, lens, tpad, lpad, sa, fo);
  } else {
    cudaFuncSetAttribute(ctc::simplified_log_fwd_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    ctc::simplified_log_fwd_kernel<false><<<batch, threads, smem, st>>>(
        blank_l, dg_l, lens, tpad, lpad, sa, fo);
  }
  return (int)cudaGetLastError();
}

int ctc_simplified_log_bwd(const float* blank_l, const float* dg_l,
                           const int* lens, const int* lab_len,
                           const float* loss, const float* sa, int batch,
                           int tpad, int lpad, float* pd, float* fo,
                           void* stream) {
  const size_t smem = ctc::slog_bwd_smem_bytes(lpad);
  const int threads = ctc::block_threads(lpad);
  cudaFuncSetAttribute(ctc::simplified_log_bwd_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  ctc::simplified_log_bwd_kernel<<<batch, threads, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      blank_l, dg_l, lens, lab_len, loss, sa, tpad, lpad, pd, fo);
  return (int)cudaGetLastError();
}

}  // extern "C"
