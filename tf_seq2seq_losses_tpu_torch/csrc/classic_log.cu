// Exact log-space classic CTC scans: the saturation guard's repair path.
//
// classic_log_fwd_kernel replaces
// tf_seq2seq_losses_tpu/ops/log_lattice.py:_classic_log_fwd_kernel
// (launched by _classic_log_fwd_call), modes "final" and "resid".
// classic_log_bwd_kernel replaces the inner kernel of
// tf_seq2seq_losses_tpu/ops/log_lattice.py:_classic_log_bwd_call.
//
// The carries are log-probabilities, so nothing can flush: these kernels
// recompute the rows whose block-float loss flushed to +inf.  They keep the
// reference's factorisations: with rep in {0, -inf} the diagonal is
// d = dc + x, x = where(rep, lae(a0, a1), a0), so the forward costs two
// logaddexp per step and streams x (not a0); the backward rebuilds d with
// no logaddexp and shares the rep-gated term, n1 = lae(where(rep, n0, hc),
// pm + b1), at two logaddexp and two exp per step.
//
// What bounds them on the H100: the same dependent chain of steps as the
// block-float kernels, plus precise expf/log1pf on it (the build passes no
// fast-math flag: the repair must hold 1e-5).  Latency-bound.
//
// Design: one CTA per sample, one thread per lane (strided beyond 512),
// the time loop stops at the sample's logit_length (past it the carries
// sit at their forced-blank fixed points), lane rolls are reads of lane
// l-1 (forward) or l+1 (backward) from double-buffered shared arrays, one
// __syncthreads per step, and each chunk of kChunk steps of inputs is
// staged into shared memory with one coalesced load.
#include "blockfloat.cuh"

namespace ctc {

constexpr int kChunk = 8;

__host__ __device__ inline size_t log_fwd_smem_bytes(int lpad) {
  // a0 a1 d[2] nbl rep dc_w[c] pt_w[c]; blank_w[c]; lae(a0, a1)
  return sizeof(float) * ((size_t)lpad * (7 + 2 * kChunk) + kChunk);
}

__host__ __device__ inline size_t log_bwd_smem_bytes(int lpad) {
  // b0 b1[2] nbl rep dc_w[c] pt_w[c] sx_w[c] sa1_w[c]; blank_w[c]
  return sizeof(float) * ((size_t)lpad * (5 + 4 * kChunk) + kChunk);
}

template <bool kResid>
__global__ void classic_log_fwd_kernel(
    const float* __restrict__ blank_l,  // [B, Tp] log blank prob
    const float* __restrict__ dc_l,     // [B, Tp, L] log expected-token prob, -inf masked
    const float* __restrict__ pt_l,     // [B, Tp, L] log preceding-token prob
    const float* __restrict__ nb,       // [B, L]
    const float* __restrict__ rep,      // [B, L]
    const int* __restrict__ lens,       // [B]
    int tpad, int lpad,
    float* __restrict__ sx,             // [B, Tp, L] (resid)
    float* __restrict__ sa1,            // [B, Tp, L] (resid)
    float* __restrict__ f0, float* __restrict__ f1) {
  extern __shared__ float smem[];
  float* a0s = smem;
  float* a1s = a0s + lpad;
  float* ds = a1s + lpad;
  float* nbl = ds + 2 * lpad;
  float* reps = nbl + lpad;
  float* dcw = reps + lpad;
  float* ptw = dcw + (size_t)kChunk * lpad;
  float* blw = ptw + (size_t)kChunk * lpad;
  float* svs = blw + kChunk;  // lae(a0, a1) of the current step, own lane
  const int b = blockIdx.x;
  const int len = lens[b];
  const size_t row = (size_t)b * lpad;

  for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
    a0s[l] = l == 0 ? 0.0f : -INFINITY;
    a1s[l] = -INFINITY;
    nbl[l] = nb[row + l] > 0.0f ? 0.0f : -INFINITY;
    reps[l] = rep[row + l];
  }
  int buf = 0;
  for (int t0 = 0; t0 < len; t0 += kChunk) {
    const int kend = min(kChunk, len - t0);
    __syncthreads();
    const size_t base = ((size_t)b * tpad + t0) * lpad;
    for (int i = threadIdx.x; i < kend * lpad; i += blockDim.x) {
      dcw[i] = dc_l[base + i];
      ptw[i] = pt_l[base + i];
    }
    for (int i = threadIdx.x; i < kend; i += blockDim.x) {
      blw[i] = blank_l[(size_t)b * tpad + t0 + i];
    }
    __syncthreads();
    for (int kk = 0; kk < kend; ++kk) {
      const float* dcr = dcw + (size_t)kk * lpad;
      const float* ptr = ptw + (size_t)kk * lpad;
      float* dnow = ds + buf * lpad;
      for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
        const float a0 = a0s[l], a1 = a1s[l];
        const float sv = lae(a0, a1);
        svs[l] = sv;
        const float x = reps[l] > 0.0f ? sv : a0;
        if (kResid) {
          const size_t o = ((size_t)b * tpad + t0 + kk) * lpad + l;
          sx[o] = x;
          sa1[o] = a1;
        }
        dnow[l] = dcr[l] + x;
      }
      __syncthreads();
      const float bl = blw[kk];
      for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
        const float a1 = a1s[l];
        const float pm = ptr[l] + nbl[l];
        const float arr = l == 0 ? -INFINITY : dnow[l - 1];
        a0s[l] = svs[l] + bl;
        a1s[l] = lae(a1 + pm, arr);
      }
      buf ^= 1;
    }
  }
  __syncthreads();
  for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
    f0[row + l] = a0s[l];
    f1[row + l] = a1s[l];
  }
}

__global__ void classic_log_bwd_kernel(
    const float* __restrict__ blank_l,  // [B, Tp]
    const float* __restrict__ dc_l,     // [B, Tp, L]
    const float* __restrict__ pt_l,     // [B, Tp, L]
    const float* __restrict__ nb,       // [B, L]
    const float* __restrict__ rep,      // [B, L]
    const int* __restrict__ lens,       // [B]
    const int* __restrict__ lab_len,    // [B]
    const float* __restrict__ loss,     // [B] finite-masked loss
    const float* __restrict__ sx,       // [B, Tp, L]
    const float* __restrict__ sa1,      // [B, Tp, L]
    int tpad, int lpad,
    float* __restrict__ pc,             // [B, Tp, L]
    float* __restrict__ f0, float* __restrict__ f1) {
  extern __shared__ float smem[];
  float* b0s = smem;
  float* b1s = b0s + lpad;  // [2, L]
  float* nbl = b1s + 2 * lpad;
  float* reps = nbl + lpad;
  float* dcw = reps + lpad;
  float* ptw = dcw + (size_t)kChunk * lpad;
  float* sxw = ptw + (size_t)kChunk * lpad;
  float* a1w = sxw + (size_t)kChunk * lpad;
  float* blw = a1w + (size_t)kChunk * lpad;
  const int b = blockIdx.x;
  const int len = lens[b];
  const int ll = lab_len[b];
  const float lo = loss[b];
  const size_t row = (size_t)b * lpad;

  for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
    const float hot = l == ll ? 0.0f : -INFINITY;
    b0s[l] = hot;
    b1s[l] = hot;
    nbl[l] = nb[row + l] > 0.0f ? 0.0f : -INFINITY;
    reps[l] = rep[row + l];
  }
  for (size_t i = (size_t)len * lpad + threadIdx.x; i < (size_t)tpad * lpad;
       i += blockDim.x) {
    pc[(size_t)b * tpad * lpad + i] = 0.0f;
  }
  int cur = 0;
  const int n_chunk = (len + kChunk - 1) / kChunk;
  for (int c = n_chunk - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    const int kend = min(kChunk, len - t0);
    __syncthreads();
    const size_t base = ((size_t)b * tpad + t0) * lpad;
    for (int i = threadIdx.x; i < kend * lpad; i += blockDim.x) {
      dcw[i] = dc_l[base + i];
      ptw[i] = pt_l[base + i];
      sxw[i] = sx[base + i];
      a1w[i] = sa1[base + i];
    }
    for (int i = threadIdx.x; i < kend; i += blockDim.x) {
      blw[i] = blank_l[(size_t)b * tpad + t0 + i];
    }
    __syncthreads();
    for (int kk = kend - 1; kk >= 0; --kk) {
      const size_t o = (size_t)kk * lpad;
      const float bl = blw[kk];
      const float* b1now = b1s + cur * lpad;
      float* b1next = b1s + (cur ^ 1) * lpad;
      for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
        const float b0 = b0s[l], b1 = b1now[l];
        const bool edge = l + 1 >= lpad;
        const float arr = edge ? -INFINITY : b1now[l + 1];
        const float dc = dcw[o + l];
        const float d = dc + sxw[o + l];
        const float pd = expf(lo + d + arr);
        const float ph_n =
            edge ? 0.0f : expf(lo + a1w[o + l + 1] + ptw[o + l + 1] + arr);
        pc[((size_t)b * tpad + t0 + kk) * lpad + l] = pd + ph_n;
        const float hc = bl + b0;
        const float n0 = lae(hc, dc + arr);
        const float pm = ptw[o + l] + nbl[l];
        b0s[l] = n0;
        b1next[l] = lae(reps[l] > 0.0f ? n0 : hc, pm + b1);
      }
      __syncthreads();
      cur ^= 1;
    }
  }
  __syncthreads();
  for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
    f0[row + l] = b0s[l];
    f1[row + l] = b1s[cur * lpad + l];
  }
}

}  // namespace ctc

extern "C" {

size_t ctc_classic_log_fwd_smem_bytes(int lpad) {
  return ctc::log_fwd_smem_bytes(lpad);
}

size_t ctc_classic_log_bwd_smem_bytes(int lpad) {
  return ctc::log_bwd_smem_bytes(lpad);
}

int ctc_classic_log_fwd(const float* blank_l, const float* dc_l,
                        const float* pt_l, const float* nb, const float* rep,
                        const int* lens, int batch, int tpad, int lpad,
                        int resid, float* sx, float* sa1, float* f0, float* f1,
                        void* stream) {
  const size_t smem = ctc::log_fwd_smem_bytes(lpad);
  const int threads = ctc::block_threads(lpad);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (resid) {
    cudaFuncSetAttribute(ctc::classic_log_fwd_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    ctc::classic_log_fwd_kernel<true><<<batch, threads, smem, st>>>(
        blank_l, dc_l, pt_l, nb, rep, lens, tpad, lpad, sx, sa1, f0, f1);
  } else {
    cudaFuncSetAttribute(ctc::classic_log_fwd_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    ctc::classic_log_fwd_kernel<false><<<batch, threads, smem, st>>>(
        blank_l, dc_l, pt_l, nb, rep, lens, tpad, lpad, sx, sa1, f0, f1);
  }
  return (int)cudaGetLastError();
}

int ctc_classic_log_bwd(const float* blank_l, const float* dc_l,
                        const float* pt_l, const float* nb, const float* rep,
                        const int* lens, const int* lab_len, const float* loss,
                        const float* sx, const float* sa1, int batch, int tpad,
                        int lpad, float* pc, float* f0, float* f1,
                        void* stream) {
  const size_t smem = ctc::log_bwd_smem_bytes(lpad);
  const int threads = ctc::block_threads(lpad);
  cudaFuncSetAttribute(ctc::classic_log_bwd_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  ctc::classic_log_bwd_kernel<<<batch, threads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      blank_l, dc_l, pt_l, nb, rep, lens, lab_len, loss, sx, sa1, tpad, lpad,
      pc, f0, f1);
  return (int)cudaGetLastError();
}

}  // extern "C"
