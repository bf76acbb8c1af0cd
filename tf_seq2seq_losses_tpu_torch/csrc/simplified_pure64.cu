// The simplified pure path's recursions in float64: the saturation guard's
// float64 repair (ops/log_lattice.py, the op ctc_port::pure_repair) of the
// simplified topology on the card, and with their tangents the HVP's
// (simplified_alpha_jvp64_kernel and simplified_beta_jvp64_kernel, below).
//
// Replaces no Pallas kernel.  The JAX package repairs these rows through
// its pure path, a lax.scan (tf_seq2seq_losses_tpu/ops/simplified.py,
// alpha and beta); the port's pure path is a Python loop over T
// (ops/simplified.py, alpha_scan and beta_scan).  These kernels compute
// that loop's steps exactly:
//
// simplified_alpha_kernel: out[b, 0] = (0 at lane 0, else -inf), then a
//   step t (ops/simplified.py:_alpha_step):
//     a'[l] = lse(a[l] + blank[t], a[l-1] + dg[t, l-1])
//   with lane l-1 of lane 0 the last lane (torch.roll; its dg is -inf).
// simplified_beta64_kernel: out[b, T] = one-hot at label_length, then a
//   step t from T-1 down (ops/simplified.py:_beta_step):
//     b'[l] = lse(b[l] + blank[t], dg[t, l] + b[l+1])
//   with lane l+1 of the last lane lane 0.
// Every operation is the plain version's, in its order, in float64 (lse:
// pure64.cuh), so a kernel writes its plain version's bits.  The alpha
// kernel is a template on the scalar type: in float32 (ctc_port::
// simplified_alpha32) it is the sampler's forward (ops/sample.py), the
// pure path's float32 loop bit for bit.
//
// What bounds them on the H100: the chain of T dependent steps, each one
// barrier and one float64 logsumexp a lane; a repair round of 1 to 32 rows
// keeps 1 to 32 of the 132 SMs busy.  Latency-bound.
//
// Design: classic_pure64.cu's with one state: one CTA per row, threads
// strided over the lanes, one __syncthreads() a step, the previous carry
// from a shared double buffer where the lanes fit (16 bytes a lane: 14528
// lanes on an H100), else from the output row the previous step wrote.
#include "pure64.cuh"

namespace ctc {

template <typename T, bool kStaged>
__global__ void __launch_bounds__(kPure64Threads)
simplified_alpha_kernel(const T* __restrict__ blank, const T* __restrict__ dg, int num_t,
                        int lp1, T* out) {
  extern __shared__ __align__(8) unsigned char carry_bytes[];
  T* carry = reinterpret_cast<T*>(carry_bytes);  // kStaged: [2][lp1]
  const int b = blockIdx.x;
  blank += (size_t)b * num_t;
  dg += (size_t)b * num_t * lp1;
  T* o = out + (size_t)b * (num_t + 1) * lp1;
  for (int l = threadIdx.x; l < lp1; l += blockDim.x) {
    const T c = l == 0 ? T(0) : T(-CUDART_INF);
    o[l] = c;
    if (kStaged) carry[l] = c;
  }
  __syncthreads();
  for (int t = 0; t < num_t; ++t) {
    const T* prev = kStaged ? carry + (t & 1) * lp1 : o + (size_t)t * lp1;
    T* next = carry + ((t + 1) & 1) * lp1;
    T* row = o + (size_t)(t + 1) * lp1;
    const T bl = blank[t];
    const T* dg_t = dg + (size_t)t * lp1;
    for (int l = threadIdx.x; l < lp1; l += blockDim.x) {
      const int lm = l == 0 ? lp1 - 1 : l - 1;
      const T a = pure_lse(prev[l] + bl, prev[lm] + dg_t[lm]);
      row[l] = a;
      if (kStaged) next[l] = a;
    }
    __syncthreads();
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kPure64Threads)
simplified_beta64_kernel(const double* __restrict__ blank, const double* __restrict__ dg,
                         const long long* __restrict__ label_length, int num_t, int lp1,
                         double* out) {
  extern __shared__ double carry[];  // kStaged: [2][lp1]
  const int b = blockIdx.x;
  blank += (size_t)b * num_t;
  dg += (size_t)b * num_t * lp1;
  double* o = out + (size_t)b * (num_t + 1) * lp1;
  const long long hot = label_length[b];
  double* last = o + (size_t)num_t * lp1;
  for (int l = threadIdx.x; l < lp1; l += blockDim.x) {
    const double c = l == hot ? 0.0 : -CUDART_INF;
    last[l] = c;
    if (kStaged) carry[l] = c;
  }
  __syncthreads();
  for (int t = num_t - 1, s = 0; t >= 0; --t, ++s) {
    const double* prev = kStaged ? carry + (s & 1) * lp1 : o + (size_t)(t + 1) * lp1;
    double* next = carry + ((s + 1) & 1) * lp1;
    double* row = o + (size_t)t * lp1;
    const double bl = blank[t];
    const double* dg_t = dg + (size_t)t * lp1;
    for (int l = threadIdx.x; l < lp1; l += blockDim.x) {
      const int lp = l == lp1 - 1 ? 0 : l + 1;
      const double v = lse64(prev[l] + bl, dg_t[l] + prev[lp]);
      row[l] = v;
      if (kStaged) next[l] = v;
    }
    __syncthreads();
  }
}

// The tangent scans of the HVP (ops/hvp.py, through the ops
// ctc_port::simplified_alpha_jvp64 and simplified_beta_jvp64): each step of
// simplified_alpha_kernel<double> and simplified_beta64_kernel with its
// tangent for the tangents t_blank and t_dg, as
// ops/simplified.py:alpha_scan_jvp and beta_scan_jvp compute them (a sum's
// tangent the sum of the tangents, the logsumexp's lse64_jvp; zero tangents
// in the initial carry).  They replace the tangent that jax.jvp carries
// through tf_seq2seq_losses_tpu/ops/simplified.py:63 and :92 in the JAX
// package's HVP (tf_seq2seq_losses_tpu/api.py:374).  Design:
// classic_pure64.cu's tangent scans with one state; the (value, tangent)
// carry double-buffered in shared memory where the lanes fit (32 bytes a
// lane: 7264 lanes on an H100), else read back from the output rows.
// Latency-bound: one lse64_jvp a lane a step.
template <bool kStaged>
__global__ void __launch_bounds__(kPure64Threads)
simplified_alpha_jvp64_kernel(const double* __restrict__ blank,
                              const double* __restrict__ dg,
                              const double* __restrict__ t_blank,
                              const double* __restrict__ t_dg, int num_t, int lp1,
                              double* out, double* t_out) {
  extern __shared__ double jvp_carry[];  // kStaged: values [2][lp1], tangents the same
  double* carry = jvp_carry;
  double* t_carry = jvp_carry + 2 * lp1;
  const int b = blockIdx.x;
  blank += (size_t)b * num_t;
  t_blank += (size_t)b * num_t;
  dg += (size_t)b * num_t * lp1;
  t_dg += (size_t)b * num_t * lp1;
  double* o = out + (size_t)b * (num_t + 1) * lp1;
  double* to = t_out + (size_t)b * (num_t + 1) * lp1;
  for (int l = threadIdx.x; l < lp1; l += blockDim.x) {
    const double c = l == 0 ? 0.0 : -CUDART_INF;
    o[l] = c;
    to[l] = 0.0;
    if (kStaged) {
      carry[l] = c;
      t_carry[l] = 0.0;
    }
  }
  __syncthreads();
  for (int t = 0; t < num_t; ++t) {
    const size_t cur = (size_t)(t & 1) * lp1, nxt = (size_t)((t + 1) & 1) * lp1;
    const double* prev = kStaged ? carry + cur : o + (size_t)t * lp1;
    const double* t_prev = kStaged ? t_carry + cur : to + (size_t)t * lp1;
    double* row = o + (size_t)(t + 1) * lp1;
    double* t_row = to + (size_t)(t + 1) * lp1;
    const double bl = blank[t], t_bl = t_blank[t];
    const size_t at = (size_t)t * lp1;
    for (int l = threadIdx.x; l < lp1; l += blockDim.x) {
      const int lm = l == 0 ? lp1 - 1 : l - 1;
      const Dual64 a = lse64_jvp(prev[l] + bl, prev[lm] + dg[at + lm], t_prev[l] + t_bl,
                                 t_prev[lm] + t_dg[at + lm]);
      row[l] = a.v;
      t_row[l] = a.t;
      if (kStaged) {
        carry[nxt + l] = a.v;
        t_carry[nxt + l] = a.t;
      }
    }
    __syncthreads();
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kPure64Threads)
simplified_beta_jvp64_kernel(const double* __restrict__ blank,
                             const double* __restrict__ dg,
                             const double* __restrict__ t_blank,
                             const double* __restrict__ t_dg,
                             const long long* __restrict__ label_length, int num_t,
                             int lp1, double* out, double* t_out) {
  extern __shared__ double jvp_carry[];  // kStaged: values [2][lp1], tangents the same
  double* carry = jvp_carry;
  double* t_carry = jvp_carry + 2 * lp1;
  const int b = blockIdx.x;
  blank += (size_t)b * num_t;
  t_blank += (size_t)b * num_t;
  dg += (size_t)b * num_t * lp1;
  t_dg += (size_t)b * num_t * lp1;
  double* o = out + (size_t)b * (num_t + 1) * lp1;
  double* to = t_out + (size_t)b * (num_t + 1) * lp1;
  const long long hot = label_length[b];
  double* last = o + (size_t)num_t * lp1;
  double* t_last = to + (size_t)num_t * lp1;
  for (int l = threadIdx.x; l < lp1; l += blockDim.x) {
    const double c = l == hot ? 0.0 : -CUDART_INF;
    last[l] = c;
    t_last[l] = 0.0;
    if (kStaged) {
      carry[l] = c;
      t_carry[l] = 0.0;
    }
  }
  __syncthreads();
  for (int t = num_t - 1, s = 0; t >= 0; --t, ++s) {
    const size_t cur = (size_t)(s & 1) * lp1, nxt = (size_t)((s + 1) & 1) * lp1;
    const double* prev = kStaged ? carry + cur : o + (size_t)(t + 1) * lp1;
    const double* t_prev = kStaged ? t_carry + cur : to + (size_t)(t + 1) * lp1;
    double* row = o + (size_t)t * lp1;
    double* t_row = to + (size_t)t * lp1;
    const double bl = blank[t], t_bl = t_blank[t];
    const size_t at = (size_t)t * lp1;
    for (int l = threadIdx.x; l < lp1; l += blockDim.x) {
      const int lp = l == lp1 - 1 ? 0 : l + 1;
      const Dual64 v = lse64_jvp(prev[l] + bl, dg[at + l] + prev[lp], t_prev[l] + t_bl,
                                 t_dg[at + l] + t_prev[lp]);
      row[l] = v.v;
      t_row[l] = v.t;
      if (kStaged) {
        carry[nxt + l] = v.v;
        t_carry[nxt + l] = v.t;
      }
    }
    __syncthreads();
  }
}

// shared memory of the staged kernels: two carries a lane
template <typename T>
inline size_t simplified_pure_smem(int lp1) { return (size_t)2 * lp1 * sizeof(T); }
inline size_t simplified_pure64_smem(int lp1) { return simplified_pure_smem<double>(lp1); }

template <typename T>
int simplified_alpha_launch(const T* blank, const T* dg, int batch, int num_t, int lp1,
                            int staged, T* out, cudaStream_t st) {
  if (batch == 0) return 0;
  if (staged)
    return launch_pure64(simplified_alpha_kernel<T, true>, batch, lp1,
                         simplified_pure_smem<T>(lp1), st, blank, dg, num_t, lp1, out);
  return launch_pure64(simplified_alpha_kernel<T, false>, batch, lp1, 0, st, blank, dg,
                       num_t, lp1, out);
}

// shared memory of the staged tangent scans: two carries a lane, each a
// value and a tangent
inline size_t simplified_jvp64_smem(int lp1) { return (size_t)2 * 2 * lp1 * sizeof(double); }

}  // namespace ctc

extern "C" {

size_t ctc_simplified_pure64_smem_bytes(int lp1) {
  return ctc::simplified_pure64_smem(lp1);
}

// staged: the carries in shared memory (the wrapper checks that the card
// gives ctc_simplified_pure64_smem_bytes(lp1)), else in the output
int ctc_simplified_alpha64(const double* blank, const double* dg, int batch, int num_t,
                           int lp1, int staged, double* out, void* stream) {
  return ctc::simplified_alpha_launch(blank, dg, batch, num_t, lp1, staged, out,
                                      static_cast<cudaStream_t>(stream));
}

size_t ctc_simplified_alpha32_smem_bytes(int lp1) {
  return ctc::simplified_pure_smem<float>(lp1);
}

// the sampler's float32 forward (ops/pure_scan.py simplified_alpha32)
int ctc_simplified_alpha32(const float* blank, const float* dg, int batch, int num_t,
                           int lp1, int staged, float* out, void* stream) {
  return ctc::simplified_alpha_launch(blank, dg, batch, num_t, lp1, staged, out,
                                      static_cast<cudaStream_t>(stream));
}

int ctc_simplified_beta64(const double* blank, const double* dg,
                          const long long* label_length, int batch, int num_t, int lp1,
                          int staged, double* out, void* stream) {
  if (batch == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (staged)
    return ctc::launch_pure64(ctc::simplified_beta64_kernel<true>, batch, lp1,
                              ctc::simplified_pure64_smem(lp1), st, blank, dg,
                              label_length, num_t, lp1, out);
  return ctc::launch_pure64(ctc::simplified_beta64_kernel<false>, batch, lp1, 0, st,
                            blank, dg, label_length, num_t, lp1, out);
}

size_t ctc_simplified_jvp64_smem_bytes(int lp1) { return ctc::simplified_jvp64_smem(lp1); }

// the HVP's tangent scans (ops/pure_scan.py simplified_alpha_jvp64 and
// simplified_beta_jvp64): the lattice and its tangent, out and t_out
// [batch, num_t + 1, lp1]; staged against ctc_simplified_jvp64_smem_bytes
int ctc_simplified_alpha_jvp64(const double* blank, const double* dg, const double* t_blank,
                               const double* t_dg, int batch, int num_t, int lp1, int staged,
                               double* out, double* t_out, void* stream) {
  if (batch == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (staged)
    return ctc::launch_pure64(ctc::simplified_alpha_jvp64_kernel<true>, batch, lp1,
                              ctc::simplified_jvp64_smem(lp1), st, blank, dg, t_blank, t_dg,
                              num_t, lp1, out, t_out);
  return ctc::launch_pure64(ctc::simplified_alpha_jvp64_kernel<false>, batch, lp1, 0, st,
                            blank, dg, t_blank, t_dg, num_t, lp1, out, t_out);
}

int ctc_simplified_beta_jvp64(const double* blank, const double* dg, const double* t_blank,
                              const double* t_dg, const long long* label_length, int batch,
                              int num_t, int lp1, int staged, double* out, double* t_out,
                              void* stream) {
  if (batch == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (staged)
    return ctc::launch_pure64(ctc::simplified_beta_jvp64_kernel<true>, batch, lp1,
                              ctc::simplified_jvp64_smem(lp1), st, blank, dg, t_blank, t_dg,
                              label_length, num_t, lp1, out, t_out);
  return ctc::launch_pure64(ctc::simplified_beta_jvp64_kernel<false>, batch, lp1, 0, st,
                            blank, dg, t_blank, t_dg, label_length, num_t, lp1, out, t_out);
}

}  // extern "C"
