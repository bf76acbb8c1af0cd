// The classic pure path's recursions in float64: the saturation guard's
// float64 repair (ops/log_lattice.py, the op ctc_port::pure_repair) on the
// card, and with their tangents the HVP's (classic_alpha_jvp64_kernel and
// classic_beta_jvp64_kernel, below).
//
// Replaces no Pallas kernel.  The JAX package repairs these rows through
// its pure path, a lax.scan that XLA compiles into one loop
// (tf_seq2seq_losses_tpu/ops/classic.py, alpha and beta); the port's pure
// path is a Python loop over T of about ten launches a step
// (ops/classic.py, alpha_scan and beta_scan), which a CUDA graph captures
// as hundreds of thousands of nodes at T=4000.  These kernels compute that
// loop's steps exactly:
//
// classic_alpha_kernel: out[b, 0] = (lane 0 closed at 0, else -inf), then
//   a step t (ops/classic.py:_alpha_step):
//     closed'[l] = lse(closed[l], open[l]) + blank[t]
//     open'[l]   = lse(open[l] + pm[t, l],
//                      lse(closed[l-1] + dc[t, l-1], open[l-1] + do[t, l-1]))
//   with lane l-1 of lane 0 the last lane (torch.roll; that lane's
//   transitions are -inf, ops/classic.py:73).
// classic_beta64_kernel: out[b, T] = one-hot at label_length in both
//   states, then a step t from T-1 down (ops/classic.py:_beta_step):
//     hc = blank[t] + closed[l]
//     closed'[l] = lse(hc, dc[t, l] + open[l+1])
//     open'[l]   = lse(lse(hc, pm[t, l] + open[l]), do[t, l] + open[l+1])
//   with lane l+1 of the last lane lane 0.
// Every operation is the plain version's, in its order, in float64 (lse:
// pure64.cuh), so a kernel writes its plain version's bits.
//
// The alpha kernel is a template on the scalar type: in float32
// (ctc_classic_alpha32, the op ctc_port::classic_alpha32) it is the forward
// that the alignment sampler walks back over (ops/sample.py), the pure
// path's float32 loop (the JAX package's float32 lax.scan,
// tf_seq2seq_losses_tpu/ops/classic.py:136, called at ops/sample.py:71),
// bit for bit, with expf and log1pf as torch's float32 exp and log1p.
//
// What bounds them on the H100: the chain of T dependent steps, each one
// barrier and three float64 logsumexps (an exp and a log1p each) a lane.
// A repair round holds 1 to 32 rows, so 1 to 32 of the 132 SMs work; the
// bytes ([B, T, Lp1] of three transitions in, [B, T+1, Lp1, 2] out) are
// far below the chain's time.  Latency-bound.
//
// Design (a first, simple one): one CTA per row, its threads strided over
// the lanes, one __syncthreads() a step.  A step reads the previous step's
// carry from a double buffer in shared memory where the row's lanes fit
// (32 bytes a lane: 7264 lanes on an H100), else from the output row the
// previous step wrote (it stays in L2): every label width is served.  A
// lane reads its neighbour's carry and that neighbour's transitions and
// forms the neighbour's diagonal term itself, so a step needs no second
// barrier.
#include "pure64.cuh"

namespace ctc {

template <typename T, bool kStaged>
__global__ void __launch_bounds__(kPure64Threads)
classic_alpha_kernel(const T* __restrict__ blank, const T* __restrict__ pm,
                     const T* __restrict__ dc, const T* __restrict__ dov, int num_t,
                     int lp1, T* out) {
  extern __shared__ __align__(8) unsigned char carry_bytes[];
  T* carry = reinterpret_cast<T*>(carry_bytes);  // kStaged: [2][lp1][2]
  const int b = blockIdx.x;
  const size_t steps = (size_t)num_t * lp1;
  blank += (size_t)b * num_t;
  pm += b * steps;
  dc += b * steps;
  dov += b * steps;
  T* o = out + (size_t)b * (num_t + 1) * lp1 * 2;
  for (int l = threadIdx.x; l < lp1; l += blockDim.x) {
    const T c = l == 0 ? T(0) : T(-CUDART_INF);
    o[2 * l] = c;
    o[2 * l + 1] = T(-CUDART_INF);
    if (kStaged) {
      carry[2 * l] = c;
      carry[2 * l + 1] = T(-CUDART_INF);
    }
  }
  __syncthreads();
  for (int t = 0; t < num_t; ++t) {
    const T* prev = kStaged ? carry + (t & 1) * 2 * lp1 : o + (size_t)t * 2 * lp1;
    T* next = carry + ((t + 1) & 1) * 2 * lp1;
    T* row = o + (size_t)(t + 1) * 2 * lp1;
    const T bl = blank[t];
    const T* pm_t = pm + (size_t)t * lp1;
    const T* dc_t = dc + (size_t)t * lp1;
    const T* do_t = dov + (size_t)t * lp1;
    for (int l = threadIdx.x; l < lp1; l += blockDim.x) {
      const int lm = l == 0 ? lp1 - 1 : l - 1;
      const T a_closed = prev[2 * l];
      const T a_open = prev[2 * l + 1];
      const T diag = pure_lse(prev[2 * lm] + dc_t[lm], prev[2 * lm + 1] + do_t[lm]);
      const T closed = pure_lse(a_closed, a_open) + bl;
      const T open = pure_lse(a_open + pm_t[l], diag);
      row[2 * l] = closed;
      row[2 * l + 1] = open;
      if (kStaged) {
        next[2 * l] = closed;
        next[2 * l + 1] = open;
      }
    }
    __syncthreads();
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kPure64Threads)
classic_beta64_kernel(const double* __restrict__ blank, const double* __restrict__ pm,
                      const double* __restrict__ dc, const double* __restrict__ dov,
                      const long long* __restrict__ label_length, int num_t, int lp1,
                      double* out) {
  extern __shared__ double carry[];  // kStaged: [2][lp1][2]
  const int b = blockIdx.x;
  const size_t steps = (size_t)num_t * lp1;
  blank += (size_t)b * num_t;
  pm += b * steps;
  dc += b * steps;
  dov += b * steps;
  double* o = out + (size_t)b * (num_t + 1) * lp1 * 2;
  const long long hot = label_length[b];
  double* last = o + (size_t)num_t * 2 * lp1;
  for (int l = threadIdx.x; l < lp1; l += blockDim.x) {
    const double c = l == hot ? 0.0 : -CUDART_INF;
    last[2 * l] = c;
    last[2 * l + 1] = c;
    if (kStaged) {
      carry[2 * l] = c;
      carry[2 * l + 1] = c;
    }
  }
  __syncthreads();
  for (int t = num_t - 1, s = 0; t >= 0; --t, ++s) {
    const double* prev =
        kStaged ? carry + (s & 1) * 2 * lp1 : o + (size_t)(t + 1) * 2 * lp1;
    double* next = carry + ((s + 1) & 1) * 2 * lp1;
    double* row = o + (size_t)t * 2 * lp1;
    const double bl = blank[t];
    const double* pm_t = pm + (size_t)t * lp1;
    const double* dc_t = dc + (size_t)t * lp1;
    const double* do_t = dov + (size_t)t * lp1;
    for (int l = threadIdx.x; l < lp1; l += blockDim.x) {
      const int lp = l == lp1 - 1 ? 0 : l + 1;
      const double b_open = prev[2 * l + 1];
      const double b_open_next = prev[2 * lp + 1];
      const double hc = bl + prev[2 * l];
      const double ho = lse64(hc, pm_t[l] + b_open);
      const double closed = lse64(hc, dc_t[l] + b_open_next);
      const double open = lse64(ho, do_t[l] + b_open_next);
      row[2 * l] = closed;
      row[2 * l + 1] = open;
      if (kStaged) {
        next[2 * l] = closed;
        next[2 * l + 1] = open;
      }
    }
    __syncthreads();
  }
}

// The tangent scans of the HVP (ops/hvp.py, through the ops
// ctc_port::classic_alpha_jvp64 and classic_beta_jvp64): each step of
// classic_alpha_kernel<double> and classic_beta64_kernel, and beside each
// value its tangent for the terms' tangents (t_blank, t_pm, t_dc, t_dov),
// as ops/classic.py:alpha_scan_jvp and beta_scan_jvp compute them: a sum's
// tangent the sum of its operands' tangents, a logsumexp's lse64_jvp
// (pure64.cuh).  The initial carry's tangents are 0; a -inf entry keeps the
// tangent its sums give, written out as the plain version writes it.
//
// They replace the tangent that jax.jvp carries through the lax.scans of
// the JAX package's HVP (tf_seq2seq_losses_tpu/api.py:374 over
// tf_seq2seq_losses_tpu/ops/classic.py:136 and :184), which the port's
// forward-mode AD ran through the Python loop of ops/classic.py, about
// twenty launches a step.  The design is the float64 scans': one CTA a
// row, threads strided over the lanes, one __syncthreads() a step; the
// (value, tangent) carry double-buffered in shared memory where the lanes
// fit (64 bytes a lane: 3632 lanes on an H100), else read back from the
// output rows the previous step wrote.  Latency-bound as they are, with
// three lse64_jvp (an exp, a log1p and a division each) a lane a step.
template <bool kStaged>
__global__ void __launch_bounds__(kPure64Threads)
classic_alpha_jvp64_kernel(const double* __restrict__ blank, const double* __restrict__ pm,
                           const double* __restrict__ dc, const double* __restrict__ dov,
                           const double* __restrict__ t_blank,
                           const double* __restrict__ t_pm,
                           const double* __restrict__ t_dc,
                           const double* __restrict__ t_dov, int num_t, int lp1,
                           double* out, double* t_out) {
  extern __shared__ double jvp_carry[];  // kStaged: values [2][lp1][2], tangents the same
  double* carry = jvp_carry;
  double* t_carry = jvp_carry + 4 * lp1;
  const int b = blockIdx.x;
  const size_t steps = (size_t)num_t * lp1;
  const size_t row_off = (size_t)b * steps;
  blank += (size_t)b * num_t;
  t_blank += (size_t)b * num_t;
  pm += row_off;
  dc += row_off;
  dov += row_off;
  t_pm += row_off;
  t_dc += row_off;
  t_dov += row_off;
  double* o = out + (size_t)b * (num_t + 1) * lp1 * 2;
  double* to = t_out + (size_t)b * (num_t + 1) * lp1 * 2;
  for (int l = threadIdx.x; l < lp1; l += blockDim.x) {
    const double c = l == 0 ? 0.0 : -CUDART_INF;
    o[2 * l] = c;
    o[2 * l + 1] = -CUDART_INF;
    to[2 * l] = 0.0;
    to[2 * l + 1] = 0.0;
    if (kStaged) {
      carry[2 * l] = c;
      carry[2 * l + 1] = -CUDART_INF;
      t_carry[2 * l] = 0.0;
      t_carry[2 * l + 1] = 0.0;
    }
  }
  __syncthreads();
  for (int t = 0; t < num_t; ++t) {
    const size_t cur = (size_t)(t & 1) * 2 * lp1, nxt = (size_t)((t + 1) & 1) * 2 * lp1;
    const double* prev = kStaged ? carry + cur : o + (size_t)t * 2 * lp1;
    const double* t_prev = kStaged ? t_carry + cur : to + (size_t)t * 2 * lp1;
    double* row = o + (size_t)(t + 1) * 2 * lp1;
    double* t_row = to + (size_t)(t + 1) * 2 * lp1;
    const double bl = blank[t], t_bl = t_blank[t];
    const size_t at = (size_t)t * lp1;
    for (int l = threadIdx.x; l < lp1; l += blockDim.x) {
      const int lm = l == 0 ? lp1 - 1 : l - 1;
      const double a_closed = prev[2 * l], a_open = prev[2 * l + 1];
      const double ta_closed = t_prev[2 * l], ta_open = t_prev[2 * l + 1];
      const Dual64 lse = lse64_jvp(a_closed, a_open, ta_closed, ta_open);
      const Dual64 diag = lse64_jvp(prev[2 * lm] + dc[at + lm], prev[2 * lm + 1] + dov[at + lm],
                                    t_prev[2 * lm] + t_dc[at + lm],
                                    t_prev[2 * lm + 1] + t_dov[at + lm]);
      const Dual64 open =
          lse64_jvp(a_open + pm[at + l], diag.v, ta_open + t_pm[at + l], diag.t);
      const double closed = lse.v + bl, t_closed = lse.t + t_bl;
      row[2 * l] = closed;
      row[2 * l + 1] = open.v;
      t_row[2 * l] = t_closed;
      t_row[2 * l + 1] = open.t;
      if (kStaged) {
        carry[nxt + 2 * l] = closed;
        carry[nxt + 2 * l + 1] = open.v;
        t_carry[nxt + 2 * l] = t_closed;
        t_carry[nxt + 2 * l + 1] = open.t;
      }
    }
    __syncthreads();
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kPure64Threads)
classic_beta_jvp64_kernel(const double* __restrict__ blank, const double* __restrict__ pm,
                          const double* __restrict__ dc, const double* __restrict__ dov,
                          const double* __restrict__ t_blank,
                          const double* __restrict__ t_pm,
                          const double* __restrict__ t_dc,
                          const double* __restrict__ t_dov,
                          const long long* __restrict__ label_length, int num_t, int lp1,
                          double* out, double* t_out) {
  extern __shared__ double jvp_carry[];  // kStaged: values [2][lp1][2], tangents the same
  double* carry = jvp_carry;
  double* t_carry = jvp_carry + 4 * lp1;
  const int b = blockIdx.x;
  const size_t steps = (size_t)num_t * lp1;
  const size_t row_off = (size_t)b * steps;
  blank += (size_t)b * num_t;
  t_blank += (size_t)b * num_t;
  pm += row_off;
  dc += row_off;
  dov += row_off;
  t_pm += row_off;
  t_dc += row_off;
  t_dov += row_off;
  double* o = out + (size_t)b * (num_t + 1) * lp1 * 2;
  double* to = t_out + (size_t)b * (num_t + 1) * lp1 * 2;
  const long long hot = label_length[b];
  double* last = o + (size_t)num_t * 2 * lp1;
  double* t_last = to + (size_t)num_t * 2 * lp1;
  for (int l = threadIdx.x; l < lp1; l += blockDim.x) {
    const double c = l == hot ? 0.0 : -CUDART_INF;
    last[2 * l] = c;
    last[2 * l + 1] = c;
    t_last[2 * l] = 0.0;
    t_last[2 * l + 1] = 0.0;
    if (kStaged) {
      carry[2 * l] = c;
      carry[2 * l + 1] = c;
      t_carry[2 * l] = 0.0;
      t_carry[2 * l + 1] = 0.0;
    }
  }
  __syncthreads();
  for (int t = num_t - 1, s = 0; t >= 0; --t, ++s) {
    const size_t cur = (size_t)(s & 1) * 2 * lp1, nxt = (size_t)((s + 1) & 1) * 2 * lp1;
    const double* prev = kStaged ? carry + cur : o + (size_t)(t + 1) * 2 * lp1;
    const double* t_prev = kStaged ? t_carry + cur : to + (size_t)(t + 1) * 2 * lp1;
    double* row = o + (size_t)t * 2 * lp1;
    double* t_row = to + (size_t)t * 2 * lp1;
    const double bl = blank[t], t_bl = t_blank[t];
    const size_t at = (size_t)t * lp1;
    for (int l = threadIdx.x; l < lp1; l += blockDim.x) {
      const int lp = l == lp1 - 1 ? 0 : l + 1;
      const double b_open = prev[2 * l + 1], b_next = prev[2 * lp + 1];
      const double tb_open = t_prev[2 * l + 1], tb_next = t_prev[2 * lp + 1];
      const double hc = bl + prev[2 * l], t_hc = t_bl + t_prev[2 * l];
      const Dual64 ho = lse64_jvp(hc, pm[at + l] + b_open, t_hc, t_pm[at + l] + tb_open);
      const Dual64 closed = lse64_jvp(hc, dc[at + l] + b_next, t_hc, t_dc[at + l] + tb_next);
      const Dual64 open =
          lse64_jvp(ho.v, dov[at + l] + b_next, ho.t, t_dov[at + l] + tb_next);
      row[2 * l] = closed.v;
      row[2 * l + 1] = open.v;
      t_row[2 * l] = closed.t;
      t_row[2 * l + 1] = open.t;
      if (kStaged) {
        carry[nxt + 2 * l] = closed.v;
        carry[nxt + 2 * l + 1] = open.v;
        t_carry[nxt + 2 * l] = closed.t;
        t_carry[nxt + 2 * l + 1] = open.t;
      }
    }
    __syncthreads();
  }
}

// shared memory of the staged kernels: two carries of two states a lane
template <typename T>
inline size_t classic_pure_smem(int lp1) { return (size_t)2 * 2 * lp1 * sizeof(T); }
inline size_t classic_pure64_smem(int lp1) { return classic_pure_smem<double>(lp1); }

template <typename T>
int classic_alpha_launch(const T* blank, const T* pm, const T* dc, const T* dov, int batch,
                         int num_t, int lp1, int staged, T* out, cudaStream_t st) {
  if (batch == 0) return 0;
  if (staged)
    return launch_pure64(classic_alpha_kernel<T, true>, batch, lp1,
                         classic_pure_smem<T>(lp1), st, blank, pm, dc, dov, num_t, lp1,
                         out);
  return launch_pure64(classic_alpha_kernel<T, false>, batch, lp1, 0, st, blank, pm, dc,
                       dov, num_t, lp1, out);
}

// shared memory of the staged tangent scans: two carries of two states a
// lane, each a value and a tangent
inline size_t classic_jvp64_smem(int lp1) { return (size_t)2 * 2 * 2 * lp1 * sizeof(double); }

}  // namespace ctc

extern "C" {

size_t ctc_classic_pure64_smem_bytes(int lp1) { return ctc::classic_pure64_smem(lp1); }

// staged: the carries in shared memory (the wrapper checks that the card
// gives ctc_classic_pure64_smem_bytes(lp1)), else in the output
int ctc_classic_alpha64(const double* blank, const double* pm, const double* dc,
                        const double* dov, int batch, int num_t, int lp1, int staged,
                        double* out, void* stream) {
  return ctc::classic_alpha_launch(blank, pm, dc, dov, batch, num_t, lp1, staged, out,
                                   static_cast<cudaStream_t>(stream));
}

size_t ctc_classic_alpha32_smem_bytes(int lp1) {
  return ctc::classic_pure_smem<float>(lp1);
}

// the sampler's float32 forward (ops/pure_scan.py classic_alpha32): the
// same kernel on float32, the pure path's float32 steps
int ctc_classic_alpha32(const float* blank, const float* pm, const float* dc,
                        const float* dov, int batch, int num_t, int lp1, int staged,
                        float* out, void* stream) {
  return ctc::classic_alpha_launch(blank, pm, dc, dov, batch, num_t, lp1, staged, out,
                                   static_cast<cudaStream_t>(stream));
}

int ctc_classic_beta64(const double* blank, const double* pm, const double* dc,
                       const double* dov, const long long* label_length, int batch,
                       int num_t, int lp1, int staged, double* out, void* stream) {
  if (batch == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (staged)
    return ctc::launch_pure64(ctc::classic_beta64_kernel<true>, batch, lp1,
                              ctc::classic_pure64_smem(lp1), st, blank, pm, dc, dov,
                              label_length, num_t, lp1, out);
  return ctc::launch_pure64(ctc::classic_beta64_kernel<false>, batch, lp1, 0, st, blank,
                            pm, dc, dov, label_length, num_t, lp1, out);
}

size_t ctc_classic_jvp64_smem_bytes(int lp1) { return ctc::classic_jvp64_smem(lp1); }

// the HVP's tangent scans (ops/pure_scan.py classic_alpha_jvp64 and
// classic_beta_jvp64): the lattice and its tangent, out and t_out
// [batch, num_t + 1, lp1, 2]; staged as above, against
// ctc_classic_jvp64_smem_bytes(lp1)
int ctc_classic_alpha_jvp64(const double* blank, const double* pm, const double* dc,
                            const double* dov, const double* t_blank, const double* t_pm,
                            const double* t_dc, const double* t_dov, int batch, int num_t,
                            int lp1, int staged, double* out, double* t_out,
                            void* stream) {
  if (batch == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (staged)
    return ctc::launch_pure64(ctc::classic_alpha_jvp64_kernel<true>, batch, lp1,
                              ctc::classic_jvp64_smem(lp1), st, blank, pm, dc, dov, t_blank,
                              t_pm, t_dc, t_dov, num_t, lp1, out, t_out);
  return ctc::launch_pure64(ctc::classic_alpha_jvp64_kernel<false>, batch, lp1, 0, st,
                            blank, pm, dc, dov, t_blank, t_pm, t_dc, t_dov, num_t, lp1, out,
                            t_out);
}

int ctc_classic_beta_jvp64(const double* blank, const double* pm, const double* dc,
                           const double* dov, const double* t_blank, const double* t_pm,
                           const double* t_dc, const double* t_dov,
                           const long long* label_length, int batch, int num_t, int lp1,
                           int staged, double* out, double* t_out, void* stream) {
  if (batch == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (staged)
    return ctc::launch_pure64(ctc::classic_beta_jvp64_kernel<true>, batch, lp1,
                              ctc::classic_jvp64_smem(lp1), st, blank, pm, dc, dov, t_blank,
                              t_pm, t_dc, t_dov, label_length, num_t, lp1, out, t_out);
  return ctc::launch_pure64(ctc::classic_beta_jvp64_kernel<false>, batch, lp1, 0, st,
                            blank, pm, dc, dov, t_blank, t_pm, t_dc, t_dov, label_length,
                            num_t, lp1, out, t_out);
}

}  // extern "C"
