// Viterbi forced alignment (ops/align.py, the ops ctc_port::classic_viterbi
// and ctc_port::simplified_viterbi): the max-plus forward over the lattice
// with an argmax pointer a state and step, then the backtrack, in one
// launch.
//
// Replaces no Pallas kernel: the JAX package's alignment is two lax.scans
// that XLA compiles into loops (tf_seq2seq_losses_tpu/ops/align.py:52
// classic_viterbi, :127 simplified_viterbi); the port's plain version is a
// Python loop over T of about fifteen launches a step (ops/align.py), which
// these kernels replace on the card.  They compute that loop's steps
// exactly:
//
// classic_viterbi_kernel, from (lane 0 closed at 0, else -inf), a step t:
//     closed'[l] = max(closed[l], open[l]) + blank[t]
//     pc[l]      = open[l] > closed[l]
//     horiz      = open[l] + pm[t, l]
//     dgc, dgo   = closed[l-1] + dc[t, l-1], open[l-1] + do[t, l-1]
//     best       = max(dgc, dgo)
//     po[l]      = best > horiz ? 1 + (dgo > dgc) : 0
//     open'[l]   = max(horiz, best)
//   with lane l-1 of lane 0 the last lane (torch.roll; its terms are -inf).
// simplified_viterbi_kernel, from (0 at lane 0, else -inf), a step t:
//     horiz = a[l] + blank[t];  diag = a[l-1] + dg[t, l-1]
//     p[l] = diag > horiz;  a'[l] = max(horiz, diag)
// max is torch.maximum (a NaN propagates), the pointers strict
// comparisons: the lattices are full of -inf ties, and a tie keeps the
// horizontal predecessor.  Then thread 0 walks the pointers back from the
// terminal state (classic: the first of the two states' maximum, as
// torch.argmax) and writes the alignment before its masking.  Adds, maxima
// and comparisons are exact in float32, so a kernel writes its plain
// version's bits.
//
// What bounds them on the H100: the chain of T dependent steps (a barrier
// and a few adds a lane), then the backtrack's T dependent loads.  The
// bytes (the terms [B, T, Lp1] in, a pointer byte a lane and step, the
// alignment out) stream once.  Latency-bound at the headline's 256 rows.
//
// Design (a first, simple one, as the float64 scans of pure64.cuh): one CTA
// a row, its threads strided over the lanes, one __syncthreads() a step,
// the carry in a double buffer in shared memory where the lanes fit (16
// and 8 bytes a lane) or else in a global scratch row; the pointers of a
// step packed in one byte a lane (classic: bit 0 closed's, bits 1-2
// open's) in a global [B, T, Lp1] scratch that stays in L2 for the
// backtrack.
#include "pure64.cuh"

namespace ctc {

// Lane l of a classic step from the carry prev ([Lp1, 2]: closed, open),
// the diagonal from lane l-1 (lane 0's from the last lane): the carry it
// reads, its candidates and its new values, as the loop computes them.
struct ClassicCell {
  float v_closed, v_open, horiz, diag_c, diag_o, best, closed, open;
};

__device__ __forceinline__ ClassicCell classic_cell(const float* prev, int l, int lp1,
                                                    float bl, const float* pm_t,
                                                    const float* dc_t, const float* do_t) {
  const int lm = l == 0 ? lp1 - 1 : l - 1;
  ClassicCell c;
  c.v_closed = prev[2 * l];
  c.v_open = prev[2 * l + 1];
  c.closed = max_nan(c.v_closed, c.v_open) + bl;
  c.horiz = c.v_open + pm_t[l];
  c.diag_c = prev[2 * lm] + dc_t[lm];
  c.diag_o = prev[2 * lm + 1] + do_t[lm];
  c.best = max_nan(c.diag_c, c.diag_o);
  c.open = max_nan(c.horiz, c.best);
  return c;
}

// Lane l of a simplified step from the carry prev [Lp1].
struct SimplifiedCell {
  float horiz, diag, next;
};

__device__ __forceinline__ SimplifiedCell simplified_cell(const float* prev, int l, int lp1,
                                                          float bl, const float* dg_t) {
  const int lm = l == 0 ? lp1 - 1 : l - 1;
  SimplifiedCell c;
  c.horiz = prev[l] + bl;
  c.diag = prev[lm] + dg_t[lm];
  c.next = max_nan(c.horiz, c.diag);
  return c;
}

template <bool kStaged>
__global__ void __launch_bounds__(kPure64Threads)
classic_viterbi_kernel(const float* __restrict__ blank, const float* __restrict__ pm,
                       const float* __restrict__ dc, const float* __restrict__ dov,
                       const long long* __restrict__ label,
                       const long long* __restrict__ label_length,
                       const long long* __restrict__ blank_index, int num_t, int lp1,
                       float* gcarry, unsigned char* ptr, float* path_lp, int* align) {
  extern __shared__ __align__(8) unsigned char smem[];
  const int b = blockIdx.x;
  const size_t steps = (size_t)num_t * lp1;
  blank += (size_t)b * num_t;
  pm += b * steps;
  dc += b * steps;
  dov += b * steps;
  label += (size_t)b * lp1;
  ptr += b * steps;
  float* carry = kStaged ? reinterpret_cast<float*>(smem) : gcarry + (size_t)b * 4 * lp1;
  for (int l = threadIdx.x; l < lp1; l += blockDim.x) {
    carry[2 * l] = l == 0 ? 0.0f : -CUDART_INF_F;
    carry[2 * l + 1] = -CUDART_INF_F;
  }
  __syncthreads();
  for (int t = 0; t < num_t; ++t) {
    const float* prev = carry + (t & 1) * 2 * lp1;
    float* next = carry + ((t + 1) & 1) * 2 * lp1;
    const float bl = blank[t];
    const float* pm_t = pm + (size_t)t * lp1;
    const float* dc_t = dc + (size_t)t * lp1;
    const float* do_t = dov + (size_t)t * lp1;
    unsigned char* ptr_t = ptr + (size_t)t * lp1;
    for (int l = threadIdx.x; l < lp1; l += blockDim.x) {
      const ClassicCell c = classic_cell(prev, l, lp1, bl, pm_t, dc_t, do_t);
      const int pc = c.v_open > c.v_closed;
      const int po = c.best > c.horiz ? 1 + (c.diag_o > c.diag_c) : 0;
      next[2 * l] = c.closed;
      next[2 * l + 1] = c.open;
      ptr_t[l] = (unsigned char)(pc | (po << 1));
    }
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  const float* fin = carry + (num_t & 1) * 2 * lp1;
  long long cur_l = label_length[b];
  const float vc = fin[2 * cur_l], vo = fin[2 * cur_l + 1];
  int cur_s = argmax2(vc, vo);
  path_lp[b] = amax2(vc, vo);
  const int blank_tok = (int)*blank_index;
  int* out = align + (size_t)b * num_t;
  for (int k = num_t - 1; k >= 0; --k) {
    const bool is_open = cur_s == 1;
    out[k] = is_open ? (int)label[cur_l > 0 ? cur_l - 1 : 0] : blank_tok;
    const int p = ptr[(size_t)k * lp1 + cur_l];
    const int pc = p & 1, po = p >> 1;
    const int prev_s = is_open ? (po == 0 ? 1 : po - 1) : pc;
    const long long prev_l = (is_open && po > 0) ? cur_l - 1 : cur_l;
    cur_l = prev_l > 0 ? prev_l : 0;
    cur_s = prev_s;
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kPure64Threads)
simplified_viterbi_kernel(const float* __restrict__ blank, const float* __restrict__ dg,
                          const long long* __restrict__ label,
                          const long long* __restrict__ label_length,
                          const long long* __restrict__ blank_index, int num_t, int lp1,
                          float* gcarry, unsigned char* ptr, float* path_lp, int* align) {
  extern __shared__ __align__(8) unsigned char smem[];
  const int b = blockIdx.x;
  const size_t steps = (size_t)num_t * lp1;
  blank += (size_t)b * num_t;
  dg += b * steps;
  label += (size_t)b * lp1;
  ptr += b * steps;
  float* carry = kStaged ? reinterpret_cast<float*>(smem) : gcarry + (size_t)b * 2 * lp1;
  for (int l = threadIdx.x; l < lp1; l += blockDim.x)
    carry[l] = l == 0 ? 0.0f : -CUDART_INF_F;
  __syncthreads();
  for (int t = 0; t < num_t; ++t) {
    const float* prev = carry + (t & 1) * lp1;
    float* next = carry + ((t + 1) & 1) * lp1;
    const float bl = blank[t];
    const float* dg_t = dg + (size_t)t * lp1;
    unsigned char* ptr_t = ptr + (size_t)t * lp1;
    for (int l = threadIdx.x; l < lp1; l += blockDim.x) {
      const SimplifiedCell c = simplified_cell(prev, l, lp1, bl, dg_t);
      ptr_t[l] = (unsigned char)(c.diag > c.horiz);
      next[l] = c.next;
    }
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  const float* fin = carry + (num_t & 1) * lp1;
  long long cur_l = label_length[b];
  path_lp[b] = fin[cur_l];
  const int blank_tok = (int)*blank_index;
  int* out = align + (size_t)b * num_t;
  for (int k = num_t - 1; k >= 0; --k) {
    const bool took_diag = ptr[(size_t)k * lp1 + cur_l] == 1;
    out[k] = took_diag ? (int)label[cur_l > 0 ? cur_l - 1 : 0] : blank_tok;
    const long long prev_l = took_diag ? cur_l - 1 : cur_l;
    cur_l = prev_l > 0 ? prev_l : 0;
  }
}

// ---------------------------------------------------------------------------
// The gradients of path_logproba (ops/align.py, the ops
// ctc_port::classic_viterbi_grad and ctc_port::simplified_viterbi_grad): the
// backward of the Viterbi ops, the gradient that autograd takes through
// their plain loops, ties included.  Replaces no Pallas kernel: the JAX
// package differentiates its lax.scans with jax.grad
// (tf_seq2seq_losses_tpu/ops/align.py:52, :127); the port's plain version
// (ops/align.py, classic_viterbi_grad_plain, simplified_viterbi_grad_plain)
// is the loop again and a reverse loop, about thirty launches a step.
//
// The forward again, in the same launch, keeping each lane's and step's
// code of its maxima (max_code: which argument takes the gradient, half
// each at a tie, all to each at a NaN): classic closed' (bits 0-1), the
// diagonal's max of the lane below, already rolled to its lane (bits 2-3),
// open' (bits 4-5); simplified the one max.  Then the reverse sweep from
// the terminal lane: classic torch.amax over the two states gives
// grad / n to each of its n equal maxima, simplified grad to the lane.
// Each step, lane j (j1 = j+1, lane 0 after the last):
//   classic:  d_h = first(c3[j], open'[j]),  d_b = second(c3[j1], open'[j1])
//             d_dc = first(c2[j1], d_b),      d_do = second(c2[j1], d_b)
//             closed[j] = d_dc + first(c1[j], closed'[j])
//             open[j]   = (d_do + d_h) + second(c1[j], closed'[j])
//             d_pm[t, j] = d_h; blank's adjoint at (t, j) = closed'[j]
//   simplified: d_h = first(c[j], a'[j]), d_d = second(c[j1], a'[j1])
//             a[j] = d_h + d_d; d_dg[t, j] = d_d; blank's at (t, j) = d_h
// the order of autograd's adds (the roll's adjoint rolls back one lane).
// blank_lp's gradient at step t sums its adjoints over the lanes in
// lane_sum's order (four partials, lane l into l % 4, the tail into the
// first, then ((p0 + p1) + p2) + p3), one thread a step after the sweep,
// from a global [Lp1, T] scratch whose reads are coalesced across the
// steps.  Halves, maxima and these adds are the plain version's, so a
// kernel writes its bits.
//
// What bounds them on the H100: the two chains of T dependent steps (a
// barrier each).  The bytes (the terms in and their gradients out, a code
// byte and an adjoint float a lane and step) stream once.
//
// Design (the forward kernels' shape): one CTA a row, threads strided over
// the lanes, the carry and then the adjoint in one double buffer, in shared
// memory where the lanes fit, else a global row; the codes in a global [T,
// Lp1] scratch a row.

// torch.maximum's routing of its gradient (ops/align.py:maximum_code): 0 all
// to the first argument, 1 all to the second, 2 half to each, 3 all to each
__device__ __forceinline__ int max_code(float a, float b) {
  return a > b ? 0 : (a < b ? 1 : (a == b ? 2 : 3));
}

__device__ __forceinline__ float first_share(int code, float g) {
  return code == 1 ? 0.0f : (code == 2 ? g / 2.0f : g);
}

__device__ __forceinline__ float second_share(int code, float g) {
  return code == 0 ? 0.0f : (code == 2 ? g / 2.0f : g);
}

// blank_lp's gradient at each step t of a row: lane_sum over the lanes of
// adj [Lp1, T], one thread a step
__device__ __forceinline__ void lane_sums(const float* adj, int num_t, int lp1,
                                          float* d_blank) {
  const int whole = lp1 - lp1 % 4;
  for (int t = threadIdx.x; t < num_t; t += blockDim.x) {
    const float* col = adj + t;
    float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f, p3 = 0.0f;
    for (int l = 0; l < whole; l += 4) {
      p0 = p0 + col[(size_t)l * num_t];
      p1 = p1 + col[(size_t)(l + 1) * num_t];
      p2 = p2 + col[(size_t)(l + 2) * num_t];
      p3 = p3 + col[(size_t)(l + 3) * num_t];
    }
    for (int l = whole; l < lp1; ++l) p0 = p0 + col[(size_t)l * num_t];
    d_blank[t] = ((p0 + p1) + p2) + p3;
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kPure64Threads)
classic_viterbi_grad_kernel(const float* __restrict__ blank, const float* __restrict__ pm,
                            const float* __restrict__ dc, const float* __restrict__ dov,
                            const long long* __restrict__ label_length,
                            const float* __restrict__ grad, int num_t, int lp1,
                            float* gcarry, unsigned char* code, float* adj,
                            float* d_blank, float* d_pm, float* d_dc, float* d_do) {
  extern __shared__ __align__(8) unsigned char smem[];
  const int b = blockIdx.x;
  const size_t steps = (size_t)num_t * lp1;
  blank += (size_t)b * num_t;
  pm += b * steps;
  dc += b * steps;
  dov += b * steps;
  code += b * steps;
  adj += b * steps;
  d_blank += (size_t)b * num_t;
  d_pm += b * steps;
  d_dc += b * steps;
  d_do += b * steps;
  float* buf = kStaged ? reinterpret_cast<float*>(smem) : gcarry + (size_t)b * 4 * lp1;
  for (int l = threadIdx.x; l < lp1; l += blockDim.x) {
    buf[2 * l] = l == 0 ? 0.0f : -CUDART_INF_F;
    buf[2 * l + 1] = -CUDART_INF_F;
  }
  __syncthreads();
  for (int t = 0; t < num_t; ++t) {
    const float* prev = buf + (t & 1) * 2 * lp1;
    float* next = buf + ((t + 1) & 1) * 2 * lp1;
    const size_t row = (size_t)t * lp1;
    for (int l = threadIdx.x; l < lp1; l += blockDim.x) {
      const ClassicCell c = classic_cell(prev, l, lp1, blank[t], pm + row, dc + row,
                                         dov + row);
      code[row + l] = (unsigned char)(max_code(c.v_closed, c.v_open) |
                                      (max_code(c.diag_c, c.diag_o) << 2) |
                                      (max_code(c.horiz, c.best) << 4));
      next[2 * l] = c.closed;
      next[2 * l + 1] = c.open;
    }
    __syncthreads();
  }
  // the terminal amax: grad / n to each of its n equal states
  const long long end = label_length[b];
  const float* fin = buf + (num_t & 1) * 2 * lp1;
  const float vc = fin[2 * end], vo = fin[2 * end + 1];
  const float top = amax2(vc, vo);
  const bool on_c = vc == top, on_o = vo == top;
  const float share = grad[b] / (float)((int)on_c + (int)on_o);
  __syncthreads();
  float* last = buf + (num_t & 1) * 2 * lp1;
  for (int l = threadIdx.x; l < lp1; l += blockDim.x) {
    last[2 * l] = l == end ? share * (on_c ? 1.0f : 0.0f) : 0.0f;
    last[2 * l + 1] = l == end ? share * (on_o ? 1.0f : 0.0f) : 0.0f;
  }
  __syncthreads();
  for (int t = num_t - 1; t >= 0; --t) {
    const float* nx = buf + ((t + 1) & 1) * 2 * lp1;
    float* pv = buf + (t & 1) * 2 * lp1;
    const size_t row = (size_t)t * lp1;
    for (int j = threadIdx.x; j < lp1; j += blockDim.x) {
      const int j1 = j + 1 == lp1 ? 0 : j + 1;
      const int cj = code[row + j], cj1 = code[row + j1];
      const float an_c = nx[2 * j], an_o = nx[2 * j + 1];
      const float d_h = first_share((cj >> 4) & 3, an_o);
      const float d_b = second_share((cj1 >> 4) & 3, nx[2 * j1 + 1]);
      const int c2 = (cj1 >> 2) & 3;
      const float d_c = first_share(c2, d_b), d_o = second_share(c2, d_b);
      d_pm[row + j] = d_h;
      d_dc[row + j] = d_c;
      d_do[row + j] = d_o;
      adj[(size_t)j * num_t + t] = an_c;
      pv[2 * j] = d_c + first_share(cj & 3, an_c);
      pv[2 * j + 1] = (d_o + d_h) + second_share(cj & 3, an_c);
    }
    __syncthreads();
  }
  lane_sums(adj, num_t, lp1, d_blank);
}

template <bool kStaged>
__global__ void __launch_bounds__(kPure64Threads)
simplified_viterbi_grad_kernel(const float* __restrict__ blank,
                               const float* __restrict__ dg,
                               const long long* __restrict__ label_length,
                               const float* __restrict__ grad, int num_t, int lp1,
                               float* gcarry, unsigned char* code, float* adj,
                               float* d_blank, float* d_dg) {
  extern __shared__ __align__(8) unsigned char smem[];
  const int b = blockIdx.x;
  const size_t steps = (size_t)num_t * lp1;
  blank += (size_t)b * num_t;
  dg += b * steps;
  code += b * steps;
  adj += b * steps;
  d_blank += (size_t)b * num_t;
  d_dg += b * steps;
  float* buf = kStaged ? reinterpret_cast<float*>(smem) : gcarry + (size_t)b * 2 * lp1;
  for (int l = threadIdx.x; l < lp1; l += blockDim.x)
    buf[l] = l == 0 ? 0.0f : -CUDART_INF_F;
  __syncthreads();
  for (int t = 0; t < num_t; ++t) {
    const float* prev = buf + (t & 1) * lp1;
    float* next = buf + ((t + 1) & 1) * lp1;
    const size_t row = (size_t)t * lp1;
    for (int l = threadIdx.x; l < lp1; l += blockDim.x) {
      const SimplifiedCell c = simplified_cell(prev, l, lp1, blank[t], dg + row);
      code[row + l] = (unsigned char)max_code(c.horiz, c.diag);
      next[l] = c.next;
    }
    __syncthreads();
  }
  const long long end = label_length[b];
  const float g = grad[b];
  float* last = buf + (num_t & 1) * lp1;
  for (int l = threadIdx.x; l < lp1; l += blockDim.x) last[l] = l == end ? g : 0.0f;
  __syncthreads();
  for (int t = num_t - 1; t >= 0; --t) {
    const float* nx = buf + ((t + 1) & 1) * lp1;
    float* pv = buf + (t & 1) * lp1;
    const size_t row = (size_t)t * lp1;
    for (int j = threadIdx.x; j < lp1; j += blockDim.x) {
      const int j1 = j + 1 == lp1 ? 0 : j + 1;
      const float d_h = first_share(code[row + j], nx[j]);
      const float d_d = second_share(code[row + j1], nx[j1]);
      d_dg[row + j] = d_d;
      adj[(size_t)j * num_t + t] = d_h;
      pv[j] = d_h + d_d;
    }
    __syncthreads();
  }
  lane_sums(adj, num_t, lp1, d_blank);
}

// shared memory of the staged kernels: two carries a lane (two states
// classic, one simplified); the gradients' adjoints reuse them
inline size_t classic_viterbi_smem(int lp1) { return (size_t)2 * 2 * lp1 * sizeof(float); }
inline size_t simplified_viterbi_smem(int lp1) { return (size_t)2 * lp1 * sizeof(float); }

}  // namespace ctc

extern "C" {

size_t ctc_classic_viterbi_smem_bytes(int lp1) { return ctc::classic_viterbi_smem(lp1); }

size_t ctc_simplified_viterbi_smem_bytes(int lp1) {
  return ctc::simplified_viterbi_smem(lp1);
}

// staged: the carries in shared memory (the wrapper checks that the card
// gives ctc_classic_viterbi_smem_bytes(lp1)), else in gcarry [B, 2, Lp1, 2];
// ptr [B, T, Lp1] bytes of scratch
int ctc_classic_viterbi(const float* blank, const float* pm, const float* dc,
                        const float* dov, const long long* label,
                        const long long* label_length, const long long* blank_index,
                        int batch, int num_t, int lp1, int staged, float* gcarry,
                        unsigned char* ptr, float* path_lp, int* align, void* stream) {
  if (batch == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (staged)
    return ctc::launch_pure64(ctc::classic_viterbi_kernel<true>, batch, lp1,
                              ctc::classic_viterbi_smem(lp1), st, blank, pm, dc, dov,
                              label, label_length, blank_index, num_t, lp1, gcarry, ptr,
                              path_lp, align);
  return ctc::launch_pure64(ctc::classic_viterbi_kernel<false>, batch, lp1, 0, st, blank,
                            pm, dc, dov, label, label_length, blank_index, num_t, lp1,
                            gcarry, ptr, path_lp, align);
}

// gcarry [B, 2, Lp1] where not staged
int ctc_simplified_viterbi(const float* blank, const float* dg, const long long* label,
                           const long long* label_length, const long long* blank_index,
                           int batch, int num_t, int lp1, int staged, float* gcarry,
                           unsigned char* ptr, float* path_lp, int* align, void* stream) {
  if (batch == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (staged)
    return ctc::launch_pure64(ctc::simplified_viterbi_kernel<true>, batch, lp1,
                              ctc::simplified_viterbi_smem(lp1), st, blank, dg, label,
                              label_length, blank_index, num_t, lp1, gcarry, ptr, path_lp,
                              align);
  return ctc::launch_pure64(ctc::simplified_viterbi_kernel<false>, batch, lp1, 0, st,
                            blank, dg, label, label_length, blank_index, num_t, lp1,
                            gcarry, ptr, path_lp, align);
}

size_t ctc_classic_viterbi_grad_smem_bytes(int lp1) { return ctc::classic_viterbi_smem(lp1); }

size_t ctc_simplified_viterbi_grad_smem_bytes(int lp1) {
  return ctc::simplified_viterbi_smem(lp1);
}

// staged as ctc_classic_viterbi, else gcarry [B, 2, Lp1, 2]; scratch code
// [B, T, Lp1] bytes and adj [B, Lp1, T]; d_blank [B, T], d_pm, d_dc, d_do
// [B, T, Lp1]
int ctc_classic_viterbi_grad(const float* blank, const float* pm, const float* dc,
                             const float* dov, const long long* label_length,
                             const float* grad, int batch, int num_t, int lp1, int staged,
                             float* gcarry, unsigned char* code, float* adj, float* d_blank,
                             float* d_pm, float* d_dc, float* d_do, void* stream) {
  if (batch == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (staged)
    return ctc::launch_pure64(ctc::classic_viterbi_grad_kernel<true>, batch, lp1,
                              ctc::classic_viterbi_smem(lp1), st, blank, pm, dc, dov,
                              label_length, grad, num_t, lp1, gcarry, code, adj, d_blank,
                              d_pm, d_dc, d_do);
  return ctc::launch_pure64(ctc::classic_viterbi_grad_kernel<false>, batch, lp1, 0, st,
                            blank, pm, dc, dov, label_length, grad, num_t, lp1, gcarry, code,
                            adj, d_blank, d_pm, d_dc, d_do);
}

// gcarry [B, 2, Lp1] where not staged; d_blank [B, T], d_dg [B, T, Lp1]
int ctc_simplified_viterbi_grad(const float* blank, const float* dg,
                                const long long* label_length, const float* grad, int batch,
                                int num_t, int lp1, int staged, float* gcarry,
                                unsigned char* code, float* adj, float* d_blank, float* d_dg,
                                void* stream) {
  if (batch == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (staged)
    return ctc::launch_pure64(ctc::simplified_viterbi_grad_kernel<true>, batch, lp1,
                              ctc::simplified_viterbi_smem(lp1), st, blank, dg, label_length,
                              grad, num_t, lp1, gcarry, code, adj, d_blank, d_dg);
  return ctc::launch_pure64(ctc::simplified_viterbi_grad_kernel<false>, batch, lp1, 0, st,
                            blank, dg, label_length, grad, num_t, lp1, gcarry, code, adj,
                            d_blank, d_dg);
}

}  // extern "C"
