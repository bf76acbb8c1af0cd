// The sampling walk of exact alignment sampling (ops/sample.py, the ops
// ctc_port::classic_walk and ctc_port::simplified_walk): forward filtering,
// backward sampling by the Gumbel-max trick, one sample of one row a
// thread.
//
// Replaces no Pallas kernel: the JAX package's walk is a lax.scan vmapped
// over the samples (tf_seq2seq_losses_tpu/ops/sample.py:65 classic_sample,
// its scan at :134 under the vmap of :139; :150 simplified_sample, :198 and
// :201).  The port's plain version is a Python loop over T of about forty
// launches a step (ops/sample.py), which these kernels replace on the
// card.  They compute that loop's steps exactly, from the terminal state
// down:
//
// classic_walk_kernel: the terminal state is the argmax over the two
//   states of alpha[T, L] + noise[s, 0, b, 0:2]; then step i handles frame
//   f = T-1-i with the noise of slot 1+i.  From (l, closed) the candidates
//   are (l, closed) and (l, open) by a blank (and -inf); from (l, open),
//   (l, open) by a repeat, (l-1, closed) and (l-1, open) by the diagonal:
//     w = alpha[f, pred] + the transition's term at frame f
//     choice = argmax(w + noise), acc = acc + (w[choice] - alpha[f, pred])
//   and the frame emits label[l-1] from an open state, else blank.
// simplified_walk_kernel: from l, the horizontal (l, a blank) and the
//   diagonal (l-1, label[l-1]; -inf at l = 0), the noise of slot i.
// argmax is torch.argmax (the first maximum; a NaN counts as the maximum).
// Adds, subtractions and comparisons are exact in float32, so a kernel
// writes its plain version's bits: acc [S, B] and emits [S, B, T], before
// the feasibility mask.
//
// What bounds them on the H100: the chain of T steps of each thread, whose
// loads from alpha and the terms sit at lanes that the previous step
// chose.  The bytes (alpha [B, T+1, Lp1(, 2)] and the terms in, which each
// step touches a few entries of, the noise once, the emissions out) are far
// below the chain at the headline.  Latency-bound.
//
// Design (a first, simple one): one thread a (sample, row), the rows of a
// sample on neighbouring threads, so that a step's noise reads are
// coalesced; no shared memory, no barrier.
#include "pure64.cuh"

namespace ctc {

constexpr int kWalkThreads = 64;

// torch.argmax of three values: the first maximum, a NaN the maximum
__device__ __forceinline__ int argmax3(float a, float b, float c) {
  const int i = argmax2(a, b);
  const float m = i ? b : a;
  if (m != m) return i;
  return (c != c || c > m) ? 2 : i;
}

// One sample's classic walk of a row, from the terminal state down, over
// its alpha a [T+1, Lp1, 2], its terms and its noise g (slot j at g + j *
// slot): calls visit(f, open_cur, choice, cur_l, lm1) at each frame f and
// returns the sum acc.
template <typename Visit>
__device__ __forceinline__ float classic_walk_path(const float* a, const float* blank,
                                                   const float* pm, const float* dc,
                                                   const float* dov, long long cur_l,
                                                   const float* g, size_t slot, int num_t,
                                                   int lp1, Visit&& visit) {
  const float* fin = a + (size_t)num_t * lp1 * 2;
  int cur_s = argmax2(fin[2 * cur_l] + g[0], fin[2 * cur_l + 1] + g[1]);
  float acc = 0.0f;
  for (int i = 0; i < num_t; ++i) {
    const int f = num_t - 1 - i;
    const float* ap = a + (size_t)f * lp1 * 2;
    const long long lm1 = cur_l > 0 ? cur_l - 1 : 0;
    const bool open_cur = cur_s == 1;
    float w0, w1, w2;
    if (open_cur) {
      const size_t row = (size_t)f * lp1;
      w0 = ap[2 * cur_l + 1] + pm[row + cur_l];
      w1 = ap[2 * lm1] + dc[row + lm1];
      w2 = ap[2 * lm1 + 1] + dov[row + lm1];
    } else {
      const float bl = blank[f];
      w0 = ap[2 * cur_l] + bl;
      w1 = ap[2 * cur_l + 1] + bl;
      w2 = -CUDART_INF_F;
    }
    const float* gi = g + (1 + (size_t)i) * slot;
    const int choice = argmax3(w0 + gi[0], w1 + gi[1], w2 + gi[2]);
    const long long prev_l = (open_cur && choice > 0) ? lm1 : cur_l;
    const int prev_s = open_cur ? (choice == 0 ? 1 : choice - 1) : choice;
    const float w = choice == 0 ? w0 : (choice == 1 ? w1 : w2);
    acc = acc + (w - ap[2 * prev_l + prev_s]);
    visit(f, open_cur, choice, cur_l, lm1);
    cur_l = prev_l;
    cur_s = prev_s;
  }
  return acc;
}

// The same of the simplified lattice: visit(f, took_diag, cur_l, lm1).
template <typename Visit>
__device__ __forceinline__ float simplified_walk_path(const float* a, const float* blank,
                                                      const float* dg, long long cur_l,
                                                      const float* g, size_t slot,
                                                      int num_t, int lp1, Visit&& visit) {
  float acc = 0.0f;
  for (int i = 0; i < num_t; ++i) {
    const int f = num_t - 1 - i;
    const float* ap = a + (size_t)f * lp1;
    const long long lm1 = cur_l > 0 ? cur_l - 1 : 0;
    const float d = ap[lm1] + dg[(size_t)f * lp1 + lm1];
    const float diag_w = cur_l > 0 ? d : -CUDART_INF_F;
    const float w0 = ap[cur_l] + blank[f];
    const float* gi = g + (size_t)i * slot;
    const bool took_diag = argmax2(w0 + gi[0], diag_w + gi[1]) == 1;
    const long long prev_l = took_diag ? lm1 : cur_l;
    acc = acc + ((took_diag ? diag_w : w0) - ap[prev_l]);
    visit(f, took_diag, cur_l, lm1);
    cur_l = prev_l;
  }
  return acc;
}

__global__ void __launch_bounds__(kWalkThreads)
classic_walk_kernel(const float* __restrict__ alpha, const float* __restrict__ blank,
                    const float* __restrict__ pm, const float* __restrict__ dc,
                    const float* __restrict__ dov, const long long* __restrict__ label,
                    const long long* __restrict__ label_length,
                    const long long* __restrict__ blank_index,
                    const float* __restrict__ noise, int num_s, int batch, int num_t,
                    int lp1, float* acc_out, int* emits) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)num_s * batch) return;
  const int b = (int)(idx % batch);
  const int s = (int)(idx / batch);
  const size_t steps = (size_t)num_t * lp1;
  const float* a = alpha + (size_t)b * (num_t + 1) * lp1 * 2;
  blank += (size_t)b * num_t;
  pm += b * steps;
  dc += b * steps;
  dov += b * steps;
  label += (size_t)b * lp1;
  // noise [S, T+1, B, 3]: slot j of this (sample, row) at g + j * 3 * batch
  const float* g = noise + ((size_t)s * (num_t + 1) * batch + b) * 3;
  int* out = emits + ((size_t)s * batch + b) * num_t;
  const int blank_tok = (int)*blank_index;
  acc_out[(size_t)s * batch + b] = classic_walk_path(
      a, blank, pm, dc, dov, label_length[b], g, (size_t)3 * batch, num_t, lp1,
      [&](int f, bool open_cur, int, long long, long long lm1) {
        out[f] = open_cur ? (int)label[lm1] : blank_tok;
      });
}

__global__ void __launch_bounds__(kWalkThreads)
simplified_walk_kernel(const float* __restrict__ alpha, const float* __restrict__ blank,
                       const float* __restrict__ dg, const long long* __restrict__ label,
                       const long long* __restrict__ label_length,
                       const long long* __restrict__ blank_index,
                       const float* __restrict__ noise, int num_s, int batch, int num_t,
                       int lp1, float* acc_out, int* emits) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)num_s * batch) return;
  const int b = (int)(idx % batch);
  const int s = (int)(idx / batch);
  const float* a = alpha + (size_t)b * (num_t + 1) * lp1;
  blank += (size_t)b * num_t;
  dg += (size_t)b * num_t * lp1;
  label += (size_t)b * lp1;
  // noise [S, T, B, 2]: slot i of this (sample, row) at g + i * 2 * batch
  const float* g = noise + ((size_t)s * num_t * batch + b) * 2;
  int* out = emits + ((size_t)s * batch + b) * num_t;
  const int blank_tok = (int)*blank_index;
  acc_out[(size_t)s * batch + b] = simplified_walk_path(
      a, blank, dg, label_length[b], g, (size_t)2 * batch, num_t, lp1,
      [&](int f, bool took_diag, long long, long long lm1) {
        out[f] = took_diag ? (int)label[lm1] : blank_tok;
      });
}

// ---------------------------------------------------------------------------
// The gradients of acc (ops/sample.py, the ops ctc_port::classic_walk_grad
// and ctc_port::simplified_walk_grad): the backward of the walk ops, the
// gradient autograd takes through their plain loops (alpha a constant).
// Replaces no Pallas kernel: the JAX package differentiates its vmapped
// lax.scan with jax.grad (tf_seq2seq_losses_tpu/ops/sample.py:65, :150);
// the port's plain version (classic_walk_grad_plain,
// simplified_walk_grad_plain) is the walk's loop again and a sum over the
// samples.
//
// A choice is an argmax of weights plus noise, so no tie rule applies: the
// gradient adds grad[s, b] to the term that sample s's chosen transition
// read at its frame and lane (classic: blank_lp from a closed state, by its
// candidate 0 or 1; prev_tok_masked at cur_l, diag_closed or diag_open at
// cur_l - 1 from an open one; simplified: blank_lp by the horizontal,
// diag_lp at cur_l - 1 by a diagonal from cur_l > 0).  Several samples can
// hit one entry: they are added in sample order s = 0..S-1, from zero, as
// the plain version adds them (sample_sum), with no atomics, whose order
// would vary between runs.  Classic blank_lp adds the samples of candidate
// 0 and those of candidate 1 apart, then the two sums.
//
// What bounds them on the H100: the walk's chain of T steps a sample (as
// classic_walk_kernel), then a pass over the picks; the dense gradients
// [B, T, Lp1] written once are the bytes.
//
// Design: one CTA a row.  Its first threads walk a sample each (the walk
// above, shared with the forward kernels), writing each frame's pick (lane
// << 3 | kind) to a global [S, B, T] scratch, while the others zero the
// row's dense gradients; then a thread a frame adds the samples' picks in
// order.

constexpr int kWalkGradThreads = 256;

// the kinds of a pick: the term that the chosen transition read
constexpr int kPickBlank0 = 0;  // blank_lp, a closed state's candidate 0
constexpr int kPickBlank1 = 1;  // blank_lp, a closed state's candidate 1
constexpr int kPickHoriz = 2;   // prev_tok_masked at cur_l
constexpr int kPickDiagC = 3;   // diag_closed (simplified: diag_lp) at cur_l - 1
constexpr int kPickDiagO = 4;   // diag_open at cur_l - 1
constexpr int kPickNone = 7;    // a constant -inf candidate

__device__ __forceinline__ void zero(float* x, size_t n) {
  for (size_t k = threadIdx.x; k < n; k += blockDim.x) x[k] = 0.0f;
}

__global__ void __launch_bounds__(kWalkGradThreads)
classic_walk_grad_kernel(const float* __restrict__ alpha, const float* __restrict__ blank,
                         const float* __restrict__ pm, const float* __restrict__ dc,
                         const float* __restrict__ dov,
                         const long long* __restrict__ label_length,
                         const float* __restrict__ noise, const float* __restrict__ grad,
                         int num_s, int batch, int num_t, int lp1, int* picks,
                         float* d_blank, float* d_pm, float* d_dc, float* d_do) {
  const int b = blockIdx.x;
  const size_t steps = (size_t)num_t * lp1;
  const float* a = alpha + (size_t)b * (num_t + 1) * lp1 * 2;
  blank += (size_t)b * num_t;
  pm += b * steps;
  dc += b * steps;
  dov += b * steps;
  d_blank += (size_t)b * num_t;
  d_pm += b * steps;
  d_dc += b * steps;
  d_do += b * steps;
  for (int s = threadIdx.x; s < num_s; s += blockDim.x) {
    int* rec = picks + ((size_t)s * batch + b) * num_t;
    classic_walk_path(a, blank, pm, dc, dov, label_length[b],
                      noise + ((size_t)s * (num_t + 1) * batch + b) * 3, (size_t)3 * batch,
                      num_t, lp1,
                      [&](int f, bool open_cur, int choice, long long cur_l, long long lm1) {
                        const long long lane = open_cur ? (choice == 0 ? cur_l : lm1) : 0;
                        const int kind = open_cur ? kPickHoriz + choice
                                                  : (choice < 2 ? choice : kPickNone);
                        rec[f] = (int)(lane << 3) | kind;
                      });
  }
  zero(d_pm, steps);
  zero(d_dc, steps);
  zero(d_do, steps);
  __syncthreads();
  for (int f = threadIdx.x; f < num_t; f += blockDim.x) {
    float blank0 = 0.0f, blank1 = 0.0f;
    for (int s = 0; s < num_s; ++s) {
      const int pick = picks[((size_t)s * batch + b) * num_t + f];
      const float gs = grad[(size_t)s * batch + b];
      const size_t at = (size_t)f * lp1 + (pick >> 3);
      switch (pick & 7) {
        case kPickBlank0: blank0 = blank0 + gs; break;
        case kPickBlank1: blank1 = blank1 + gs; break;
        case kPickHoriz: d_pm[at] = d_pm[at] + gs; break;
        case kPickDiagC: d_dc[at] = d_dc[at] + gs; break;
        case kPickDiagO: d_do[at] = d_do[at] + gs; break;
        default: break;
      }
    }
    d_blank[f] = blank0 + blank1;
  }
}

__global__ void __launch_bounds__(kWalkGradThreads)
simplified_walk_grad_kernel(const float* __restrict__ alpha,
                            const float* __restrict__ blank, const float* __restrict__ dg,
                            const long long* __restrict__ label_length,
                            const float* __restrict__ noise,
                            const float* __restrict__ grad, int num_s, int batch,
                            int num_t, int lp1, int* picks, float* d_blank, float* d_dg) {
  const int b = blockIdx.x;
  const size_t steps = (size_t)num_t * lp1;
  const float* a = alpha + (size_t)b * (num_t + 1) * lp1;
  blank += (size_t)b * num_t;
  dg += b * steps;
  d_blank += (size_t)b * num_t;
  d_dg += b * steps;
  for (int s = threadIdx.x; s < num_s; s += blockDim.x) {
    int* rec = picks + ((size_t)s * batch + b) * num_t;
    simplified_walk_path(a, blank, dg, label_length[b],
                         noise + ((size_t)s * num_t * batch + b) * 2, (size_t)2 * batch,
                         num_t, lp1,
                         [&](int f, bool took_diag, long long cur_l, long long lm1) {
                           const int kind = !took_diag ? kPickBlank0
                                                       : (cur_l > 0 ? kPickDiagC : kPickNone);
                           rec[f] = (int)(lm1 << 3) | kind;
                         });
  }
  zero(d_dg, steps);
  __syncthreads();
  for (int f = threadIdx.x; f < num_t; f += blockDim.x) {
    float sum = 0.0f;
    for (int s = 0; s < num_s; ++s) {
      const int pick = picks[((size_t)s * batch + b) * num_t + f];
      const float gs = grad[(size_t)s * batch + b];
      if ((pick & 7) == kPickBlank0) {
        sum = sum + gs;
      } else if ((pick & 7) == kPickDiagC) {
        const size_t at = (size_t)f * lp1 + (pick >> 3);
        d_dg[at] = d_dg[at] + gs;
      }
    }
    d_blank[f] = sum;
  }
}

// Launch one thread a (sample, row); returns the CUDA error.
template <typename Kernel, typename... Args>
int launch_walk(Kernel kernel, int num_s, int batch, cudaStream_t st, Args... args) {
  if (num_s == 0 || batch == 0) return 0;
  const long long n = (long long)num_s * batch;
  return launch(kernel, (int)((n + kWalkThreads - 1) / kWalkThreads), kWalkThreads, 0, st,
                args...);
}

}  // namespace ctc

extern "C" {

// noise [S, T+1, B, 3]; acc_out [S, B], emits [S, B, T]
int ctc_classic_walk(const float* alpha, const float* blank, const float* pm,
                     const float* dc, const float* dov, const long long* label,
                     const long long* label_length, const long long* blank_index,
                     const float* noise, int num_s, int batch, int num_t, int lp1,
                     float* acc_out, int* emits, void* stream) {
  return ctc::launch_walk(ctc::classic_walk_kernel, num_s, batch,
                         static_cast<cudaStream_t>(stream), alpha, blank, pm, dc, dov,
                         label, label_length, blank_index, noise, num_s, batch, num_t,
                         lp1, acc_out, emits);
}

// noise [S, T, B, 2]; acc_out [S, B], emits [S, B, T]
int ctc_simplified_walk(const float* alpha, const float* blank, const float* dg,
                        const long long* label, const long long* label_length,
                        const long long* blank_index, const float* noise, int num_s,
                        int batch, int num_t, int lp1, float* acc_out, int* emits,
                        void* stream) {
  return ctc::launch_walk(ctc::simplified_walk_kernel, num_s, batch,
                         static_cast<cudaStream_t>(stream), alpha, blank, dg, label,
                         label_length, blank_index, noise, num_s, batch, num_t, lp1,
                         acc_out, emits);
}

// one CTA a row; picks [S, B, T] int scratch; d_blank [B, T], d_pm, d_dc,
// d_do [B, T, Lp1]
int ctc_classic_walk_grad(const float* alpha, const float* blank, const float* pm,
                          const float* dc, const float* dov, const long long* label_length,
                          const float* noise, const float* grad, int num_s, int batch,
                          int num_t, int lp1, int* picks, float* d_blank, float* d_pm,
                          float* d_dc, float* d_do, void* stream) {
  if (batch == 0) return 0;
  return ctc::launch(ctc::classic_walk_grad_kernel, batch, ctc::kWalkGradThreads, 0,
                     static_cast<cudaStream_t>(stream), alpha, blank, pm, dc, dov,
                     label_length, noise, grad, num_s, batch, num_t, lp1, picks, d_blank,
                     d_pm, d_dc, d_do);
}

// d_blank [B, T], d_dg [B, T, Lp1]
int ctc_simplified_walk_grad(const float* alpha, const float* blank, const float* dg,
                             const long long* label_length, const float* noise,
                             const float* grad, int num_s, int batch, int num_t, int lp1,
                             int* picks, float* d_blank, float* d_dg, void* stream) {
  if (batch == 0) return 0;
  return ctc::launch(ctc::simplified_walk_grad_kernel, batch, ctc::kWalkGradThreads, 0,
                     static_cast<cudaStream_t>(stream), alpha, blank, dg, label_length,
                     noise, grad, num_s, batch, num_t, lp1, picks, d_blank, d_dg);
}

}  // extern "C"
