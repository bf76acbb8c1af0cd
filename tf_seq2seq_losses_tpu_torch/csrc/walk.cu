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
  const size_t slot = (size_t)3 * batch;
  int* out = emits + ((size_t)s * batch + b) * num_t;
  const int blank_tok = (int)*blank_index;

  long long cur_l = label_length[b];
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
    out[f] = open_cur ? (int)label[lm1] : blank_tok;
    cur_l = prev_l;
    cur_s = prev_s;
  }
  acc_out[(size_t)s * batch + b] = acc;
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
  const size_t slot = (size_t)2 * batch;
  int* out = emits + ((size_t)s * batch + b) * num_t;
  const int blank_tok = (int)*blank_index;

  long long cur_l = label_length[b];
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
    out[f] = took_diag ? (int)label[lm1] : blank_tok;
    cur_l = prev_l;
  }
  acc_out[(size_t)s * batch + b] = acc;
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

}  // extern "C"
