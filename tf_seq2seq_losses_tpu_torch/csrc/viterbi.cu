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
      const int lm = l == 0 ? lp1 - 1 : l - 1;
      const float v_closed = prev[2 * l];
      const float v_open = prev[2 * l + 1];
      const float new_closed = max_nan(v_closed, v_open) + bl;
      const int pc = v_open > v_closed;
      const float horiz = v_open + pm_t[l];
      const float diag_c = prev[2 * lm] + dc_t[lm];
      const float diag_o = prev[2 * lm + 1] + do_t[lm];
      const float best = max_nan(diag_c, diag_o);
      const int po = best > horiz ? 1 + (diag_o > diag_c) : 0;
      next[2 * l] = new_closed;
      next[2 * l + 1] = max_nan(horiz, best);
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
      const int lm = l == 0 ? lp1 - 1 : l - 1;
      const float horiz = prev[l] + bl;
      const float diag = prev[lm] + dg_t[lm];
      ptr_t[l] = (unsigned char)(diag > horiz);
      next[l] = max_nan(horiz, diag);
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

// shared memory of the staged kernels: two carries a lane (two states
// classic, one simplified)
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

}  // extern "C"
