// Fused d_logits epilogue (kernel B12): the act scatter, the gradient
// assembly and the log-softmax cotangent of the streamed one-chunk scheme
// in one pass, for either topology.
//
// Replaces tf_seq2seq_losses_tpu/ops/pallas_lattice.py:_fused_epilogue_kernel
// (launched by _fused_epilogue_call through _fused_dlogits).  For each row
// (b, t) with t < lens[b]:
//   sums[v]  = the acts[b, t, l] of the lanes l with lm[b, l] != 0 and
//              labels[b, l] = v, summed in float64 in ascending lane order
//              and rounded once to f32 (exact products: the sums of the
//              float64 act scatter of ops/cuda_lattice.py, deterministic,
//              no TF32, no atomics);
//   neg[v]   = scale[b] * sums[v] for v != blank;
//   neg[blank] = max(1 - sum over v != blank of neg[v], 0), the posterior
//              identity;
//   out[b, t, v] = d_loss[b] * (exp(logproba[b, t, v]) - neg[v]).
// Rows t >= lens[b] are exactly 0, by a select (the host sets lens to 0 on
// rows whose fast loss is not finite, whose acts are not read).
//
// What bounds it on the H100: bytes.  It reads the valid rows' acts over
// the label's lanes and their log-probabilities and writes d_logits
// [B, T, V] (about 0.06 ms at B=256, T=500, V=128 at 3.35 TB/s); it does
// a few operations per element.
//
// Design: one CTA of 8 warps per (sample, block of 64 steps).  The TPU
// kernel scattered with a one-hot product [bt, L] @ [L, V] in a bf16 hi/lo
// split; here the CTA first builds its sample's lane lists in shared
// memory: head[v], the first lane that holds token v, and next[l], the next
// lane that holds lane l's token.  One warp builds them, walking the lanes
// last to first in groups of 32: __match_any_sync finds a lane's peers in
// its group, and a lane without a later peer in the group links to the
// head that the later groups left.  Then each warp takes one row at a time:
// it stages the row's acts over the label's lanes in its own slice of
// shared memory (coalesced), each lane sums the lists of its tokens
// v = lane, lane + 32, ..., the warp reduces the non-blank sum with a
// butterfly (the same bits on every lane), and each lane writes its tokens'
// d_logits (coalesced along v).  The sums are walked twice, for the blank's
// identity and for the output, so that no V-wide buffer per warp is needed
// and V is bounded only by head[V] in shared memory.
#include <cuda_runtime.h>
#include <math.h>

namespace ctc {

constexpr int kEpiWarps = 8;
constexpr int kEpiRows = 64;  // steps per CTA

__host__ __device__ inline size_t epi_smem_bytes(int lpad, int num_tokens) {
  // floats: one act row per warp; ints: next[lpad], head[V], nl
  return sizeof(float) * (size_t)kEpiWarps * lpad +
         sizeof(int) * ((size_t)lpad + num_tokens + 1);
}

// sums[v] of one staged act row
__device__ __forceinline__ float token_sum(const float* row, const int* head,
                                           const int* next, int v) {
  double acc = 0.0;
  for (int l = head[v]; l >= 0; l = next[l]) acc += (double)row[l];
  return (float)acc;
}

__global__ void fused_dlogits_kernel(
    const float* __restrict__ acts,      // [B, Tp, L] combined acts
    const int* __restrict__ labels,      // [B, L] token of each lane
    const float* __restrict__ lm,        // [B, L] the lane is a label token
    const float* __restrict__ scale,     // [B] act scale
    const float* __restrict__ d_loss,    // [B]
    const int* __restrict__ lens,        // [B] valid steps
    const float* __restrict__ logproba,  // [B, T, V]
    const int* __restrict__ blank_ptr,   // [1] blank index
    int num_t, int tpad, int lpad, int num_tokens,
    float* __restrict__ out) {           // [B, T, V]
  extern __shared__ float smem[];
  float* rows = smem;
  int* next = reinterpret_cast<int*>(rows + (size_t)kEpiWarps * lpad);
  int* head = next + lpad;
  int* nl_s = head + num_tokens;
  const int b = blockIdx.y;
  const int t_begin = blockIdx.x * kEpiRows;
  const int t_end = min(t_begin + kEpiRows, num_t);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned full = 0xffffffffu;
  const size_t lrow = (size_t)b * lpad;

  for (int v = threadIdx.x; v < num_tokens; v += blockDim.x) head[v] = -1;
  __syncthreads();
  if (warp == 0) {
    int nl = 0;  // one past the last listed lane
    for (int g = lpad / 32 - 1; g >= 0; --g) {
      const int l = g * 32 + lane;
      const int tok = labels[lrow + l];
      const bool listed = lm[lrow + l] != 0.0f && tok >= 0 && tok < num_tokens;
      const int v = listed ? tok : -1;
      const unsigned peers = __match_any_sync(full, v);
      const unsigned valid = __ballot_sync(full, listed);
      if (nl == 0 && valid != 0u) nl = g * 32 + 32 - __clz(valid);
      if (listed) {
        const unsigned later = peers & ~((2u << lane) - 1u);
        next[l] = later != 0u ? g * 32 + __ffs(later) - 1 : head[v];
      }
      __syncwarp();
      // the lowest lane of a token's peers in the group is its new head
      if (listed && (peers & ((1u << lane) - 1u)) == 0u) head[v] = l;
      __syncwarp();
    }
    if (lane == 0) *nl_s = nl;
  }
  __syncthreads();

  const int nl = *nl_s;
  const int blank = *blank_ptr;
  const int len = lens[b];
  const float sc = scale[b];
  const float dl = d_loss[b];
  float* row = rows + (size_t)warp * lpad;
  for (int t = t_begin + warp; t < t_end; t += kEpiWarps) {
    float* o = out + ((size_t)b * num_t + t) * num_tokens;
    if (t >= len) {
      for (int v = lane; v < num_tokens; v += 32) o[v] = 0.0f;
      continue;
    }
    const float* a = acts + ((size_t)b * tpad + t) * lpad;
    for (int l = lane; l < nl; l += 32) row[l] = a[l];
    __syncwarp();
    float s = 0.0f;
    for (int v = lane; v < num_tokens; v += 32) {
      if (v != blank) s += sc * token_sum(row, head, next, v);
    }
    for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(full, s, m);
    const float neg_blank = fmaxf(1.0f - s, 0.0f);
    const float* lp = logproba + ((size_t)b * num_t + t) * num_tokens;
    for (int v = lane; v < num_tokens; v += 32) {
      const float neg = v == blank ? neg_blank : sc * token_sum(row, head, next, v);
      o[v] = dl * (expf(lp[v]) - neg);
    }
    __syncwarp();  // the row's reads are done before the next row is staged
  }
}

}  // namespace ctc

extern "C" {

size_t ctc_fused_epilogue_smem_bytes(int lpad, int num_tokens) {
  return ctc::epi_smem_bytes(lpad, num_tokens);
}

int ctc_fused_dlogits(const float* acts, const int* labels, const float* lm,
                      const float* scale, const float* d_loss, const int* lens,
                      const float* logproba, const int* blank, int batch,
                      int num_t, int tpad, int lpad, int num_tokens, float* out,
                      void* stream) {
  if (batch == 0 || num_t == 0 || num_tokens == 0) return 0;
  const size_t smem = ctc::epi_smem_bytes(lpad, num_tokens);
  cudaFuncSetAttribute(ctc::fused_dlogits_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((num_t + ctc::kEpiRows - 1) / ctc::kEpiRows, batch);
  ctc::fused_dlogits_kernel<<<grid, ctc::kEpiWarps * 32, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      acts, labels, lm, scale, d_loss, lens, logproba, blank, num_t, tpad, lpad,
      num_tokens, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
