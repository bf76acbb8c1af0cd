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
// [B, T, V] (0.054 ms at B=256, T=500, V=128 at 3.35 TB/s); it does a
// float64 add a lane and a few operations a token per row.
//
// What held the parent design back (one CTA of 8 warps per sample and 64
// steps; one warp built the sample's lane lists as linked lists with its
// own global loads while seven waited; each warp staged one row at a time
// with its own loads, then walked each token's list twice, a chain of
// dependent shared-memory loads, for the blank's identity and for the
// output; H100 80GB HBM3, 700 W, V=128 at the headline): 0.152 ms against
// the 0.054 bound.  Built beforehand, the lists saved nothing; without the
// second walk it took 0.121, without both walks 0.0996, and the store of
// d_logits alone 0.0555: the walks, chains exposed row by row, were 0.052.
//
// Design against that:
// - The token lists are a CSR: lanes[] holds the listed lanes grouped by
//   token, each group in ascending lane order, and ends[v] the end of token
//   v's group.  Every thread stages the lanes' tokens and counts them into
//   ends[] (integer shared atomics: the counts do not depend on their
//   order), warp 0 turns the counts into offsets with a warp scan and
//   places the lanes 32 at a time in ascending order (__match_any_sync
//   ranks a lane among its peers of the group), advancing each offset to
//   its token's end.  A walk's loads of lanes[] are independent, not a
//   chain.
// - The acts run ahead, asynchronously: each warp owns a ring of
//   epi_depth(lpad) slots in shared memory with an mbarrier each, and its
//   lane 0 fills a slot with one bulk copy (TMA, evict-first) of a row's
//   acts over the listed lanes; it issues the first rows as soon as the
//   label's last listed lane is known, before the lists are placed, and
//   the row epi_depth places later as each row is read.
// - Each lane holds its tokens' sums in registers between the blank's
//   identity and the output (up to kEpiMaxTpl tokens a lane, V <= 256: a
//   template parameter), so a row walks its lists once; wider vocabularies
//   walk them twice, as the parent did, and V stays bounded only by
//   ends[V] in shared memory.
// - Each row's log-probabilities are loaded before its acts are waited
//   for, and d_logits is stored with the streaming hint.
// Every sum keeps its lane order and every f32 operation its order
// (-fmad=false), so the output is the parent's bit for bit.
//
// What bounds it now (the same card and shape): 0.095 to 0.103 ms.  Its
// bytes alone (no lists, no walks) take 0.076, reads and writes together at
// 2.5 TB/s, and its store of d_logits alone 0.040 (0.054 without the
// streaming hint); the walks that the staging does not hide are 0.02.
// Occupancy is not it: capped at 6 or 8 CTAs an SM by registers it is no
// faster.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "stage.cuh"

namespace ctc {

constexpr int kEpiWarps = 8;
constexpr int kEpiRows = 64;   // steps per CTA
constexpr int kEpiMaxTpl = 8;  // tokens a lane keeps the sums of: V <= 256

// act rows each warp stages ahead
__host__ __device__ inline int epi_depth(int lpad) { return lpad <= 2048 ? 2 : 1; }

__host__ __device__ inline size_t epi_smem_bytes(int lpad, int num_tokens) {
  // floats: each warp's ring of act rows; an mbarrier per ring slot; ints:
  // lanes[lpad], ends[V], nl
  const int slots = kEpiWarps * epi_depth(lpad);
  return sizeof(float) * (size_t)slots * lpad + sizeof(uint64_t) * slots +
         sizeof(int) * ((size_t)lpad + num_tokens + 1);
}

// sums[v] of one staged act row: its lanes lanes[i0 .. i1) in ascending order
__device__ __forceinline__ float token_sum(const float* row, const int* lanes, int i0,
                                           int i1) {
  double acc = 0.0;
  for (int i = i0; i < i1; ++i) acc += (double)row[lanes[i]];
  return (float)acc;
}

// TPL > 0: each lane keeps the sums of its TPL tokens v = lane + 32 k;
// TPL = 0: any V, two walks
template <int TPL>
__global__ void __launch_bounds__(kEpiWarps * 32) fused_dlogits_kernel(
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
  extern __shared__ __align__(16) float smem[];
  const int depth = epi_depth(lpad);
  float* ring = smem;                                            // [warps, depth, L]
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + (size_t)kEpiWarps * depth * lpad);
  int* lanes = reinterpret_cast<int*>(bars + kEpiWarps * depth);  // [L]
  int* ends = lanes + lpad;                                      // [V]
  int* nl_s = ends + num_tokens;
  int* tokv = reinterpret_cast<int*>(ring);  // [L] while the lists are built: warp 0's ring
  const int b = blockIdx.y;
  const int t_begin = blockIdx.x * kEpiRows;
  const int t_end = min(t_begin + kEpiRows, num_t);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned full = 0xffffffffu;
  const size_t lrow = (size_t)b * lpad;
  const int len = lens[b];
  // this warp's rows t = t_begin + warp + 8 i; the valid ones come first
  const int t0 = t_begin + warp;
  const int valid_end = min(t_end, len);
  const int n_valid = valid_end > t0 ? (valid_end - t0 + kEpiWarps - 1) / kEpiWarps : 0;
  uint64_t* wbars = bars + warp * depth;
  float* wring = ring + (size_t)warp * depth * lpad;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kEpiWarps * depth; ++s) mbar_init(&bars[s], 1);
    mbar_fence_init();
    *nl_s = 0;
  }
  for (int v = threadIdx.x; v < num_tokens; v += blockDim.x) ends[v] = 0;
  __syncthreads();
  // the lanes' tokens (-1: not listed), their counts, one past the last
  // listed lane
  for (int l = threadIdx.x; l < lpad; l += blockDim.x) {
    const int tok = labels[lrow + l];
    const bool listed = lm[lrow + l] != 0.0f && tok >= 0 && tok < num_tokens;
    tokv[l] = listed ? tok : -1;
    if (listed) {
      atomicAdd(&ends[tok], 1);
      atomicMax(nl_s, l + 1);
    }
  }
  __syncthreads();
  const int nl = *nl_s;
  const uint32_t row_bytes = (uint32_t)((nl + 3) / 4 * 4) * sizeof(float);
  uint64_t policy = 0;
  auto issue = [&](int i) {
    const int s = i % depth;
    const size_t t = (size_t)(t0 + kEpiWarps * i);
    stage_row(wring + (size_t)s * lpad, acts + ((size_t)b * tpad + t) * lpad, row_bytes,
              &wbars[s], policy);
  };
  if (lane == 0 && nl > 0 && warp > 0) {
    policy = evict_first_policy();
    for (int i = 0; i < depth && i < n_valid; ++i) issue(i);
  }
  if (warp == 0) {
    // counts to offsets: ends[v] = the start of token v's group
    int run = 0;
    for (int v0 = 0; v0 < num_tokens; v0 += 32) {
      const int v = v0 + lane;
      const int c = v < num_tokens ? ends[v] : 0;
      int incl = c;
      for (int m = 1; m < 32; m <<= 1) {
        const int y = __shfl_up_sync(full, incl, m);
        if (lane >= m) incl += y;
      }
      if (v < num_tokens) ends[v] = run + incl - c;
      run += __shfl_sync(full, incl, 31);
    }
    __syncwarp();
    // place the lanes in ascending order; each offset ends at its group's end
    const unsigned below = (1u << lane) - 1u;
    for (int g = 0; g * 32 < nl; ++g) {
      const int l = g * 32 + lane;
      const int v = l < nl ? tokv[l] : -1;
      const unsigned peers = __match_any_sync(full, v);
      int base = 0;
      if (v >= 0) {
        base = ends[v];
        lanes[base + __popc(peers & below)] = l;
      }
      __syncwarp();
      if (v >= 0 && (peers & below) == 0u) ends[v] = base + __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();
  if (warp == 0 && lane == 0 && nl > 0) {
    // warp 0's ring held the tokens
    fence_proxy_async();
    policy = evict_first_policy();
    for (int i = 0; i < depth && i < n_valid; ++i) issue(i);
  }

  const int blank = *blank_ptr;
  const float sc = scale[b];
  const float dl = d_loss[b];
  for (int i = 0, t = t0; t < t_end; ++i, t += kEpiWarps) {
    float* o = out + ((size_t)b * num_t + t) * num_tokens;
    if (i >= n_valid) {
      for (int v = lane; v < num_tokens; v += 32) __stcs(o + v, 0.0f);
      continue;
    }
    const float* lp = logproba + ((size_t)b * num_t + t) * num_tokens;
    const float* row = wring + (size_t)(i % depth) * lpad;
    if constexpr (TPL > 0) {
      float lpv[TPL], sum[TPL];
#pragma unroll
      for (int k = 0; k < TPL; ++k) {
        const int v = lane + 32 * k;
        lpv[k] = v < num_tokens ? lp[v] : 0.0f;
      }
      if (nl > 0) mbar_wait(&wbars[i % depth], (i / depth) & 1);
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < TPL; ++k) {
        const int v = lane + 32 * k;
        sum[k] = 0.0f;
        if (v < num_tokens) {
          sum[k] = token_sum(row, lanes, v == 0 ? 0 : ends[v - 1], ends[v]);
          if (v != blank) s += sc * sum[k];
        }
      }
      for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(full, s, m);
      const float neg_blank = fmaxf(1.0f - s, 0.0f);
#pragma unroll
      for (int k = 0; k < TPL; ++k) {
        const int v = lane + 32 * k;
        if (v < num_tokens) {
          const float neg = v == blank ? neg_blank : sc * sum[k];
          __stcs(o + v, dl * (expf(lpv[k]) - neg));
        }
      }
    } else {
      if (nl > 0) mbar_wait(&wbars[i % depth], (i / depth) & 1);
      float s = 0.0f;
      for (int v = lane; v < num_tokens; v += 32) {
        if (v != blank) s += sc * token_sum(row, lanes, v == 0 ? 0 : ends[v - 1], ends[v]);
      }
      for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(full, s, m);
      const float neg_blank = fmaxf(1.0f - s, 0.0f);
      for (int v = lane; v < num_tokens; v += 32) {
        const float neg = v == blank
                              ? neg_blank
                              : sc * token_sum(row, lanes, v == 0 ? 0 : ends[v - 1], ends[v]);
        __stcs(o + v, dl * (expf(lp[v]) - neg));
      }
    }
    __syncwarp();  // the row's reads are done before its slot is refilled
    if (lane == 0 && i + depth < n_valid && nl > 0) {
      fence_proxy_async();
      issue(i + depth);
    }
  }
}

struct EpiArgs {
  const float *acts;
  const int* labels;
  const float *lm, *scale, *d_loss;
  const int* lens;
  const float* logproba;
  const int* blank;
  int num_t, tpad, lpad, num_tokens;
  float* out;
};

template <int TPL>
int launch_epi(int tpl, int batch, cudaStream_t st, const EpiArgs& a) {
  if constexpr (TPL > kEpiMaxTpl) {
    return launch_epi<0>(0, batch, st, a);
  } else {
    if (TPL > 0 && tpl != TPL) return launch_epi<TPL + 1>(tpl, batch, st, a);
    const size_t smem = epi_smem_bytes(a.lpad, a.num_tokens);
    cudaFuncSetAttribute(fused_dlogits_kernel<TPL>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    const dim3 grid((a.num_t + kEpiRows - 1) / kEpiRows, batch);
    fused_dlogits_kernel<TPL><<<grid, kEpiWarps * 32, smem, st>>>(
        a.acts, a.labels, a.lm, a.scale, a.d_loss, a.lens, a.logproba, a.blank,
        a.num_t, a.tpad, a.lpad, a.num_tokens, a.out);
    return (int)cudaGetLastError();
  }
}

}  // namespace ctc

extern "C" {

size_t ctc_fused_epilogue_smem_bytes(int lpad, int num_tokens) {
  return ctc::epi_smem_bytes(lpad, num_tokens);
}

// acts 16-byte aligned (the wrapper checks)
int ctc_fused_dlogits(const float* acts, const int* labels, const float* lm,
                      const float* scale, const float* d_loss, const int* lens,
                      const float* logproba, const int* blank, int batch,
                      int num_t, int tpad, int lpad, int num_tokens, float* out,
                      void* stream) {
  if (batch == 0 || num_t == 0 || num_tokens == 0) return 0;
  const ctc::EpiArgs a{acts, labels, lm, scale, d_loss, lens, logproba, blank,
                       num_t, tpad, lpad, num_tokens, out};
  return ctc::launch_epi<1>((num_tokens + 31) / 32, batch,
                            static_cast<cudaStream_t>(stream), a);
}

}  // extern "C"
