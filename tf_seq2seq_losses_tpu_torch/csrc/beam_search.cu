// Prefix beam search (ops/decode.py, the op ctc_port::beam_search): every
// frame of the search, then the backtrack of the beams' tokens, in one
// launch.  Two instantiations by merge_repeats: classic_beam_search
// (repeats collapse) and simplified_beam_search (blank removal alone).
//
// Replaces no Pallas kernel: the JAX package's search is a lax.scan vmapped
// over the batch (tf_seq2seq_losses_tpu/ops/decode.py:54, the scan at :192,
// the vmap at :274), which XLA compiles into one loop.  The port's plain
// version, beam_search_plain, is a batched Python loop over T of about 50
// launches a frame, which this kernel replaces on the card.  It writes that
// loop's bits: tokens, lengths and scores of all K beams, dead ones
// included.  A frame t of a row, over the state (length, last, h1, h2, pb,
// pnb) of its K beams:
//
//   pool      n = K (1 + V) candidates in the loop's order: candidate
//             k (1 + V) is beam k's stay, k (1 + V) + 1 + v its extension
//             by token v, each (pb, pnb) by _frame's formulas; frames past
//             logit_length are forced-blank stays (pnb moves into pb);
//   merge     the pool sorted by the unique key (h1, h2, pool index), which
//             is jnp.lexsort((h2, h1))'s stable order; a run of equal
//             (h1, h2) is one prefix, its head the member of lowest pool
//             index; the head takes the run's segment logsumexp of each
//             component as utils/numerics.py:unsorted_segment_logsumexp
//             computes it (the max, m_safe, the sum of exp(x - m_safe) in
//             pool-index order from 0, then m_safe + log(sum) or -inf),
//             every other member -inf;
//   top K     the K largest of the key (score, then sorted position
//             ascending), which is torch.sort(score, descending=True,
//             stable=True)'s order over sorted positions: equal scores,
//             the -inf of dead slots above all, go by hash order;
//   state     the selected candidate's length, last and hashes, the head's
//             merged (pb, pnb) (-inf for a non-head), and a back-pointer
//             (pool index, the slot written or -1) a beam and frame.
//
// At the end the scores lse(pb, pnb) are ranked as a stable argsort of
// -score, and each beam's tokens are found by walking its back-pointers
// from the last frame down: the first write met for a slot stands, slots
// never written are 0.  The hashes are uint32 and wrap as the JAX
// package's do (decode.hash_step emulates them in int64).  The float32
// adds are exact; exp, log and log1p are expf, logf and log1pf, torch's
// CUDA float32 kernels (lse32 of pure64.cuh), so the kernel rounds as the
// loop does.  The loop's index_add on the card is atomic, in no fixed
// order; a run holds at most two finite members (the stay of a prefix and
// the extension of its parent by its last token), the dead ones adding
// exact zeros, so any order gives these bits.  A blank index outside
// [0, V) (the loop raises there) matches no token and reads the nearest
// token's log-probability, so that no read leaves the row.
//
// What bounds it on the H100: the chain of T dependent frames, each a few
// dozen barriers (the bitonic sort's log2(P) (log2(P) + 1) / 2 stages over
// the padded pool P, K block-wide maxima).  The bytes (the log-probabilities
// [B, T, V] read once, the tokens [B, K, Lcap] written once, the
// back-pointers [B, T, K] written and read back once) are far below that at
// the headline (B=256, T=500, V=32, K=8: P=512, 45 sort stages).
// Latency-bound.
//
// Design (a first, simple one, as viterbi.cu): one CTA a row, P / 2
// threads (32 to 1024).  The pool, the sort, the merged values and the
// beams' state live in shared memory where they fit
// (ctc_beam_search_smem_bytes), else in a global scratch row of the same
// layout (a pool of K=16 at V=1024 is 16400 candidates, P=32768).  No
// [K, Lcap] tokens are copied a frame: the back-pointers go to a global
// [B, T, K] scratch, read back once by the backtrack.
#include <stdint.h>

#include "pure64.cuh"

namespace ctc {

constexpr int kBeamThreads = 1024;
constexpr int kBeamMinPool = 64;  // the least padded pool: 32 threads
constexpr unsigned kH1Mult = 0x85EBCA6Bu;
constexpr unsigned kH2Mult = 0xC2B2AE35u;
constexpr unsigned kBit31 = 0x80000000u;

// A row's workspace, in bytes from its start: the sort's keys (h1, h2) and
// the selection keys, u64 [P] each; the maxima's exchange, u64 [2][32];
// the sort's pool indices, u32 [P]; the candidates' pb and pnb, f32 [n]
// each; the beams' state twice (this frame's and the next), seven words a
// beam (length, last, h1, h2, pb, pnb, tot = lse(pb, pnb)); the selected
// sorted positions, int [K].  The total rounds up to 16 bytes.
struct BeamLayout {
  int n, pad;
  size_t skey, sel, red, sidx, cpb, cpnb, state, selpos, bytes;
};

__host__ __device__ inline BeamLayout beam_layout(int k, int vocab) {
  BeamLayout a;
  a.n = k * (1 + vocab);
  a.pad = kBeamMinPool;
  while (a.pad < a.n) a.pad <<= 1;
  const size_t p = (size_t)a.pad, n = (size_t)a.n;
  a.skey = 0;
  a.sel = a.skey + 8 * p;
  a.red = a.sel + 8 * p;
  a.sidx = a.red + 8 * 64;
  a.cpb = a.sidx + 4 * p;
  a.cpnb = a.cpb + 4 * n;
  a.state = a.cpnb + 4 * n;
  a.selpos = a.state + (size_t)2 * 7 * 4 * k;
  a.bytes = (a.selpos + (size_t)4 * k + 15) / 16 * 16;
  return a;
}

inline int beam_threads(int pad) {
  const int half = pad / 2;
  return half < kBeamThreads ? half : kBeamThreads;
}

// One of the two state buffers: seven arrays of K words.
struct BeamState {
  int* length;
  int* last;
  unsigned* h1;
  unsigned* h2;
  float* pb;
  float* pnb;
  float* tot;
};

__device__ __forceinline__ BeamState beam_state(unsigned char* base, int k, int which) {
  uint32_t* w = reinterpret_cast<uint32_t*>(base) + (size_t)which * 7 * k;
  return {reinterpret_cast<int*>(w), reinterpret_cast<int*>(w + k), w + 2 * k, w + 3 * k,
          reinterpret_cast<float*>(w + 4 * k), reinterpret_cast<float*>(w + 5 * k),
          reinterpret_cast<float*>(w + 6 * k)};
}

// The selection key of a candidate at sorted position s: its score mapped
// to an unsigned order (a NaN above +inf, as torch.sort puts NaN first
// descending; -0 as +0, which compare equal), then the position
// reversed, so that the largest key is the highest score, the lowest
// position among equal scores.  Every candidate's key is above 0.
__device__ __forceinline__ unsigned long long select_key(float score, int s) {
  unsigned u;
  if (score != score) {
    u = 0xFFFFFFFFu;
  } else {
    const unsigned bits = __float_as_uint(score + 0.0f);
    u = (bits & kBit31) ? ~bits : (bits | kBit31);
  }
  return ((unsigned long long)u << 32) | (0xFFFFFFFFu - (unsigned)s);
}

// The largest v of the CTA; red holds a value a warp (blockDim.x a
// multiple of 32).  One barrier; callers alternate two red buffers, so a
// warp's next write never meets a read of this one.
__device__ __forceinline__ unsigned long long block_max(unsigned long long v,
                                                        unsigned long long* red) {
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long w = __shfl_xor_sync(0xFFFFFFFFu, v, o);
    v = w > v ? w : v;
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned long long m = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) m = red[w] > m ? red[w] : m;
  return m;
}

// torch.stable argsort's "before" on -score: a number before a NaN, NaNs
// tied
__device__ __forceinline__ bool before(float y, float x) {
  return y < x || (y == y && x != x);
}

template <bool kMerge, bool kStaged>
__global__ void __launch_bounds__(kBeamThreads)
beam_search_kernel(const float* __restrict__ lp, const long long* __restrict__ logit_length,
                   const long long* __restrict__ blank_index, int num_t, int vocab, int k,
                   int l_cap, unsigned char* gws, int2* bp, int* tokens, int* lengths,
                   float* scores) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BeamLayout lay = beam_layout(k, vocab);
  const int b = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const int width = 1 + vocab, n = lay.n, pad = lay.pad;
  unsigned char* ws = kStaged ? smem : gws + (size_t)b * lay.bytes;
  unsigned long long* skey = reinterpret_cast<unsigned long long*>(ws + lay.skey);
  unsigned long long* sel = reinterpret_cast<unsigned long long*>(ws + lay.sel);
  unsigned long long* red = reinterpret_cast<unsigned long long*>(ws + lay.red);
  unsigned* sidx = reinterpret_cast<unsigned*>(ws + lay.sidx);
  float* cpb = reinterpret_cast<float*>(ws + lay.cpb);
  float* cpnb = reinterpret_cast<float*>(ws + lay.cpnb);
  int* selpos = reinterpret_cast<int*>(ws + lay.selpos);
  const float ninf = -CUDART_INF_F;
  const long long live_t = logit_length[b];
  const long long bi = *blank_index;
  // a blank outside [0, V) runs as no token, and every score is NaN: the
  // loop raises on it, and the kernel reads nothing back to the host
  const bool bad_blank = bi < 0 || bi >= vocab;
  const int blank = bi < 0 ? -1 : (bi >= vocab ? vocab : (int)bi);
  const int blank_at = blank < 0 ? 0 : (blank >= vocab ? vocab - 1 : blank);
  lp += (size_t)b * num_t * vocab;
  bp += (size_t)b * num_t * k;

  // _initial_beams: beam 0 the empty prefix at probability 1, the others
  // dead slots with distinct sentinel hashes (bit 31 set)
  {
    const BeamState s0 = beam_state(ws + lay.state, k, 0);
    for (int j = tid; j < k; j += nth) {
      s0.length[j] = 0;
      s0.last[j] = -1;
      s0.h1[j] = j == 0 ? 0u : ((unsigned)j | kBit31);
      s0.h2[j] = j == 0 ? 0u : (((unsigned)j * kH2Mult) | kBit31);
      s0.pb[j] = j == 0 ? 0.0f : ninf;
      s0.pnb[j] = ninf;
      s0.tot[j] = lse32(s0.pb[j], s0.pnb[j]);
    }
  }
  __syncthreads();

  for (int t = 0; t < num_t; ++t) {
    const BeamState cur = beam_state(ws + lay.state, k, t & 1);
    const BeamState nxt = beam_state(ws + lay.state, k, (t + 1) & 1);
    const float* lp_t = lp + (size_t)t * vocab;
    const bool live = t < live_t;
    const float blank_lp = live ? lp_t[blank_at] : 0.0f;

    // ---- the pool, one candidate a thread; the padding sorts last
    for (int i = tid; i < pad; i += nth) {
      sidx[i] = (unsigned)i;
      if (i >= n) {
        skey[i] = ~0ull;
        continue;
      }
      const int j = i / width, r = i - j * width;
      unsigned g1 = cur.h1[j], g2 = cur.h2[j];
      float c_pb = ninf, c_pnb = ninf;
      if (r == 0) {
        c_pb = cur.tot[j] + blank_lp;
        if (kMerge) {
          const int ls = cur.last[j];
          const float last_lp = (ls >= 0 && live) ? lp_t[ls] : ninf;
          c_pnb = cur.pnb[j] + last_lp;
        }
      } else {
        const int v = r - 1;
        const float tok = live ? lp_t[v] : ninf;
        const float base = (kMerge && v == cur.last[j]) ? cur.pb[j] : cur.tot[j];
        const bool dead = v == blank || cur.length[j] >= l_cap || !live;
        c_pnb = dead ? ninf : base + tok;
        g1 = g1 * kH1Mult + (unsigned)(v + 1);
        g2 = g2 * kH2Mult + (unsigned)(v + 1);
      }
      cpb[i] = c_pb;
      cpnb[i] = c_pnb;
      skey[i] = ((unsigned long long)g1 << 32) | g2;
    }
    __syncthreads();

    // ---- bitonic sort of (key, pool index), ascending
    for (int size = 2; size <= pad; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int p = tid; p < pad / 2; p += nth) {
          const int lo = 2 * p - (p & (stride - 1)), hi = lo + stride;
          const unsigned long long ka = skey[lo], kb = skey[hi];
          const unsigned ia = sidx[lo], ib = sidx[hi];
          const bool greater = ka > kb || (ka == kb && ia > ib);
          if (greater == ((lo & size) == 0)) {
            skey[lo] = kb;
            skey[hi] = ka;
            sidx[lo] = ib;
            sidx[hi] = ia;
          }
        }
        __syncthreads();
      }
    }

    // ---- the runs: each head merges its members in pool-index order
    for (int s = tid; s < pad; s += nth) {
      if (s >= n) {
        sel[s] = 0;  // the padding is never selected
        continue;
      }
      const unsigned long long key = skey[s];
      float score = ninf;
      if (s == 0 || skey[s - 1] != key) {
        int e = s + 1;
        while (e < n && skey[e] == key) ++e;
        float m1 = ninf, m2 = ninf;
        for (int q = s; q < e; ++q) {
          m1 = amax2(m1, cpb[sidx[q]]);
          m2 = amax2(m2, cpnb[sidx[q]]);
        }
        // torch.isfinite: false for +-inf and NaN
        const float z1 = fabsf(m1) < CUDART_INF_F ? m1 : 0.0f;
        const float z2 = fabsf(m2) < CUDART_INF_F ? m2 : 0.0f;
        float sum1 = 0.0f, sum2 = 0.0f;
        for (int q = s; q < e; ++q) {
          sum1 = sum1 + expf(cpb[sidx[q]] - z1);
          sum2 = sum2 + expf(cpnb[sidx[q]] - z2);
        }
        const float r1 = z1 + (sum1 == 0.0f ? ninf : logf(sum1));
        const float r2 = z2 + (sum2 == 0.0f ? ninf : logf(sum2));
        cpb[sidx[s]] = r1;  // the run's pool indices are this thread's alone
        cpnb[sidx[s]] = r2;
        score = lse32(r1, r2);
      }
      sel[s] = select_key(score, s);
    }
    __syncthreads();

    // ---- the top K: K block-wide maxima of the selection key
    for (int r = 0; r < k; ++r) {
      unsigned long long best = 0;
      for (int s = tid; s < pad; s += nth) best = sel[s] > best ? sel[s] : best;
      best = block_max(best, red + (r & 1) * 32);
      const int s_best = (int)(0xFFFFFFFFu - (unsigned)(best & 0xFFFFFFFFull));
      if (s_best % nth == tid) sel[s_best] = 0;  // its owner takes it out
      if (tid == 0) selpos[r] = s_best;
    }
    __syncthreads();

    // ---- the next state and the back-pointers
    for (int j = tid; j < k; j += nth) {
      const int s = selpos[j];
      const unsigned i = sidx[s];
      const int parent = (int)(i / (unsigned)width), r = (int)i - parent * width;
      const bool head = s == 0 || skey[s - 1] != skey[s];
      const int plen = cur.length[parent];
      nxt.length[j] = r == 0 ? plen : min(plen + 1, l_cap);
      nxt.last[j] = r == 0 ? cur.last[parent] : r - 1;
      nxt.h1[j] = (unsigned)(skey[s] >> 32);
      nxt.h2[j] = (unsigned)skey[s];
      const float pb = head ? cpb[i] : ninf, pnb = head ? cpnb[i] : ninf;
      nxt.pb[j] = pb;
      nxt.pnb[j] = pnb;
      nxt.tot[j] = lse32(pb, pnb);
      bp[(size_t)t * k + j] = make_int2((int)i, (r > 0 && l_cap > 0) ? min(plen, l_cap - 1)
                                                                      : -1);
    }
    __syncthreads();
  }

  // ---- the end: rank by a stable argsort of -score, then backtrack
  const BeamState fin = beam_state(ws + lay.state, k, num_t & 1);
  for (int j = tid; j < k; j += nth) {
    const float score = fin.tot[j];
    const float x = -score;
    int rank = 0;
    for (int q = 0; q < k; ++q) {
      const float y = -fin.tot[q];
      rank += before(y, x) || (q < j && !before(x, y));
    }
    const size_t row = (size_t)b * k + rank;
    scores[row] = bad_blank ? CUDART_NAN_F : score;
    lengths[row] = fin.length[j];
    int* out = tokens + row * l_cap;
    for (int l = 0; l < l_cap; ++l) out[l] = -1;
    int beam = j;
    for (int t = num_t - 1; t >= 0; --t) {
      const int2 p = bp[(size_t)t * k + beam];
      const int parent = p.x / width;
      if (p.y >= 0 && out[p.y] < 0) out[p.y] = p.x - parent * width - 1;
      beam = parent;
    }
    for (int l = 0; l < l_cap; ++l) out[l] = out[l] < 0 ? 0 : out[l];
  }
}

template <bool kMerge>
int launch_beam_search(const float* lp, const long long* logit_length,
                       const long long* blank_index, int batch, int num_t, int vocab, int k,
                       int l_cap, int staged, unsigned char* gws, int2* bp, int* tokens,
                       int* lengths, float* scores, cudaStream_t st) {
  const BeamLayout lay = beam_layout(k, vocab);
  const int threads = beam_threads(lay.pad);
  if (staged)
    return launch(beam_search_kernel<kMerge, true>, batch, threads, lay.bytes, st, lp,
                  logit_length, blank_index, num_t, vocab, k, l_cap, gws, bp, tokens,
                  lengths, scores);
  return launch(beam_search_kernel<kMerge, false>, batch, threads, 0, st, lp, logit_length,
                blank_index, num_t, vocab, k, l_cap, gws, bp, tokens, lengths, scores);
}

}  // namespace ctc

extern "C" {

// a row's workspace: shared memory where staged, else a row of gws
size_t ctc_beam_search_smem_bytes(int vocab, int k) {
  return ctc::beam_layout(k, vocab).bytes;
}

// staged: the workspace in shared memory (the wrapper checks that the card
// gives ctc_beam_search_smem_bytes(V, K)), else in gws [B, that many
// bytes]; bp [B, T, K, 2] int32 of scratch; tokens [B, K, Lcap] int32,
// lengths [B, K] int32, scores [B, K]
int ctc_beam_search(const float* lp, const long long* logit_length,
                    const long long* blank_index, int batch, int num_t, int vocab, int k,
                    int l_cap, int merge_repeats, int staged, unsigned char* gws, int* bp,
                    int* tokens, int* lengths, float* scores, void* stream) {
  if (batch == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int2* bp2 = reinterpret_cast<int2*>(bp);
  if (merge_repeats)
    return ctc::launch_beam_search<true>(lp, logit_length, blank_index, batch, num_t, vocab,
                                         k, l_cap, staged, gws, bp2, tokens, lengths,
                                         scores, st);
  return ctc::launch_beam_search<false>(lp, logit_length, blank_index, batch, num_t, vocab,
                                        k, l_cap, staged, gws, bp2, tokens, lengths, scores,
                                        st);
}

}  // extern "C"
