// Prefix beam search (ops/decode.py, the op ctc_port::beam_search): every
// frame of the search, then the backtrack of the beams' tokens, in one
// launch.  Two instantiations by merge_repeats: classic_beam_search
// (repeats collapse) and simplified_beam_search (blank removal alone).  The
// scores' gradient (the op ctc_port::beam_search_grad) is a second kernel,
// beam_search_grad_kernel below: classic_beam_search_grad and
// simplified_beam_search_grad.
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

// A candidate's (pb, pnb) by _pool's formulas, from its parent beam's state
// (pb, pnb, tot = lse(pb, pnb), last, length) and its place r in the
// parent's run of 1 + V candidates: r = 0 the stay, else the extension by
// token r - 1.  Frames past logit_length (!live) are forced-blank stays.
template <bool kMerge>
__device__ __forceinline__ float2 pool_candidate(int r, float pb, float pnb, float tot, int last,
                                                 int length, const float* lp_t, bool live,
                                                 float blank_lp, int blank, int l_cap) {
  const float ninf = -CUDART_INF_F;
  if (r == 0) {
    float c_pnb = ninf;
    if (kMerge) {
      const float last_lp = (last >= 0 && live) ? lp_t[last] : ninf;
      c_pnb = pnb + last_lp;
    }
    return make_float2(tot + blank_lp, c_pnb);
  }
  const int v = r - 1;
  const float tok = live ? lp_t[v] : ninf;
  const float base = (kMerge && v == last) ? pb : tot;
  const bool dead = v == blank || length >= l_cap || !live;
  return make_float2(ninf, dead ? ninf : base + tok);
}

__device__ __forceinline__ bool finite32(float x) { return fabsf(x) < CUDART_INF_F; }

// What the backward keeps of frame t for beam j (beam_search_grad_kernel):
// beam j's state before the frame (its parent side), and the run selected
// into beam j: the head's pool index (-1 for a non-head, which passes no
// gradient on) and the pool index of the run's one other member with a
// finite pb or pnb, or -1.  A run holds at most two such members: live beams
// are distinct prefixes, so only the stay of a prefix and the extension of
// its parent by its last token can meet; the other members are dead
// (-inf), whose share of the merge's gradient is exactly zero.
struct BeamRecord {
  float pb, pnb, tot;
  int last, length, head, other;
};
static_assert(sizeof(BeamRecord) == 7 * 4, "seven words a beam and frame");

// Every frame of a row's search in its workspace ws: the pool, the sort,
// the runs' merge, the top K, the next state.  The forward (kRecord false)
// keeps back-pointers bp [T, K]; the backward (kRecord true) the records
// rec [T, K] instead.  The last state is buffer num_t & 1.
template <bool kMerge, bool kRecord>
__device__ __forceinline__ void beam_frames(const float* __restrict__ lp, long long live_t,
                                            int blank, int blank_at, int num_t, int vocab,
                                            int k, int l_cap, unsigned char* ws,
                                            const BeamLayout& lay, int2* bp,
                                            BeamRecord* rec) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const int width = 1 + vocab, n = lay.n, pad = lay.pad;
  unsigned long long* skey = reinterpret_cast<unsigned long long*>(ws + lay.skey);
  unsigned long long* sel = reinterpret_cast<unsigned long long*>(ws + lay.sel);
  unsigned long long* red = reinterpret_cast<unsigned long long*>(ws + lay.red);
  unsigned* sidx = reinterpret_cast<unsigned*>(ws + lay.sidx);
  float* cpb = reinterpret_cast<float*>(ws + lay.cpb);
  float* cpnb = reinterpret_cast<float*>(ws + lay.cpnb);
  int* selpos = reinterpret_cast<int*>(ws + lay.selpos);
  const float ninf = -CUDART_INF_F;

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
      const float2 c = pool_candidate<kMerge>(r, cur.pb[j], cur.pnb[j], cur.tot[j],
                                              cur.last[j], cur.length[j], lp_t, live,
                                              blank_lp, blank, l_cap);
      if (r > 0) {
        g1 = g1 * kH1Mult + (unsigned)r;
        g2 = g2 * kH2Mult + (unsigned)r;
      }
      cpb[i] = c.x;
      cpnb[i] = c.y;
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
        const float z1 = finite32(m1) ? m1 : 0.0f;
        const float z2 = finite32(m2) ? m2 : 0.0f;
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

    // ---- the next state, and the back-pointers or the records
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
      if (kRecord) {
        // a non-head member's (pb, pnb) is still its candidate's: the merge
        // wrote the heads' alone
        int other = -1;
        for (int q = s + 1; head && q < n && skey[q] == skey[s]; ++q) {
          const unsigned m = sidx[q];
          if (finite32(cpb[m]) || finite32(cpnb[m])) {
            other = (int)m;
            break;
          }
        }
        rec[(size_t)t * k + j] = BeamRecord{cur.pb[j], cur.pnb[j], cur.tot[j], cur.last[j],
                                            cur.length[j], head ? (int)i : -1, other};
      } else {
        bp[(size_t)t * k + j] = make_int2((int)i, (r > 0 && l_cap > 0) ? min(plen, l_cap - 1)
                                                                        : -1);
      }
    }
    __syncthreads();
  }
}

// Beam j's place in a stable argsort of -score over the last state.
__device__ __forceinline__ int beam_rank(const BeamState& fin, int j, int k) {
  const float x = -fin.tot[j];
  int rank = 0;
  for (int q = 0; q < k; ++q) {
    const float y = -fin.tot[q];
    rank += before(y, x) || (q < j && !before(x, y));
  }
  return rank;
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
  const int width = 1 + vocab;
  unsigned char* ws = kStaged ? smem : gws + (size_t)b * lay.bytes;
  const long long bi = *blank_index;
  // a blank outside [0, V) runs as no token, and every score is NaN: the
  // loop raises on it, and the kernel reads nothing back to the host
  const bool bad_blank = bi < 0 || bi >= vocab;
  const int blank = bi < 0 ? -1 : (bi >= vocab ? vocab : (int)bi);
  const int blank_at = blank < 0 ? 0 : (blank >= vocab ? vocab - 1 : blank);
  bp += (size_t)b * num_t * k;
  beam_frames<kMerge, false>(lp + (size_t)b * num_t * vocab, logit_length[b], blank, blank_at,
                             num_t, vocab, k, l_cap, ws, lay, bp, nullptr);

  // ---- the end: rank by a stable argsort of -score, then backtrack
  const BeamState fin = beam_state(ws + lay.state, k, num_t & 1);
  for (int j = tid; j < k; j += nth) {
    const float score = fin.tot[j];
    const size_t row = (size_t)b * k + beam_rank(fin, j, k);
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

// ---------------------------------------------------------------------------
// the scores' gradient (decode.beam_search_grad_plain)
// ---------------------------------------------------------------------------

// Float32 lanes of torch's CPU sum kernel's vectors (decode.SUM_LANES): the
// sums below add in its orders, which autograd takes through the loop on
// the CPU.
constexpr int kSumLanes = 8;

__device__ __forceinline__ int ceil_log2(int n) { return n <= 2 ? 1 : 32 - __clz(n - 1); }

// decode.cascade_sum of f(0), ..., f(count - 1): ATen's multi_row_sum
template <typename F>
__device__ __forceinline__ float cascade_sum(F f, int count) {
  const int power = max(4, ceil_log2(count) / 4);
  const int step = 1 << power, mask = step - 1;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int i = 0;
  while (i + step <= count) {
    for (int q = 0; q < step; ++q, ++i) acc[0] = acc[0] + f(i);
#pragma unroll
    for (int j = 1; j < 4; ++j) {
      acc[j] = acc[j] + acc[j - 1];
      acc[j - 1] = 0.0f;
      if (i & (mask << (j * power))) break;
    }
  }
  for (; i < count; ++i) acc[0] = acc[0] + f(i);
  return ((acc[0] + acc[1]) + acc[2]) + acc[3];
}

// decode.ilp_sum: ATen's row_sum, four partial sums
template <typename F>
__device__ __forceinline__ float ilp_sum(F f, int count) {
  const int whole = count / 4;
  float p[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    p[q] = whole ? cascade_sum([&](int i) { return f(4 * i + q); }, whole) : 0.0f;
  for (int i = 4 * whole; i < count; ++i) p[0] = p[0] + f(i);
  return ((p[0] + p[1]) + p[2]) + p[3];
}

// decode.lane_sum: over a contiguous axis, in vectors of kSumLanes
template <typename F>
__device__ __forceinline__ float lane_sum(F f, int count) {
  if (count < kSumLanes) return ilp_sum(f, count);
  const int vecs = count / kSumLanes;
  float out = 0.0f;
  for (int q = vecs * kSumLanes; q < count; ++q) out = out + f(q);
  for (int l = 0; l < kSumLanes; ++l)
    out = out + ilp_sum([&](int i) { return f(i * kSumLanes + l); }, vecs);
  return out;
}

// decode.beam_sum's column v of vocab over the K beams f(0), ..., f(k - 1)
template <typename F>
__device__ __forceinline__ float beam_sum(F f, int k, int v, int vocab) {
  if (vocab == 1) return lane_sum(f, k);
  const int group = vocab >= kSumLanes ? 4 * kSumLanes : 4;
  return v < vocab / group * group ? cascade_sum(f, k) : ilp_sum(f, k);
}

// decode.logsumexp_grad: the adjoints of lse32(x, y) under g as autograd
// takes them, each argument's from a later use (x_first, y_first) first,
// then the min's share, then the max's
__device__ __forceinline__ float2 lse32_grad(float x, float y, float g, float x_first,
                                             float y_first) {
  const bool special = (x == -CUDART_INF_F && y == -CUDART_INF_F) ||
                       (x == CUDART_INF_F && y == CUDART_INF_F);
  const float g_out = special ? 0.0f : g;
  const bool x_nan = x != x;
  const float mx = (x > y || x_nan) ? x : y;
  const float mn = (x < y || x_nan) ? x : y;
  const float e = expf((special ? 0.0f : mn) - (special ? 0.0f : mx));
  const float g_diff = g_out / (e + 1.0f) * e;
  const float g_mx = (special ? 0.0f : g_out) + (special ? 0.0f : -g_diff);
  const float g_mn = special ? 0.0f : g_diff;
  const bool tie = x == y;
  const float half_mx = tie ? g_mx / 2.0f : g_mx, half_mn = tie ? g_mn / 2.0f : g_mn;
  return make_float2((x_first + (x > y ? 0.0f : half_mn)) + (x < y ? 0.0f : half_mx),
                     (y_first + (x < y ? 0.0f : half_mn)) + (x > y ? 0.0f : half_mx));
}

// The gradient of the scores in the log-probabilities under grad [B, K]:
// the frames again (beam_frames, keeping each frame's records in rec [B, T,
// K]), then the reverse chain of beam_search_grad_plain from the last frame
// down, writing each frame's d_lp [V] once.  The workspace after the
// frames: the stays' pb adjoints by beam in cpb, every candidate's pnb
// adjoint in cpnb, the frame's parent records in the state buffers, the
// beams' (pb, pnb) adjoints in sel (two buffers of 2K floats: state s's at
// s & 1).  A frame:
//
//   merge     each selected head's share of its run's logsumexp to its
//             (at most two) finite members: g / sum * exp(x - max) for pb
//             and for pnb (zero for a run left empty), as csrc and the loop
//             merge them (the max, then the sum in pool-index order);
//   tokens    thread v: the extensions' adjoints summed over the beams
//             (beam_sum), classic the stays' last_lp adjoints scattered in
//             beam order; the blank's the stays' pb adjoints (ilp_sum);
//   parents   thread k: tot's adjoint, the stay's pb adjoint plus the
//             extensions' (lane_sum; classic those of tokens other than
//             the beam's last), then lse32_grad into the parent's (pb, pnb),
//             classic the extension by its last token's adjoint into pb and
//             the stay's pnb adjoint into pnb first.
//
// What bounds it: the forward's chain of T frames again, then T short
// frames of a few barriers.  A blank outside [0, V) gives NaN.
template <bool kMerge, bool kStaged>
__global__ void __launch_bounds__(kBeamThreads)
beam_search_grad_kernel(const float* __restrict__ lp,
                        const long long* __restrict__ logit_length,
                        const long long* __restrict__ blank_index,
                        const float* __restrict__ grad, int num_t, int vocab, int k,
                        int l_cap, unsigned char* gws, BeamRecord* rec, float* d_lp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BeamLayout lay = beam_layout(k, vocab);
  const int b = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const int width = 1 + vocab, n = lay.n;
  unsigned char* ws = kStaged ? smem : gws + (size_t)b * lay.bytes;
  const long long bi = *blank_index;
  const bool bad_blank = bi < 0 || bi >= vocab;
  const int blank = bi < 0 ? -1 : (bi >= vocab ? vocab : (int)bi);
  const int blank_at = blank < 0 ? 0 : (blank >= vocab ? vocab - 1 : blank);
  const long long live_t = logit_length[b];
  lp += (size_t)b * num_t * vocab;
  rec += (size_t)b * num_t * k;
  d_lp += (size_t)b * num_t * vocab;
  beam_frames<kMerge, true>(lp, live_t, blank, blank_at, num_t, vocab, k, l_cap, ws, lay,
                            nullptr, rec);

  float* gcp = reinterpret_cast<float*>(ws + lay.cpb);
  float* gcn = reinterpret_cast<float*>(ws + lay.cpnb);
  float* gbuf = reinterpret_cast<float*>(ws + lay.sel);
  BeamRecord* prow = reinterpret_cast<BeamRecord*>(ws + lay.state);
  // the final scores' adjoints through the stable re-sort, then lse
  {
    const BeamState fin = beam_state(ws + lay.state, k, num_t & 1);
    float* g0 = gbuf + (num_t & 1) * 2 * k;
    for (int j = tid; j < k; j += nth) {
      const float2 g = lse32_grad(fin.pb[j], fin.pnb[j],
                                  0.0f + grad[(size_t)b * k + beam_rank(fin, j, k)], 0.0f, 0.0f);
      g0[j] = g.x;
      g0[k + j] = g.y;
    }
  }
  __syncthreads();

  for (int t = num_t - 1; t >= 0; --t) {
    const float* lp_t = lp + (size_t)t * vocab;
    const bool live = t < live_t;
    const float blank_lp = live ? lp_t[blank_at] : 0.0f;
    const BeamRecord* rec_t = rec + (size_t)t * k;
    const float* g_sel = gbuf + ((t + 1) & 1) * 2 * k;  // the selected beams'
    float* g_par = gbuf + (t & 1) * 2 * k;               // the parents'
    for (int i = tid; i < n; i += nth) gcn[i] = 0.0f;
    for (int j = tid; j < k; j += nth) {
      gcp[j] = 0.0f;
      prow[j] = rec_t[j];
    }
    __syncthreads();

    // ---- merge: the selected heads' adjoints onto their runs' members
    for (int j = tid; j < k; j += nth) {
      const int head = prow[j].head, other = prow[j].other;
      if (head < 0) continue;
      int at[2] = {head, other};
      float2 c[2];
      for (int m = 0; m < 2; ++m) {
        c[m] = make_float2(-CUDART_INF_F, -CUDART_INF_F);
        if (at[m] < 0) continue;
        const int p = at[m] / width;
        const BeamRecord& s = prow[p];
        c[m] = pool_candidate<kMerge>(at[m] - p * width, s.pb, s.pnb, s.tot, s.last, s.length,
                                      lp_t, live, blank_lp, blank, l_cap);
      }
      const float m1 = amax2(amax2(-CUDART_INF_F, c[0].x), c[1].x);
      const float m2 = amax2(amax2(-CUDART_INF_F, c[0].y), c[1].y);
      const float z1 = finite32(m1) ? m1 : 0.0f, z2 = finite32(m2) ? m2 : 0.0f;
      const float e1[2] = {expf(c[0].x - z1), expf(c[1].x - z1)};
      const float e2[2] = {expf(c[0].y - z2), expf(c[1].y - z2)};
      const float sum1 = (0.0f + e1[0]) + e1[1], sum2 = (0.0f + e2[0]) + e2[1];
      const float w1 = sum1 == 0.0f ? 0.0f : g_sel[j] / sum1;
      const float w2 = sum2 == 0.0f ? 0.0f : g_sel[k + j] / sum2;
      for (int m = 0; m < 2; ++m) {
        if (at[m] < 0) continue;
        const int p = at[m] / width;
        if (at[m] == p * width) gcp[p] = w1 * e1[m];
        gcn[at[m]] = w2 * e2[m];
      }
    }
    __syncthreads();

    // ---- the frame's d_lp (items 0..V-1) and the parents' adjoints (V..V+K-1)
    for (int it = tid; it < vocab + k; it += nth) {
      if (it < vocab) {
        const int v = it;
        float acc = beam_sum([&](int q) {
          const bool dead = v == blank || prow[q].length >= l_cap || !live;
          return dead ? 0.0f : gcn[q * width + 1 + v];
        }, k, v, vocab);
        if (kMerge) {
          float scattered = 0.0f;
          for (int q = 0; q < k; ++q) {
            const int last = prow[q].last;
            if (max(last, 0) == v) scattered = scattered + (last >= 0 ? gcn[q * width] : 0.0f);
          }
          acc = acc + scattered;
        }
        float out = live ? acc : 0.0f;
        if (v == blank) {
          const float g_blank = ilp_sum([&](int q) { return gcp[q]; }, k);
          out = out + (0.0f + (live ? g_blank : 0.0f));
        } else {
          out = out + 0.0f;
        }
        d_lp[(size_t)t * vocab + v] = bad_blank ? CUDART_NAN_F : out;
      } else {
        const int q = it - vocab;
        const BeamRecord& s = prow[q];
        const bool row_dead = s.length >= l_cap || !live;
        const float* g_ext = gcn + q * width + 1;
        float tot_adj, pb_first = 0.0f, pnb_first = 0.0f;
        if (kMerge) {
          tot_adj = lane_sum([&](int v) {
            return (v == blank || row_dead || v == s.last) ? 0.0f : g_ext[v];
          }, vocab);
          pb_first = 0.0f + ((s.last >= 0 && s.last != blank && !row_dead) ? g_ext[s.last]
                                                                           : 0.0f);
          pnb_first = gcn[q * width];
        } else {
          tot_adj = lane_sum([&](int v) {
            return (v == blank || row_dead) ? 0.0f : g_ext[v];
          }, vocab);
        }
        const float2 g = lse32_grad(s.pb, s.pnb, gcp[q] + tot_adj, pb_first, pnb_first);
        g_par[q] = g.x;
        g_par[k + q] = g.y;
      }
    }
    __syncthreads();
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

template <bool kMerge>
int launch_beam_search_grad(const float* lp, const long long* logit_length,
                            const long long* blank_index, const float* grad, int batch,
                            int num_t, int vocab, int k, int l_cap, int staged,
                            unsigned char* gws, BeamRecord* rec, float* d_lp, cudaStream_t st) {
  const BeamLayout lay = beam_layout(k, vocab);
  const int threads = beam_threads(lay.pad);
  if (staged)
    return launch(beam_search_grad_kernel<kMerge, true>, batch, threads, lay.bytes, st, lp,
                  logit_length, blank_index, grad, num_t, vocab, k, l_cap, gws, rec, d_lp);
  return launch(beam_search_grad_kernel<kMerge, false>, batch, threads, 0, st, lp,
                logit_length, blank_index, grad, num_t, vocab, k, l_cap, gws, rec, d_lp);
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

// the scores' gradient under grad [B, K]: the forward's workspace (staged
// as ctc_beam_search), rec [B, T, K, 7] int32 of scratch, d_lp [B, T, V]
int ctc_beam_search_grad(const float* lp, const long long* logit_length,
                         const long long* blank_index, const float* grad, int batch,
                         int num_t, int vocab, int k, int l_cap, int merge_repeats, int staged,
                         unsigned char* gws, int* rec, float* d_lp, void* stream) {
  if (batch == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ctc::BeamRecord* r = reinterpret_cast<ctc::BeamRecord*>(rec);
  if (merge_repeats)
    return ctc::launch_beam_search_grad<true>(lp, logit_length, blank_index, grad, batch, num_t,
                                              vocab, k, l_cap, staged, gws, r, d_lp, st);
  return ctc::launch_beam_search_grad<false>(lp, logit_length, blank_index, grad, batch, num_t,
                                             vocab, k, l_cap, staged, gws, r, d_lp, st);
}

}  // extern "C"
