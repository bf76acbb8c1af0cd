// Simplified CTC beta scan over streamed alpha residuals (kernel B7),
// emitting the loss-normalised act pd.
//
// Replaces the inner kernel of tf_seq2seq_losses_tpu/ops/pallas_lattice.py:
// _simplified_bwd_call_streamed.  Per step t (descending) and lane l:
//   arr[l] = b[l + 1] * s_arr[l],
//   pd[t, l] = (a[t, l] * dg[t, l]) * arr[l] * s_hi[l] * s_lo[l],
//   b'[l] = blank * b[l] + dg[t, l] * arr[l],
// where a is the forward's residual mantissa and s_hi * s_lo = 2^(Fa + Fb -
// Ebi) (alpha frame, beta frame, per-sample normaliser Ebi = floor(-loss /
// ln2)), so every act is a posterior in [0, 1] and needs no exponent of its
// own.  The simplified act is pd alone: a non-blank token is emitted only
// by a diagonal step, so there is no horizontal term and no second lane
// exchange.  It also emits the final beta carry; the host turns it into the
// fast loss, the guard's flush signal.
//
// One CTA per sample.  The scan starts at the sample's own logit_length
// (the beta init, one-hot at label_length, is a fixed point of the
// forced-blank step) and runs the windows in reverse; the frame of a
// backward window opens over lanes l .. l+K.  Acts at t >= logit_length are
// written as zeros.  The lane roll is a read of lane l+1 from a
// double-buffered exchange: one barrier of the lane threads per step.
//
// What bounded the parent design on the H100 (one thread a lane, every
// per-lane value in shared memory, each window's K rows of dg and sa loaded
// by strided loops behind window opens with four barriers; H100 80GB HBM3,
// 700 W, the headline: B=256, T=500, 256 lanes, window 8, CUDA events):
// 0.458 ms against a byte bound of 0.065, of which the staging with the
// window opens alone took 0.338 and the window opens with the scans alone
// 0.190: the staging was 58% of it and nothing overlapped it.
//
// Design against that (classic_bwd.cuh's, with one state and one act, and
// a producer warp):
// - Staging runs ahead, asynchronously, off the step chain.  Each step's
//   rows dg[b, t] and sa[b, t] go to a ring of sbwd_ring_rows(K) slots of
//   shared memory, each with a "full" mbarrier the bulk copies complete on
//   and an "empty" one the lanes release it on.  One thread of an extra,
//   last warp, which takes no part in the steps' barriers, issues each slot
//   as two bulk copies (TMA, evict-first in L2) in the order the scan reads
//   them, time descending: the first R rows at once, then each row R places
//   later as soon as the slot's step has released it.  A step reads only
//   its own lanes of its slot (its one neighbour read, b[l+1], is of the
//   exchange), so thread 0 releases the slot just after the step's barrier.
//   Each window's K blanks come by 4-byte cp.async (a window's blank row is
//   not 16-byte aligned at every window), a window ahead, into one of two
//   slots.
// - A thread's lanes (t + j * threads, j < LPT, LPT a template parameter)
//   keep the beta carry, its exponent, the alignment factor and the act
//   scale in registers; shared memory holds the ring and the exchange,
//   whose two buffers also carry the window open's true exponents and
//   frames.
// - The act scale 2^(fa + fb - ebi) is taken once a window as a double
//   (act_scale): the same bits as scaled_act, two float64 conversions fewer
//   an act.
// - pd and its zero fill past logit_length are stored with the streaming
//   hint: nothing here reads them back.
// Every per-lane operation keeps its order (-fmad=false), so pd and the
// beta carry are the parent's, the plain version's and simplified_bwd_rf.cu's
// bit for bit.
//
// What bounds it now (the same card and shape): 0.23 to 0.24 ms.  Taking
// the steps' lane work out leaves 0.165, taking the staging out 0.194: the
// rest is the step chain of 500 barriers and window opens, as in B6
// (0.18 to 0.21 ms).  With the issuing thread among the lane threads, as in
// classic_bwd.cuh, the kernel took 0.27 ms; loading the alpha frames a
// window ahead, or taking the act after the barrier, saved nothing.  ptxas:
// up to eight lanes a thread without spills; 9 to 12 spill up to 168 bytes.
#include "blockfloat.cuh"
#include "stage.cuh"

namespace ctc {

constexpr int kSBwdSpareRows = 2;  // ring slots beyond one window
constexpr int kSBwdMinRing = 4;    // slots staged ahead at windows 1 and 2
constexpr int kSBwdMaxLpt = 12;    // lanes per thread: the widest label at window 1

__host__ __device__ inline int sbwd_ring_rows(int k) {
  return k + kSBwdSpareRows > kSBwdMinRing ? k + kSBwdSpareRows : kSBwdMinRing;
}

__host__ __device__ inline size_t sbwd_smem_bytes(int lpad, int k) {
  // per lane: ring[R][dg, sa], x[2]; blank[2][k]; two mbarriers per ring
  // slot (full, empty)
  const int r = sbwd_ring_rows(k);
  return sizeof(float) * ((size_t)lpad * (2 * r + 2) + 2 * k) +
         sizeof(uint64_t) * (size_t)(2 * r);
}

template <int LPT>
__global__ void __launch_bounds__(512 + 32, LPT <= 2 ? 2 : 1) simplified_bwd_streamed_kernel(
    const float* __restrict__ blank,   // [B, Tp]
    const float* __restrict__ dg,      // [B, Tp, L]
    const int* __restrict__ lens,      // [B] logit_length, clamped to [0, T]
    const int* __restrict__ lab_len,   // [B] label_length
    const float* __restrict__ ebi,     // [B] act normaliser
    const float* __restrict__ sa,      // [B, Tp, L] alpha mantissas
    const int* __restrict__ saf,       // [B, Tp / K, L] alpha frames
    int tpad, int lpad, int k_win,
    float* __restrict__ pd,            // [B, Tp, L]
    float* __restrict__ fo, int* __restrict__ fe) {
  extern __shared__ __align__(16) float smem[];
  const int n_ring = sbwd_ring_rows(k_win);
  float* ring = smem;                                  // [R, 2, L]
  float* x = ring + (size_t)n_ring * 2 * lpad;         // [2, L]
  float* blank_s = x + 2 * lpad;                       // [2, K]
  uint64_t* bars = reinterpret_cast<uint64_t*>(blank_s + 2 * k_win);  // [R] full
  uint64_t* empty = bars + n_ring;                                    // [R]

  const int tid = threadIdx.x;
  const int nt = blockDim.x - 32;  // lane threads; the last warp stages
  const int b = blockIdx.x;
  const int len = lens[b];
  const int ll = lab_len[b];
  const float ebv = ebi[b];
  const int n_win_all = tpad / k_win;
  const int n_win = (len + k_win - 1) / k_win;
  const size_t row = (size_t)b * lpad;
  const uint32_t row_bytes = (uint32_t)lpad * sizeof(float);
  const float* dgb = dg + (size_t)b * tpad * lpad;
  const float* sab = sa + (size_t)b * tpad * lpad;

  uint64_t policy = 0;
  // the n-th slot in load order holds step len - 1 - n
  auto issue_row = [&](int n) {
    const int s = n % n_ring;
    const size_t t = (size_t)(len - 1 - n);
    float* dst = ring + (size_t)s * 2 * lpad;
    mbar_expect_tx(&bars[s], 2 * row_bytes);
    bulk_load(dst, dgb + t * lpad, row_bytes, &bars[s], policy);
    bulk_load(dst + lpad, sab + t * lpad, row_bytes, &bars[s], policy);
  };
  auto issue_blank = [&](int w, int slot) {
    const int t0 = w * k_win;
    const int kend = min(k_win, len - t0);
    for (int i = tid; i < kend; i += nt) {
      cp_async4(blank_s + slot * k_win + i, blank + (size_t)b * tpad + t0 + i);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < 2 * n_ring; ++s) mbar_init(&bars[s], 1);
    mbar_fence_init();
  }
  __syncthreads();  // the last barrier of the whole CTA
  if (tid >= nt) {
    // the producer: row n into slot n mod R once step n - R released it
    if (tid == nt && len > 0) {
      policy = evict_first_policy();
      for (int n = 0; n < len; ++n) {
        if (n >= n_ring) {
          mbar_wait(&empty[n % n_ring], (n / n_ring - 1) & 1);
          fence_proxy_async();
        }
        issue_row(n);
      }
    }
    return;
  }
  if (n_win > 0) issue_blank(n_win - 1, 0);

  // own lanes: the beta carry and its exponent
  float bv[LPT];
  int es[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int l = tid + j * nt;
    bv[j] = l < lpad && l == ll ? 1.0f : 0.0f;
    es[j] = 0;
  }
  // acts past logit_length are zero
  for (size_t i = (size_t)len * lpad + tid; i < (size_t)tpad * lpad; i += nt) {
    __stcs(pd + (size_t)b * tpad * lpad + i, 0.0f);
  }

  int n = 0;  // the next step's place in load order
  for (int wi = 0; wi < n_win; ++wi) {
    const int w = n_win - 1 - wi;
    const int t0 = w * k_win;
    const int kend = min(k_win, len - t0);
    const float* blank_w = blank_s + (wi & 1) * k_win;
    // the window open's exponents and frames go to the two exchange
    // buffers: every step of the last window read them before its barrier
    int* et = reinterpret_cast<int*>(x);
    int* fs = reinterpret_cast<int*>(x + lpad);
    // open the window: true exponents (subnormal mantissas flushed) ...
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int l = tid + j * nt;
      if (l < lpad) {
        bv[j] = flush_subnormal(bv[j]);
        et[l] = true_exp(bv[j], es[j]);
      }
    }
    cp_async_wait_all();
    consumer_sync(nt);  // the exponents, this window's blanks
    if (wi + 1 < n_win) issue_blank(w - 1, (wi + 1) & 1);
    // ... frame = max over the source lanes l .. l+K (mass flows downward) ...
    int f[LPT];
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int l = tid + j * nt;
      f[j] = 0;
      if (l < lpad) {
        int m = et[l];
        for (int jj = 1; jj <= k_win && l + jj < lpad; ++jj) m = max(m, et[l + jj]);
        f[j] = m;
        fs[l] = m;
      }
    }
    consumer_sync(nt);
    // ... rescale into the frame; the alignment factor, the act scale, and
    // b for the first step's exchange
    float sarr[LPT];
    double sc[LPT];
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int l = tid + j * nt;
      sarr[j] = 0.0f;
      sc[j] = 0.0;
      if (l < lpad) {
        bv[j] *= pow2i(es[j] - f[j]);
        const int f_src = l + 1 >= lpad ? -kEBig : fs[l + 1];
        sarr[j] = pow2i(f_src - f[j]);
        es[j] = f[j];
        float shi, slo;
        act_factor(saf[((size_t)b * n_win_all + w) * lpad + l], f[j], ebv, &shi, &slo);
        sc[j] = act_scale(shi, slo);
        x[l] = bv[j];
      }
    }
    consumer_sync(nt);
    for (int kk = kend - 1; kk >= 0; --kk, ++n) {
      const int s = n % n_ring;
      mbar_wait(&bars[s], (n / n_ring) & 1);
      const float* dw = ring + (size_t)s * 2 * lpad;
      const float* aw = dw + lpad;
      const float bl = blank_w[kk];
      const int cur = (kend - 1 - kk) & 1;
      const float* bnow = x + cur * lpad;
      float* bnext = x + (cur ^ 1) * lpad;
      float* pdt = pd + ((size_t)b * tpad + t0 + kk) * lpad;
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int l = tid + j * nt;
        if (l < lpad) {
          const float bn = l + 1 >= lpad ? 0.0f : bnow[l + 1];
          const float arr = bn * sarr[j];
          const float d = dw[l];
          __stcs(pdt + l, scaled_act_by(aw[l], d, arr, sc[j]));
          bv[j] = bl * bv[j] + d * arr;
          bnext[l] = bv[j];
        }
      }
      consumer_sync(nt);
      // slot s is read: it takes the row R places later
      if (tid == 0 && n + n_ring < len) mbar_arrive(&empty[s]);
    }
  }
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int l = tid + j * nt;
    if (l < lpad) {
      fo[row + l] = bv[j];
      fe[row + l] = es[j];
    }
  }
}

struct SBwdArgs {
  const float *blank, *dg;
  const int *lens, *lab_len;
  const float *ebi, *sa;
  const int* saf;
  int tpad, lpad, k_win;
  float *pd, *fo;
  int* fe;
};

template <int LPT>
int launch_sbwd(int lpt, int batch, cudaStream_t st, const SBwdArgs& a) {
  if constexpr (LPT > kSBwdMaxLpt) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (lpt != LPT) return launch_sbwd<LPT + 1>(lpt, batch, st, a);
    const size_t smem = sbwd_smem_bytes(a.lpad, a.k_win);
    cudaFuncSetAttribute(simplified_bwd_streamed_kernel<LPT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    simplified_bwd_streamed_kernel<LPT><<<batch, strided_threads(a.lpad) + 32, smem, st>>>(
        a.blank, a.dg, a.lens, a.lab_len, a.ebi, a.sa, a.saf, a.tpad, a.lpad, a.k_win,
        a.pd, a.fo, a.fe);
    return (int)cudaGetLastError();
  }
}

}  // namespace ctc

extern "C" {

size_t ctc_simplified_bwd_smem_bytes(int lpad, int k_win) {
  return ctc::sbwd_smem_bytes(lpad, k_win);
}

// dg and sa 16-byte aligned (the wrapper checks)
int ctc_simplified_bwd_streamed(const float* blank, const float* dg,
                                const int* lens, const int* lab_len,
                                const float* ebi, const float* sa,
                                const int* saf, int batch, int tpad, int lpad,
                                int k_win, float* pd, float* fo, int* fe,
                                void* stream) {
  const ctc::SBwdArgs a{blank, dg, lens, lab_len, ebi, sa, saf, tpad, lpad, k_win,
                        pd, fo, fe};
  return ctc::launch_sbwd<1>(ctc::lanes_per_thread(lpad), batch,
                             static_cast<cudaStream_t>(stream), a);
}

}  // extern "C"
