// The beta scan that emits the combined, loss-normalised act pc, shared by
// classic_bwd.cu (B3: over streamed alpha residuals) and classic_bwd_half.cu
// (B13: over the half-stream residuals, rebuilding a0 first).
//
// Per step t (descending) and lane l it emits
//   pc[t, l] = pd[l] + ph[l + 1],
//   pd[l] = (a0 dc + a1 do)[l] * beta_open[t + 1, l + 1],
//   ph[l] = a1[l] * pt[l] * beta_open[t + 1, l],
// each scaled by 2^(Fa + Fb - Ebi) (alpha frame, beta frame, per-sample
// normaliser Ebi = floor(-loss / ln2)), so every act is a posterior in
// [0, 2] and needs no exponent of its own.  It also emits the final beta
// carry; the host turns it into the fast loss, the guard's flush signal.
//
// One CTA per sample.  The scan starts at the sample's own logit_length
// (the beta init, one-hot at label_length in both states, is already the
// forced-blank fixed point (b0, b1) -> (b0, b0)) and runs the windows in
// reverse; the frame of a backward window opens over lanes l .. l+K.  Acts
// at t >= logit_length are written as zeros.  The lane roll is a read of
// lane l+1 from a double-buffered exchange: one __syncthreads per step.
// The thread of lane l computes ph[l+1] itself from lane l+1's residual, its
// own transition (pt[l+1] = dcu[l]) and lane l+1's act scale, which is fixed
// for the window, so the act needs no second exchange.
//
// What bounded the parent design on the H100 (one thread a lane, every
// per-lane value in shared memory, each window's K rows of transitions and
// residuals loaded by strided loops before three barriers; H100 80GB HBM3,
// 700 W, the headline: B=256, T=500, 256 lanes, window 8, CUDA events):
// B3 took 0.873 ms, of which the staging with the window opens alone took
// 0.704 and the window opens with the scans alone 0.262; B13 0.711, 0.542
// and 0.316.  The staging was three quarters of each and nothing overlapped
// it (the parts add up to more than the whole).
//
// Design against that (the one classic_bwd_rf.cu and classic_fwd.cu proved):
// - Staging runs ahead, asynchronously.  Each step's rows (the transition
//   row dcu[b, t] and, contiguous, the residual pair sa[b, t]; B13: dcu[b, t]
//   and a1[b, t]) go to a ring of bwd_ring_rows(K) slots of shared memory,
//   each with its own mbarrier.  One thread issues each slot as bulk copies
//   (TMA, evict-first in L2) in the order the scan reads them, which is
//   time descending: every slot of the ring ahead at the start, then, as a
//   step's barrier passes, the row R places later into the slot it read (a
//   step makes all its neighbour reads, dcu[l-1], a1[l+1] and b1[l+1],
//   before its barrier).  Each window's K blanks come by 4-byte cp.async (a
//   window's blank row is not 16-byte aligned at every window), a window
//   ahead, into one of two slots; B13's a0 opening each window goes a
//   window ahead on its own mbarrier.
// - B13 rebuilds at each window open, once the window's rows have landed,
//   its own lanes' a0 with the forward's own a0' = (a0 + a1) * blank into a
//   [K, L] slot, so the staged window is the one B3 stages, bit for bit.
// - A thread's lanes (t + j * threads, j < LPT, LPT a template parameter)
//   keep the beta carry, the lane masks, the alignment factor and the act
//   scales of the lane and of lane l+1 in registers; shared memory holds the
//   ring and the exchange, whose two buffers also carry the window open's
//   true exponents and frames.  Lane l computes lane l+1's act scale itself
//   from its frame and its alpha frame in global memory: no exchange of it.
// - The act scale 2^(fa + fb - ebi) is taken once a window as a double
//   (act_scale): the same bits as scaled_act, two float64 conversions fewer
//   an act (they run at 16 a clock per SM).
// - pc and its zero fill past logit_length are stored with the streaming
//   hint: nothing here reads them back.
// Every per-lane operation keeps its order (-fmad=false), so pc and the
// beta carry are the parent's, the plain version's and classic_bwd_rf.cu's
// bit for bit, and B13's are B3's.
//
// What bounds it now (the same card and shape): B3 0.32 ms (0.64 us a step)
// and B13 0.39, against byte bounds of 0.086 and 0.068.  Taking the steps'
// lane work out leaves B3 0.18 ms of barriers, window opens and staging;
// that work is 0.14 ms, the float64 acts 0.023 of it.  Taking the staging
// out saves 0.09 ms, and two more ring slots save nothing: no step waits
// for its row's bytes, the cost is the issuing thread's fence, arrival and
// two bulk copies a step ahead of its warp's next step, and the polls.
// B13 adds its rebuild (0.034 ms) and the wait for a window's rows at its
// open.  ptxas: up to two lanes a thread in 64 registers without spills
// (two CTAs of 512 threads an SM), up to four in 128; from five some spill
// 4 to 164 bytes.
#pragma once

#include "blockfloat.cuh"
#include "stage.cuh"

namespace ctc {

constexpr int kBwdSpareRows = 2;  // ring slots beyond one window
constexpr int kBwdMinRing = 4;    // slots staged ahead at windows 1 and 2
constexpr int kBwdMaxLpt = 10;    // lanes per thread: the widest label at window 1

__host__ __device__ inline int bwd_ring_rows(int k) {
  return k + kBwdSpareRows > kBwdMinRing ? k + kBwdSpareRows : kBwdMinRing;
}

// Floats a ring slot holds per lane: dcu, a0, a1 (B3); dcu, a1 (B13).
template <bool kHalf>
__host__ __device__ constexpr int bwd_row_parts() {
  return kHalf ? 2 : 3;
}

template <bool kHalf>
__host__ __device__ inline size_t bwd_smem_bytes(int lpad, int k) {
  // per lane: ring[R][parts], x[2]; B13 also a0 opening the window and the
  // window's a0[k]; blank[2][k]; an mbarrier per ring slot (B13: and a0's)
  const int r = bwd_ring_rows(k);
  const size_t per_lane = (size_t)r * bwd_row_parts<kHalf>() + 2 + (kHalf ? k + 1 : 0);
  return sizeof(float) * ((size_t)lpad * per_lane + 2 * k) +
         sizeof(uint64_t) * (size_t)(r + (kHalf ? 1 : 0));
}

template <bool kHalf, int LPT>
__global__ void __launch_bounds__(512, LPT <= 2 ? 2 : 1) classic_bwd_streamed_kernel(
    const float* __restrict__ blank,   // [B, Tp]
    const float* __restrict__ dcu,     // [B, Tp, L]
    const float* __restrict__ lm,      // [B, L]
    const float* __restrict__ nb,      // [B, L]
    const float* __restrict__ rep,     // [B, L]
    const int* __restrict__ lens,      // [B] logit_length, clamped to [0, T]
    const int* __restrict__ lab_len,   // [B] label_length
    const float* __restrict__ ebi,     // [B] act normaliser
    const float* __restrict__ sa,      // [B, Tp, 2, L] alpha mantissas; kHalf: a1 [B, Tp, L]
    const int* __restrict__ saf,       // [B, Tp / K, L] alpha frames
    const float* __restrict__ a0_open, // kHalf: [B, Tp / K, L] a0 opening each window
    int tpad, int lpad, int k_win,
    float* __restrict__ pc,            // [B, Tp, L]
    float* __restrict__ f0, float* __restrict__ f1, int* __restrict__ fe) {
  constexpr int kParts = bwd_row_parts<kHalf>();
  extern __shared__ __align__(16) float smem[];
  const int n_ring = bwd_ring_rows(k_win);
  float* ring = smem;                                  // [R, parts, L]
  float* x = ring + (size_t)n_ring * kParts * lpad;    // [2, L]
  float* a0o = x + 2 * lpad;                           // kHalf: [L]
  float* a0s = a0o + (kHalf ? lpad : 0);               // kHalf: [K, L]
  float* blank_s = a0s + (kHalf ? (size_t)k_win * lpad : 0);          // [2, K]
  uint64_t* bars = reinterpret_cast<uint64_t*>(blank_s + 2 * k_win);  // [R (+ 1)]
  uint64_t* a0_bar = bars + n_ring;

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int b = blockIdx.x;
  const int len = lens[b];
  const int ll = lab_len[b];
  const float ebv = ebi[b];
  const int n_win_all = tpad / k_win;
  const int n_win = (len + k_win - 1) / k_win;
  const size_t row = (size_t)b * lpad;
  const uint32_t row_bytes = (uint32_t)lpad * sizeof(float);
  const float* dcb = dcu + (size_t)b * tpad * lpad;
  const float* sab = sa + (size_t)b * tpad * (kParts - 1) * lpad;

  uint64_t policy = 0;
  // the n-th slot in load order holds step len - 1 - n
  auto issue_row = [&](int n) {
    const int s = n % n_ring;
    const size_t t = (size_t)(len - 1 - n);
    float* dst = ring + (size_t)s * kParts * lpad;
    mbar_expect_tx(&bars[s], kParts * row_bytes);
    bulk_load(dst, dcb + t * lpad, row_bytes, &bars[s], policy);
    bulk_load(dst + lpad, sab + t * (kParts - 1) * lpad, (kParts - 1) * row_bytes,
              &bars[s], policy);
  };
  auto issue_a0 = [&](int w) {
    stage_row(a0o, a0_open + ((size_t)b * n_win_all + w) * lpad, row_bytes, a0_bar,
              policy);
  };
  auto issue_blank = [&](int w, int slot) {
    const int t0 = w * k_win;
    const int kend = min(k_win, len - t0);
    for (int i = tid; i < kend; i += nt) {
      cp_async4(blank_s + slot * k_win + i, blank + (size_t)b * tpad + t0 + i);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < n_ring + (kHalf ? 1 : 0); ++s) mbar_init(&bars[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0 && len > 0) {
    policy = evict_first_policy();
    if (kHalf) issue_a0(n_win - 1);
    for (int n = 0; n < n_ring && n < len; ++n) issue_row(n);
  }
  if (n_win > 0) issue_blank(n_win - 1, 0);

  // own lanes: beta carry, lane masks
  float b0[LPT], b1[LPT], lmv[LPT], nbv[LPT], repv[LPT];
  int eb[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int l = tid + j * nt;
    b0[j] = b1[j] = lmv[j] = nbv[j] = repv[j] = 0.0f;
    eb[j] = 0;
    if (l < lpad) {
      const float hot = l == ll ? 1.0f : 0.0f;
      b0[j] = hot;
      b1[j] = hot;
      lmv[j] = lm[row + l];
      nbv[j] = nb[row + l];
      repv[j] = rep[row + l];
    }
  }
  // acts past logit_length are zero
  for (size_t i = (size_t)len * lpad + tid; i < (size_t)tpad * lpad; i += nt) {
    __stcs(pc + (size_t)b * tpad * lpad + i, 0.0f);
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
        b0[j] = flush_subnormal(b0[j]);
        b1[j] = flush_subnormal(b1[j]);
        et[l] = true_exp(b0[j], b1[j], eb[j]);
      }
    }
    cp_async_wait_all();
    __syncthreads();  // the exponents, this window's blanks
    if (wi + 1 < n_win) issue_blank(w - 1, (wi + 1) & 1);
    if (kHalf) {
      // rebuild a0 across the window from its first step's value, in time
      // order, once the window's a1 rows have landed
      mbar_wait(a0_bar, wi & 1);
      for (int kk = 0; kk < kend; ++kk) {
        const int m = n + kend - 1 - kk;
        mbar_wait(&bars[m % n_ring], (m / n_ring) & 1);
      }
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int l = tid + j * nt;
        if (l < lpad) {
          float a0 = a0o[l];
          for (int kk = 0; kk < kend; ++kk) {
            const int m = n + kend - 1 - kk;
            const float a1 = ring[((size_t)(m % n_ring) * kParts + 1) * lpad + l];
            a0s[(size_t)kk * lpad + l] = a0;
            a0 = (a0 + a1) * blank_w[kk];
          }
        }
      }
    }
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
    __syncthreads();
    if (kHalf && tid == 0 && wi + 1 < n_win) {
      fence_proxy_async();
      issue_a0(w - 1);
    }
    // ... rescale into the frame; the alignment factor, the act scales of
    // the lane and of lane l+1, and b1 for the first step's exchange
    float sarr[LPT];
    double sc[LPT], scn[LPT];
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int l = tid + j * nt;
      sarr[j] = 0.0f;
      sc[j] = scn[j] = 0.0;
      if (l < lpad) {
        const float r = pow2i(eb[j] - f[j]);
        b0[j] *= r;
        b1[j] *= r;
        const bool edge = l + 1 >= lpad;
        const int f_src = edge ? -kEBig : fs[l + 1];
        sarr[j] = pow2i(f_src - f[j]);
        eb[j] = f[j];
        const size_t ow = ((size_t)b * n_win_all + w) * lpad + l;
        float shi, slo;
        act_factor(saf[ow], f[j], ebv, &shi, &slo);
        sc[j] = act_scale(shi, slo);
        if (!edge) {
          act_factor(saf[ow + 1], f_src, ebv, &shi, &slo);
          scn[j] = act_scale(shi, slo);
        }
        x[l] = b1[j];
      }
    }
    __syncthreads();
    for (int kk = kend - 1; kk >= 0; --kk, ++n) {
      const int s = n % n_ring;
      // B13 waited for the window's rows at its open
      if (!kHalf) mbar_wait(&bars[s], (n / n_ring) & 1);
      const float* dw = ring + (size_t)s * kParts * lpad;
      const float* a0w = kHalf ? a0s + (size_t)kk * lpad : dw + lpad;
      const float* a1w = dw + (size_t)(kParts - 1) * lpad;
      const float bl = blank_w[kk];
      const int cur = (kend - 1 - kk) & 1;
      const float* b1now = x + cur * lpad;
      float* b1next = x + (cur ^ 1) * lpad;
      float* pct = pc + ((size_t)b * tpad + t0 + kk) * lpad;
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int l = tid + j * nt;
        if (l < lpad) {
          const bool edge = l + 1 >= lpad;
          const float b1n = edge ? 0.0f : b1now[l + 1];
          const float arr = b1n * sarr[j];
          const float dc = dw[l] * lmv[j];
          const float dov = dc * repv[j];
          const float pt = l == 0 ? 0.0f : dw[l - 1];
          const float pm = pt * nbv[j];
          const float d = a0w[l] * dc + a1w[l] * dov;
          const float pd = scaled_act_by(d, arr, sc[j]);
          const float ph_n =
              edge ? 0.0f : scaled_act_by(a1w[l + 1], dw[l], b1n, scn[j]);
          __stcs(pct + l, pd + ph_n);
          const float hc = bl * b0[j];
          b0[j] = hc + dc * arr;
          b1[j] = hc + pm * b1[j] + dov * arr;
          b1next[l] = b1[j];
        }
      }
      __syncthreads();
      // slot s is read: it takes the row R places later
      if (tid == 0 && n + n_ring < len) {
        fence_proxy_async();
        issue_row(n + n_ring);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int l = tid + j * nt;
    if (l < lpad) {
      f0[row + l] = b0[j];
      f1[row + l] = b1[j];
      fe[row + l] = eb[j];
    }
  }
}

struct BwdArgs {
  const float *blank, *dcu, *lm, *nb, *rep;
  const int *lens, *lab_len;
  const float* ebi;
  const float* sa;
  const int* saf;
  const float* a0_open;
  int tpad, lpad, k_win;
  float *pc, *f0, *f1;
  int* fe;
};

template <bool kHalf, int LPT>
int launch_bwd(int lpt, int batch, cudaStream_t st, const BwdArgs& a) {
  if constexpr (LPT > kBwdMaxLpt) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (lpt != LPT) return launch_bwd<kHalf, LPT + 1>(lpt, batch, st, a);
    const size_t smem = bwd_smem_bytes<kHalf>(a.lpad, a.k_win);
    cudaFuncSetAttribute(classic_bwd_streamed_kernel<kHalf, LPT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    classic_bwd_streamed_kernel<kHalf, LPT>
        <<<batch, strided_threads(a.lpad), smem, st>>>(
        a.blank, a.dcu, a.lm, a.nb, a.rep, a.lens, a.lab_len, a.ebi, a.sa, a.saf,
        a.a0_open, a.tpad, a.lpad, a.k_win, a.pc, a.f0, a.f1, a.fe);
    return (int)cudaGetLastError();
  }
}

}  // namespace ctc
