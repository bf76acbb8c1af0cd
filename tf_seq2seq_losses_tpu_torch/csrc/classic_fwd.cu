// Classic CTC alpha scan in block-float probability space (modes "final",
// "resid", "bound" and "resid1").
//
// Replaces tf_seq2seq_losses_tpu/ops/pallas_lattice.py:_classic_fwd_kernel
// (launched by _classic_fwd_call).  Mode "final" emits the last carry, from
// which the host picks the loss (forward-only classic_ctc_loss, and each
// chunk of the chunked training forward); mode "resid" also streams every
// step's mantissas and every window's frames, the residual pack that
// classic_bwd.cu reads (the streamed training forward); mode "bound" also
// writes the carry entering each window, [n_windows, B, L] x (a0, a1, e),
// from which classic_bwd_rf.cu re-expands alpha (the residual-free scheme);
// mode "resid1" (the half-stream scheme, config.half_stream) streams only the
// open mantissas a1 of every step, [B, Tp, L], the frames as mode "resid"
// does, and a0 at each window's first step in that window's frame,
// [B, Tp / K, L] (what mode "resid" stores at sa[:, w K, 0]), from which
// classic_bwd_half.cu rebuilds the window's a0 with the forward's own
// operations: (1 + 1/K) / 2 of mode resid's residual mantissa bytes.
// The time block of the residual-free scheme is one window: the TPU's
// blocks of several windows existed to fill its grid cells.  An optional
// initial carry (null: unit mass at lane 0) lets a chunk of a long time
// axis start where the previous chunk ended.
//
// What bounds it on the H100: the scan is sequential in time, so one
// sample's steps are a chain of dependent shared-memory exchanges and
// barriers; the bytes (the [B, T, L] transition stream in, and in "resid"
// mode the [B, T, 2, L] residual stream out, in "resid1" mode [B, T, L] plus
// 2 / K a cell, in "bound" mode 3 / K floats a cell) would take a few tens
// of microseconds at full HBM rate at the headline, a few hundred at long
// T.  It is latency-bound.  Measured on the parent design (one CTA per
// sample, every per-lane value in shared memory, each window's K rows of
// transitions loaded by a strided loop with nothing overlapped; H100 80GB
// HBM3, 700 W, one long-T chunk of 504 steps at B=256 and 2016 lanes): mode
// final 2.55 ms, of which the staging with the window opens alone took 1.86
// and the scans alone 0.86; at the headline (256 lanes) 0.367, 0.264 and
// 0.153 ms.
//
// Design against that (the one csrc/classic_bwd_rf.cu proved):
// - Staging runs ahead, asynchronously.  Each step's transition row goes to
//   a ring of fwd_ring_rows(K) rows of shared memory, each with its own
//   mbarrier; one thread issues each row as a bulk copy (TMA, evict-first
//   in L2), every row of the ring ahead at the start, then, once every
//   thread has passed the barrier of the step after the one that read a
//   slot (a step reads its neighbour's row at lane l - 1 after its
//   barrier), the row R places later, in time order.  Each window's K blanks
//   come by 4-byte cp.async (they are not 16-byte aligned at every window),
//   a window ahead, into one of two slots.  So the loads fly while earlier
//   steps compute.
// - A thread's lanes (t + j * threads, j < LPT, LPT a template parameter)
//   keep the carry (a0, a1, e), the lane masks and the alignment factor in
//   registers; shared memory holds only what a neighbour reads (the
//   exchange d of the step, double-buffered, whose two buffers also carry
//   the window open's true exponents and frames) and the ring.  That frees
//   shared memory: at 2016 lanes and window 8 two CTAs share an SM, and the
//   batch runs in one wave where the parent needed two.
// - Residual and boundary stores are plain coalesced stores with the
//   streaming hint: this kernel never reads them back.
// Every per-lane operation keeps its order (-fmad=false), so the results
// are the parent's bit for bit, and classic_bwd_rf.cu, which re-runs these
// operations, still gives classic_bwd.cu's acts bit for bit.
//
// The time loop stops at the sample's own logit_length (past it the carry
// is at its forced-blank fixed point (a0, a1) -> (a0 + a1, 0), which the
// host's loss pick reproduces), so no batch sort or whole-cell skip is
// needed.
#include "blockfloat.cuh"
#include "stage.cuh"

namespace ctc {

enum FwdMode { kFinal = 0, kResid = 1, kBound = 2, kResid1 = 3 };

constexpr int kFwdSpareRows = 2;  // ring rows beyond one window
// The ring's least depth: rows staged ahead at small windows, and the depth
// at which the widest label that shared memory holds at any window takes at
// most kFwdMaxLpt lanes a thread (4832 lanes at windows 1 to 8).
constexpr int kFwdMinRing = 10;
constexpr int kFwdMaxLpt = 10;

__host__ __device__ inline int fwd_ring_rows(int k) {
  return k + kFwdSpareRows > kFwdMinRing ? k + kFwdSpareRows : kFwdMinRing;
}

__host__ __device__ inline size_t fwd_smem_bytes(int lpad, int k) {
  // per lane: ring[R], x[2]; blank[2][k]; an mbarrier per ring row
  const int r = fwd_ring_rows(k);
  return sizeof(float) * ((size_t)lpad * (r + 2) + 2 * k) + sizeof(uint64_t) * r;
}

template <int kMode, int LPT>
__global__ void __launch_bounds__(512, LPT <= 4 ? 2 : 1) classic_fwd_kernel(
    const float* __restrict__ blank,  // [B, Tp]
    const float* __restrict__ dcu,    // [B, Tp, L] unmasked expected-token probs
    const float* __restrict__ lm,     // [B, L] label-length mask
    const float* __restrict__ nb,     // [B, L] preceding label is not blank
    const float* __restrict__ rep,    // [B, L] label differs from its predecessor
    const int* __restrict__ lens,     // [B] steps to run, within [0, Tp]
    const float* __restrict__ i0,     // [B, L] initial carry (null: the t=0 one)
    const float* __restrict__ i1,
    const int* __restrict__ ie,
    int tpad, int lpad, int k_win,
    float* __restrict__ sa,           // [B, Tp, 2, L] (resid); a1 [B, Tp, L] (resid1)
    int* __restrict__ saf,            // [B, Tp / K, L] (resid, resid1)
    float* __restrict__ a0w,          // [B, Tp / K, L] a0 opening a window (resid1)
    float* __restrict__ bd0,          // [Tp / K, B, L] carry entering a window (bound)
    float* __restrict__ bd1,
    int* __restrict__ bde,
    float* __restrict__ f0, float* __restrict__ f1, int* __restrict__ fe) {
  extern __shared__ __align__(16) float smem[];
  const int n_ring = fwd_ring_rows(k_win);
  float* ring = smem;                                    // [R, L]
  float* x = ring + (size_t)n_ring * lpad;               // [2, L]
  float* blank_s = x + 2 * lpad;                         // [2, K]
  uint64_t* bars = reinterpret_cast<uint64_t*>(blank_s + 2 * k_win);  // [R]

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int b = blockIdx.x;
  const int batch = gridDim.x;
  const int len = lens[b];
  const int n_win_all = tpad / k_win;
  const int n_win = (len + k_win - 1) / k_win;
  const size_t row = (size_t)b * lpad;
  const float* dcb = dcu + (size_t)b * tpad * lpad;
  const uint32_t row_bytes = (uint32_t)lpad * sizeof(float);

  uint64_t policy = 0;
  auto issue_row = [&](int n) {  // step n's row, into slot n mod R
    const int s = n % n_ring;
    stage_row(ring + (size_t)s * lpad, dcb + (size_t)n * lpad, row_bytes, &bars[s],
              policy);
  };
  auto issue_blank = [&](int w) {
    const int t0 = w * k_win;
    const int kend = min(k_win, len - t0);
    for (int i = tid; i < kend; i += nt) {
      cp_async4(blank_s + (w & 1) * k_win + i, blank + (size_t)b * tpad + t0 + i);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < n_ring; ++s) mbar_init(&bars[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0 && len > 0) {
    policy = evict_first_policy();
    for (int n = 0; n < n_ring && n < len; ++n) issue_row(n);
  }
  if (n_win > 0) issue_blank(0);

  // own lanes: the carry, the lane masks
  float a0[LPT], a1[LPT], lmv[LPT], nbv[LPT], repv[LPT], sarr[LPT];
  int e[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int l = tid + j * nt;
    a0[j] = a1[j] = lmv[j] = nbv[j] = repv[j] = sarr[j] = 0.0f;
    e[j] = 0;
    if (l < lpad) {
      if (i0 != nullptr) {
        a0[j] = i0[row + l];
        a1[j] = i1[row + l];
        e[j] = ie[row + l];
      } else {
        a0[j] = l == 0 ? 1.0f : 0.0f;
      }
      lmv[j] = lm[row + l];
      nbv[j] = nb[row + l];
      repv[j] = rep[row + l];
    }
  }

  int buf = 0;  // the exchange buffer the next step writes
  int n = 0;    // the next step, which is also its row's place in load order
  for (int w = 0; w < n_win; ++w) {
    const int t0 = w * k_win;
    const int kend = min(k_win, len - t0);
    // the window open's exponents go to the buffer the first step writes,
    // its frames to the other, which the second step writes: every thread
    // has read them by the barriers before
    int* et = reinterpret_cast<int*>(x + buf * lpad);
    int* fs = reinterpret_cast<int*>(x + (buf ^ 1) * lpad);
    // open the window: true exponents (subnormal mantissas flushed) ...
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int l = tid + j * nt;
      if (l < lpad) {
        if (kMode == kBound) {
          const size_t o = ((size_t)w * batch + b) * lpad + l;
          __stcs(bd0 + o, a0[j]);
          __stcs(bd1 + o, a1[j]);
          __stcs(bde + o, e[j]);
        }
        a0[j] = flush_subnormal(a0[j]);
        a1[j] = flush_subnormal(a1[j]);
        et[l] = true_exp(a0[j], a1[j], e[j]);
      }
    }
    cp_async_wait_all();
    __syncthreads();  // the exponents, this window's blanks; the last window done
    if (w + 1 < n_win) issue_blank(w + 1);
    // ... frame = max over the source lanes l-K .. l (mass flows upward) ...
    int f[LPT];
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int l = tid + j * nt;
      f[j] = 0;
      if (l < lpad) {
        int m = et[l];
        for (int jj = 1; jj <= k_win && jj <= l; ++jj) m = max(m, et[l - jj]);
        f[j] = m;
        fs[l] = m;
      }
    }
    __syncthreads();
    // ... rescale into the frame, neighbour alignment factor
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int l = tid + j * nt;
      if (l < lpad) {
        const float r = pow2i(e[j] - f[j]);
        a0[j] *= r;
        a1[j] *= r;
        const int f_src = l == 0 ? -kEBig : fs[l - 1];
        sarr[j] = pow2i(f_src - f[j]);
        e[j] = f[j];
        const size_t ow = ((size_t)b * n_win_all + w) * lpad + l;
        if (kMode == kResid || kMode == kResid1) __stcs(saf + ow, f[j]);
        if (kMode == kResid1) __stcs(a0w + ow, a0[j]);
      }
    }
    const float* blank_w = blank_s + (w & 1) * k_win;
    for (int kk = 0; kk < kend; ++kk, ++n) {
      const int t = t0 + kk;
      const int s = n % n_ring;
      mbar_wait(&bars[s], (n / n_ring) & 1);
      const float* dw = ring + (size_t)s * lpad;
      float* dnow = x + buf * lpad;
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int l = tid + j * nt;
        if (l < lpad) {
          if (kMode == kResid) {
            const size_t o = (((size_t)b * tpad + t) * 2) * lpad + l;
            __stcs(sa + o, a0[j]);
            __stcs(sa + o + lpad, a1[j]);
          }
          if (kMode == kResid1) __stcs(sa + ((size_t)b * tpad + t) * lpad + l, a1[j]);
          const float dc = dw[l] * lmv[j];
          const float dov = dc * repv[j];
          dnow[l] = a0[j] * dc + a1[j] * dov;
        }
      }
      __syncthreads();
      // the last step's row is read: its slot takes the row R places later
      if (tid == 0 && n > 0 && n - 1 + n_ring < len) {
        fence_proxy_async();
        issue_row(n - 1 + n_ring);
      }
      const float bl = blank_w[kk];
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int l = tid + j * nt;
        if (l < lpad) {
          const float pt = l == 0 ? 0.0f : dw[l - 1];
          const float pm = pt * nbv[j];
          const float arr = l == 0 ? 0.0f : dnow[l - 1] * sarr[j];
          const float n0 = (a0[j] + a1[j]) * bl;
          a1[j] = a1[j] * pm + arr;
          a0[j] = n0;
        }
      }
      buf ^= 1;
    }
  }
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int l = tid + j * nt;
    if (l < lpad) {
      f0[row + l] = a0[j];
      f1[row + l] = a1[j];
      fe[row + l] = e[j];
      // the windows past the sample's length hold its final carry
      for (int w = n_win; kMode == kBound && w < n_win_all; ++w) {
        const size_t o = ((size_t)w * batch + b) * lpad + l;
        __stcs(bd0 + o, a0[j]);
        __stcs(bd1 + o, a1[j]);
        __stcs(bde + o, e[j]);
      }
    }
  }
}

struct FwdArgs {
  const float *blank, *dcu, *lm, *nb, *rep;
  const int* lens;
  const float *i0, *i1;
  const int* ie;
  int tpad, lpad, k_win;
  float* sa;
  int* saf;
  float *a0w, *bd0, *bd1;
  int* bde;
  float *f0, *f1;
  int* fe;
};

template <int kMode, int LPT>
int launch_fwd(int lpt, int batch, cudaStream_t st, const FwdArgs& a) {
  if constexpr (LPT > kFwdMaxLpt) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (lpt != LPT) return launch_fwd<kMode, LPT + 1>(lpt, batch, st, a);
    const size_t smem = fwd_smem_bytes(a.lpad, a.k_win);
    cudaFuncSetAttribute(classic_fwd_kernel<kMode, LPT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    classic_fwd_kernel<kMode, LPT><<<batch, strided_threads(a.lpad), smem, st>>>(
        a.blank, a.dcu, a.lm, a.nb, a.rep, a.lens, a.i0, a.i1, a.ie, a.tpad, a.lpad,
        a.k_win, a.sa, a.saf, a.a0w, a.bd0, a.bd1, a.bde, a.f0, a.f1, a.fe);
    return (int)cudaGetLastError();
  }
}

}  // namespace ctc

extern "C" {

size_t ctc_classic_fwd_smem_bytes(int lpad, int k_win) {
  return ctc::fwd_smem_bytes(lpad, k_win);
}

// mode: 0 final, 1 resid, 2 bound, 3 resid1; i0, i1, ie null for the t=0
// carry; dcu 16-byte aligned (the wrapper checks)
int ctc_classic_fwd(const float* blank, const float* dcu, const float* lm,
                    const float* nb, const float* rep, const int* lens,
                    const float* i0, const float* i1, const int* ie,
                    int batch, int tpad, int lpad, int k_win, int mode,
                    float* sa, int* saf, float* a0w, float* bd0, float* bd1,
                    int* bde, float* f0, float* f1, int* fe, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ctc::FwdArgs a{blank, dcu, lm, nb, rep, lens, i0, i1, ie, tpad, lpad, k_win,
                       sa, saf, a0w, bd0, bd1, bde, f0, f1, fe};
  const int lpt = ctc::lanes_per_thread(lpad);
  switch (mode) {
    case ctc::kResid1: return ctc::launch_fwd<ctc::kResid1, 1>(lpt, batch, st, a);
    case ctc::kResid: return ctc::launch_fwd<ctc::kResid, 1>(lpt, batch, st, a);
    case ctc::kBound: return ctc::launch_fwd<ctc::kBound, 1>(lpt, batch, st, a);
    default: return ctc::launch_fwd<ctc::kFinal, 1>(lpt, batch, st, a);
  }
}

}  // extern "C"
