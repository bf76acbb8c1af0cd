// Simplified CTC alpha scan in block-float probability space (modes "final",
// "resid" and "bound").
//
// Replaces tf_seq2seq_losses_tpu/ops/pallas_lattice.py:_simplified_fwd_kernel
// (launched by _simplified_fwd_call), modes "final", "resid" and "bound".
// The carry is one mantissa per lane (no closed/open state): per step
//   a'[l] = a[l] * blank + (a * dg)[l - 1] * s_arr[l],
// with the frame of each window opened over the source lanes l-K .. l.
// Mode "final" emits the last carry, from which the host picks the loss
// (forward-only simplified_ctc_loss, and each chunk of the chunked training
// forward); mode "resid" also streams every step's mantissas and every
// window's frames, the residual pack that simplified_bwd.cu reads (the
// streamed training forward); mode "bound" also writes the carry entering
// each window, [n_windows, B, L] x (a, e), from which simplified_bwd_rf.cu
// re-expands alpha (the residual-free scheme).  An optional initial carry
// (null: unit mass at lane 0) lets a chunk start where the previous one
// ended.
//
// What bounds it on the H100: the scan is sequential in time, so one
// sample's steps are a chain of dependent shared-memory exchanges and
// barriers; its bytes (the [B, T, L] transition stream in and, in "resid"
// mode, the [B, T, L] residual stream out) would take a few tens of
// microseconds at full HBM rate at the headline.  It is latency-bound.
// Measured on the parent design (classic_fwd.cu's parent with one state:
// every per-lane value in shared memory, each window's rows loaded by a
// strided loop with nothing overlapped; H100 80GB HBM3, 700 W, one long-T
// chunk of 504 steps at B=256 and 2016 lanes): mode final 2.24 ms, of which
// the staging with the window opens alone took 1.85 and the scans alone
// 0.63; at the headline 0.327, 0.260 and 0.124 ms.
//
// Design against that: classic_fwd.cu's with one state.  Each step's row is
// staged by a bulk copy into a ring on mbarriers, issued ahead by one
// thread in time order (a step reads only its own lanes of its row, so the
// slot is free once every thread has passed that step's barrier), the
// window's blanks by 4-byte cp.async a window ahead; a thread's lanes keep
// the carry (a, e) and the alignment factor in registers, shared memory
// only the exchange (a * dg, double-buffered; the window open's exponents
// and frames in its two buffers) and the ring; residual and boundary
// stores carry the streaming hint.  Every per-lane operation keeps its
// order, so the results are the parent's bit for bit.
//
// The time loop stops at the sample's own logit_length (past it the
// forced-blank step a' = a * 1 + (a * 0)[l - 1] is the identity).
#include "blockfloat.cuh"
#include "stage.cuh"

namespace ctc {

enum SFwdMode { kSFinal = 0, kSResid = 1, kSBound = 2 };

constexpr int kSFwdSpareRows = 2;  // ring rows beyond one window
// The ring's least depth: rows staged ahead at small windows, and the
// deepest that still holds the 7264 lanes of the parent at window 1 (8288
// lanes there, 17 a thread).
constexpr int kSFwdMinRing = 5;
constexpr int kSFwdMaxLpt = 17;

__host__ __device__ inline int sfwd_ring_rows(int k) {
  return k + kSFwdSpareRows > kSFwdMinRing ? k + kSFwdSpareRows : kSFwdMinRing;
}

__host__ __device__ inline size_t sfwd_smem_bytes(int lpad, int k) {
  // per lane: ring[R], x[2]; blank[2][k]; an mbarrier per ring row
  const int r = sfwd_ring_rows(k);
  return sizeof(float) * ((size_t)lpad * (r + 2) + 2 * k) + sizeof(uint64_t) * r;
}

template <int kMode, int LPT>
__global__ void __launch_bounds__(512, LPT <= 4 ? 2 : 1) simplified_fwd_kernel(
    const float* __restrict__ blank,  // [B, Tp]
    const float* __restrict__ dg,     // [B, Tp, L] p[label[l]], 0 past label_length
    const int* __restrict__ lens,     // [B] steps to run, within [0, Tp]
    const float* __restrict__ ia,     // [B, L] initial carry (null: the t=0 one)
    const int* __restrict__ ie,
    int tpad, int lpad, int k_win,
    float* __restrict__ sa,           // [B, Tp, L] (resid)
    int* __restrict__ saf,            // [B, Tp / K, L] (resid)
    float* __restrict__ bd,           // [Tp / K, B, L] carry entering a window (bound)
    int* __restrict__ bde,
    float* __restrict__ fo, int* __restrict__ fe) {
  extern __shared__ __align__(16) float smem[];
  const int n_ring = sfwd_ring_rows(k_win);
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
  const float* dgb = dg + (size_t)b * tpad * lpad;
  const uint32_t row_bytes = (uint32_t)lpad * sizeof(float);

  uint64_t policy = 0;
  auto issue_row = [&](int n) {  // step n's row, into slot n mod R
    const int s = n % n_ring;
    stage_row(ring + (size_t)s * lpad, dgb + (size_t)n * lpad, row_bytes, &bars[s],
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

  // own lanes: the carry
  float av[LPT], sarr[LPT];
  int es[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int l = tid + j * nt;
    av[j] = sarr[j] = 0.0f;
    es[j] = 0;
    if (l < lpad) {
      if (ia != nullptr) {
        av[j] = ia[row + l];
        es[j] = ie[row + l];
      } else {
        av[j] = l == 0 ? 1.0f : 0.0f;
      }
    }
  }

  int buf = 0;  // the exchange buffer the next step writes
  int n = 0;    // the next step, which is also its row's place in load order
  for (int w = 0; w < n_win; ++w) {
    const int t0 = w * k_win;
    const int kend = min(k_win, len - t0);
    // the window open's exponents and frames go to the exchange buffers
    // (see classic_fwd.cu)
    int* et = reinterpret_cast<int*>(x + buf * lpad);
    int* fs = reinterpret_cast<int*>(x + (buf ^ 1) * lpad);
    // open the window: true exponents (subnormal mantissas flushed) ...
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int l = tid + j * nt;
      if (l < lpad) {
        if (kMode == kSBound) {
          const size_t o = ((size_t)w * batch + b) * lpad + l;
          __stcs(bd + o, av[j]);
          __stcs(bde + o, es[j]);
        }
        av[j] = flush_subnormal(av[j]);
        et[l] = true_exp(av[j], es[j]);
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
        av[j] *= pow2i(es[j] - f[j]);
        const int f_src = l == 0 ? -kEBig : fs[l - 1];
        sarr[j] = pow2i(f_src - f[j]);
        es[j] = f[j];
        if (kMode == kSResid) __stcs(saf + ((size_t)b * n_win_all + w) * lpad + l, f[j]);
      }
    }
    const float* blank_w = blank_s + (w & 1) * k_win;
    for (int kk = 0; kk < kend; ++kk, ++n) {
      const int s = n % n_ring;
      mbar_wait(&bars[s], (n / n_ring) & 1);
      const float* dw = ring + (size_t)s * lpad;
      float* dnow = x + buf * lpad;
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int l = tid + j * nt;
        if (l < lpad) {
          if (kMode == kSResid) __stcs(sa + ((size_t)b * tpad + t0 + kk) * lpad + l, av[j]);
          dnow[l] = av[j] * dw[l];
        }
      }
      __syncthreads();
      // this step's row is read: its slot takes the row R places later
      if (tid == 0 && n + n_ring < len) {
        fence_proxy_async();
        issue_row(n + n_ring);
      }
      const float bl = blank_w[kk];
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int l = tid + j * nt;
        if (l < lpad) {
          const float arr = l == 0 ? 0.0f : dnow[l - 1] * sarr[j];
          av[j] = av[j] * bl + arr;
        }
      }
      buf ^= 1;
    }
  }
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int l = tid + j * nt;
    if (l < lpad) {
      fo[row + l] = av[j];
      fe[row + l] = es[j];
      // the windows past the sample's length hold its final carry
      for (int w = n_win; kMode == kSBound && w < n_win_all; ++w) {
        const size_t o = ((size_t)w * batch + b) * lpad + l;
        __stcs(bd + o, av[j]);
        __stcs(bde + o, es[j]);
      }
    }
  }
}

struct SFwdArgs {
  const float *blank, *dg;
  const int* lens;
  const float* ia;
  const int* ie;
  int tpad, lpad, k_win;
  float* sa;
  int* saf;
  float* bd;
  int* bde;
  float* fo;
  int* fe;
};

template <int kMode, int LPT>
int launch_sfwd(int lpt, int batch, cudaStream_t st, const SFwdArgs& a) {
  if constexpr (LPT > kSFwdMaxLpt) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (lpt != LPT) return launch_sfwd<kMode, LPT + 1>(lpt, batch, st, a);
    const size_t smem = sfwd_smem_bytes(a.lpad, a.k_win);
    cudaFuncSetAttribute(simplified_fwd_kernel<kMode, LPT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    simplified_fwd_kernel<kMode, LPT><<<batch, strided_threads(a.lpad), smem, st>>>(
        a.blank, a.dg, a.lens, a.ia, a.ie, a.tpad, a.lpad, a.k_win, a.sa, a.saf, a.bd,
        a.bde, a.fo, a.fe);
    return (int)cudaGetLastError();
  }
}

}  // namespace ctc

extern "C" {

size_t ctc_simplified_fwd_smem_bytes(int lpad, int k_win) {
  return ctc::sfwd_smem_bytes(lpad, k_win);
}

// mode: 0 final, 1 resid, 2 bound; ia, ie null for the t=0 carry; dg
// 16-byte aligned (the wrapper checks)
int ctc_simplified_fwd(const float* blank, const float* dg, const int* lens,
                       const float* ia, const int* ie, int batch, int tpad,
                       int lpad, int k_win, int mode, float* sa, int* saf,
                       float* bd, int* bde, float* fo, int* fe, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ctc::SFwdArgs a{blank, dg, lens, ia, ie, tpad, lpad, k_win,
                        sa, saf, bd, bde, fo, fe};
  const int lpt = ctc::lanes_per_thread(lpad);
  switch (mode) {
    case ctc::kSResid: return ctc::launch_sfwd<ctc::kSResid, 1>(lpt, batch, st, a);
    case ctc::kSBound: return ctc::launch_sfwd<ctc::kSBound, 1>(lpt, batch, st, a);
    default: return ctc::launch_sfwd<ctc::kSFinal, 1>(lpt, batch, st, a);
  }
}

}  // extern "C"
