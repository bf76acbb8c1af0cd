// Simplified CTC residual-free beta scan: re-expands alpha over each window
// from its boundary carry, then scans beta back over the window, emitting
// the loss-normalised act pd.
//
// Replaces the inner kernel of tf_seq2seq_losses_tpu/ops/pallas_lattice.py:
// _simplified_bwd_call, the backward of the residual-free scheme that
// serves the chunked long-T path and stream_residuals=False.  Its inputs are
// the window boundaries [Tp / K, B, L] x (a, e) that simplified_fwd.cu writes
// in mode "bound", and the beta carry entering the span (null: one-hot at
// label_length); it emits the beta carry leaving it, which the host chains
// into the previous chunk.  The re-expanded mantissas and frames are those
// simplified_fwd.cu streams in mode "resid" (the same operations on the same
// carry, each rounded on its own under -fmad=false), so pd equals
// simplified_bwd.cu's bit for bit.
//
// What bounds it on the H100: a chain of dependent steps per sample, two per
// window (alpha re-expansion, beta scan), each a shared-memory exchange and
// a barrier; its bytes (the [B, T, L] transition stream and boundaries in,
// pd out) would take a few hundred microseconds at full HBM rate at long T.
// Measured on the parent design (H100 80GB HBM3, 700 W, one long-T chunk of
// 504 steps at B=256 and 2016 lanes): 4.07 ms, of which the staging with
// the window opens alone took 2.31 ms and the scans alone 1.83 ms, with no
// overlap; reading the workspace from shared memory saved 0.44 ms.  At the
// headline (256 lanes): 0.552 ms, 0.345 staging, 0.315 scans.
//
// Design: that of classic_bwd_rf.cu with a single state.  The transition
// rows are staged ahead by bulk copies into a ring of K + kSpareRows rows,
// the boundary rows of the next window as soon as the open has read the
// current ones, and the blank row by cp.async; a thread's lanes keep their
// carries and constants in registers (LPT lanes a thread, a template
// parameter), shared memory keeps the exchange buffer, the frames and the
// staged rows.  The re-expanded alpha of a window goes to the CTA's slice of
// a global workspace [B, K, L] (it stays in L2: pd is stored with the
// streaming hint, the transitions are evict-first), and each thread reads
// back only its own lanes, one step ahead, so the simplified act needs no
// neighbour's residual.  The act scale is taken once a window as a double.
//
// What bounds it now (the same chunk and card): 1.83 ms (0.49 at the
// headline).  Without the float64 act it takes 1.67 ms; a ring of 4 spare
// rows changes nothing.  The rest is the step chain: one CTA per SM in two
// waves, each step a barrier, one shared-memory exchange and the lanes'
// arithmetic.
#include "blockfloat.cuh"
#include "stage.cuh"

namespace ctc {

constexpr int kSpareRows = 2;       // ring rows beyond one window
constexpr int kSBwdRfMaxLpt = 13;   // lanes per thread: the widest label at K=1

__host__ __device__ inline size_t sbwd_rf_smem_bytes(int lpad, int k) {
  // per lane: ring[k + spare], bd bde, x[2] (d, then b), et fs;
  // blank[2][k]; mbarriers: ring + 1
  return sizeof(float) * ((size_t)lpad * (k + kSpareRows + 6) + 2 * k) +
         sizeof(uint64_t) * (size_t)(k + kSpareRows + 1);
}

template <int LPT>
__global__ void __launch_bounds__(512, 1) simplified_bwd_rf_kernel(
    const float* __restrict__ blank,   // [B, Tp]
    const float* __restrict__ dg,      // [B, Tp, L]
    const int* __restrict__ lens,      // [B] steps to run, within [0, Tp]
    const int* __restrict__ lab_len,   // [B] label_length
    const float* __restrict__ ebi,     // [B] act normaliser
    const float* __restrict__ bd,      // [Tp / K, B, L] alpha entering a window
    const int* __restrict__ bde,
    const float* __restrict__ ib,      // [B, L] beta carry in (null: one-hot)
    const int* __restrict__ ie,
    int tpad, int lpad, int k_win,
    float* __restrict__ ws,            // [B, K, L] re-expanded alpha
    float* __restrict__ pd,            // [B, Tp, L]
    float* __restrict__ fo, int* __restrict__ fe) {
  extern __shared__ __align__(16) float smem[];
  const int n_ring = k_win + kSpareRows;
  float* ring = smem;                          // [R, L]
  float* bnd = ring + (size_t)n_ring * lpad;   // [L]
  int* bnde = reinterpret_cast<int*>(bnd + lpad);
  float* x = reinterpret_cast<float*>(bnde + lpad);  // [2, L]
  int* et = reinterpret_cast<int*>(x + 2 * lpad);
  int* fs = et + lpad;
  float* blank_s = reinterpret_cast<float*>(fs + lpad);  // [2, K]
  uint64_t* bars = reinterpret_cast<uint64_t*>(blank_s + 2 * k_win);  // [R + 1]
  uint64_t* bnd_bar = bars + n_ring;

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int b = blockIdx.x;
  const int batch = gridDim.x;
  const int len = lens[b];
  const int ll = lab_len[b];
  const float ebv = ebi[b];
  const size_t row = (size_t)b * lpad;
  float* wsb = ws + (size_t)b * k_win * lpad;
  const float* dgb = dg + (size_t)b * tpad * lpad;
  const uint32_t row_bytes = (uint32_t)lpad * sizeof(float);
  const int n_win = (len + k_win - 1) / k_win;
  const int kend_first = len - (n_win - 1) * k_win;

  // time step of the n-th row in load order: windows last to first, rows
  // first to last within each
  auto row_time = [&](int n) {
    if (n < kend_first) return (n_win - 1) * k_win + n;
    const int m = n - kend_first;
    return (n_win - 2 - m / k_win) * k_win + m % k_win;
  };
  uint64_t policy = 0;
  auto issue_row = [&](int n) {
    const int s = n % n_ring;
    stage_row(ring + (size_t)s * lpad, dgb + (size_t)row_time(n) * lpad, row_bytes,
              &bars[s], policy);
  };
  auto issue_bounds = [&](int w) {
    const size_t bo = ((size_t)w * batch + b) * lpad;
    mbar_expect_tx(bnd_bar, 2 * row_bytes);
    bulk_load(bnd, bd + bo, row_bytes, bnd_bar, policy);
    bulk_load(bnde, bde + bo, row_bytes, bnd_bar, policy);
  };
  auto issue_blank = [&](int w, int slot) {
    const int t0 = w * k_win;
    const int kend = min(k_win, len - t0);
    for (int i = tid; i < kend; i += nt) {
      cp_async4(blank_s + slot * k_win + i, blank + (size_t)b * tpad + t0 + i);
    }
  };

  if (tid == 0) {
    for (int s = 0; s <= n_ring; ++s) mbar_init(&bars[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0 && n_win > 0) {
    policy = evict_first_policy();
    issue_bounds(n_win - 1);
    for (int n = 0; n < n_ring && n < len; ++n) issue_row(n);
  }
  if (n_win > 0) issue_blank(n_win - 1, 0);

  // own lanes: the beta carry
  float bv[LPT];
  int es[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int l = tid + j * nt;
    bv[j] = 0.0f;
    es[j] = 0;
    if (l < lpad) {
      if (ib != nullptr) {
        bv[j] = ib[row + l];
        es[j] = ie[row + l];
      } else {
        bv[j] = l == ll ? 1.0f : 0.0f;
      }
    }
  }
  // acts past the sample's length are zero
  for (size_t i = (size_t)len * lpad + tid; i < (size_t)tpad * lpad; i += nt) {
    __stcs(pd + (size_t)b * tpad * lpad + i, 0.0f);
  }

  int base = 0;  // load-order index of the window's first row
  for (int wi = 0; wi < n_win; ++wi) {
    const int w = n_win - 1 - wi;
    const int t0 = w * k_win;
    const int kend = wi == 0 ? kend_first : k_win;
    const float* blw = blank_s + (wi & 1) * k_win;
    cp_async_wait_all();
    __syncthreads();  // this window's blank row; the last window's reads done
    if (wi + 1 < n_win) issue_blank(w - 1, (wi + 1) & 1);
    // ---- alpha: open the window on its boundary carry (simplified_fwd.cu)
    float av[LPT], sarr[LPT];
    int fa[LPT];
    mbar_wait(bnd_bar, wi & 1);
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int l = tid + j * nt;
      av[j] = 0.0f;
      fa[j] = 0;
      if (l < lpad) {
        const float m = flush_subnormal(bnd[l]);
        const int e = bnde[l];
        av[j] = m;
        fa[j] = e;
        et[l] = true_exp(m, e);
      }
    }
    __syncthreads();
    if (tid == 0 && wi + 1 < n_win) {
      fence_proxy_async();
      issue_bounds(w - 1);
    }
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int l = tid + j * nt;
      if (l < lpad) {
        int f = et[l];
        for (int jj = 1; jj <= k_win && jj <= l; ++jj) f = max(f, et[l - jj]);
        fs[l] = f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int l = tid + j * nt;
      sarr[j] = 0.0f;
      if (l < lpad) {
        const int f = fs[l];
        av[j] *= pow2i(fa[j] - f);
        const int f_src = l == 0 ? -kEBig : fs[l - 1];
        sarr[j] = pow2i(f_src - f);
        fa[j] = f;
      }
    }
    // ... and re-expand its steps into the workspace
    for (int kk = 0; kk < kend; ++kk) {
      const int n = base + kk;
      mbar_wait(&bars[n % n_ring], (n / n_ring) & 1);
      const float* dw = ring + (size_t)(n % n_ring) * lpad;
      float* dnow = x + (kk & 1) * lpad;
      float* wk = wsb + (size_t)kk * lpad;
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int l = tid + j * nt;
        if (l < lpad) {
          wk[l] = av[j];
          dnow[l] = av[j] * dw[l];
        }
      }
      __syncthreads();
      const float bl = blw[kk];
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int l = tid + j * nt;
        if (l < lpad) {
          const float arr = l == 0 ? 0.0f : dnow[l - 1] * sarr[j];
          av[j] = av[j] * bl + arr;
        }
      }
    }
    // ---- beta: open the backward window (simplified_bwd.cu) ---------------
    double sc[LPT];
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int l = tid + j * nt;
      if (l < lpad) {
        const float m = flush_subnormal(bv[j]);
        bv[j] = m;
        et[l] = true_exp(m, es[j]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int l = tid + j * nt;
      if (l < lpad) {
        int f = et[l];
        for (int jj = 1; jj <= k_win && l + jj < lpad; ++jj) f = max(f, et[l + jj]);
        fs[l] = f;
      }
    }
    __syncthreads();
    float* bx = x;  // [2, L]: b for the neighbour, double-buffered
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int l = tid + j * nt;
      sc[j] = 0.0;
      if (l < lpad) {
        const int f = fs[l];
        bv[j] *= pow2i(es[j] - f);
        const int f_src = l == lpad - 1 ? -kEBig : fs[l + 1];
        sarr[j] = pow2i(f_src - f);
        es[j] = f;
        float shi, slo;
        act_factor(fa[j], f, ebv, &shi, &slo);
        sc[j] = act_scale(shi, slo);
        bx[l] = bv[j];
      }
    }
    // the workspace of the last step, read ahead of it (own lanes only)
    float p[LPT];
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int l = tid + j * nt;
      p[j] = l < lpad ? wsb[(size_t)(kend - 1) * lpad + l] : 0.0f;
    }
    __syncthreads();
    int cur = 0;
    for (int kk = kend - 1; kk >= 0; --kk) {
      const int n = base + kk;
      const float* dw = ring + (size_t)(n % n_ring) * lpad;
      const float bl = blw[kk];
      const float* bnow = bx + cur * lpad;
      float* bnext = bx + (cur ^ 1) * lpad;
      float q[LPT];
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int l = tid + j * nt;
        q[j] = kk > 0 && l < lpad ? wsb[(size_t)(kk - 1) * lpad + l] : 0.0f;
      }
      float* pdt = pd + ((size_t)b * tpad + t0 + kk) * lpad;
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int l = tid + j * nt;
        if (l < lpad) {
          const float bn = l + 1 >= lpad ? 0.0f : bnow[l + 1];
          const float arr = bn * sarr[j];
          const float d = dw[l];
          __stcs(pdt + l, scaled_act_by(p[j], d, arr, sc[j]));
          bv[j] = bl * bv[j] + d * arr;
          bnext[l] = bv[j];
        }
        p[j] = q[j];
      }
      __syncthreads();
      cur ^= 1;
      // row n is read: its ring slot takes the row R places later
      if (tid == 0 && n + n_ring < len) {
        fence_proxy_async();
        issue_row(n + n_ring);
      }
    }
    base += kend;
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

template <int LPT>
int launch_sbwd_rf(int lpt, size_t smem, int batch, int threads,
                   cudaStream_t stream, const float* blank, const float* dg,
                   const int* lens, const int* lab_len, const float* ebi,
                   const float* bd, const int* bde, const float* ib,
                   const int* ie, int tpad, int lpad, int k_win, float* ws,
                   float* pd, float* fo, int* fe) {
  if constexpr (LPT > kSBwdRfMaxLpt) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (lpt != LPT) {
      return launch_sbwd_rf<LPT + 1>(lpt, smem, batch, threads, stream, blank, dg,
                                     lens, lab_len, ebi, bd, bde, ib, ie, tpad,
                                     lpad, k_win, ws, pd, fo, fe);
    }
    cudaFuncSetAttribute(simplified_bwd_rf_kernel<LPT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    simplified_bwd_rf_kernel<LPT><<<batch, threads, smem, stream>>>(
        blank, dg, lens, lab_len, ebi, bd, bde, ib, ie, tpad, lpad, k_win, ws, pd,
        fo, fe);
    return (int)cudaGetLastError();
  }
}

}  // namespace ctc

extern "C" {

size_t ctc_simplified_bwd_rf_smem_bytes(int lpad, int k_win) {
  return ctc::sbwd_rf_smem_bytes(lpad, k_win);
}

// ib, ie null for the beta carry at the end of the lattice; dg, bd and bde
// 16-byte aligned (the wrapper checks)
int ctc_simplified_bwd_rf(const float* blank, const float* dg, const int* lens,
                          const int* lab_len, const float* ebi,
                          const float* bd, const int* bde, const float* ib,
                          const int* ie, int batch, int tpad, int lpad,
                          int k_win, float* ws, float* pd, float* fo, int* fe,
                          void* stream) {
  return ctc::launch_sbwd_rf<1>(
      ctc::lanes_per_thread(lpad), ctc::sbwd_rf_smem_bytes(lpad, k_win), batch,
      ctc::strided_threads(lpad), static_cast<cudaStream_t>(stream), blank, dg,
      lens, lab_len, ebi, bd, bde, ib, ie, tpad, lpad, k_win, ws, pd, fo, fe);
}

}  // extern "C"
