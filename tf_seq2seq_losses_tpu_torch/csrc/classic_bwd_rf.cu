// Classic CTC residual-free beta scan: re-expands alpha over each window
// from its boundary carry, then scans beta back over the window, emitting
// the combined, loss-normalised act pc.
//
// Replaces tf_seq2seq_losses_tpu/ops/pallas_lattice.py:_classic_bwd_kernel
// (launched by _classic_bwd_call), the backward of the residual-free scheme
// that serves the chunked long-T path and stream_residuals=False.  Its
// inputs are the window boundaries [Tp / K, B, L] x (a0, a1, e) that
// classic_fwd.cu writes in mode "bound", and the beta carry entering the
// span (null: one-hot at label_length, the end of the lattice); it emits the
// beta carry leaving it, which the host chains into the previous chunk.
//
// Output layout, the port's own: the JAX kernel emits the acts ph and pd
// separately and scatters them against two one-hot matrices.  This kernel
// emits the combined act pc[t, l] = pd[l] + ph[l + 1], as classic_bwd.cu
// does over streamed residuals, so both schemes share the act scatter and
// the gradient assembly.  The re-expanded mantissas and frames are those
// classic_fwd.cu streams in mode "resid" (the same operations on the same
// carry, each rounded on its own under -fmad=false), so pc equals
// classic_bwd.cu's bit for bit.
//
// What bounds it on the H100: a chain of dependent steps per sample, two
// per window (the alpha re-expansion and the beta scan), each a
// shared-memory exchange and a barrier; its bytes (the [B, T, L] transition
// stream and boundaries in, pc out) would take a few hundred microseconds
// at full HBM rate at long T.  Measured on the parent design (one CTA per
// sample, every per-lane value in shared memory, each window's transitions
// and boundaries loaded synchronously; H100 80GB HBM3, 700 W, one long-T
// chunk of 504 steps at B=256 and 2016 lanes): 5.58 ms, of which the
// staging with the window opens alone took 2.36 ms and the scans alone
// 3.22 ms, with no overlap between them; reading the workspace from shared
// memory instead of global saved 0.98 ms.  At the headline (256 lanes):
// 0.648 ms, 0.353 staging, 0.410 scans.
//
// Design against that:
// - Staging runs ahead, asynchronously.  The window's transition rows sit
//   in a ring of K + kSpareRows rows of shared memory, each with its own
//   mbarrier.  One thread issues each row as a bulk copy (TMA, evict-first
//   in L2): every row of the ring ahead at the start, then, as the beta
//   phase frees a row, the row R places later in the load order (windows
//   last to first, rows first to last in each).  The next window's
//   boundary rows go to their buffer as soon as the window open has read
//   the current ones, and its blank row by 4-byte cp.async (it is not
//   16-byte aligned at every window).  So the loads of a window fly while
//   the previous window's scans run.
// - A thread's lanes (t + j * threads, j < LPT, LPT a template parameter)
//   keep their carries and per-lane constants in registers; shared memory
//   holds only what a neighbour reads (the exchange buffer, the frames,
//   the act scale at l + 1, taken once a window in float64) and the
//   staged rows.  That frees the shared memory for the ring, and the
//   unrolled lane loop overlaps its loads.
// - The re-expanded alpha of a window still goes to a global workspace
//   [B, K, 2, L] (K steps x 2 x 2016 lanes do not fit beside the rest),
//   but the beta step loads step kk - 1's values while it computes step
//   kk, and the act stream pc is stored with the streaming hint, so the
//   workspace stays in L2 and its latency is off the chain.
// - The act scale 2^(fa + fb - ebi) is taken once a window as a double:
//   float64 conversions run at 16 a clock per SM, and the act is the only
//   float64 work of the step.
// The scan starts at the sample's own length and acts past it are zero.
//
// What bounds it now (the same chunk and card): 2.50 ms (0.48 at the
// headline).  Without the float64 act it takes 2.19 ms; a ring of 4 spare
// rows instead of 2 changes nothing, so no step waits for its row.  The
// rest is the step chain itself: one CTA per SM in two waves of the batch,
// each step a barrier, shared-memory exchanges and the lanes' arithmetic
// (four lanes a thread at 2016 lanes).
#include "blockfloat.cuh"
#include "stage.cuh"

namespace ctc {

constexpr int kSpareRows = 2;      // ring rows beyond one window
constexpr int kBwdRfMaxLpt = 10;   // lanes per thread: the widest label at K=1

__host__ __device__ inline size_t bwd_rf_smem_bytes(int lpad, int k) {
  // per lane: ring[k + spare], bd0 bd1 bde, x[2] (d in the alpha phase, b1
  // in the beta phase), the act scale (a double), et fs; blank[2][k];
  // mbarriers: ring + 1
  return sizeof(float) * ((size_t)lpad * (k + kSpareRows + 9) + 2 * k) +
         sizeof(uint64_t) * (size_t)(k + kSpareRows + 1);
}

template <int LPT>
__global__ void __launch_bounds__(512, 1) classic_bwd_rf_kernel(
    const float* __restrict__ blank,   // [B, Tp]
    const float* __restrict__ dcu,     // [B, Tp, L]
    const float* __restrict__ lm,      // [B, L]
    const float* __restrict__ nb,      // [B, L]
    const float* __restrict__ rep,     // [B, L]
    const int* __restrict__ lens,      // [B] steps to run, within [0, Tp]
    const int* __restrict__ lab_len,   // [B] label_length
    const float* __restrict__ ebi,     // [B] act normaliser
    const float* __restrict__ bd0,     // [Tp / K, B, L] alpha entering a window
    const float* __restrict__ bd1,
    const int* __restrict__ bde,
    const float* __restrict__ i0,      // [B, L] beta carry in (null: one-hot)
    const float* __restrict__ i1,
    const int* __restrict__ ie,
    int tpad, int lpad, int k_win,
    float* __restrict__ ws,            // [B, K, 2, L] re-expanded alpha
    float* __restrict__ pc,            // [B, Tp, L]
    float* __restrict__ f0, float* __restrict__ f1, int* __restrict__ fe) {
  extern __shared__ __align__(16) float smem[];
  const int n_ring = k_win + kSpareRows;
  float* ring = smem;                              // [R, L]
  float* bnd0 = ring + (size_t)n_ring * lpad;      // [L]
  float* bnd1 = bnd0 + lpad;
  int* bnde = reinterpret_cast<int*>(bnd1 + lpad);
  float* x = reinterpret_cast<float*>(bnde + lpad);  // [2, L]
  double* scs = reinterpret_cast<double*>(x + 2 * lpad);  // act scale [L]
  int* et = reinterpret_cast<int*>(scs + lpad);
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
  float* wsb = ws + (size_t)b * k_win * 2 * lpad;
  const float* dcb = dcu + (size_t)b * tpad * lpad;
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
    stage_row(ring + (size_t)s * lpad, dcb + (size_t)row_time(n) * lpad, row_bytes,
              &bars[s], policy);
  };
  auto issue_bounds = [&](int w) {
    const size_t bo = ((size_t)w * batch + b) * lpad;
    mbar_expect_tx(bnd_bar, 3 * row_bytes);
    bulk_load(bnd0, bd0 + bo, row_bytes, bnd_bar, policy);
    bulk_load(bnd1, bd1 + bo, row_bytes, bnd_bar, policy);
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

  // own lanes: beta carry, lane masks
  float b0[LPT], b1[LPT], lmv[LPT], nbv[LPT], repv[LPT];
  int eb[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int l = tid + j * nt;
    b0[j] = b1[j] = lmv[j] = nbv[j] = repv[j] = 0.0f;
    eb[j] = 0;
    if (l < lpad) {
      if (i0 != nullptr) {
        b0[j] = i0[row + l];
        b1[j] = i1[row + l];
        eb[j] = ie[row + l];
      } else {
        const float hot = l == ll ? 1.0f : 0.0f;
        b0[j] = hot;
        b1[j] = hot;
      }
      lmv[j] = lm[row + l];
      nbv[j] = nb[row + l];
      repv[j] = rep[row + l];
    }
  }
  // acts past the sample's length are zero
  for (size_t i = (size_t)len * lpad + tid; i < (size_t)tpad * lpad; i += nt) {
    __stcs(pc + (size_t)b * tpad * lpad + i, 0.0f);
  }

  int base = 0;  // load-order index of the window's first row
  for (int wi = 0; wi < n_win; ++wi) {
    const int w = n_win - 1 - wi;
    const int t0 = w * k_win;
    const int kend = wi == 0 ? kend_first : k_win;
    const float* blank_w = blank_s + (wi & 1) * k_win;
    cp_async_wait_all();
    __syncthreads();  // this window's blank row; the last window's reads done
    if (wi + 1 < n_win) issue_blank(w - 1, (wi + 1) & 1);
    // ---- alpha: open the window on its boundary carry (classic_fwd.cu) ----
    float a0[LPT], a1[LPT], sarr[LPT];
    int fa[LPT];
    mbar_wait(bnd_bar, wi & 1);
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int l = tid + j * nt;
      a0[j] = a1[j] = 0.0f;
      fa[j] = 0;
      if (l < lpad) {
        const float m0 = flush_subnormal(bnd0[l]);
        const float m1 = flush_subnormal(bnd1[l]);
        const int e = bnde[l];
        a0[j] = m0;
        a1[j] = m1;
        fa[j] = e;
        et[l] = true_exp(m0, m1, e);
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
        const float r = pow2i(fa[j] - f);
        a0[j] *= r;
        a1[j] *= r;
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
      float* wk = wsb + (size_t)kk * 2 * lpad;
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int l = tid + j * nt;
        if (l < lpad) {
          wk[l] = a0[j];
          wk[lpad + l] = a1[j];
          const float dc = dw[l] * lmv[j];
          const float dov = dc * repv[j];
          dnow[l] = a0[j] * dc + a1[j] * dov;
        }
      }
      __syncthreads();
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
    }
    // ---- beta: open the backward window (classic_bwd.cu) ------------------
    double sc[LPT];
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int l = tid + j * nt;
      if (l < lpad) {
        const float m0 = flush_subnormal(b0[j]);
        const float m1 = flush_subnormal(b1[j]);
        b0[j] = m0;
        b1[j] = m1;
        et[l] = true_exp(m0, m1, eb[j]);
      }
    }
    __syncthreads();  // also publishes the workspace to the whole CTA
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
    float* b1x = x;  // [2, L]: b1 for the neighbour, double-buffered
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int l = tid + j * nt;
      sc[j] = 0.0;
      if (l < lpad) {
        const int f = fs[l];
        const float r = pow2i(eb[j] - f);
        b0[j] *= r;
        b1[j] *= r;
        const int f_src = l == lpad - 1 ? -kEBig : fs[l + 1];
        sarr[j] = pow2i(f_src - f);
        eb[j] = f;
        float shi, slo;
        act_factor(fa[j], f, ebv, &shi, &slo);
        sc[j] = act_scale(shi, slo);
        scs[l] = sc[j];
        b1x[l] = b1[j];
      }
    }
    // the workspace of the last step, read ahead of it
    float p0[LPT], p1[LPT], p1n[LPT];
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int l = tid + j * nt;
      const float* wk = wsb + (size_t)(kend - 1) * 2 * lpad;
      p0[j] = p1[j] = p1n[j] = 0.0f;
      if (l < lpad) {
        p0[j] = wk[l];
        p1[j] = wk[lpad + l];
        if (l + 1 < lpad) p1n[j] = wk[lpad + l + 1];
      }
    }
    __syncthreads();
    int cur = 0;
    for (int kk = kend - 1; kk >= 0; --kk) {
      const int n = base + kk;
      const float* dw = ring + (size_t)(n % n_ring) * lpad;
      const float bl = blank_w[kk];
      const float* b1now = b1x + cur * lpad;
      float* b1next = b1x + (cur ^ 1) * lpad;
      float q0[LPT], q1[LPT], q1n[LPT];
      const float* wk = wsb + (size_t)(kk > 0 ? kk - 1 : 0) * 2 * lpad;
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int l = tid + j * nt;
        q0[j] = q1[j] = q1n[j] = 0.0f;
        if (kk > 0 && l < lpad) {
          q0[j] = wk[l];
          q1[j] = wk[lpad + l];
          if (l + 1 < lpad) q1n[j] = wk[lpad + l + 1];
        }
      }
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
          const float dd = p0[j] * dc + p1[j] * dov;
          const float pd = scaled_act_by(dd, arr, sc[j]);
          const float ph_n =
              edge ? 0.0f : scaled_act_by(p1n[j], dw[l], b1n, scs[l + 1]);
          __stcs(pct + l, pd + ph_n);
          const float hc = bl * b0[j];
          b0[j] = hc + dc * arr;
          b1[j] = hc + pm * b1[j] + dov * arr;
          b1next[l] = b1[j];
        }
        p0[j] = q0[j];
        p1[j] = q1[j];
        p1n[j] = q1n[j];
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
      f0[row + l] = b0[j];
      f1[row + l] = b1[j];
      fe[row + l] = eb[j];
    }
  }
}

template <int LPT>
int launch_bwd_rf(int lpt, size_t smem, int batch, int threads, cudaStream_t stream,
                  const float* blank, const float* dcu, const float* lm,
                  const float* nb, const float* rep, const int* lens,
                  const int* lab_len, const float* ebi, const float* bd0,
                  const float* bd1, const int* bde, const float* i0,
                  const float* i1, const int* ie, int tpad, int lpad, int k_win,
                  float* ws, float* pc, float* f0, float* f1, int* fe) {
  if constexpr (LPT > kBwdRfMaxLpt) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (lpt != LPT) {
      return launch_bwd_rf<LPT + 1>(lpt, smem, batch, threads, stream, blank, dcu,
                                    lm, nb, rep, lens, lab_len, ebi, bd0, bd1, bde,
                                    i0, i1, ie, tpad, lpad, k_win, ws, pc, f0, f1,
                                    fe);
    }
    cudaFuncSetAttribute(classic_bwd_rf_kernel<LPT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    classic_bwd_rf_kernel<LPT><<<batch, threads, smem, stream>>>(
        blank, dcu, lm, nb, rep, lens, lab_len, ebi, bd0, bd1, bde, i0, i1, ie,
        tpad, lpad, k_win, ws, pc, f0, f1, fe);
    return (int)cudaGetLastError();
  }
}

}  // namespace ctc

extern "C" {

size_t ctc_classic_bwd_rf_smem_bytes(int lpad, int k_win) {
  return ctc::bwd_rf_smem_bytes(lpad, k_win);
}

// i0, i1, ie null for the beta carry at the end of the lattice; dcu, bd0,
// bd1 and bde 16-byte aligned (the wrapper checks)
int ctc_classic_bwd_rf(const float* blank, const float* dcu, const float* lm,
                       const float* nb, const float* rep, const int* lens,
                       const int* lab_len, const float* ebi, const float* bd0,
                       const float* bd1, const int* bde, const float* i0,
                       const float* i1, const int* ie, int batch, int tpad,
                       int lpad, int k_win, float* ws, float* pc, float* f0,
                       float* f1, int* fe, void* stream) {
  return ctc::launch_bwd_rf<1>(
      ctc::lanes_per_thread(lpad), ctc::bwd_rf_smem_bytes(lpad, k_win), batch,
      ctc::strided_threads(lpad), static_cast<cudaStream_t>(stream), blank, dcu,
      lm, nb, rep, lens, lab_len, ebi, bd0, bd1, bde, i0, i1, ie, tpad, lpad,
      k_win, ws, pc, f0, f1, fe);
}

}  // extern "C"
