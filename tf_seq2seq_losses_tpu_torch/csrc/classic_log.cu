// Exact log-space classic CTC scans: the saturation guard's repair path.
//
// classic_log_fwd_kernel (B4) replaces
// tf_seq2seq_losses_tpu/ops/log_lattice.py:_classic_log_fwd_kernel
// (launched by _classic_log_fwd_call), modes "final" and "resid".
// classic_log_bwd_kernel (B5) replaces the inner kernel of
// tf_seq2seq_losses_tpu/ops/log_lattice.py:_classic_log_bwd_call.
//
// The carries are log-probabilities, so nothing can flush: these kernels
// recompute the rows whose block-float loss flushed to +inf.  They keep the
// reference's factorisations: with rep in {0, -inf} the diagonal is
// d = dc + x, x = where(rep, lae(a0, a1), a0), so the forward costs two
// logaddexp per step and streams x (not a0); the backward rebuilds d with
// no logaddexp and shares the rep-gated term, n1 = lae(where(rep, n0, hc),
// pm + b1), at two logaddexp and two exp per step.
//
// What bounds them on the H100: the dependent chain of steps, one barrier
// and two precise logaddexp (expf, log1pf) a step on it (the build passes no
// fast-math flag: the repair must hold 1e-5).  The bytes, the [B, T, L]
// streams of dc and pt (and in the backward the residuals x and a1 in, pc
// out), would take a fifth to a third of the time at the headline and
// nothing in a repair round of a few rows.  Latency-bound.  What bounded
// the parent design (one thread a lane, every per-lane value in shared
// memory, each chunk of 8 steps' rows loaded by strided loops between two
// barriers; H100 80GB HBM3, 700 W, CUDA events): at the headline (B=256, T=500, 256
// lanes) B4 final took 0.458 ms, 0.221 with its chunk loads taken out and
// 0.254 with its steps taken out; B4 resid 0.511, 0.251, 0.254; B5 0.546,
// 0.287, 0.297.  On a repair round (4 rows of the headline, 493 steps) the
// loads still cost 0.09 to 0.11 ms of 0.31 to 0.32: 62 loads' latencies on
// the chain.  Nothing overlapped them.
//
// Design against that (the one classic_bwd.cuh and simplified_bwd.cu use):
// - One CTA per sample; the time loop stops at the sample's logit_length
//   (past it the carries sit at their forced-blank fixed points).
// - Staging runs ahead, asynchronously, off the step chain.  Each step's
//   rows (B4: dc_l[b, t], pt_l[b, t] in ascending time; B5: dc_l, pt_l, sx,
//   sa1 at [b, t] in descending time) go to a ring of kLogRing slots of
//   shared memory, each with a "full" mbarrier the bulk copies complete on
//   and an "empty" one the lanes release it on.  One thread of an extra,
//   last warp, which takes no part in the steps' barriers, issues each slot
//   as bulk copies (TMA, evict-first in L2) in the order the scan reads
//   them: the first kLogRing rows at once, then each row kLogRing places
//   later as soon as the slot's step has released it.  A step reads all it
//   needs of its slot before its barrier (B5 also lane l+1's pt and a1), so
//   thread 0 releases the slot just after the step's barrier.  The blanks
//   come by 4-byte cp.async kLogRun steps at a time, a run ahead, into one
//   of two slots.
// - A thread's lanes (t + j * threads, j < LPT, LPT a template parameter)
//   keep the carries (B4 a0, a1; B5 b0, b1) and the nb and rep masks in
//   registers.  Shared memory holds the ring and the one value a neighbour
//   needs, double-buffered, with one barrier among the lane threads a step:
//   B4's d = dc + x of lane l-1, B5's b1 of lane l+1.
// - B4 takes its first logaddexp, lae(a0, a1), which needs no staged row,
//   before it waits for the step's slot.
// - B4's residuals x and a1, B5's pc and its zero fill past logit_length
//   are stored with the streaming hint: nothing here reads them back.
// Every floating-point expression keeps its operands and their order
// (-fmad=false, precise expf and log1pf), so both kernels write the
// parent's bits, and their plain versions' on the card.
//
// What bounds them now (the same card): at the headline B4 final 0.22 ms,
// B4 resid 0.23, B5 0.32, against byte bounds of 0.042, 0.084 and 0.104;
// on the repair round 0.19 to 0.20 ms (B4, 0.40 us a step) and 0.27 (B5,
// 0.54 us a step), against bounds of a microsecond or two: the chain.
// Waiting for the slot after the first logaddexp took B4 0.24 / 0.27 ms to
// 0.22 / 0.23 at the headline.  No help: B5's acts taken after the barrier
// (0.32 -> 0.34 ms), and either kernel waiting for the next step's slot
// before its barrier (B5 0.32 -> 0.35, B4 0.22 -> 0.25), which puts the
// poll on the last warp's chain.  ptxas: 32 to 61 registers, no spills, at
// one to four lanes a thread.
#include "blockfloat.cuh"
#include "stage.cuh"

namespace ctc {

constexpr int kLogRing = 8;  // ring slots: rows staged ahead of the step
constexpr int kLogRun = 8;   // steps whose blanks are staged at a time
// Lanes per thread: CLASSIC_LOG_LANES (ops/log_lattice.py), the widest
// label the host sends these kernels, is 1568 lanes, four a thread.
constexpr int kLogMaxLpt = 4;

__host__ __device__ inline size_t log_fwd_smem_bytes(int lpad) {
  // per lane: ring[R][dc, pt], d[2]; blank[2][run]; two mbarriers per ring
  // slot (full, empty)
  return sizeof(float) * ((size_t)lpad * (2 * kLogRing + 2) + 2 * kLogRun) +
         sizeof(uint64_t) * (2 * kLogRing);
}

__host__ __device__ inline size_t log_bwd_smem_bytes(int lpad) {
  // per lane: ring[R][dc, pt, sx, sa1], b1[2]; blank[2][run]; two
  // mbarriers per ring slot (full, empty)
  return sizeof(float) * ((size_t)lpad * (4 * kLogRing + 2) + 2 * kLogRun) +
         sizeof(uint64_t) * (2 * kLogRing);
}

template <bool kResid, int LPT>
__global__ void __launch_bounds__(512 + 32, LPT <= 2 ? 2 : 1) classic_log_fwd_kernel(
    const float* __restrict__ blank_l,  // [B, Tp] log blank prob
    const float* __restrict__ dc_l,     // [B, Tp, L] log expected-token prob, -inf masked
    const float* __restrict__ pt_l,     // [B, Tp, L] log preceding-token prob
    const float* __restrict__ nb,       // [B, L]
    const float* __restrict__ rep,      // [B, L]
    const int* __restrict__ lens,       // [B]
    int tpad, int lpad,
    float* __restrict__ sx,             // [B, Tp, L] (resid)
    float* __restrict__ sa1,            // [B, Tp, L] (resid)
    float* __restrict__ f0, float* __restrict__ f1) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                  // [R, 2, L]
  float* ds = ring + (size_t)kLogRing * 2 * lpad;      // [2, L]
  float* blank_s = ds + 2 * lpad;                      // [2, run]
  uint64_t* full = reinterpret_cast<uint64_t*>(blank_s + 2 * kLogRun);  // [R]
  uint64_t* empty = full + kLogRing;                                    // [R]

  const int tid = threadIdx.x;
  const int nt = blockDim.x - 32;  // lane threads; the last warp stages
  const int b = blockIdx.x;
  const int len = lens[b];
  const int n_run = (len + kLogRun - 1) / kLogRun;
  const size_t row = (size_t)b * lpad;
  const uint32_t row_bytes = (uint32_t)lpad * sizeof(float);
  const float* dcb = dc_l + (size_t)b * tpad * lpad;
  const float* ptb = pt_l + (size_t)b * tpad * lpad;

  auto issue_blank = [&](int r) {  // run r's blanks, into slot r mod 2
    const int t0 = r * kLogRun;
    const int kend = min(kLogRun, len - t0);
    for (int i = tid; i < kend; i += nt) {
      cp_async4(blank_s + (r & 1) * kLogRun + i, blank_l + (size_t)b * tpad + t0 + i);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < 2 * kLogRing; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  if (tid < nt && n_run > 0) issue_blank(0);
  cp_async_wait_all();
  __syncthreads();  // the last barrier of the whole CTA
  if (tid >= nt) {
    // the producer: step n's rows into slot n mod R once step n - R
    // released it
    if (tid == nt && len > 0) {
      const uint64_t policy = evict_first_policy();
      for (int n = 0; n < len; ++n) {
        const int s = n % kLogRing;
        if (n >= kLogRing) {
          mbar_wait(&empty[s], (n / kLogRing - 1) & 1);
          fence_proxy_async();
        }
        float* dst = ring + (size_t)s * 2 * lpad;
        mbar_expect_tx(&full[s], 2 * row_bytes);
        bulk_load(dst, dcb + (size_t)n * lpad, row_bytes, &full[s], policy);
        bulk_load(dst + lpad, ptb + (size_t)n * lpad, row_bytes, &full[s], policy);
      }
    }
    return;
  }

  // own lanes: the carry, the lane masks
  float a0[LPT], a1[LPT], nbl[LPT];
  bool rp[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int l = tid + j * nt;
    a0[j] = l == 0 ? 0.0f : -INFINITY;
    a1[j] = -INFINITY;
    nbl[j] = l < lpad && nb[row + l] > 0.0f ? 0.0f : -INFINITY;
    rp[j] = l < lpad && rep[row + l] > 0.0f;
  }

  int n = 0;  // the step, which is also its row's place in load order
  for (int r = 0; r < n_run; ++r) {
    const int t0 = r * kLogRun;
    const int kend = min(kLogRun, len - t0);
    const float* blank_r = blank_s + (r & 1) * kLogRun;
    // the other slot's run was read before the barrier that ended it
    if (r + 1 < n_run) issue_blank(r + 1);
    for (int kk = 0; kk < kend; ++kk, ++n) {
      const int s = n % kLogRing;
      // the first logaddexp needs no staged row: wait for the slot after it
      float sv[LPT];
#pragma unroll
      for (int j = 0; j < LPT; ++j) sv[j] = lae(a0[j], a1[j]);
      mbar_wait(&full[s], (n / kLogRing) & 1);
      const float* dw = ring + (size_t)s * 2 * lpad;
      const float* pw = dw + lpad;
      const float bl = blank_r[kk];
      float* dnow = ds + (n & 1) * lpad;
      float pm[LPT];
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int l = tid + j * nt;
        if (l < lpad) {
          const float x = rp[j] ? sv[j] : a0[j];
          if (kResid) {
            const size_t o = ((size_t)b * tpad + t0 + kk) * lpad + l;
            __stcs(sx + o, x);
            __stcs(sa1 + o, a1[j]);
          }
          dnow[l] = dw[l] + x;
          pm[j] = pw[l] + nbl[j];
          a0[j] = sv[j] + bl;
        }
      }
      // the next run's blanks land before the barrier that ends this run
      if (kk == kend - 1) cp_async_wait_all();
      consumer_sync(nt);
      // slot s is read: it takes the row R places later
      if (tid == 0 && n + kLogRing < len) mbar_arrive(&empty[s]);
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int l = tid + j * nt;
        if (l < lpad) {
          const float arr = l == 0 ? -INFINITY : dnow[l - 1];
          a1[j] = lae(a1[j] + pm[j], arr);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int l = tid + j * nt;
    if (l < lpad) {
      f0[row + l] = a0[j];
      f1[row + l] = a1[j];
    }
  }
}

template <int LPT>
__global__ void __launch_bounds__(512 + 32, LPT <= 2 ? 2 : 1) classic_log_bwd_kernel(
    const float* __restrict__ blank_l,  // [B, Tp]
    const float* __restrict__ dc_l,     // [B, Tp, L]
    const float* __restrict__ pt_l,     // [B, Tp, L]
    const float* __restrict__ nb,       // [B, L]
    const float* __restrict__ rep,      // [B, L]
    const int* __restrict__ lens,       // [B]
    const int* __restrict__ lab_len,    // [B]
    const float* __restrict__ loss,     // [B] finite-masked loss
    const float* __restrict__ sx,       // [B, Tp, L]
    const float* __restrict__ sa1,      // [B, Tp, L]
    int tpad, int lpad,
    float* __restrict__ pc,             // [B, Tp, L]
    float* __restrict__ f0, float* __restrict__ f1) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                  // [R, 4, L]
  float* bs = ring + (size_t)kLogRing * 4 * lpad;      // [2, L]
  float* blank_s = bs + 2 * lpad;                      // [2, run]
  uint64_t* full = reinterpret_cast<uint64_t*>(blank_s + 2 * kLogRun);  // [R]
  uint64_t* empty = full + kLogRing;                                    // [R]

  const int tid = threadIdx.x;
  const int nt = blockDim.x - 32;  // lane threads; the last warp stages
  const int b = blockIdx.x;
  const int len = lens[b];
  const int ll = lab_len[b];
  const float lo = loss[b];
  const int n_run = (len + kLogRun - 1) / kLogRun;
  const size_t row = (size_t)b * lpad;
  const uint32_t row_bytes = (uint32_t)lpad * sizeof(float);
  const size_t cell0 = (size_t)b * tpad * lpad;
  float* pcb = pc + cell0;

  auto issue_blank = [&](int r, int slot) {  // run r's blanks
    const int t0 = r * kLogRun;
    const int kend = min(kLogRun, len - t0);
    for (int i = tid; i < kend; i += nt) {
      cp_async4(blank_s + slot * kLogRun + i, blank_l + (size_t)b * tpad + t0 + i);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < 2 * kLogRing; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  // own lanes: the beta carry (one-hot at label_length in both states, the
  // forced-blank fixed point), the lane masks; b1 also to the exchange the
  // first step reads
  float b0[LPT], b1[LPT], nbl[LPT];
  bool rp[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int l = tid + j * nt;
    const float hot = l == ll ? 0.0f : -INFINITY;
    b0[j] = b1[j] = hot;
    nbl[j] = tid < nt && l < lpad && nb[row + l] > 0.0f ? 0.0f : -INFINITY;
    rp[j] = tid < nt && l < lpad && rep[row + l] > 0.0f;
    if (tid < nt && l < lpad) bs[l] = hot;
  }
  if (tid < nt) {
    if (n_run > 0) issue_blank(n_run - 1, 0);
    // acts past logit_length are zero
    for (size_t i = (size_t)len * lpad + tid; i < (size_t)tpad * lpad; i += nt) {
      __stcs(pcb + i, 0.0f);
    }
  }
  cp_async_wait_all();
  __syncthreads();  // the last barrier of the whole CTA
  if (tid >= nt) {
    // the producer: the n-th slot in load order holds step len - 1 - n,
    // into slot n mod R once step len - 1 - (n - R) released it
    if (tid == nt && len > 0) {
      const uint64_t policy = evict_first_policy();
      for (int n = 0; n < len; ++n) {
        const int s = n % kLogRing;
        if (n >= kLogRing) {
          mbar_wait(&empty[s], (n / kLogRing - 1) & 1);
          fence_proxy_async();
        }
        const size_t o = cell0 + (size_t)(len - 1 - n) * lpad;
        float* dst = ring + (size_t)s * 4 * lpad;
        mbar_expect_tx(&full[s], 4 * row_bytes);
        bulk_load(dst, dc_l + o, row_bytes, &full[s], policy);
        bulk_load(dst + lpad, pt_l + o, row_bytes, &full[s], policy);
        bulk_load(dst + 2 * lpad, sx + o, row_bytes, &full[s], policy);
        bulk_load(dst + 3 * lpad, sa1 + o, row_bytes, &full[s], policy);
      }
    }
    return;
  }

  int n = 0;  // the step's place in load order
  for (int ri = 0; ri < n_run; ++ri) {
    const int r = n_run - 1 - ri;
    const int t0 = r * kLogRun;
    const int kend = min(kLogRun, len - t0);
    const float* blank_r = blank_s + (ri & 1) * kLogRun;
    // the other slot's run was read before the barrier that ended it
    if (ri + 1 < n_run) issue_blank(r - 1, (ri + 1) & 1);
    for (int kk = kend - 1; kk >= 0; --kk, ++n) {
      const int s = n % kLogRing;
      mbar_wait(&full[s], (n / kLogRing) & 1);
      const float* dw = ring + (size_t)s * 4 * lpad;
      const float* pw = dw + lpad;
      const float* xw = pw + lpad;
      const float* aw = xw + lpad;
      const float bl = blank_r[kk];
      const float* bnow = bs + (n & 1) * lpad;
      float* bnext = bs + ((n & 1) ^ 1) * lpad;
      float* pct = pcb + (size_t)(t0 + kk) * lpad;
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int l = tid + j * nt;
        if (l < lpad) {
          const bool edge = l + 1 >= lpad;
          const float arr = edge ? -INFINITY : bnow[l + 1];
          const float dc = dw[l];
          const float hc = bl + b0[j];
          const float n0 = lae(hc, dc + arr);
          const float pm = pw[l] + nbl[j];
          const float n1 = lae(rp[j] ? n0 : hc, pm + b1[j]);
          bnext[l] = n1;
          const float d = dc + xw[l];
          const float pd = expf(lo + d + arr);
          const float ph_n = edge ? 0.0f : expf(lo + aw[l + 1] + pw[l + 1] + arr);
          __stcs(pct + l, pd + ph_n);
          b0[j] = n0;
          b1[j] = n1;
        }
      }
      // the next run's blanks land before the barrier that ends this run
      if (kk == 0) cp_async_wait_all();
      consumer_sync(nt);
      // slot s is read: it takes the row R places later
      if (tid == 0 && n + kLogRing < len) mbar_arrive(&empty[s]);
    }
  }
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int l = tid + j * nt;
    if (l < lpad) {
      f0[row + l] = b0[j];
      f1[row + l] = b1[j];
    }
  }
}

struct LogFwdArgs {
  const float *blank_l, *dc_l, *pt_l, *nb, *rep;
  const int* lens;
  int tpad, lpad;
  float *sx, *sa1, *f0, *f1;
};

template <bool kResid, int LPT>
int launch_log_fwd(int lpt, int batch, cudaStream_t st, const LogFwdArgs& a) {
  if constexpr (LPT > kLogMaxLpt) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (lpt != LPT) return launch_log_fwd<kResid, LPT + 1>(lpt, batch, st, a);
    const size_t smem = log_fwd_smem_bytes(a.lpad);
    cudaFuncSetAttribute(classic_log_fwd_kernel<kResid, LPT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    classic_log_fwd_kernel<kResid, LPT><<<batch, strided_threads(a.lpad) + 32, smem, st>>>(
        a.blank_l, a.dc_l, a.pt_l, a.nb, a.rep, a.lens, a.tpad, a.lpad, a.sx, a.sa1,
        a.f0, a.f1);
    return (int)cudaGetLastError();
  }
}

struct LogBwdArgs {
  const float *blank_l, *dc_l, *pt_l, *nb, *rep;
  const int *lens, *lab_len;
  const float *loss, *sx, *sa1;
  int tpad, lpad;
  float *pc, *f0, *f1;
};

template <int LPT>
int launch_log_bwd(int lpt, int batch, cudaStream_t st, const LogBwdArgs& a) {
  if constexpr (LPT > kLogMaxLpt) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (lpt != LPT) return launch_log_bwd<LPT + 1>(lpt, batch, st, a);
    const size_t smem = log_bwd_smem_bytes(a.lpad);
    cudaFuncSetAttribute(classic_log_bwd_kernel<LPT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    classic_log_bwd_kernel<LPT><<<batch, strided_threads(a.lpad) + 32, smem, st>>>(
        a.blank_l, a.dc_l, a.pt_l, a.nb, a.rep, a.lens, a.lab_len, a.loss, a.sx, a.sa1,
        a.tpad, a.lpad, a.pc, a.f0, a.f1);
    return (int)cudaGetLastError();
  }
}

}  // namespace ctc

extern "C" {

size_t ctc_classic_log_fwd_smem_bytes(int lpad) {
  return ctc::log_fwd_smem_bytes(lpad);
}

size_t ctc_classic_log_bwd_smem_bytes(int lpad) {
  return ctc::log_bwd_smem_bytes(lpad);
}

// dc_l and pt_l 16-byte aligned (the wrapper checks)
int ctc_classic_log_fwd(const float* blank_l, const float* dc_l,
                        const float* pt_l, const float* nb, const float* rep,
                        const int* lens, int batch, int tpad, int lpad,
                        int resid, float* sx, float* sa1, float* f0, float* f1,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ctc::LogFwdArgs a{blank_l, dc_l, pt_l, nb, rep, lens, tpad, lpad, sx, sa1, f0, f1};
  const int lpt = ctc::lanes_per_thread(lpad);
  return resid ? ctc::launch_log_fwd<true, 1>(lpt, batch, st, a)
               : ctc::launch_log_fwd<false, 1>(lpt, batch, st, a);
}

// dc_l, pt_l, sx and sa1 16-byte aligned (the wrapper checks)
int ctc_classic_log_bwd(const float* blank_l, const float* dc_l,
                        const float* pt_l, const float* nb, const float* rep,
                        const int* lens, const int* lab_len, const float* loss,
                        const float* sx, const float* sa1, int batch, int tpad,
                        int lpad, float* pc, float* f0, float* f1,
                        void* stream) {
  const ctc::LogBwdArgs a{blank_l, dc_l, pt_l, nb, rep, lens, lab_len, loss, sx, sa1,
                          tpad, lpad, pc, f0, f1};
  return ctc::launch_log_bwd<1>(ctc::lanes_per_thread(lpad), batch,
                                static_cast<cudaStream_t>(stream), a);
}

}  // extern "C"
