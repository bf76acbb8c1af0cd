// Exact log-space simplified CTC scans: the saturation guard's repair path
// for the simplified topology.
//
// simplified_log_fwd_kernel (B8) replaces
// tf_seq2seq_losses_tpu/ops/log_lattice.py:_simplified_log_fwd_kernel
// (launched by _simplified_log_fwd_call), modes "final" and "resid":
//   a'[l] = lae(a[l] + blank, (a + dg)[l - 1]).
// simplified_log_bwd_kernel (B9) replaces the inner kernel of
// tf_seq2seq_losses_tpu/ops/log_lattice.py:_simplified_log_grad_impl:
//   pd[t, l] = exp(loss + a[t, l] + dg[t, l] + b[l + 1]),
//   b'[l] = lae(blank + b[l], dg[t, l] + b[l + 1]).
//
// The carries are log-probabilities, so nothing can flush: these kernels
// recompute the rows whose block-float loss flushed to +inf.
//
// What bounds them on the H100: the dependent chain of steps, one barrier
// and one precise logaddexp (expf, log1pf) a step on it (the build passes
// no fast-math flag: the repair must hold 1e-5).  The bytes, the [B, T, L]
// stream of dg (and in the backward the residual a in, pd out), are a
// fraction of the time at the headline and nothing in a repair round of a
// few rows.  Latency-bound.  What bounded the parent design (one thread a
// lane, every per-lane value in shared memory, each chunk of 8 steps' rows
// loaded by strided loops between two barriers; H100 80GB HBM3, 700 W, CUDA
// events, tools/time_scans.py): at the headline (B=256, T=500, 256 lanes)
// B8 final took 0.340 ms, 0.136 with its chunk loads taken out and 0.221
// with its steps taken out; B8 resid 0.381, 0.151, 0.220; B9 0.422, 0.156,
// 0.269.  On a repair round (4 rows of the headline, 493 steps) 0.215 to
// 0.228 ms, of which the 62 synchronous chunk loads about 0.12: each a
// load's latency on the chain.  Nothing overlapped them.
//
// Design against that (classic_log.cu's, with one state):
// - One CTA per sample; the time loop stops at the sample's logit_length
//   (past it the carry sits at its forced-blank fixed point).
// - Staging runs ahead, asynchronously, off the step chain.  Each step's
//   rows (B8: dg_l[b, t] in ascending time; B9: dg_l and sa at [b, t] in
//   descending time) go to a ring of kSLogRing slots of shared memory, each
//   with a "full" mbarrier the bulk copies complete on and an "empty" one
//   the lanes release it on.  One thread of an extra, last warp, which
//   takes no part in the steps' barriers, issues each slot as bulk copies
//   (TMA, evict-first in L2) in the order the scan reads them: the first
//   kSLogRing rows at once, then each row kSLogRing places later as soon as
//   the slot's step has released it.  A step reads all it needs of its
//   slot before its barrier, so thread 0 releases the slot just after the
//   step's barrier.  The blanks come by 4-byte cp.async (rows of blank_l
//   are not 16-byte aligned) kSLogRun steps at a time, a run ahead, into
//   one of two slots.
// - A thread's lanes (t + j * threads, j < LPT, LPT a template parameter)
//   keep the carry (B8 a, B9 b) in registers.  Shared memory holds the ring
//   and the one value a neighbour needs, double-buffered, with one barrier
//   among the lane threads a step: B8's a + dg of lane l-1, B9's b of lane
//   l+1.
// - B8 forms a + blank, which needs no staged row, before it waits for the
//   step's slot.
// - B8's residual a, B9's pd and its zero fill past logit_length are
//   stored with the streaming hint: nothing here reads them back.
// Every floating-point expression keeps its operands and their order
// ((lo + a) + d + arr, lae(a + bl, arr), lae(bl + b, d + arr); -fmad=false,
// precise expf and log1pf), so both kernels write the parent's bits, and
// their plain versions' on the card.
//
// What bounds them now (the same card): at the headline B8 final 0.15 ms,
// B8 resid 0.17, B9 0.20, against byte bounds of 0.021, 0.042 and 0.063; on
// the repair round 0.13, 0.14 and 0.16 ms (0.26 to 0.32 us a step),
// against bounds under a microsecond: the chain.  The parent's steps on
// real rows (its first chunk staged once and reused) take 0.13 to 0.14 ms
// on the round and 0.14 to 0.17 at the headline: B8 sits on that chain, B9
// 0.02 to 0.03 ms above it.  (The split's "loads out" copy ran its steps
// on unwritten shared memory, which made them cheaper: 0.09 on the
// round.)  No help (each within 0.01 ms or slower): a ring of 16 or 32
// slots, each lane warp releasing its slot before the barrier, releasing
// it after B8's logaddexp, a relaxed arrival, testing the next step's slot
// right after the barrier and waiting only if it had not landed, B9
// forming bl + b and reading lane l+1's b before its wait, or taking its
// logaddexp before its act.  ptxas: 28 to 53 registers, no spills, at one
// to seven lanes a thread.
#include "blockfloat.cuh"
#include "stage.cuh"

namespace ctc {

constexpr int kSLogRing = 8;  // ring slots: rows staged ahead of the step
constexpr int kSLogRun = 8;   // steps whose blanks are staged at a time
// Lanes per thread: SIMPLIFIED_LOG_LANES (ops/log_lattice.py), the widest
// label the host sends these kernels, is 3200 lanes, seven a thread.
constexpr int kSLogMaxLpt = 7;

__host__ __device__ inline size_t slog_fwd_smem_bytes(int lpad) {
  // per lane: ring[R][dg], d[2]; blank[2][run]; two mbarriers per ring
  // slot (full, empty)
  return sizeof(float) * ((size_t)lpad * (kSLogRing + 2) + 2 * kSLogRun) +
         sizeof(uint64_t) * (2 * kSLogRing);
}

__host__ __device__ inline size_t slog_bwd_smem_bytes(int lpad) {
  // per lane: ring[R][dg, sa], b[2]; blank[2][run]; two mbarriers per ring
  // slot (full, empty)
  return sizeof(float) * ((size_t)lpad * (2 * kSLogRing + 2) + 2 * kSLogRun) +
         sizeof(uint64_t) * (2 * kSLogRing);
}

template <bool kResid, int LPT>
__global__ void __launch_bounds__(512 + 32, LPT <= 2 ? 2 : 1) simplified_log_fwd_kernel(
    const float* __restrict__ blank_l,  // [B, Tp] log blank prob
    const float* __restrict__ dg_l,     // [B, Tp, L] log p[label[l]], -inf masked
    const int* __restrict__ lens,       // [B]
    int tpad, int lpad,
    float* __restrict__ sa,             // [B, Tp, L] (resid)
    float* __restrict__ fo) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                  // [R, L]
  float* ds = ring + (size_t)kSLogRing * lpad;         // [2, L]
  float* blank_s = ds + 2 * lpad;                      // [2, run]
  uint64_t* full = reinterpret_cast<uint64_t*>(blank_s + 2 * kSLogRun);  // [R]
  uint64_t* empty = full + kSLogRing;                                    // [R]

  const int tid = threadIdx.x;
  const int nt = blockDim.x - 32;  // lane threads; the last warp stages
  const int b = blockIdx.x;
  const int len = lens[b];
  const int n_run = (len + kSLogRun - 1) / kSLogRun;
  const size_t row = (size_t)b * lpad;
  const uint32_t row_bytes = (uint32_t)lpad * sizeof(float);
  const float* dgb = dg_l + (size_t)b * tpad * lpad;

  auto issue_blank = [&](int r) {  // run r's blanks, into slot r mod 2
    const int t0 = r * kSLogRun;
    const int kend = min(kSLogRun, len - t0);
    for (int i = tid; i < kend; i += nt) {
      cp_async4(blank_s + (r & 1) * kSLogRun + i, blank_l + (size_t)b * tpad + t0 + i);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < 2 * kSLogRing; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  if (tid < nt && n_run > 0) issue_blank(0);
  cp_async_wait_all();
  __syncthreads();  // the last barrier of the whole CTA
  if (tid >= nt) {
    // the producer: step n's row into slot n mod R once step n - R
    // released it
    if (tid == nt && len > 0) {
      const uint64_t policy = evict_first_policy();
      for (int n = 0; n < len; ++n) {
        const int s = n % kSLogRing;
        if (n >= kSLogRing) {
          mbar_wait(&empty[s], (n / kSLogRing - 1) & 1);
          fence_proxy_async();
        }
        stage_row(ring + (size_t)s * lpad, dgb + (size_t)n * lpad, row_bytes, &full[s],
                  policy);
      }
    }
    return;
  }

  // own lanes: the carry
  float a[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) a[j] = tid + j * nt == 0 ? 0.0f : -INFINITY;

  int n = 0;  // the step, which is also its row's place in load order
  for (int r = 0; r < n_run; ++r) {
    const int t0 = r * kSLogRun;
    const int kend = min(kSLogRun, len - t0);
    const float* blank_r = blank_s + (r & 1) * kSLogRun;
    // the other slot's run was read before the barrier that ended it
    if (r + 1 < n_run) issue_blank(r + 1);
    for (int kk = 0; kk < kend; ++kk, ++n) {
      const int s = n % kSLogRing;
      // a + blank needs no staged row: wait for the slot after it
      const float bl = blank_r[kk];
      float ab[LPT];
#pragma unroll
      for (int j = 0; j < LPT; ++j) ab[j] = a[j] + bl;
      mbar_wait(&full[s], (n / kSLogRing) & 1);
      const float* dw = ring + (size_t)s * lpad;
      float* dnow = ds + (n & 1) * lpad;
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int l = tid + j * nt;
        if (l < lpad) {
          if (kResid) __stcs(sa + ((size_t)b * tpad + t0 + kk) * lpad + l, a[j]);
          dnow[l] = a[j] + dw[l];
        }
      }
      // the next run's blanks land before the barrier that ends this run
      if (kk == kend - 1) cp_async_wait_all();
      consumer_sync(nt);
      // slot s is read: it takes the row R places later
      if (tid == 0 && n + kSLogRing < len) mbar_arrive(&empty[s]);
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int l = tid + j * nt;
        if (l < lpad) {
          const float arr = l == 0 ? -INFINITY : dnow[l - 1];
          a[j] = lae(ab[j], arr);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int l = tid + j * nt;
    if (l < lpad) fo[row + l] = a[j];
  }
}

template <int LPT>
__global__ void __launch_bounds__(512 + 32, LPT <= 2 ? 2 : 1) simplified_log_bwd_kernel(
    const float* __restrict__ blank_l,  // [B, Tp]
    const float* __restrict__ dg_l,     // [B, Tp, L]
    const int* __restrict__ lens,       // [B]
    const int* __restrict__ lab_len,    // [B]
    const float* __restrict__ loss,     // [B] finite-masked loss
    const float* __restrict__ sa,       // [B, Tp, L] log alpha
    int tpad, int lpad,
    float* __restrict__ pd,             // [B, Tp, L]
    float* __restrict__ fo) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                  // [R, 2, L]
  float* bs = ring + (size_t)kSLogRing * 2 * lpad;     // [2, L]
  float* blank_s = bs + 2 * lpad;                      // [2, run]
  uint64_t* full = reinterpret_cast<uint64_t*>(blank_s + 2 * kSLogRun);  // [R]
  uint64_t* empty = full + kSLogRing;                                    // [R]

  const int tid = threadIdx.x;
  const int nt = blockDim.x - 32;  // lane threads; the last warp stages
  const int b = blockIdx.x;
  const int len = lens[b];
  const int ll = lab_len[b];
  const float lo = loss[b];
  const int n_run = (len + kSLogRun - 1) / kSLogRun;
  const size_t row = (size_t)b * lpad;
  const uint32_t row_bytes = (uint32_t)lpad * sizeof(float);
  const size_t cell0 = (size_t)b * tpad * lpad;
  float* pdb = pd + cell0;

  auto issue_blank = [&](int r, int slot) {  // run r's blanks
    const int t0 = r * kSLogRun;
    const int kend = min(kSLogRun, len - t0);
    for (int i = tid; i < kend; i += nt) {
      cp_async4(blank_s + slot * kSLogRun + i, blank_l + (size_t)b * tpad + t0 + i);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < 2 * kSLogRing; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  // own lanes: the beta carry (one-hot at label_length, the forced-blank
  // fixed point), also to the exchange the first step reads
  float bv[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int l = tid + j * nt;
    bv[j] = l == ll ? 0.0f : -INFINITY;
    if (tid < nt && l < lpad) bs[l] = bv[j];
  }
  if (tid < nt) {
    if (n_run > 0) issue_blank(n_run - 1, 0);
    // acts past logit_length are zero
    for (size_t i = (size_t)len * lpad + tid; i < (size_t)tpad * lpad; i += nt) {
      __stcs(pdb + i, 0.0f);
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
        const int s = n % kSLogRing;
        if (n >= kSLogRing) {
          mbar_wait(&empty[s], (n / kSLogRing - 1) & 1);
          fence_proxy_async();
        }
        const size_t o = cell0 + (size_t)(len - 1 - n) * lpad;
        float* dst = ring + (size_t)s * 2 * lpad;
        mbar_expect_tx(&full[s], 2 * row_bytes);
        bulk_load(dst, dg_l + o, row_bytes, &full[s], policy);
        bulk_load(dst + lpad, sa + o, row_bytes, &full[s], policy);
      }
    }
    return;
  }

  int n = 0;  // the step's place in load order
  for (int ri = 0; ri < n_run; ++ri) {
    const int r = n_run - 1 - ri;
    const int t0 = r * kSLogRun;
    const int kend = min(kSLogRun, len - t0);
    const float* blank_r = blank_s + (ri & 1) * kSLogRun;
    // the other slot's run was read before the barrier that ended it
    if (ri + 1 < n_run) issue_blank(r - 1, (ri + 1) & 1);
    for (int kk = kend - 1; kk >= 0; --kk, ++n) {
      const int s = n % kSLogRing;
      mbar_wait(&full[s], (n / kSLogRing) & 1);
      const float* dw = ring + (size_t)s * 2 * lpad;
      const float* aw = dw + lpad;
      const float bl = blank_r[kk];
      const float* bnow = bs + (n & 1) * lpad;
      float* bnext = bs + ((n & 1) ^ 1) * lpad;
      float* pdt = pdb + (size_t)(t0 + kk) * lpad;
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int l = tid + j * nt;
        if (l < lpad) {
          const float arr = l + 1 >= lpad ? -INFINITY : bnow[l + 1];
          const float d = dw[l];
          __stcs(pdt + l, expf(lo + aw[l] + d + arr));
          bv[j] = lae(bl + bv[j], d + arr);
          bnext[l] = bv[j];
        }
      }
      // the next run's blanks land before the barrier that ends this run
      if (kk == 0) cp_async_wait_all();
      consumer_sync(nt);
      // slot s is read: it takes the row R places later
      if (tid == 0 && n + kSLogRing < len) mbar_arrive(&empty[s]);
    }
  }
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int l = tid + j * nt;
    if (l < lpad) fo[row + l] = bv[j];
  }
}

struct SLogFwdArgs {
  const float *blank_l, *dg_l;
  const int* lens;
  int tpad, lpad;
  float *sa, *fo;
};

template <bool kResid, int LPT>
int launch_slog_fwd(int lpt, int batch, cudaStream_t st, const SLogFwdArgs& a) {
  if constexpr (LPT > kSLogMaxLpt) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (lpt != LPT) return launch_slog_fwd<kResid, LPT + 1>(lpt, batch, st, a);
    const size_t smem = slog_fwd_smem_bytes(a.lpad);
    cudaFuncSetAttribute(simplified_log_fwd_kernel<kResid, LPT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    simplified_log_fwd_kernel<kResid, LPT><<<batch, strided_threads(a.lpad) + 32, smem, st>>>(
        a.blank_l, a.dg_l, a.lens, a.tpad, a.lpad, a.sa, a.fo);
    return (int)cudaGetLastError();
  }
}

struct SLogBwdArgs {
  const float *blank_l, *dg_l;
  const int *lens, *lab_len;
  const float *loss, *sa;
  int tpad, lpad;
  float *pd, *fo;
};

template <int LPT>
int launch_slog_bwd(int lpt, int batch, cudaStream_t st, const SLogBwdArgs& a) {
  if constexpr (LPT > kSLogMaxLpt) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (lpt != LPT) return launch_slog_bwd<LPT + 1>(lpt, batch, st, a);
    const size_t smem = slog_bwd_smem_bytes(a.lpad);
    cudaFuncSetAttribute(simplified_log_bwd_kernel<LPT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    simplified_log_bwd_kernel<LPT><<<batch, strided_threads(a.lpad) + 32, smem, st>>>(
        a.blank_l, a.dg_l, a.lens, a.lab_len, a.loss, a.sa, a.tpad, a.lpad, a.pd, a.fo);
    return (int)cudaGetLastError();
  }
}

}  // namespace ctc

extern "C" {

size_t ctc_simplified_log_fwd_smem_bytes(int lpad) {
  return ctc::slog_fwd_smem_bytes(lpad);
}

size_t ctc_simplified_log_bwd_smem_bytes(int lpad) {
  return ctc::slog_bwd_smem_bytes(lpad);
}

// dg_l 16-byte aligned (the wrapper checks)
int ctc_simplified_log_fwd(const float* blank_l, const float* dg_l,
                           const int* lens, int batch, int tpad, int lpad,
                           int resid, float* sa, float* fo, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ctc::SLogFwdArgs a{blank_l, dg_l, lens, tpad, lpad, sa, fo};
  const int lpt = ctc::lanes_per_thread(lpad);
  return resid ? ctc::launch_slog_fwd<true, 1>(lpt, batch, st, a)
               : ctc::launch_slog_fwd<false, 1>(lpt, batch, st, a);
}

// dg_l and sa 16-byte aligned (the wrapper checks)
int ctc_simplified_log_bwd(const float* blank_l, const float* dg_l,
                           const int* lens, const int* lab_len,
                           const float* loss, const float* sa, int batch,
                           int tpad, int lpad, float* pd, float* fo,
                           void* stream) {
  const ctc::SLogBwdArgs a{blank_l, dg_l, lens, lab_len, loss, sa, tpad, lpad, pd, fo};
  return ctc::launch_slog_bwd<1>(ctc::lanes_per_thread(lpad), batch,
                                 static_cast<cudaStream_t>(stream), a);
}

}  // extern "C"
