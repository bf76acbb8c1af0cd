// Classic CTC beta scan over streamed alpha residuals (kernel B3), emitting
// the combined, loss-normalised act pc.
//
// Replaces tf_seq2seq_losses_tpu/ops/pallas_lattice.py:
// _classic_bwd_kernel_streamed (launched by _classic_bwd_call_streamed).
// The scan itself is in classic_bwd.cuh, which classic_bwd_half.cu shares;
// its head comment gives the design and what bounds it.  Each step's ring
// slot holds the transition row and the residual pair [a0, a1] of that
// step, 12 bytes a lane.
//
// What bounds it on the H100: a chain of up to 500 dependent steps per
// sample, each a barrier and a shared-memory exchange; its bytes (the
// transition stream and the [B, T, 2, L] residuals in, pc out) would take
// 0.086 ms at full HBM rate at the headline.  The parent design took
// 0.873 ms there, three quarters of it in the synchronous window staging;
// this one 0.32 ms, the step chain (H100 80GB HBM3, 700 W; the split is in
// classic_bwd.cuh).
#include "classic_bwd.cuh"

extern "C" {

size_t ctc_classic_bwd_smem_bytes(int lpad, int k_win) {
  return ctc::bwd_smem_bytes<false>(lpad, k_win);
}

// dcu and sa 16-byte aligned (the wrapper checks)
int ctc_classic_bwd_streamed(const float* blank, const float* dcu,
                             const float* lm, const float* nb, const float* rep,
                             const int* lens, const int* lab_len,
                             const float* ebi, const float* sa, const int* saf,
                             int batch, int tpad, int lpad, int k_win,
                             float* pc, float* f0, float* f1, int* fe,
                             void* stream) {
  const ctc::BwdArgs a{blank, dcu, lm, nb, rep, lens, lab_len, ebi, sa, saf,
                       nullptr, tpad, lpad, k_win, pc, f0, f1, fe};
  return ctc::launch_bwd<false, 1>(ctc::lanes_per_thread(lpad), batch,
                                   static_cast<cudaStream_t>(stream), a);
}

}  // extern "C"
