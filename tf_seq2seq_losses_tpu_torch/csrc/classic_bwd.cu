// Classic CTC beta scan over streamed alpha residuals (kernel B3), emitting
// the combined, loss-normalised act pc.
//
// Replaces tf_seq2seq_losses_tpu/ops/pallas_lattice.py:
// _classic_bwd_kernel_streamed (launched by _classic_bwd_call_streamed).
// The scan itself is in classic_bwd.cuh, which classic_bwd_half.cu shares.
//
// What bounds it on the H100: like the forward, a chain of 500 dependent
// steps per sample (shared-memory exchange plus a barrier each); its bytes
// (the transition stream and the [B, T, 2, L] residuals in, pc out) would
// take a few tens of microseconds at full HBM rate.  It is latency-bound.
#include "classic_bwd.cuh"

extern "C" {

size_t ctc_classic_bwd_smem_bytes(int lpad, int k_win) {
  return ctc::bwd_smem_bytes(lpad, k_win);
}

int ctc_classic_bwd_streamed(const float* blank, const float* dcu,
                             const float* lm, const float* nb, const float* rep,
                             const int* lens, const int* lab_len,
                             const float* ebi, const float* sa, const int* saf,
                             int batch, int tpad, int lpad, int k_win,
                             float* pc, float* f0, float* f1, int* fe,
                             void* stream) {
  const size_t smem = ctc::bwd_smem_bytes(lpad, k_win);
  const int threads = ctc::block_threads(lpad);
  cudaFuncSetAttribute(ctc::classic_bwd_streamed_kernel<false>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  ctc::classic_bwd_streamed_kernel<false><<<batch, threads, smem,
                                            static_cast<cudaStream_t>(stream)>>>(
      blank, dcu, lm, nb, rep, lens, lab_len, ebi, sa, saf, nullptr, tpad, lpad,
      k_win, pc, f0, f1, fe);
  return (int)cudaGetLastError();
}

}  // extern "C"
