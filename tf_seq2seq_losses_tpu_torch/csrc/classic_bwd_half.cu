// Classic CTC beta scan over the half-stream residuals (kernel B13),
// emitting the combined, loss-normalised act pc.
//
// Replaces tf_seq2seq_losses_tpu/ops/pallas_lattice.py:
// _classic_bwd_kernel_half (launched by _classic_bwd_call_half).  Its
// residuals are classic_fwd.cu mode "resid1": the open mantissas a1 of every
// step, the window frames and a0 at each window's first step, already in
// that window's frame (the port's layout; the TPU kernel kept a0 at each
// time-block boundary and rescaled it window by window from the frames).
// Each window rebuilds a0 from there with the forward's own operations and
// then runs B3's beta and act step (classic_bwd.cuh), so pc and the beta
// carry equal B3's on the same forward bit for bit.
//
// What bounds it on the H100: B3's chain of dependent steps, shared-memory
// exchanges and barriers (latency-bound); it reads (1 + 1/K) / 2 of B3's
// residual mantissa bytes, and its shared memory is B3's, so it holds B3's
// lanes.
#include "classic_bwd.cuh"

extern "C" {

size_t ctc_classic_bwd_half_smem_bytes(int lpad, int k_win) {
  return ctc::bwd_smem_bytes(lpad, k_win);
}

int ctc_classic_bwd_half(const float* blank, const float* dcu, const float* lm,
                         const float* nb, const float* rep, const int* lens,
                         const int* lab_len, const float* ebi, const float* a1,
                         const int* saf, const float* a0w, int batch, int tpad,
                         int lpad, int k_win, float* pc, float* f0, float* f1,
                         int* fe, void* stream) {
  const size_t smem = ctc::bwd_smem_bytes(lpad, k_win);
  const int threads = ctc::block_threads(lpad);
  cudaFuncSetAttribute(ctc::classic_bwd_streamed_kernel<true>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  ctc::classic_bwd_streamed_kernel<true><<<batch, threads, smem,
                                           static_cast<cudaStream_t>(stream)>>>(
      blank, dcu, lm, nb, rep, lens, lab_len, ebi, a1, saf, a0w, tpad, lpad, k_win,
      pc, f0, f1, fe);
  return (int)cudaGetLastError();
}

}  // extern "C"
