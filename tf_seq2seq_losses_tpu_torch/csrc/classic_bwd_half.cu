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
// then runs B3's beta and act step (classic_bwd.cuh, whose head comment
// gives the design), so pc and the beta carry equal B3's on the same
// forward bit for bit.  A ring slot holds a step's transition row and a1,
// 8 bytes a lane; the window's rebuilt a0 takes K floats a lane more, so
// below window 16 it holds more lanes than B3 (1856 against 1792 at 8).
//
// What bounds it on the H100: B3's chain of dependent steps; it reads
// (1 + 1/K) / 2 of B3's residual mantissa bytes (a 0.068 ms byte bound at
// the headline).  The parent design took 0.711 ms there, three quarters of
// it in the synchronous window staging; this one 0.39 ms, B3's step chain
// plus the rebuild and the wait for a window's rows at its open (H100 80GB
// HBM3, 700 W; the split is in classic_bwd.cuh).
#include "classic_bwd.cuh"

extern "C" {

size_t ctc_classic_bwd_half_smem_bytes(int lpad, int k_win) {
  return ctc::bwd_smem_bytes<true>(lpad, k_win);
}

// dcu, a1 and a0w 16-byte aligned (the wrapper checks)
int ctc_classic_bwd_half(const float* blank, const float* dcu, const float* lm,
                         const float* nb, const float* rep, const int* lens,
                         const int* lab_len, const float* ebi, const float* a1,
                         const int* saf, const float* a0w, int batch, int tpad,
                         int lpad, int k_win, float* pc, float* f0, float* f1,
                         int* fe, void* stream) {
  const ctc::BwdArgs a{blank, dcu, lm, nb, rep, lens, lab_len, ebi, a1, saf,
                       a0w, tpad, lpad, k_win, pc, f0, f1, fe};
  return ctc::launch_bwd<true, 1>(ctc::lanes_per_thread(lpad), batch,
                                  static_cast<cudaStream_t>(stream), a);
}

}  // extern "C"
