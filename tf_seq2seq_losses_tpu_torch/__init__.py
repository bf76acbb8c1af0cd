"""PyTorch and CUDA port of tf-seq2seq-losses-tpu: the classic and simplified
CTC losses with analytic gradients and Hessians, token posteriors, the
Hessian-vector product, forced alignment, alignment sampling, and greedy
and beam-search decoding.

On CUDA tensors the loss, its gradient and the posteriors run through
hand-written Hopper kernels (``csrc/``); on CPU tensors through the pure
log-space path.  The JAX package ``tf_seq2seq_losses_tpu`` is the
reference this port is tested against.

Beside the API: ``models`` (the flagship CTC encoder and the greedy
decoders), ``parallel`` (the rank mesh, the batch-sharded losses and the
data- and tensor-parallel training step over ``torch.distributed``),
``utils`` (kernel config, numerics, profiling, the debug guard and the
roofline model) and ``entry`` (the flagship forward and a multi-rank dry
run).
"""

from tf_seq2seq_losses_tpu_torch.api import (
    BaseCtcLossData,
    ClassicCtcLossData,
    SimplifiedCtcLossData,
    classic_ctc_loss,
    ctc_beam_search_decode,
    ctc_forced_alignment,
    ctc_greedy_decode,
    ctc_loss,
    ctc_loss_from_logproba,
    ctc_loss_gradient,
    ctc_loss_hessian,
    ctc_loss_hessian_vector_product,
    ctc_sample_alignments,
    ctc_token_posteriors,
    simplified_ctc_loss,
)

__version__ = "0.1.0"
__all__ = [
    "classic_ctc_loss",
    "simplified_ctc_loss",
    "ctc_loss",
    "ctc_loss_from_logproba",
    "ctc_loss_gradient",
    "ctc_loss_hessian",
    "ctc_loss_hessian_vector_product",
    "ctc_forced_alignment",
    "ctc_beam_search_decode",
    "ctc_greedy_decode",
    "ctc_token_posteriors",
    "ctc_sample_alignments",
    "BaseCtcLossData",
    "ClassicCtcLossData",
    "SimplifiedCtcLossData",
]
