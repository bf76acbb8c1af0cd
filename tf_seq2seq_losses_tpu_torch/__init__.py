"""PyTorch and CUDA port of tf-seq2seq-losses-tpu: the classic and simplified
CTC losses with analytic gradients and Hessians.

On CUDA tensors the loss and its gradient run through hand-written Hopper
kernels (``csrc/``); on CPU tensors through the pure log-space path.  The
JAX package ``tf_seq2seq_losses_tpu`` is the reference this port is tested
against.
"""

from tf_seq2seq_losses_tpu_torch.api import (
    BaseCtcLossData,
    ClassicCtcLossData,
    SimplifiedCtcLossData,
    classic_ctc_loss,
    ctc_loss,
    ctc_loss_from_logproba,
    ctc_loss_gradient,
    ctc_loss_hessian,
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
    "BaseCtcLossData",
    "ClassicCtcLossData",
    "SimplifiedCtcLossData",
]
