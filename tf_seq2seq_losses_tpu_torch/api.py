"""Public API of the PyTorch port: the classic and simplified CTC losses and
their analytic derivatives.

Signatures follow ``tf_seq2seq_losses_tpu/api.py`` (the ``tf.nn.ctc_loss``
argument order with batch-major tensors).  Every function computes on the
device of ``logits``/``logprobas``: the CUDA kernels for CUDA tensors, the
pure log-space path for CPU tensors (see ``utils/config.py``).  Logits that
are not a tensor (a numpy array, a list) go to the current CUDA device, as
the JAX package puts them on its accelerator; without a CUDA device they
raise ``ValueError``: pass a CPU tensor to compute on the CPU.
"""

from __future__ import annotations

from functools import cached_property
from typing import Union

import torch

from tf_seq2seq_losses_tpu_torch.ops import core as _core
from tf_seq2seq_losses_tpu_torch.ops.autodiff import (
    Gradient,
    Hessian,
    Loss,
    LossFromLogits,
)
from tf_seq2seq_losses_tpu_torch.ops.topology import TOPOLOGIES, Topology

IntLike = Union[int, torch.Tensor]


def _check_topology(topology: str) -> Topology:
    if topology not in TOPOLOGIES:
        raise ValueError(
            f"unknown topology {topology!r}; expected one of {sorted(TOPOLOGIES)}"
        )
    return TOPOLOGIES[topology]


def ctc_loss_from_logproba(
    labels, logprobas, label_length, logit_length, blank_index: IntLike,
    topology: str = "classic",
) -> torch.Tensor:
    """CTC loss treating log-probabilities as free parameters; the first
    derivative is the analytic gradient, the second the analytic Hessian,
    a third raises."""
    topo = _check_topology(topology)
    return Loss.apply(_core.values_tensor(logprobas), labels, label_length,
                      logit_length, blank_index, topo)


def ctc_loss(
    labels, logits, label_length, logit_length, blank_index: IntLike,
    topology: str = "classic",
) -> torch.Tensor:
    """CTC loss from logits [B, T, V]; reduced-precision logits compute in
    float32 (the gradient comes back in the input dtype)."""
    topo = _check_topology(topology)
    logits = _core.values_tensor(logits)
    if logits.ndim != 3:
        raise ValueError(
            f"logits must be rank 3 [batch, time, vocab], got shape {tuple(logits.shape)}"
        )
    return LossFromLogits.apply(logits.to(torch.float32), labels, label_length,
                                logit_length, blank_index, topo)


def classic_ctc_loss(
    labels, logits, label_length, logit_length, blank_index: IntLike = 0
) -> torch.Tensor:
    """Classic (Graves) CTC loss: repeated non-blank labels merge on decode.
    Infeasible samples get ``+inf`` loss and a zero gradient."""
    return ctc_loss(labels, logits, label_length, logit_length, blank_index, "classic")


def simplified_ctc_loss(
    labels, logits, label_length, logit_length, blank_index: IntLike = 0
) -> torch.Tensor:
    """Simplified CTC loss: blanks removed, no repeated-token merge
    (``a_bb_ccc_c -> abbccccc``).  Infeasible samples (label longer than
    logits) get ``+inf`` loss and a zero gradient."""
    return ctc_loss(labels, logits, label_length, logit_length, blank_index,
                    "simplified")


def ctc_loss_gradient(
    labels, logprobas, label_length, logit_length, blank_index: IntLike,
    topology: str = "classic",
) -> torch.Tensor:
    """Analytic loss gradient w.r.t. ``logprobas``."""
    topo = _check_topology(topology)
    return Gradient.apply(_core.values_tensor(logprobas), labels, label_length,
                          logit_length, blank_index, topo, None)


def ctc_loss_hessian(
    labels, logprobas, label_length, logit_length, blank_index: IntLike,
    topology: str = "classic",
) -> torch.Tensor:
    """Analytic Hessian [B, T, V, T, V] w.r.t. ``logprobas`` (small shapes:
    O(T^2 L^2) memory)."""
    topo = _check_topology(topology)
    return Hessian.apply(_core.values_tensor(logprobas), labels, label_length,
                         logit_length, blank_index, topo)


class BaseCtcLossData:
    """Eager, cached view over the functional core for one input batch:
    ``.alpha``, ``.beta``, ``.gamma``, ``.loss``, ``.gradient``,
    ``.hessian`` and ``.logarithmic_logproba_gradient`` (pure path).  The
    topology is the subclass's ``_topology_name``."""

    _topology_name = "classic"

    def __init__(self, labels, logprobas, label_length, logit_length,
                 blank_index: IntLike = 0):
        self._topology = _check_topology(self._topology_name)
        self._ctx = _core.make_context(
            labels, logprobas, label_length, logit_length, blank_index
        )

    @cached_property
    def alpha(self) -> torch.Tensor:
        return self._topology.alpha(self._ctx)

    @cached_property
    def beta(self) -> torch.Tensor:
        return self._topology.beta(self._ctx)

    @cached_property
    def gamma(self) -> torch.Tensor:
        return self._topology.gamma(self._ctx)

    @cached_property
    def loss(self) -> torch.Tensor:
        return self._topology.loss(self._ctx, self.alpha)

    @cached_property
    def logarithmic_logproba_gradient(self) -> torch.Tensor:
        return _core.gradient_log(self._topology, self._ctx, self.loss)

    @cached_property
    def gradient(self) -> torch.Tensor:
        return -torch.exp(self.logarithmic_logproba_gradient)

    @cached_property
    def hessian(self) -> torch.Tensor:
        return _core.hessian(self._topology, self._ctx, self.loss)


class ClassicCtcLossData(BaseCtcLossData):
    """Classic topology data object."""

    _topology_name = "classic"


class SimplifiedCtcLossData(BaseCtcLossData):
    """Simplified topology data object."""

    _topology_name = "simplified"
