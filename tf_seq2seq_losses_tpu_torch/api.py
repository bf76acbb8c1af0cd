"""Public API of the PyTorch port: the classic CTC loss and its analytic
derivatives.

Signatures follow ``tf_seq2seq_losses_tpu/api.py`` (the ``tf.nn.ctc_loss``
argument order with batch-major tensors).  Every function computes on the
device of ``logits``/``logprobas``: the CUDA kernels for CUDA tensors, the
pure log-space path for CPU tensors (see ``utils/config.py``).
"""

from __future__ import annotations

from functools import cached_property
from typing import Union

import numpy as np
import torch

from tf_seq2seq_losses_tpu_torch.ops import core as _core
from tf_seq2seq_losses_tpu_torch.ops.autodiff import (
    Gradient,
    Hessian,
    Loss,
    LossFromLogits,
)
from tf_seq2seq_losses_tpu_torch.ops.topology import CLASSIC

IntLike = Union[int, torch.Tensor]
_TOPOLOGIES = ("classic", "simplified")


def _check_topology(topology: str) -> None:
    if topology not in _TOPOLOGIES:
        raise ValueError(
            f"unknown topology {topology!r}; expected one of {sorted(_TOPOLOGIES)}"
        )
    if topology == "simplified":
        raise NotImplementedError(
            "the simplified topology is not ported yet (ROADMAP A10)"
        )


def _tensor(x) -> torch.Tensor:
    """Values as a tensor; labels, lengths and blank may be tensors, arrays
    or ints, and ``make_context`` moves them to the values' device."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def ctc_loss_from_logproba(
    labels, logprobas, label_length, logit_length, blank_index: IntLike,
    topology: str = "classic",
) -> torch.Tensor:
    """CTC loss treating log-probabilities as free parameters; the first
    derivative is the analytic gradient, the second the analytic Hessian,
    a third raises."""
    _check_topology(topology)
    return Loss.apply(_tensor(logprobas), labels, label_length, logit_length,
                      blank_index)


def ctc_loss(
    labels, logits, label_length, logit_length, blank_index: IntLike,
    topology: str = "classic",
) -> torch.Tensor:
    """CTC loss from logits [B, T, V]; reduced-precision logits compute in
    float32 (the gradient comes back in the input dtype)."""
    _check_topology(topology)
    logits = _tensor(logits)
    if logits.ndim != 3:
        raise ValueError(
            f"logits must be rank 3 [batch, time, vocab], got shape {tuple(logits.shape)}"
        )
    return LossFromLogits.apply(logits.to(torch.float32), labels, label_length,
                                logit_length, blank_index)


def classic_ctc_loss(
    labels, logits, label_length, logit_length, blank_index: IntLike = 0
) -> torch.Tensor:
    """Classic (Graves) CTC loss: repeated non-blank labels merge on decode.
    Infeasible samples get ``+inf`` loss and a zero gradient."""
    return ctc_loss(labels, logits, label_length, logit_length, blank_index, "classic")


def ctc_loss_gradient(
    labels, logprobas, label_length, logit_length, blank_index: IntLike,
    topology: str = "classic",
) -> torch.Tensor:
    """Analytic loss gradient w.r.t. ``logprobas``."""
    _check_topology(topology)
    return Gradient.apply(_tensor(logprobas), labels, label_length, logit_length,
                          blank_index, None)


def ctc_loss_hessian(
    labels, logprobas, label_length, logit_length, blank_index: IntLike,
    topology: str = "classic",
) -> torch.Tensor:
    """Analytic Hessian [B, T, V, T, V] w.r.t. ``logprobas`` (small shapes:
    O(T^2 L^2) memory)."""
    _check_topology(topology)
    return Hessian.apply(_tensor(logprobas), labels, label_length, logit_length,
                         blank_index)


class BaseCtcLossData:
    """Eager, cached view over the functional core for one input batch:
    ``.alpha``, ``.beta``, ``.gamma``, ``.loss``, ``.gradient``,
    ``.hessian`` and ``.logarithmic_logproba_gradient`` (pure path)."""

    _topology_name = "classic"

    def __init__(self, labels, logprobas, label_length, logit_length,
                 blank_index: IntLike = 0):
        _check_topology(self._topology_name)
        self._topology = CLASSIC
        self._ctx = _core.make_context(
            labels, _tensor(logprobas), label_length, logit_length, blank_index
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
