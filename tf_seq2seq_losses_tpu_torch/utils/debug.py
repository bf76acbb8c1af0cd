"""Debugging guard: a CTC loss that reports invalid inputs and results.

Counterpart of ``tf_seq2seq_losses_tpu/utils/debug.py``, whose
``checked_ctc_loss`` runs under ``jax.experimental.checkify``.  Here the
four checks reduce to booleans on the loss's device and the host reads
them once, after the loss: the first failed check, in the reference's
order, is the error.  Use in tests and debugging; the production path
stays unchecked.
"""

from __future__ import annotations

from typing import Optional

import torch

from tf_seq2seq_losses_tpu_torch import api
from tf_seq2seq_losses_tpu_torch.ops import core

LOSS_TOLERANCE = 1e-4  # a loss is -log P >= 0; rounding may dip below 0
_MESSAGES = (
    "NaN in logits",
    "negative length",
    "NaN loss (library bug?)",
    "negative loss (library bug?)",
)


class CheckError(RuntimeError):
    """Raised by :meth:`Error.throw` when a check failed."""


class Error:
    """The outcome of the checks, as checkify's error object: ``get()`` is
    the first failed check's message or ``None``; ``throw()`` raises
    :class:`CheckError` with it."""

    def __init__(self, message: Optional[str]):
        self._message = message

    def get(self) -> Optional[str]:
        return self._message

    def throw(self) -> None:
        if self._message is not None:
            raise CheckError(self._message)


def checked_ctc_loss(
    labels,
    logits,
    label_length,
    logit_length,
    blank_index=0,
    topology: str = "classic",
):
    """CTC loss with runtime validity checks; returns ``(error, loss)``.

    The checks: no NaN in ``logits``, no negative length, no NaN loss, no
    loss below ``-1e-4``.  A row with a negative length has no loss: the
    loss is computed at length 0 there, and the error says so."""
    logits = core.values_tensor(logits)
    label_length = torch.as_tensor(label_length, device=logits.device)
    logit_length = torch.as_tensor(logit_length, device=logits.device)
    ok_logits = ~torch.isnan(logits).any()
    ok_lengths = (label_length >= 0).all() & (logit_length >= 0).all()
    loss = api.ctc_loss(labels, logits, label_length.clamp(min=0),
                        logit_length.clamp(min=0), blank_index, topology)
    ok_loss = ~torch.isnan(loss).any()
    ok_sign = (loss >= -LOSS_TOLERANCE).all()
    passed = torch.stack([ok_logits, ok_lengths, ok_loss, ok_sign]).tolist()
    failed = [msg for msg, ok in zip(_MESSAGES, passed) if not ok]
    return Error(failed[0] if failed else None), loss
