"""Greedy CTC decoding for the two loss topologies.

Counterpart of ``tf_seq2seq_losses_tpu/models/decoding.py``: wrappers over
:func:`ops.decode.greedy_decode` that take raw logits (the arg-max is
invariant under log-softmax) and pad with ``blank_index`` instead of zero,
the contract of a training loop's validation decode.
"""

from __future__ import annotations

import torch

from tf_seq2seq_losses_tpu_torch.ops import core
from tf_seq2seq_losses_tpu_torch.ops.decode import greedy_decode as _greedy


def greedy_decode_classic(logits, logit_length, blank_index: int = 0):
    """Best-path decode with the classic collapse rule (``a_bb_ccc_c ->
    abcc``): merge repeats, then drop blanks.  Returns ``(tokens [B, T],
    length [B])``, int32, tokens left-aligned and padded with
    ``blank_index``."""
    return _decode(logits, logit_length, blank_index, merge_repeats=True)


def greedy_decode_simplified(logits, logit_length, blank_index: int = 0):
    """Best-path decode with the simplified rule (``a_bb_ccc_c ->
    abbcccc``): drop blanks only, no repeat merging."""
    return _decode(logits, logit_length, blank_index, merge_repeats=False)


def _decode(logits, logit_length, blank_index, merge_repeats):
    logits = core.values_tensor(logits)
    device = logits.device
    num_t = logits.shape[1]
    blank = torch.as_tensor(blank_index, device=device)
    tokens, length, _ = _greedy(logits, torch.as_tensor(logit_length, device=device),
                                blank, num_t, merge_repeats)
    pad = torch.arange(num_t, device=device)[None, :] >= length[:, None]
    return torch.where(pad, blank.to(torch.int32), tokens), length
