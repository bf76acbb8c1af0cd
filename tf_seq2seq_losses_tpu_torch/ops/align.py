"""Viterbi forced alignment over the CTC lattices, in PyTorch.

Counterpart of ``tf_seq2seq_losses_tpu/ops/align.py``: the alpha
recursions of the losses with ``max`` in place of ``logsumexp``, integer
argmax pointers kept per step, then a backtrack from the terminal state.
Python time loops on the ``[B, Lp1(, 2)]`` carry, as the pure loss path.

The pointers come from *strict* comparisons, as in the JAX package: the
lattices are full of ``-inf`` ties, and a ``>=`` would pick another of the
equally scored (impossible) predecessors and change the alignment.  They
are stored as int8, ``[T, B, Lp1]`` per state.

Conventions (those of the loss modules):

* classic: being in ``(l, open)`` after frame ``t`` means frame ``t``
  emitted (or repeated) ``label[l-1]``; ``closed`` means blank.  The
  emission depends only on the state.
* simplified: the edge determines the emission (horizontal = blank,
  diagonal into ``l`` = ``label[l-1]``), so the backtrack reads the stored
  pointer.
* frames at ``t >= logit_length`` and infeasible samples emit blank; an
  infeasible sample's ``path_logproba`` is ``-inf``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tf_seq2seq_losses_tpu_torch.ops.classic import terms as classic_terms
from tf_seq2seq_losses_tpu_torch.ops.core import CtcContext, expected_token_lp

NEG_INF = float("-inf")


def _final_state(v_last: torch.Tensor, label_length: torch.Tensor) -> torch.Tensor:
    """The terminal lattice value at ``l = label_length``."""
    rng = torch.arange(v_last.shape[0], device=v_last.device)
    return v_last[rng, label_length]


def _initial(ctx: CtcContext, states: Tuple[int, ...]) -> torch.Tensor:
    batch = ctx.logproba.shape[0]
    init = torch.full((batch, ctx.label.shape[1]) + states, NEG_INF,
                      device=ctx.logproba.device)
    init[(slice(None), 0) + (0,) * len(states)] = 0.0
    return init


def classic_viterbi(ctx: CtcContext) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(path_logproba [B], alignment [B, T] int32)`` through the classic
    lattice."""
    batch, num_t, _ = ctx.logproba.shape
    lp1 = ctx.label.shape[1]
    device = ctx.logproba.device
    t = classic_terms(ctx)

    carry = _initial(ctx, (2,))
    ptr_closed = torch.empty((num_t, batch, lp1), dtype=torch.int8, device=device)
    ptr_open = torch.empty((num_t, batch, lp1), dtype=torch.int8, device=device)
    for k in range(num_t):
        v_closed, v_open = carry[..., 0], carry[..., 1]
        # into (l, closed): blank from (l, closed) or (l, open)
        new_closed = torch.maximum(v_closed, v_open) + t.blank_lp[:, k, None]
        ptr_closed[k] = v_open > v_closed
        # into (l, open): horizontal repeat from (l, open), or diagonal from
        # (l-1, closed/open).  The roll's wrap is safe: position Lp1-1 is
        # -inf past label_length (as in the alpha recursion)
        horiz = v_open + t.prev_tok_masked[:, k]
        diag_c = v_closed + t.diag_closed[:, k]
        diag_o = v_open + t.diag_open[:, k]
        diag_best = torch.roll(torch.maximum(diag_c, diag_o), shifts=1, dims=1)
        diag_from_open = torch.roll((diag_o > diag_c).to(torch.int8), shifts=1, dims=1)
        ptr_open[k] = torch.where(diag_best > horiz, 1 + diag_from_open,
                                  torch.zeros_like(diag_from_open))
        carry = torch.stack([new_closed, torch.maximum(horiz, diag_best)], dim=-1)

    vf = _final_state(carry, ctx.label_length)  # [B, 2]
    cur_s = torch.argmax(vf, dim=1)  # the first maximum, as jnp.argmax
    path_lp = torch.amax(vf, dim=1)

    rng = torch.arange(batch, device=device)
    cur_l = ctx.label_length
    emits = torch.empty((batch, num_t), dtype=torch.int64, device=device)
    for k in range(num_t - 1, -1, -1):
        is_open = cur_s == 1
        emits[:, k] = torch.where(
            is_open, ctx.label[rng, torch.clamp(cur_l - 1, min=0)], ctx.blank_index)
        pc_here = ptr_closed[k][rng, cur_l].to(torch.int64)
        po_here = ptr_open[k][rng, cur_l].to(torch.int64)
        prev_s = torch.where(is_open, torch.where(po_here == 0, 1, po_here - 1), pc_here)
        prev_l = torch.where(is_open & (po_here > 0), cur_l - 1, cur_l)
        cur_l, cur_s = torch.clamp(prev_l, min=0), prev_s
    return _mask_alignment(ctx, path_lp, emits)


def simplified_viterbi(ctx: CtcContext) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(path_logproba [B], alignment [B, T] int32)`` through the
    simplified lattice (blank removal without collapse)."""
    batch, num_t, _ = ctx.logproba.shape
    lp1 = ctx.label.shape[1]
    device = ctx.logproba.device
    diag_lp = expected_token_lp(ctx)

    carry = _initial(ctx, ())
    ptrs = torch.empty((num_t, batch, lp1), dtype=torch.int8, device=device)
    for k in range(num_t):
        horiz = carry + ctx.blank_lp[:, k, None]
        diag = torch.roll(carry + diag_lp[:, k], shifts=1, dims=1)
        ptrs[k] = diag > horiz  # 1: diagonal, an emitted token
        carry = torch.maximum(horiz, diag)

    path_lp = _final_state(carry, ctx.label_length)
    rng = torch.arange(batch, device=device)
    cur_l = ctx.label_length
    emits = torch.empty((batch, num_t), dtype=torch.int64, device=device)
    for k in range(num_t - 1, -1, -1):
        took_diag = ptrs[k][rng, cur_l] == 1
        emits[:, k] = torch.where(
            took_diag, ctx.label[rng, torch.clamp(cur_l - 1, min=0)], ctx.blank_index)
        cur_l = torch.clamp(torch.where(took_diag, cur_l - 1, cur_l), min=0)
    return _mask_alignment(ctx, path_lp, emits)


def _mask_alignment(ctx: CtcContext, path_lp: torch.Tensor, alignment: torch.Tensor):
    """Blank out frames past logit_length and whole infeasible samples."""
    feasible = torch.isfinite(path_lp)
    alignment = torch.where(ctx.logit_length_mask & feasible[:, None], alignment,
                            ctx.blank_index)
    return path_lp, alignment.to(torch.int32)


VITERBI = {"classic": classic_viterbi, "simplified": simplified_viterbi}
