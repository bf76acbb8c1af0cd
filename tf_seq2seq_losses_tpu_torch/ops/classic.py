"""Classic (Graves) CTC topology in pure log-space PyTorch.

Counterpart of ``tf_seq2seq_losses_tpu/ops/classic.py``.  The per-sample
lattice is ``[Lp1 prefix positions] x [2 states]``: state 0 is "closed"
(the last emission was a blank), state 1 is "open".  Appending a blank
closes a state; repeating the last token keeps an open state open; any
other label token moves diagonally to the open state of the next position.

This path is the CPU default, the guard's last resort and the port's own
oracle for the kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tf_seq2seq_losses_tpu_torch.ops.core import (
    CtcContext,
    expected_token_lp,
    select_from_act,
    take_token_logprobas,
)
from tf_seq2seq_losses_tpu_torch.utils.numerics import (
    apply_logarithmic_mask,
    logsumexp as _lse,
    logsumexp_jvp as _lse_jvp,
    reduce_logsumexp as _reduce_lse,
)

NEG_INF = float("-inf")


class ClassicTerms(NamedTuple):
    blank_lp: torch.Tensor  # [B, T] any -> closed
    prev_tok_masked: torch.Tensor  # [B, T, Lp1] open -> open, blank excluded
    prev_tok_plain: torch.Tensor  # [B, T, Lp1] preceding-label token log-prob
    diag_closed: torch.Tensor  # [B, T, Lp1] closed -> open diagonal
    diag_open: torch.Tensor  # [B, T, Lp1] open -> open diagonal, repeats masked


def terms(ctx: CtcContext) -> ClassicTerms:
    prev_tok_plain = take_token_logprobas(ctx.logproba, ctx.preceded_label)
    not_blank = ctx.preceded_label != ctx.blank_index
    prev_tok_masked = apply_logarithmic_mask(prev_tok_plain, not_blank[:, None, :])
    repetition_ok = ctx.label != torch.roll(ctx.label, shifts=1, dims=1)
    diag_closed = expected_token_lp(ctx)
    diag_open = apply_logarithmic_mask(diag_closed, repetition_ok[:, None, :])
    return ClassicTerms(
        blank_lp=ctx.blank_lp,
        prev_tok_masked=prev_tok_masked,
        prev_tok_plain=prev_tok_plain,
        diag_closed=diag_closed,
        diag_open=diag_open,
    )


def _alpha_init(batch: int, lp1: int, device) -> torch.Tensor:
    init = torch.full((batch, lp1, 2), NEG_INF, device=device)
    init[:, 0, 0] = 0.0
    return init


def _alpha_step(blank, prev_masked, d_closed, d_open, carry):
    a_closed = carry[..., 0]
    a_open = carry[..., 1]
    horiz_closed = _lse(a_closed, a_open) + blank[..., None]
    horiz_open = a_open + prev_masked
    diag = _lse(a_closed + d_closed, a_open + d_open)
    # the wrap lane is safe: position Lp1-1 is always masked to -inf
    diag = torch.roll(diag, shifts=1, dims=-1)
    return torch.stack([horiz_closed, _lse(horiz_open, diag)], dim=-1)


def alpha(ctx: CtcContext, t: ClassicTerms = None) -> torch.Tensor:
    """Forward lattice log-probabilities [B, T+1, Lp1, 2]."""
    if t is None:
        t = terms(ctx)
    return alpha_scan(t.blank_lp, t.prev_tok_masked, t.diag_closed, t.diag_open)


def alpha_scan(blank_lp, prev_tok_masked, diag_closed, diag_open) -> torch.Tensor:
    """The forward recursion over the terms of :func:`terms` (``blank_lp``
    [B, T], the others [B, T, Lp1]): [B, T+1, Lp1, 2].  The plain version
    of the kernel ``classic_alpha64`` (``ops/pure_scan.py``)."""
    batch, num_t, lp1 = diag_closed.shape
    carry = _alpha_init(batch, lp1, diag_closed.device)
    out = [carry]
    for k in range(num_t):
        carry = _alpha_step(
            blank_lp[:, k],
            prev_tok_masked[:, k],
            diag_closed[:, k],
            diag_open[:, k],
            carry,
        )
        out.append(carry)
    return torch.stack(out, dim=1)


def _beta_last(label_length: torch.Tensor, lp1: int, device) -> torch.Tensor:
    lanes = torch.arange(lp1, device=label_length.device)
    hot = lanes[None, :] == label_length[:, None]
    onehot = torch.where(
        hot,
        torch.zeros((), device=device),
        torch.full((), NEG_INF, device=device),
    )
    return torch.stack([onehot, onehot], dim=-1)


def _beta_step(blank, prev_masked, d_closed, d_open, carry):
    b_closed = carry[..., 0]
    b_open = carry[..., 1]
    horiz_closed = blank[:, None] + b_closed
    horiz_open = _lse(horiz_closed, prev_masked + b_open)
    b_open_next = torch.roll(b_open, shifts=-1, dims=1)
    new_closed = _lse(horiz_closed, d_closed + b_open_next)
    new_open = _lse(horiz_open, d_open + b_open_next)
    return torch.stack([new_closed, new_open], dim=-1)


def beta(ctx: CtcContext) -> torch.Tensor:
    """Backward lattice log-probabilities [B, T+1, Lp1, 2]."""
    t = terms(ctx)
    return beta_scan(t.blank_lp, t.prev_tok_masked, t.diag_closed, t.diag_open,
                     ctx.label_length)


def beta_scan(blank_lp, prev_tok_masked, diag_closed, diag_open,
              label_length) -> torch.Tensor:
    """The backward recursion over the terms of :func:`terms` from the
    one-hot at ``label_length`` [B]: [B, T+1, Lp1, 2].  The plain version
    of the kernel ``classic_beta64`` (``ops/pure_scan.py``)."""
    _, num_t, lp1 = diag_closed.shape
    carry = _beta_last(label_length, lp1, diag_closed.device)
    out = [carry]
    for k in range(num_t - 1, -1, -1):
        carry = _beta_step(
            blank_lp[:, k],
            prev_tok_masked[:, k],
            diag_closed[:, k],
            diag_open[:, k],
            carry,
        )
        out.append(carry)
    return torch.stack(out[::-1], dim=1)


def _alpha_step_jvp(blank, prev_masked, d_closed, d_open, carry, tangents):
    """:func:`_alpha_step` and its tangent: ``tangents`` holds those of the
    step's terms and of ``carry``, in that order."""
    t_blank, t_prev, t_dc, t_do, t_carry = tangents
    a_closed, a_open = carry[..., 0], carry[..., 1]
    ta_closed, ta_open = t_carry[..., 0], t_carry[..., 1]
    lse, t_lse = _lse_jvp(a_closed, a_open, ta_closed, ta_open)
    diag, t_diag = _lse_jvp(a_closed + d_closed, a_open + d_open,
                            ta_closed + t_dc, ta_open + t_do)
    opened, t_opened = _lse_jvp(a_open + prev_masked, torch.roll(diag, shifts=1, dims=-1),
                                ta_open + t_prev, torch.roll(t_diag, shifts=1, dims=-1))
    return (torch.stack([lse + blank[..., None], opened], dim=-1),
            torch.stack([t_lse + t_blank[..., None], t_opened], dim=-1))


def alpha_scan_jvp(blank_lp, prev_tok_masked, diag_closed, diag_open, t_blank_lp,
                   t_prev_tok_masked, t_diag_closed, t_diag_open):
    """:func:`alpha_scan` and its tangent for the terms' tangents ``t_*``:
    ``(alpha, tangent)``, each [B, T+1, Lp1, 2], the values and tangents
    that ``torch.func.jvp`` of :func:`alpha_scan` gives (the initial carry
    has a zero tangent; -inf entries keep the tangent their sums give).
    The plain version of the kernel ``classic_alpha_jvp64``
    (``ops/pure_scan.py``)."""
    batch, num_t, lp1 = diag_closed.shape
    carry = _alpha_init(batch, lp1, diag_closed.device).to(diag_closed.dtype)
    t_carry = torch.zeros_like(carry)
    out, t_out = [carry], [t_carry]
    for k in range(num_t):
        carry, t_carry = _alpha_step_jvp(
            blank_lp[:, k], prev_tok_masked[:, k], diag_closed[:, k], diag_open[:, k],
            carry, (t_blank_lp[:, k], t_prev_tok_masked[:, k], t_diag_closed[:, k],
                    t_diag_open[:, k], t_carry))
        out.append(carry)
        t_out.append(t_carry)
    return torch.stack(out, dim=1), torch.stack(t_out, dim=1)


def _beta_step_jvp(blank, prev_masked, d_closed, d_open, carry, tangents):
    """:func:`_beta_step` and its tangent (``tangents`` as in
    :func:`_alpha_step_jvp`)."""
    t_blank, t_prev, t_dc, t_do, t_carry = tangents
    b_closed, b_open = carry[..., 0], carry[..., 1]
    tb_closed, tb_open = t_carry[..., 0], t_carry[..., 1]
    h_closed, t_h_closed = blank[:, None] + b_closed, t_blank[:, None] + tb_closed
    h_open, t_h_open = _lse_jvp(h_closed, prev_masked + b_open, t_h_closed,
                                t_prev + tb_open)
    b_next = torch.roll(b_open, shifts=-1, dims=1)
    t_next = torch.roll(tb_open, shifts=-1, dims=1)
    closed, t_closed = _lse_jvp(h_closed, d_closed + b_next, t_h_closed, t_dc + t_next)
    opened, t_opened = _lse_jvp(h_open, d_open + b_next, t_h_open, t_do + t_next)
    return (torch.stack([closed, opened], dim=-1),
            torch.stack([t_closed, t_opened], dim=-1))


def beta_scan_jvp(blank_lp, prev_tok_masked, diag_closed, diag_open, t_blank_lp,
                  t_prev_tok_masked, t_diag_closed, t_diag_open, label_length):
    """:func:`beta_scan` and its tangent, as :func:`alpha_scan_jvp`: the
    plain version of the kernel ``classic_beta_jvp64``."""
    _, num_t, lp1 = diag_closed.shape
    carry = _beta_last(label_length, lp1, diag_closed.device).to(diag_closed.dtype)
    t_carry = torch.zeros_like(carry)
    out, t_out = [carry], [t_carry]
    for k in range(num_t - 1, -1, -1):
        carry, t_carry = _beta_step_jvp(
            blank_lp[:, k], prev_tok_masked[:, k], diag_closed[:, k], diag_open[:, k],
            carry, (t_blank_lp[:, k], t_prev_tok_masked[:, k], t_diag_closed[:, k],
                    t_diag_open[:, k], t_carry))
        out.append(carry)
        t_out.append(t_carry)
    return torch.stack(out[::-1], dim=1), torch.stack(t_out[::-1], dim=1)


def loss(ctx: CtcContext, alpha_tensor: torch.Tensor) -> torch.Tensor:
    """``-logsumexp_s alpha[:, T]`` picked at label_length."""
    params = _reduce_lse(alpha_tensor[:, -1], dim=-1)
    picked = torch.gather(params, 1, ctx.label_length[:, None])[:, 0]
    return -picked


def gamma(ctx: CtcContext) -> torch.Tensor:
    """Pairwise lattice transition log-probs
    [B, T+1, Lp1, 2, T+1, Lp1, 2]: identity at ``t1 == t2``, -inf for
    ``t1 > t2``.  O(T^2 L^2) memory: the Hessian's small-shape path."""
    t = terms(ctx)
    batch, num_t, _ = ctx.logproba.shape
    lp1 = ctx.label.shape[1]
    tp1 = num_t + 1
    device = ctx.logproba.device
    eye = torch.where(
        torch.eye(lp1 * 2, dtype=torch.bool, device=device),
        torch.zeros((), device=device),
        torch.full((), NEG_INF, device=device),
    ).reshape(1, 1, lp1, 2, lp1, 2)
    diagonal_gamma = eye.expand(batch, tp1, lp1, 2, lp1, 2)
    starts = torch.arange(tp1, device=device)

    carry = diagonal_gamma
    out = [carry]
    for i in range(num_t):
        g_closed = carry[..., 0]
        g_open = carry[..., 1]
        bl = t.blank_lp[:, i][:, None, None, None, None]
        horiz_closed = _lse(g_closed, g_open) + bl
        horiz_open = g_open + t.prev_tok_masked[:, i][:, None, None, None, :]
        diag = _lse(
            g_closed + t.diag_closed[:, i][:, None, None, None, :],
            g_open + t.diag_open[:, i][:, None, None, None, :],
        )
        diag = torch.roll(diag, shifts=1, dims=4)
        new = torch.stack([horiz_closed, _lse(horiz_open, diag)], dim=-1)
        started = (starts <= i)[None, :, None, None, None, None]
        carry = torch.where(started, new, diagonal_gamma)
        out.append(carry)
    full = torch.stack(out, dim=0)  # [t2, B, t1, l1, s1, l2, s2]
    full = full.permute(1, 2, 3, 4, 0, 5, 6)
    upper = (starts[:, None] <= starts[None, :])[None, :, None, None, :, None, None]
    return apply_logarithmic_mask(full, upper)


def combine(ctx: CtcContext, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Contract transition log-probs over the lattice into token bins.

    ``a``: [B, *DIMS_A, T, Lp1, 2];  ``b``: [B, T, Lp1, 2, *DIMS_B];
    returns [B, *DIMS_A, T, V, *DIMS_B].  The blank column is the
    horizontal blank term; the others are the logaddexp of the repeated-
    token horizontal term (scattered by the preceding label) and the
    diagonal term (scattered by the label).
    """
    t = terms(ctx)
    batch, num_t, num_tokens = ctx.logproba.shape
    lp1 = ctx.label.shape[1]
    dims_a = tuple(a.shape[1:-3])
    dims_b = tuple(b.shape[4:])
    a_dim = int(np.prod(dims_a, dtype=np.int64)) if dims_a else 1
    d_dim = int(np.prod(dims_b, dtype=np.int64)) if dims_b else 1
    a = a.reshape(batch, a_dim, num_t, lp1, 2)
    b = b.reshape(batch, num_t, lp1, 2, d_dim)
    b = torch.movedim(b, -1, 1)  # [B, D, T, Lp1, 2]

    a_any = _lse(a[..., 0], a[..., 1])  # [B, A, T, Lp1]
    b_closed = b[..., 0]
    b_open = b[..., 1]

    ab = a_any[:, :, None] + b_closed[:, None]  # [B, A, D, T, Lp1]
    blank_term = ctx.blank_lp[:, None, None] + _reduce_lse(ab, dim=-1)

    act_h = a[..., 1][:, :, None] + t.prev_tok_plain[:, None, None] + b_open[:, None]
    diag = _lse(a[..., 0] + t.diag_closed[:, None], a[..., 1] + t.diag_open[:, None])
    b_open_next = torch.roll(b_open, shifts=-1, dims=-1)
    act_d = diag[:, :, None] + b_open_next[:, None]

    def scatter(act, label):
        flat = act.reshape(batch, a_dim * d_dim, num_t, lp1)
        out = select_from_act(flat, label, num_tokens)
        return out.reshape(batch, a_dim, d_dim, num_t, num_tokens)

    non_blank = _lse(scatter(act_h, ctx.preceded_label), scatter(act_d, ctx.label))
    token_is_blank = torch.arange(num_tokens, device=a.device) == ctx.blank_index
    out = torch.where(token_is_blank, blank_term[..., None], non_blank)
    out = torch.movedim(out, 2, -1)  # [B, A, T, V, D]
    return out.reshape(batch, *dims_a, num_t, num_tokens, *dims_b)
