"""Simplified CTC topology in pure log-space PyTorch: blank removal without
the repeated-token merge.

Counterpart of ``tf_seq2seq_losses_tpu/ops/simplified.py``.  The lattice is
the ``Lp1`` prefix positions alone (no closed/open state axis): a
horizontal step is a blank emission, a diagonal step emits the next label
token.  The recursions are Python time loops on the ``[B, Lp1]`` carry.

This path is the CPU default, the guard's last resort and the port's own
oracle for the simplified kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from tf_seq2seq_losses_tpu_torch.ops.core import (
    CtcContext,
    expected_token_lp,
    select_from_act,
)
from tf_seq2seq_losses_tpu_torch.utils.numerics import (
    apply_logarithmic_mask,
    logsumexp as _lse,
    logsumexp_jvp as _lse_jvp,
    reduce_logsumexp as _reduce_lse,
)

NEG_INF = float("-inf")


def _alpha_init(batch: int, lp1: int, device) -> torch.Tensor:
    init = torch.full((batch, lp1), NEG_INF, device=device)
    init[:, 0] = 0.0
    return init


def _alpha_step(blank, diag_lp, carry):
    horizontal = carry + blank[:, None]
    # the wrap lane is safe: position Lp1-1 is always masked to -inf
    diag = torch.roll(carry + diag_lp, shifts=1, dims=1)
    return _lse(horizontal, diag)


def alpha(ctx: CtcContext, diag_lp: torch.Tensor = None) -> torch.Tensor:
    """Forward lattice log-probabilities [B, T+1, Lp1]; ``diag_lp`` is
    ``expected_token_lp(ctx)`` where the caller has it already."""
    if diag_lp is None:
        diag_lp = expected_token_lp(ctx)
    return alpha_scan(ctx.blank_lp, diag_lp)


def alpha_scan(blank_lp, diag_lp) -> torch.Tensor:
    """The forward recursion over ``blank_lp`` [B, T] and ``diag_lp`` [B, T,
    Lp1]: [B, T+1, Lp1].  The plain version of the kernel
    ``simplified_alpha64`` (``ops/pure_scan.py``)."""
    batch, num_t, lp1 = diag_lp.shape
    carry = _alpha_init(batch, lp1, diag_lp.device)
    out = [carry]
    for k in range(num_t):
        carry = _alpha_step(blank_lp[:, k], diag_lp[:, k], carry)
        out.append(carry)
    return torch.stack(out, dim=1)


def _beta_last(label_length: torch.Tensor, lp1: int, device) -> torch.Tensor:
    lanes = torch.arange(lp1, device=label_length.device)
    hot = lanes[None, :] == label_length[:, None]
    return torch.where(
        hot,
        torch.zeros((), device=device),
        torch.full((), NEG_INF, device=device),
    )


def _beta_step(blank, diag_lp, carry):
    horizontal = carry + blank[:, None]
    diag = diag_lp + torch.roll(carry, shifts=-1, dims=1)
    return _lse(horizontal, diag)


def beta(ctx: CtcContext) -> torch.Tensor:
    """Backward lattice log-probabilities [B, T+1, Lp1]."""
    return beta_scan(ctx.blank_lp, expected_token_lp(ctx), ctx.label_length)


def beta_scan(blank_lp, diag_lp, label_length) -> torch.Tensor:
    """The backward recursion over ``blank_lp`` and ``diag_lp`` from the
    one-hot at ``label_length`` [B]: [B, T+1, Lp1].  The plain version of
    the kernel ``simplified_beta64`` (``ops/pure_scan.py``)."""
    _, num_t, lp1 = diag_lp.shape
    carry = _beta_last(label_length, lp1, diag_lp.device)
    out = [carry]
    for k in range(num_t - 1, -1, -1):
        carry = _beta_step(blank_lp[:, k], diag_lp[:, k], carry)
        out.append(carry)
    return torch.stack(out[::-1], dim=1)


def alpha_scan_jvp(blank_lp, diag_lp, t_blank_lp, t_diag_lp):
    """:func:`alpha_scan` and its tangent for the tangents ``t_blank_lp``
    and ``t_diag_lp``: ``(alpha, tangent)``, each [B, T+1, Lp1], the values
    and tangents that ``torch.func.jvp`` of :func:`alpha_scan` gives (the
    initial carry has a zero tangent).  The plain version of the kernel
    ``simplified_alpha_jvp64`` (``ops/pure_scan.py``)."""
    batch, num_t, lp1 = diag_lp.shape
    carry = _alpha_init(batch, lp1, diag_lp.device).to(diag_lp.dtype)
    t_carry = torch.zeros_like(carry)
    out, t_out = [carry], [t_carry]
    for k in range(num_t):
        carry, t_carry = _lse_jvp(
            carry + blank_lp[:, k, None],
            torch.roll(carry + diag_lp[:, k], shifts=1, dims=1),
            t_carry + t_blank_lp[:, k, None],
            torch.roll(t_carry + t_diag_lp[:, k], shifts=1, dims=1))
        out.append(carry)
        t_out.append(t_carry)
    return torch.stack(out, dim=1), torch.stack(t_out, dim=1)


def beta_scan_jvp(blank_lp, diag_lp, t_blank_lp, t_diag_lp, label_length):
    """:func:`beta_scan` and its tangent, as :func:`alpha_scan_jvp`: the
    plain version of the kernel ``simplified_beta_jvp64``."""
    _, num_t, lp1 = diag_lp.shape
    carry = _beta_last(label_length, lp1, diag_lp.device).to(diag_lp.dtype)
    t_carry = torch.zeros_like(carry)
    out, t_out = [carry], [t_carry]
    for k in range(num_t - 1, -1, -1):
        carry, t_carry = _lse_jvp(
            carry + blank_lp[:, k, None],
            diag_lp[:, k] + torch.roll(carry, shifts=-1, dims=1),
            t_carry + t_blank_lp[:, k, None],
            t_diag_lp[:, k] + torch.roll(t_carry, shifts=-1, dims=1))
        out.append(carry)
        t_out.append(t_carry)
    return torch.stack(out[::-1], dim=1), torch.stack(t_out[::-1], dim=1)


def loss(ctx: CtcContext, alpha_tensor: torch.Tensor) -> torch.Tensor:
    """``-alpha[:, T]`` picked at label_length."""
    return -torch.gather(alpha_tensor[:, -1], 1, ctx.label_length[:, None])[:, 0]


def gamma(ctx: CtcContext) -> torch.Tensor:
    """Pairwise lattice transition log-probs [B, T+1, Lp1, T+1, Lp1]:
    identity at ``t1 == t2``, -inf for ``t1 > t2``.  O(T^2 L^2) memory: the
    Hessian's small-shape path."""
    batch, num_t, _ = ctx.logproba.shape
    lp1 = ctx.label.shape[1]
    tp1 = num_t + 1
    device = ctx.logproba.device
    diag_lp = expected_token_lp(ctx)
    eye = torch.where(
        torch.eye(lp1, dtype=torch.bool, device=device),
        torch.zeros((), device=device),
        torch.full((), NEG_INF, device=device),
    ).reshape(1, 1, lp1, lp1)
    diagonal_gamma = eye.expand(batch, tp1, lp1, lp1)
    starts = torch.arange(tp1, device=device)

    carry = diagonal_gamma
    out = [carry]
    for i in range(num_t):
        horizontal = carry + ctx.blank_lp[:, i][:, None, None, None]
        diag = torch.roll(carry + diag_lp[:, i][:, None, None, :], shifts=1, dims=3)
        new = _lse(horizontal, diag)
        started = (starts <= i)[None, :, None, None]
        carry = torch.where(started, new, diagonal_gamma)
        out.append(carry)
    full = torch.stack(out, dim=0)  # [t2, B, t1, l1, l2]
    full = full.permute(1, 2, 3, 0, 4)
    upper = (starts[:, None] <= starts[None, :])[None, :, None, :, None]
    return apply_logarithmic_mask(full, upper)


def combine(ctx: CtcContext, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Contract transition log-probs over the lattice into token bins.

    ``a``: [B, *DIMS_A, T, Lp1];  ``b``: [B, T, Lp1, *DIMS_B];
    returns [B, *DIMS_A, T, V, *DIMS_B].  The blank column is the blank
    emission over the whole lattice sum; the others are the diagonal term
    scattered by the label.
    """
    batch, num_t, num_tokens = ctx.logproba.shape
    lp1 = ctx.label.shape[1]
    dims_a = tuple(a.shape[1:-2])
    dims_b = tuple(b.shape[3:])
    a_dim = int(np.prod(dims_a, dtype=np.int64)) if dims_a else 1
    d_dim = int(np.prod(dims_b, dtype=np.int64)) if dims_b else 1
    a = a.reshape(batch, a_dim, num_t, lp1)
    b = b.reshape(batch, num_t, lp1, d_dim)
    b = torch.movedim(b, -1, 1)  # [B, D, T, Lp1]

    ab = a[:, :, None] + b[:, None]  # [B, A, D, T, Lp1]
    blank_term = ctx.blank_lp[:, None, None] + _reduce_lse(ab, dim=-1)

    b_next = torch.roll(b, shifts=-1, dims=-1)
    act_d = a[:, :, None] + expected_token_lp(ctx)[:, None, None] + b_next[:, None]
    flat = act_d.reshape(batch, a_dim * d_dim, num_t, lp1)
    non_blank = select_from_act(flat, ctx.label, num_tokens).reshape(
        batch, a_dim, d_dim, num_t, num_tokens
    )
    token_is_blank = torch.arange(num_tokens, device=a.device) == ctx.blank_index
    out = torch.where(token_is_blank, blank_term[..., None], non_blank)
    out = torch.movedim(out, 2, -1)  # [B, A, T, V, D]
    return out.reshape(batch, *dims_a, num_t, num_tokens, *dims_b)
