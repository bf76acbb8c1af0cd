"""Shared CTC lattice machinery: input canonicalisation, gathers, grad/Hessian.

Counterpart of ``tf_seq2seq_losses_tpu/ops/core.py``.  The JAX package
gathers token log-probabilities with one-hot matrix products (a TPU gather
along the vocabulary axis serialises); here ``torch.gather`` does the same
selection exactly, -inf entries included.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import numpy as np
import torch

from tf_seq2seq_losses_tpu_torch.utils.numerics import apply_logarithmic_mask

NEG_INF = float("-inf")


class CtcContext(NamedTuple):
    """Canonical batch-major inputs shared by every lattice computation.

    ``Lp1`` is ``labels.shape[1] + 1``; positions past ``label_length`` are
    blank-padded and carry exact -inf lattice entries.
    """

    logproba: torch.Tensor  # [B, T, V] f32, forced-blank rows past logit_length
    raw_logproba: torch.Tensor  # [B, T, V] f32, unforced
    label: torch.Tensor  # [B, Lp1] int64, blank past label_length
    preceded_label: torch.Tensor  # [B, Lp1] label rolled right by one
    label_length: torch.Tensor  # [B] int64
    logit_length: torch.Tensor  # [B] int64
    blank_index: torch.Tensor  # [] int64
    label_length_mask: torch.Tensor  # [B, Lp1] bool, l < label_length
    logit_length_mask: torch.Tensor  # [B, T] bool, t < logit_length
    blank_lp: torch.Tensor  # [B, T] log-prob of blank


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def index_tensor(x, device) -> torch.Tensor:
    """A 0-d int64 tensor of the index ``x`` on ``device``: a tensor moves
    there, a Python or numpy integer becomes a device fill, with no
    host-to-device copy (a CUDA graph may capture it)."""
    if isinstance(x, torch.Tensor):
        return x.to(device).to(torch.int64).reshape(())
    if not isinstance(x, int):  # a Python int stays a constant under torch.compile
        x = int(np.asarray(x).reshape(()))
    return torch.full((), x, dtype=torch.int64, device=device)


def values_tensor(x) -> torch.Tensor:
    """Logits or log-probabilities as a tensor.  A tensor is used on its own
    device (a CPU tensor is the caller's request for the CPU); any other
    array goes to the current CUDA device, as the JAX package puts it on
    its default device, the accelerator."""
    if isinstance(x, torch.Tensor):
        return x
    if not torch.cuda.is_available():
        raise ValueError(
            "logits/logprobas that are not a torch.Tensor are placed on the "
            "current CUDA device, and no CUDA device is available; pass a CPU "
            "tensor (torch.as_tensor(x)) to compute on the CPU"
        )
    device = torch.device("cuda", torch.cuda.current_device())
    return torch.as_tensor(np.asarray(x), device=device)


def make_context(
    labels,
    logprobas: torch.Tensor,
    label_length,
    logit_length,
    blank_index: Union[int, torch.Tensor],
) -> CtcContext:
    """Canonicalise inputs onto ``logprobas``' device (see
    :func:`values_tensor` for a ``logprobas`` that is not a tensor)."""
    logprobas = values_tensor(logprobas)
    device = logprobas.device
    labels = _as_tensor(labels, device)
    label_length = _as_tensor(label_length, device)
    logit_length = _as_tensor(logit_length, device)
    if logprobas.ndim != 3:
        raise ValueError(f"logprobas must be rank 3, got {tuple(logprobas.shape)}")
    if labels.ndim != 2:
        raise ValueError(f"labels must be rank 2, got {tuple(labels.shape)}")
    if label_length.ndim != 1 or logit_length.ndim != 1:
        raise ValueError("label_length and logit_length must be rank 1")
    batch = logprobas.shape[0]
    if (
        labels.shape[0] != batch
        or label_length.shape[0] != batch
        or logit_length.shape[0] != batch
    ):
        raise ValueError("inconsistent batch dimensions")
    if not logprobas.dtype.is_floating_point:
        raise TypeError(
            f"logprobas/logits must be floating point, got {logprobas.dtype}"
        )
    for name, t in (
        ("labels", labels),
        ("label_length", label_length),
        ("logit_length", logit_length),
    ):
        if t.dtype.is_floating_point or t.dtype.is_complex or t.dtype == torch.bool:
            raise TypeError(f"{name} must be integer typed, got {t.dtype}")

    logprobas = logprobas.to(torch.float32)
    labels = labels.to(torch.int64)
    label_length = label_length.to(torch.int64)
    logit_length = logit_length.to(torch.int64)
    blank = index_tensor(blank_index, device)

    _, num_t, num_tokens = logprobas.shape
    lp1 = labels.shape[1] + 1

    # cleaned label: one extra column, blank past label_length
    padded = torch.cat(
        [labels, torch.zeros((batch, 1), dtype=torch.int64, device=device)], dim=1
    )
    label_length_mask = (
        torch.arange(lp1, device=device)[None, :] < label_length[:, None]
    )
    label = torch.where(label_length_mask, padded, blank)
    preceded = torch.roll(label, shifts=1, dims=1)

    # forced-blank rows past logit_length keep the recursions exact no-ops
    logit_length_mask = (
        torch.arange(num_t, device=device)[None, :] < logit_length[:, None]
    )
    blank_row = torch.where(
        torch.arange(num_tokens, device=device) == blank,
        torch.zeros((), device=device),
        torch.full((), NEG_INF, device=device),
    )
    logproba = torch.where(
        logit_length_mask[:, :, None], logprobas, blank_row[None, None, :]
    )
    blank_lp = take_blank_logproba(logproba, blank)
    return CtcContext(
        logproba=logproba,
        raw_logproba=logprobas,
        label=label,
        preceded_label=preceded,
        label_length=label_length,
        logit_length=logit_length,
        blank_index=blank,
        label_length_mask=label_length_mask,
        logit_length_mask=logit_length_mask,
        blank_lp=blank_lp,
    )


def float64_context(ctx: CtcContext) -> CtcContext:
    """``ctx`` with its log-probabilities in float64, for the pure path of a
    repair: the float32 pure path's rounding grows with the steps (1e-2 of
    d_logits at T=4000), the float64 one stays far under the 1e-5 that
    the kernel path meets."""
    return ctx._replace(logproba=ctx.logproba.double(),
                        raw_logproba=ctx.raw_logproba.double(),
                        blank_lp=ctx.blank_lp.double())


def take_token_logprobas(logproba: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """``out[b, t, l] = logproba[b, t, label[b, l]]`` (exact, -inf kept)."""
    num_t = logproba.shape[1]
    idx = label[:, None, :].expand(-1, num_t, -1)
    return torch.gather(logproba, 2, idx)


def take_blank_logproba(logproba: torch.Tensor, blank: torch.Tensor) -> torch.Tensor:
    """``logproba[:, :, blank]``."""
    return torch.index_select(logproba, 2, blank.reshape(1))[..., 0]


def expected_token_lp(ctx: CtcContext) -> torch.Tensor:
    """Expected-token log-probs [B, T, Lp1], -inf past label_length."""
    label_lp = take_token_logprobas(ctx.logproba, ctx.label)
    return apply_logarithmic_mask(label_lp, ctx.label_length_mask[:, None, :])


def select_from_act(act: torch.Tensor, label: torch.Tensor, num_tokens: int):
    """Log-space scatter of label-indexed activations into token bins.

    ``out[b, a, t, k] = logsumexp_{l : label[b, l] = k} act[b, a, t, l]``;
    tokens absent from the label give exactly -inf (zero derivative).

    act: [B, A, T, Lp1] -> [B, A, T, V]
    """
    m = torch.amax(act, dim=3, keepdim=True).detach()
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(act - m_safe)
    idx = label[:, None, None, :].expand_as(p)
    sums = torch.zeros(
        p.shape[:3] + (num_tokens,), dtype=p.dtype, device=p.device
    ).scatter_add(3, idx, p)
    empty = sums == 0.0
    safe_log = torch.log(torch.where(empty, torch.ones_like(sums), sums))
    return m_safe + torch.where(empty, torch.full_like(safe_log, NEG_INF), safe_log)


def gradient_log(topology, ctx: CtcContext, loss: torch.Tensor,
                 alpha: torch.Tensor = None, beta: torch.Tensor = None) -> torch.Tensor:
    """Log of minus the loss gradient w.r.t. log-probabilities:
    ``loss + combine(alpha[:, :-1], beta[:, 1:])``, -inf for infinite-loss
    samples and for steps past ``logit_length``; ``alpha`` and ``beta`` are
    ``topology.alpha(ctx)`` and ``topology.beta(ctx)`` where the caller has
    them already."""
    if alpha is None:
        alpha = topology.alpha(ctx)
    if beta is None:
        beta = topology.beta(ctx)
    combined = topology.combine(ctx, alpha[:, :-1], beta[:, 1:])
    out = loss[:, None, None] + combined
    out = torch.where(
        torch.isposinf(loss)[:, None, None], torch.full_like(out, NEG_INF), out
    )
    return apply_logarithmic_mask(out, ctx.logit_length_mask[:, :, None])


def gradient(topology, ctx: CtcContext, loss: torch.Tensor = None) -> torch.Tensor:
    """Analytic loss gradient w.r.t. log-probabilities (pure path); one
    alpha recursion serves the loss and the gradient."""
    alpha = topology.alpha(ctx)
    if loss is None:
        loss = topology.loss(ctx, alpha)
    return -torch.exp(gradient_log(topology, ctx, loss, alpha))


def hessian(topology, ctx: CtcContext, loss: torch.Tensor) -> torch.Tensor:
    """Analytic Hessian [B, T, V, T, V] w.r.t. log-probabilities.

    Two nested ``combine`` contractions against the pairwise transition
    tensor ``gamma``, the diagonal overwritten with the log-gradient, the
    upper time triangle mirrored, then ``H = -exp(.) + g (x) g`` with
    infinite-loss samples and out-of-length rows and columns zeroed.
    O(T^2 (L^2 + V^2)) memory: a small-shape feature.
    """
    alpha = topology.alpha(ctx)
    beta = topology.beta(ctx)
    gamma = topology.gamma(ctx)
    grad_log = gradient_log(topology, ctx, loss)
    grad = -torch.exp(grad_log)
    batch, num_t, num_tokens = ctx.logproba.shape

    ag = topology.combine(ctx, alpha[:, :-1], gamma[:, 1:])
    agb = topology.combine(ctx, ag[:, :, :, :-1], beta[:, 1:])
    term = loss[:, None, None, None, None] + agb  # [B, T, V, T, V]

    tv = num_t * num_tokens
    flat = term.reshape(batch, tv, tv).clone()
    diag = torch.arange(tv, device=flat.device)
    flat[:, diag, diag] = grad_log.reshape(batch, tv)
    term = flat.reshape(term.shape)

    t_idx = torch.arange(num_t, device=term.device)
    upper = (t_idx[:, None] <= t_idx[None, :])[None, :, None, :, None]
    term = torch.where(upper, term, term.permute(0, 3, 4, 1, 2))

    hess = -torch.exp(term) + grad[:, :, :, None, None] * grad[:, None, None, :, :]
    zero = torch.zeros_like(hess)
    hess = torch.where(torch.isposinf(loss)[:, None, None, None, None], zero, hess)
    tmask = ctx.logit_length_mask
    hess = torch.where(tmask[:, :, None, None, None], hess, zero)
    return torch.where(tmask[:, None, None, :, None], hess, zero)
