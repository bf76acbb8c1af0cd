"""Posterior alignment sampling over the CTC lattices, in PyTorch.

Counterpart of ``tf_seq2seq_losses_tpu/ops/sample.py``: exact draws from
``P(path | label, logits)`` by forward filtering, backward sampling.  The
alpha recursion of the losses runs once and is shared by all ``S``
samples; then a walk backwards from the terminal state draws each frame's
predecessor among at most 3 (classic ``[Lp1, 2]`` lattice) or 2
(simplified ``[Lp1]``) candidates with probability proportional to
``alpha[t-1, pred] * trans(pred -> cur, frame t-1)``, by the Gumbel-max
trick.

The walks take their Gumbel noise as an argument: ``[S, T+1, B, 3]``
classic (slot 0 is the terminal-state draw over the two states, lanes 0
and 1), ``[S, T, B, 2]`` simplified.  :func:`gumbel` draws it from a
``torch.Generator``; the JAX package draws the same shapes from its key,
so both walks can be fed one draw and compared.  The JAX package vmaps the
walk over the samples; here the samples are a leading ``S`` axis of every
tensor of the walk.

Frames at ``t >= logit_length`` carry the forced-blank canonicalisation
(blank log-prob 0), so the walk emits blanks there and the path log-prob
is unaffected; infeasible samples return ``-inf`` path log-prob and
all-blank alignments.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tf_seq2seq_losses_tpu_torch.ops import classic as _classic
from tf_seq2seq_losses_tpu_torch.ops import simplified as _simplified
from tf_seq2seq_losses_tpu_torch.ops.core import CtcContext, expected_token_lp

NEG_INF = float("-inf")


def gumbel(shape, generator, device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, ``u`` uniform in
    ``[tiny, 1)``, as ``jax.random.gumbel`` draws it (float32)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def noise_shape(topology: str, num_samples: int, ctx: CtcContext) -> tuple:
    """The shape of the Gumbel noise that the topology's walk consumes."""
    batch, num_t, _ = ctx.logproba.shape
    if topology == "classic":
        return (num_samples, num_t + 1, batch, 3)
    return (num_samples, num_t, batch, 2)


def _mask_samples(ctx: CtcContext, path_lp: torch.Tensor, alignments: torch.Tensor):
    """Blank frames past logit_length; ``-inf`` and all-blank for
    infeasible samples (alignments [B, S, T], path_lp [B, S])."""
    feasible = torch.isfinite(path_lp)
    mask = ctx.logit_length_mask[:, None, :] & feasible[:, :, None]
    alignments = torch.where(mask, alignments, ctx.blank_index).to(torch.int32)
    path_lp = torch.where(feasible, path_lp, torch.full_like(path_lp, NEG_INF))
    return alignments, path_lp


def _finish(ctx, feasible_lp, acc, emits):
    """``acc [S, B]`` and ``emits [S, B, T]`` to the masked
    ``(alignments [B, S, T], path_logprobas [B, S])``."""
    acc = torch.where(torch.isfinite(feasible_lp)[None, :], acc,
                      torch.full_like(acc, NEG_INF))
    return _mask_samples(ctx, acc.transpose(0, 1), emits.transpose(0, 1))


def classic_walk(ctx: CtcContext, noise: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(alignments [B, S, T] int32, path_logprobas [B, S])`` ~ P(path |
    label), one sample per slice of ``noise`` [S, T+1, B, 3]."""
    batch, num_t, _ = ctx.logproba.shape
    num_s = noise.shape[0]
    device = ctx.logproba.device
    t = _classic.terms(ctx)
    a = _classic.alpha(ctx, t)  # [B, T+1, Lp1, 2], shared by every sample
    rng = torch.arange(batch, device=device)[None, :]  # against [S, B]

    af = a[rng[0], num_t, ctx.label_length]  # [B, 2] terminal values
    cur_s = torch.argmax(af[None] + noise[:, 0, :, :2], dim=2)  # [S, B]
    cur_l = ctx.label_length[None, :].expand(num_s, batch)
    acc = torch.zeros((num_s, batch), device=device)
    emits = torch.empty((num_s, batch, num_t), dtype=torch.int64, device=device)
    neg_inf = torch.full((num_s, batch), NEG_INF, device=device)
    label = ctx.label[rng[0]]  # [B, Lp1]
    # step i handles frame num_t-1-i, whose transition took alpha[:, f] to
    # alpha[:, f+1], with the noise of slot 1+i.  Predecessor candidates:
    #   closed: 0 -> (l, closed), 1 -> (l, open); transition blank
    #   open:   0 -> (l, open) horizontal repeat, 1 -> (l-1, closed) and
    #           2 -> (l-1, open) diagonal
    for i in range(num_t):
        f = num_t - 1 - i
        a_prev = a[:, f]  # [B, Lp1, 2]
        blank = t.blank_lp[:, f][None, :]
        lm1 = torch.clamp(cur_l - 1, min=0)
        here = a_prev[rng, cur_l]  # [S, B, 2]
        below = a_prev[rng, lm1]
        w_closed = torch.stack([here[..., 0] + blank, here[..., 1] + blank, neg_inf],
                               dim=2)
        w_open = torch.stack([
            here[..., 1] + t.prev_tok_masked[:, f][rng, cur_l],
            below[..., 0] + t.diag_closed[:, f][rng, lm1],
            below[..., 1] + t.diag_open[:, f][rng, lm1],
        ], dim=2)
        open_cur = cur_s == 1
        w = torch.where(open_cur[..., None], w_open, w_closed)
        choice = torch.argmax(w + noise[:, 1 + i], dim=2)
        prev_l = torch.where(open_cur & (choice > 0), lm1, cur_l)
        prev_s = torch.where(open_cur, torch.where(choice == 0, 1, choice - 1), choice)
        # the frame's log-prob: the chosen weight minus the predecessor's
        # alpha (the transition term alone)
        acc = acc + (torch.gather(w, 2, choice[..., None])[..., 0]
                     - a_prev[rng, prev_l, prev_s])
        emits[:, :, f] = torch.where(open_cur, label[rng, lm1], ctx.blank_index)
        cur_l, cur_s = prev_l, prev_s
    # feasibility from the terminal alpha (finite iff some valid path)
    return _finish(ctx, torch.amax(af, dim=1), acc, emits)


def simplified_walk(ctx: CtcContext, noise: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(alignments [B, S, T] int32, path_logprobas [B, S])`` through the
    simplified lattice (the edge determines the emission), one sample per
    slice of ``noise`` [S, T, B, 2]."""
    batch, num_t, _ = ctx.logproba.shape
    num_s = noise.shape[0]
    device = ctx.logproba.device
    diag_lp = expected_token_lp(ctx)  # [B, T, Lp1]
    a = _simplified.alpha(ctx, diag_lp)  # [B, T+1, Lp1], shared
    rng = torch.arange(batch, device=device)[None, :]

    feasible_lp = a[rng[0], num_t, ctx.label_length]  # [B]
    cur_l = ctx.label_length[None, :].expand(num_s, batch)
    acc = torch.zeros((num_s, batch), device=device)
    emits = torch.empty((num_s, batch, num_t), dtype=torch.int64, device=device)
    neg_inf = torch.full((num_s, batch), NEG_INF, device=device)
    label = ctx.label[rng[0]]
    for i in range(num_t):
        f = num_t - 1 - i
        a_prev = a[:, f]  # [B, Lp1]
        lm1 = torch.clamp(cur_l - 1, min=0)
        # the diagonal (emit label[cur_l-1] from l-1) is impossible at
        # cur_l == 0, where the clamped gather would offer a finite self-loop
        diag_w = torch.where(cur_l > 0, a_prev[rng, lm1] + diag_lp[:, f][rng, lm1],
                             neg_inf)
        w = torch.stack([a_prev[rng, cur_l] + ctx.blank_lp[:, f][None, :], diag_w],
                        dim=2)
        choice = torch.argmax(w + noise[:, i], dim=2)
        took_diag = choice == 1
        prev_l = torch.where(took_diag, lm1, cur_l)
        acc = acc + (torch.gather(w, 2, choice[..., None])[..., 0]
                     - a_prev[rng, prev_l])
        emits[:, :, f] = torch.where(took_diag, label[rng, lm1], ctx.blank_index)
        cur_l = prev_l
    return _finish(ctx, feasible_lp, acc, emits)


WALKS = {"classic": classic_walk, "simplified": simplified_walk}


def sample(ctx: CtcContext, topology: str, generator, num_samples: int):
    """``(alignments [B, S, T] int32, path_logprobas [B, S])``: Gumbel noise
    of the walk's shape drawn from ``generator`` on the log-probabilities'
    device, then the topology's walk."""
    noise = gumbel(noise_shape(topology, num_samples, ctx), generator,
                   ctx.logproba.device)
    return WALKS[topology](ctx, noise)
