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

Both scans over T are custom ops (``cuda_lattice.kernel_op``): the alpha,
``ctc_port::classic_alpha32`` or ``ctc_port::simplified_alpha32``
(``ops/pure_scan.py``), and the walk, ``ctc_port::classic_walk`` or
``ctc_port::simplified_walk``.  CUDA tensors launch their kernels
(csrc/classic_pure64.cu, csrc/simplified_pure64.cu, csrc/walk.cu: one thread
a sample of a row), CPU tensors run their plain versions, the Python loops
over T.  Each op has a fake, for ``torch.compile``, and a ``vmap`` rule
that folds the groups into the batch (the noise's at its axis 2).  The
terms, the noise and the masking around them are plain torch.  The path
log-probabilities are differentiable in the terms: the walk's op pulls a
gradient back through its plain version, run again
(``cuda_lattice.plain_grad``); alpha is a constant of it, as each step's
sum takes the chosen predecessor's alpha off again.

Frames at ``t >= logit_length`` carry the forced-blank canonicalisation
(blank log-prob 0), so the walk emits blanks there and the path log-prob
is unaffected; infeasible samples return ``-inf`` path log-prob and
all-blank alignments.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from tf_seq2seq_losses_tpu_torch.ops import _build, pure_scan
from tf_seq2seq_losses_tpu_torch.ops import classic as _classic
from tf_seq2seq_losses_tpu_torch.ops.core import CtcContext, expected_token_lp
from tf_seq2seq_losses_tpu_torch.ops.cuda_lattice import (
    check_device,
    check_dtype,
    check_tensor,
    kernel_op,
    plain_grad,
    register_fold,
)

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


def _walk_fake(alpha: Tensor, noise: Tensor):
    num_s, batch, num_t = noise.shape[0], alpha.shape[0], alpha.shape[1] - 1
    return (alpha.new_empty((num_s, batch)),
            alpha.new_empty((num_s, batch, num_t), dtype=torch.int32))


def _launch_walk(fn: str, name: str, args, noise: Tensor, batch: int, num_t: int,
                 lp1: int, dev):
    """Launch walk.cu's entry point ``fn`` over the pointers of ``args`` and
    ``noise``: ``(acc [S, B], emits [S, B, T] int32)``."""
    num_s = noise.shape[0]
    acc = torch.empty((num_s, batch), device=dev)
    emits = torch.empty((num_s, batch, num_t), dtype=torch.int32, device=dev)
    _build.launch("walk", fn, name, dev, *args, noise, num_s, batch, num_t, lp1, acc,
                  emits)
    return acc, emits


def _check_walk(alpha, blank_lp, terms, label, label_length, blank, noise, alpha_tail,
                noise_tail):
    batch, num_t = blank_lp.shape
    lp1 = label.shape[1]
    dev = alpha.device
    f32 = torch.float32
    check_tensor(alpha, (batch, num_t + 1, lp1) + alpha_tail, f32, "alpha", dev)
    check_tensor(blank_lp, (batch, num_t), f32, "blank_lp", dev)
    for i, t in enumerate(terms):
        check_tensor(t, (batch, num_t, lp1), f32, f"term {i}", dev)
    check_tensor(label, (batch, lp1), torch.int64, "label", dev)
    check_tensor(label_length, (batch,), torch.int64, "label_length", dev)
    check_tensor(blank, (), torch.int64, "blank", dev)
    check_tensor(noise, (noise.shape[0],) + noise_tail(num_t, batch), f32, "noise", dev)
    return batch, num_t, lp1, dev


# ---------------------------------------------------------------------------
# classic
# ---------------------------------------------------------------------------


def classic_walk_scan(alpha, blank_lp, prev_tok_masked, diag_closed, diag_open, label,
                      label_length, blank, noise) -> Tuple[Tensor, Tensor]:
    """``(acc [S, B], emits [S, B, T] int32)``: one walk back over the
    classic ``alpha`` [B, T+1, Lp1, 2] per slice of ``noise`` [S, T+1, B, 3],
    over the terms of ``classic.terms`` (float32), the cleaned ``label`` [B,
    Lp1], ``label_length`` [B] and ``blank`` [] (int64): the path
    log-probabilities and emissions before the feasibility mask of
    :func:`_finish`.

    The op ``ctc_port::classic_walk``: CUDA tensors launch csrc/walk.cu; CPU
    tensors run :func:`classic_walk_plain`."""
    check_device(alpha, "classic_walk")
    check_dtype((("alpha", alpha), ("blank_lp", blank_lp),
                 ("prev_tok_masked", prev_tok_masked), ("diag_closed", diag_closed),
                 ("diag_open", diag_open), ("noise", noise)), torch.float32, "classic_walk")
    return _classic_walk(*(t.contiguous() for t in (
        alpha, blank_lp, prev_tok_masked, diag_closed, diag_open, label,
        label_length)), blank, noise.contiguous())


def classic_walk_plain(alpha: Tensor, blank_lp: Tensor, prev_tok_masked: Tensor,
                       diag_closed: Tensor, diag_open: Tensor, label: Tensor,
                       label_length: Tensor, blank: Tensor,
                       noise: Tensor) -> Tuple[Tensor, Tensor]:
    """The plain version of the kernel ``classic_walk``: the walk's loop
    over T, every sample at once."""
    batch, num_t = blank_lp.shape
    num_s = noise.shape[0]
    device = alpha.device
    a = alpha
    rng = torch.arange(batch, device=device)[None, :]  # against [S, B]

    af = a[rng[0], num_t, label_length]  # [B, 2] terminal values
    cur_s = torch.argmax(af[None] + noise[:, 0, :, :2], dim=2)  # [S, B]
    cur_l = label_length[None, :].expand(num_s, batch)
    acc = torch.zeros((num_s, batch), device=device)
    emits = torch.empty((num_s, batch, num_t), dtype=torch.int64, device=device)
    neg_inf = torch.full((num_s, batch), NEG_INF, device=device)
    # step i handles frame num_t-1-i, whose transition took alpha[:, f] to
    # alpha[:, f+1], with the noise of slot 1+i.  Predecessor candidates:
    #   closed: 0 -> (l, closed), 1 -> (l, open); transition blank
    #   open:   0 -> (l, open) horizontal repeat, 1 -> (l-1, closed) and
    #           2 -> (l-1, open) diagonal
    for i in range(num_t):
        f = num_t - 1 - i
        a_prev = a[:, f]  # [B, Lp1, 2]
        blank_f = blank_lp[:, f][None, :]
        lm1 = torch.clamp(cur_l - 1, min=0)
        here = a_prev[rng, cur_l]  # [S, B, 2]
        below = a_prev[rng, lm1]
        w_closed = torch.stack([here[..., 0] + blank_f, here[..., 1] + blank_f, neg_inf],
                               dim=2)
        w_open = torch.stack([
            here[..., 1] + prev_tok_masked[:, f][rng, cur_l],
            below[..., 0] + diag_closed[:, f][rng, lm1],
            below[..., 1] + diag_open[:, f][rng, lm1],
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
        emits[:, :, f] = torch.where(open_cur, label[rng, lm1], blank)
        cur_l, cur_s = prev_l, prev_s
    return acc, emits.to(torch.int32)


_classic_walk_op = kernel_op("classic_walk", classic_walk_plain)
register_fold(_classic_walk_op, (0, 0, 0, 0, 0, 0, 0, None, 2), (1, 1))
_classic_walk = plain_grad("classic_walk", classic_walk_plain, (1, 2, 3, 4), (0,))


@_classic_walk_op.register_fake
def _classic_walk_fake(alpha, blank_lp, prev_tok_masked, diag_closed, diag_open, label,
                       label_length, blank, noise):
    return _walk_fake(alpha, noise)


@_classic_walk_op.register_kernel("cuda")
def _classic_walk_launch(alpha, blank_lp, prev_tok_masked, diag_closed, diag_open,
                         label, label_length, blank, noise):
    batch, num_t, lp1, dev = _check_walk(
        alpha, blank_lp, (prev_tok_masked, diag_closed, diag_open), label, label_length,
        blank, noise, (2,), lambda t, b: (t + 1, b, 3))
    out = _launch_walk("ctc_classic_walk", "classic_walk",
                       (alpha, blank_lp, prev_tok_masked, diag_closed, diag_open, label,
                        label_length, blank), noise, batch, num_t, lp1, dev)
    classic_walk_scan.launches += 1
    return out


classic_walk_scan.launches = 0


def classic_walk(ctx: CtcContext, noise: Tensor) -> Tuple[Tensor, Tensor]:
    """``(alignments [B, S, T] int32, path_logprobas [B, S])`` ~ P(path |
    label), one sample per slice of ``noise`` [S, T+1, B, 3]."""
    num_t = ctx.logproba.shape[1]
    t = _classic.terms(ctx)
    args = (t.blank_lp, t.prev_tok_masked, t.diag_closed, t.diag_open)
    # [B, T+1, Lp1, 2], shared by every sample; a constant of the gradient:
    # the walk's sum takes each chosen predecessor's alpha off again
    a = pure_scan.classic_alpha32(*(x.detach() for x in args))
    acc, emits = classic_walk_scan(a, *args, ctx.label, ctx.label_length,
                                   ctx.blank_index, noise)
    af = _final(a, num_t, ctx.label_length)  # [B, 2] terminal values
    # feasibility from the terminal alpha (finite iff some valid path)
    return _finish(ctx, torch.amax(af, dim=1), acc, emits)


def _final(a: Tensor, num_t: int, label_length: Tensor) -> Tensor:
    """``a[b, num_t, label_length[b]]`` for each row ``b``."""
    return a[torch.arange(a.shape[0], device=a.device), num_t, label_length]


# ---------------------------------------------------------------------------
# simplified
# ---------------------------------------------------------------------------


def simplified_walk_scan(alpha, blank_lp, diag_lp, label, label_length, blank,
                         noise) -> Tuple[Tensor, Tensor]:
    """``(acc [S, B], emits [S, B, T] int32)``: one walk back over the
    simplified ``alpha`` [B, T+1, Lp1] per slice of ``noise`` [S, T, B, 2],
    over ``blank_lp`` and ``diag_lp`` (``core.expected_token_lp``).

    The op ``ctc_port::simplified_walk``: CUDA tensors launch csrc/walk.cu;
    CPU tensors run :func:`simplified_walk_plain`."""
    check_device(alpha, "simplified_walk")
    check_dtype((("alpha", alpha), ("blank_lp", blank_lp), ("diag_lp", diag_lp),
                 ("noise", noise)), torch.float32, "simplified_walk")
    return _simplified_walk(*(t.contiguous() for t in (
        alpha, blank_lp, diag_lp, label, label_length)), blank, noise.contiguous())


def simplified_walk_plain(alpha: Tensor, blank_lp: Tensor, diag_lp: Tensor,
                          label: Tensor, label_length: Tensor, blank: Tensor,
                          noise: Tensor) -> Tuple[Tensor, Tensor]:
    """The plain version of the kernel ``simplified_walk`` (the edge
    determines the emission)."""
    batch, num_t = blank_lp.shape
    num_s = noise.shape[0]
    device = alpha.device
    a = alpha
    rng = torch.arange(batch, device=device)[None, :]

    cur_l = label_length[None, :].expand(num_s, batch)
    acc = torch.zeros((num_s, batch), device=device)
    emits = torch.empty((num_s, batch, num_t), dtype=torch.int64, device=device)
    neg_inf = torch.full((num_s, batch), NEG_INF, device=device)
    for i in range(num_t):
        f = num_t - 1 - i
        a_prev = a[:, f]  # [B, Lp1]
        lm1 = torch.clamp(cur_l - 1, min=0)
        # the diagonal (emit label[cur_l-1] from l-1) is impossible at
        # cur_l == 0, where the clamped gather would offer a finite self-loop
        diag_w = torch.where(cur_l > 0, a_prev[rng, lm1] + diag_lp[:, f][rng, lm1],
                             neg_inf)
        w = torch.stack([a_prev[rng, cur_l] + blank_lp[:, f][None, :], diag_w], dim=2)
        choice = torch.argmax(w + noise[:, i], dim=2)
        took_diag = choice == 1
        prev_l = torch.where(took_diag, lm1, cur_l)
        acc = acc + (torch.gather(w, 2, choice[..., None])[..., 0]
                     - a_prev[rng, prev_l])
        emits[:, :, f] = torch.where(took_diag, label[rng, lm1], blank)
        cur_l = prev_l
    return acc, emits.to(torch.int32)


_simplified_walk_op = kernel_op("simplified_walk", simplified_walk_plain)
register_fold(_simplified_walk_op, (0, 0, 0, 0, 0, None, 2), (1, 1))
_simplified_walk = plain_grad("simplified_walk", simplified_walk_plain, (1, 2), (0,))


@_simplified_walk_op.register_fake
def _simplified_walk_fake(alpha, blank_lp, diag_lp, label, label_length, blank, noise):
    return _walk_fake(alpha, noise)


@_simplified_walk_op.register_kernel("cuda")
def _simplified_walk_launch(alpha, blank_lp, diag_lp, label, label_length, blank, noise):
    batch, num_t, lp1, dev = _check_walk(
        alpha, blank_lp, (diag_lp,), label, label_length, blank, noise, (),
        lambda t, b: (t, b, 2))
    out = _launch_walk("ctc_simplified_walk", "simplified_walk",
                       (alpha, blank_lp, diag_lp, label, label_length, blank), noise,
                       batch, num_t, lp1, dev)
    simplified_walk_scan.launches += 1
    return out


simplified_walk_scan.launches = 0


def simplified_walk(ctx: CtcContext, noise: Tensor) -> Tuple[Tensor, Tensor]:
    """``(alignments [B, S, T] int32, path_logprobas [B, S])`` through the
    simplified lattice, one sample per slice of ``noise`` [S, T, B, 2]."""
    num_t = ctx.logproba.shape[1]
    diag_lp = expected_token_lp(ctx)  # [B, T, Lp1]
    # [B, T+1, Lp1], shared; a constant of the gradient, as the classic one
    a = pure_scan.simplified_alpha32(ctx.blank_lp.detach(), diag_lp.detach())
    acc, emits = simplified_walk_scan(a, ctx.blank_lp, diag_lp, ctx.label,
                                      ctx.label_length, ctx.blank_index, noise)
    return _finish(ctx, _final(a, num_t, ctx.label_length), acc, emits)


WALKS = {"classic": classic_walk, "simplified": simplified_walk}


def sample(ctx: CtcContext, topology: str, generator, num_samples: int):
    """``(alignments [B, S, T] int32, path_logprobas [B, S])``: Gumbel noise
    of the walk's shape drawn from ``generator`` on the log-probabilities'
    device, then the topology's walk.  Under ``torch.compile`` only
    PyTorch's default generator (``generator=None``): Dynamo cannot trace
    a ``torch.Generator``."""
    if generator is not None and torch.compiler.is_compiling():
        raise TypeError(
            "ctc_sample_alignments under torch.compile: Dynamo cannot trace a "
            "torch.Generator; pass generator=None (PyTorch's default generator, "
            "seeded by torch.manual_seed) or call it outside the compiled function")
    noise = gumbel(noise_shape(topology, num_samples, ctx), generator,
                   ctx.logproba.device)
    return WALKS[topology](ctx, noise)
