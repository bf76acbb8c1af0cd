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
log-probabilities are differentiable in the terms: the walk's op has the
backward ``ctc_port::classic_walk_grad`` or ``ctc_port::simplified_walk_grad``
(``cuda_lattice.op_with_grad``), whose CUDA implementation runs the walk
again in one launch, keeping each sample's chosen transitions, then adds
each sample's cotangent to the term its transition read, the samples in
order; alpha is a constant of it, as each step's sum takes the chosen
predecessor's alpha off again.

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
    op_with_grad,
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


def _launch_walk_grad(fn: str, name: str, args, noise: Tensor, grad: Tensor, batch: int,
                      num_t: int, lp1: int, n_terms: int, dev):
    """Launch walk.cu's gradient entry point ``fn`` over the pointers of
    ``args``, ``noise`` and ``grad``: ``(d blank_lp [B, T], then the n_terms
    [B, T, Lp1])``.  The scratch: each sample's choice at each frame, an
    int32 ``[S, B, T]``."""
    num_s = noise.shape[0]
    picks = torch.empty((num_s, batch, num_t), dtype=torch.int32, device=dev)
    outs = [torch.empty((batch, num_t), device=dev)]
    outs += [torch.empty((batch, num_t, lp1), device=dev) for _ in range(n_terms)]
    _build.launch("walk", fn, name, dev, *args, noise, grad, num_s, batch, num_t, lp1,
                  picks, *outs)
    return tuple(outs)


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
    tensors run :func:`classic_walk_plain`.  Its backward is
    :func:`classic_walk_grad`."""
    check_device(alpha, "classic_walk")
    check_dtype((("alpha", alpha), ("blank_lp", blank_lp),
                 ("prev_tok_masked", prev_tok_masked), ("diag_closed", diag_closed),
                 ("diag_open", diag_open), ("noise", noise)), torch.float32, "classic_walk")
    return _classic_walk(*(t.contiguous() for t in (
        alpha, blank_lp, prev_tok_masked, diag_closed, diag_open, label,
        label_length)), blank, noise.contiguous())


def _classic_walk_steps(alpha, blank_lp, prev_tok_masked, diag_closed, diag_open,
                        label_length, noise):
    """The classic walk's loop over T, every sample at once: yields, from
    the last frame down, ``(f, open_cur, choice, cur_l, lm1, w_chosen,
    a_chosen)`` [S, B] of frame ``f``: the state it leaves, the chosen
    candidate, the lanes, the chosen weight and predecessor's alpha.

    Step i handles frame num_t-1-i, whose transition took alpha[:, f] to
    alpha[:, f+1], with the noise of slot 1+i.  Predecessor candidates:
      closed: 0 -> (l, closed), 1 -> (l, open); transition blank
      open:   0 -> (l, open) horizontal repeat, 1 -> (l-1, closed) and
              2 -> (l-1, open) diagonal"""
    batch, num_t = blank_lp.shape
    num_s = noise.shape[0]
    device = alpha.device
    rng = torch.arange(batch, device=device)[None, :]  # against [S, B]
    af = alpha[rng[0], num_t, label_length]  # [B, 2] terminal values
    cur_s = torch.argmax(af[None] + noise[:, 0, :, :2], dim=2)  # [S, B]
    cur_l = label_length[None, :].expand(num_s, batch)
    neg_inf = torch.full((num_s, batch), NEG_INF, device=device)
    for i in range(num_t):
        f = num_t - 1 - i
        a_prev = alpha[:, f]  # [B, Lp1, 2]
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
        yield (f, open_cur, choice, cur_l, lm1,
               torch.gather(w, 2, choice[..., None])[..., 0], a_prev[rng, prev_l, prev_s])
        cur_l, cur_s = prev_l, prev_s


def classic_walk_plain(alpha: Tensor, blank_lp: Tensor, prev_tok_masked: Tensor,
                       diag_closed: Tensor, diag_open: Tensor, label: Tensor,
                       label_length: Tensor, blank: Tensor,
                       noise: Tensor) -> Tuple[Tensor, Tensor]:
    """The plain version of the kernel ``classic_walk``: the walk's loop
    over T, every sample at once."""
    rng = torch.arange(blank_lp.shape[0], device=alpha.device)[None, :]
    acc = torch.zeros((noise.shape[0], blank_lp.shape[0]), device=alpha.device)
    emits = []
    for f, open_cur, choice, cur_l, lm1, w, a in _classic_walk_steps(
            alpha, blank_lp, prev_tok_masked, diag_closed, diag_open, label_length, noise):
        # the frame's log-prob: the chosen weight minus the predecessor's
        # alpha (the transition term alone)
        acc = acc + (w - a)
        emits.append(torch.where(open_cur, label[rng, lm1], blank))
    return acc, _emissions(emits, noise.shape[0], *blank_lp.shape, alpha.device)


def _emissions(emits, num_s: int, batch: int, num_t: int, device) -> Tensor:
    """The walk's emissions, last frame first, as ``[S, B, T]`` int32."""
    if not emits:
        return torch.empty((num_s, batch, num_t), dtype=torch.int32, device=device)
    return torch.stack(emits[::-1], dim=2).to(torch.int32)


_classic_walk_op = kernel_op("classic_walk", classic_walk_plain)
register_fold(_classic_walk_op, (0, 0, 0, 0, 0, 0, 0, None, 2), (1, 1))


@_classic_walk_op.register_fake
def _classic_walk_fake(alpha, blank_lp, prev_tok_masked, diag_closed, diag_open, label,
                       label_length, blank, noise):
    return _walk_fake(alpha, noise)


def _check_classic(alpha, blank_lp, prev_tok_masked, diag_closed, diag_open, label,
                   label_length, blank, noise):
    return _check_walk(alpha, blank_lp, (prev_tok_masked, diag_closed, diag_open), label,
                       label_length, blank, noise, (2,), lambda t, b: (t + 1, b, 3))


@_classic_walk_op.register_kernel("cuda")
def _classic_walk_launch(alpha, blank_lp, prev_tok_masked, diag_closed, diag_open,
                         label, label_length, blank, noise):
    batch, num_t, lp1, dev = _check_classic(alpha, blank_lp, prev_tok_masked,
                                            diag_closed, diag_open, label, label_length,
                                            blank, noise)
    out = _launch_walk("ctc_classic_walk", "classic_walk",
                       (alpha, blank_lp, prev_tok_masked, diag_closed, diag_open, label,
                        label_length, blank), noise, batch, num_t, lp1, dev)
    classic_walk_scan.launches += 1
    return out


classic_walk_scan.launches = 0


def classic_walk_grad(alpha, blank_lp, prev_tok_masked, diag_closed, diag_open, label,
                      label_length, blank, noise,
                      grad) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The gradients of ``acc`` (:func:`classic_walk_scan`'s first output)
    under the cotangent ``grad`` [S, B], in the four terms: ``(d blank_lp [B,
    T], d prev_tok_masked, d diag_closed, d diag_open [B, T, Lp1])``, the
    gradient autograd takes through :func:`classic_walk_plain` (alpha is a
    constant of it).

    The op ``ctc_port::classic_walk_grad``: CUDA tensors launch
    csrc/walk.cu; CPU tensors run :func:`classic_walk_grad_plain`."""
    check_device(alpha, "classic_walk_grad")
    check_dtype((("alpha", alpha), ("blank_lp", blank_lp),
                 ("prev_tok_masked", prev_tok_masked), ("diag_closed", diag_closed),
                 ("diag_open", diag_open), ("noise", noise), ("grad", grad)),
                torch.float32, "classic_walk_grad")
    return _classic_walk_grad(*(t.contiguous() for t in (
        alpha, blank_lp, prev_tok_masked, diag_closed, diag_open, label,
        label_length)), blank, noise.contiguous(), grad.contiguous())


def classic_walk_grad_plain(alpha: Tensor, blank_lp: Tensor, prev_tok_masked: Tensor,
                            diag_closed: Tensor, diag_open: Tensor, label: Tensor,
                            label_length: Tensor, blank: Tensor, noise: Tensor,
                            grad: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The plain version of the kernel ``classic_walk_grad``, out of place:
    the walk again, keeping each frame's choice, then ``grad[s, b]`` added to
    the term that sample ``s``'s chosen transition read at its frame and
    lane, the samples in order (:func:`sample_sum`).  ``blank_lp`` is read
    by two candidates of a closed state: its gradient is the sum over the
    samples that chose the first plus the sum over those that chose the
    second, as autograd adds them."""
    steps = _classic_walk_steps(alpha, blank_lp, prev_tok_masked, diag_closed, diag_open,
                                label_length, noise)
    open_cur, choice, cur_l, lm1 = _picks([step[1:5] for step in steps], 4, noise.shape[0],
                                          *blank_lp.shape, alpha.device)
    closed = ~open_cur
    lp1 = diag_closed.shape[2]
    return (sample_sum(grad, closed & (choice == 0))
            + sample_sum(grad, closed & (choice == 1)),
            sample_sum(grad, open_cur & (choice == 0), cur_l, lp1),
            sample_sum(grad, open_cur & (choice == 1), lm1, lp1),
            sample_sum(grad, open_cur & (choice == 2), lm1, lp1))


def _picks(rows, fields: int, num_s: int, batch: int, num_t: int, device):
    """A walk's per-frame records ``rows`` (tuples of ``fields`` tensors [S,
    B], from the last frame down) stacked in frame order, each ``[S, B,
    T]``."""
    if not rows:
        return (torch.empty((num_s, batch, 0), dtype=torch.bool, device=device),) * fields
    return tuple(torch.stack(xs, dim=2) for xs in zip(*rows[::-1]))


def sample_sum(grad: Tensor, pick: Tensor, lane: Tensor = None, lp1: int = 0) -> Tensor:
    """``sum_s grad[s, b]`` over the samples ``s`` that ``pick`` [S, B, T]
    marks at frame ``t``, from zero and in sample order (autograd's order on
    the CPU for a handful of samples, its index backward's at any count, and
    the kernels'): ``[B, T]``, or with ``lane`` [S, B, T] at lane
    ``lane[s, b, t]`` of ``[B, T, lp1]``."""
    batch, num_t = pick.shape[1:]
    if lane is None:
        total = grad.new_zeros((batch, num_t))
        for s in range(pick.shape[0]):
            total = total + torch.where(pick[s], grad[s][:, None], 0.0)
        return total
    lanes = torch.arange(lp1, device=grad.device)
    total = grad.new_zeros((batch, num_t, lp1))
    for s in range(pick.shape[0]):
        hit = pick[s][..., None] & (lane[s][..., None] == lanes)
        total = total + torch.where(hit, grad[s][:, None, None], 0.0)
    return total


_classic_walk_grad_op = kernel_op("classic_walk_grad", classic_walk_grad_plain)
register_fold(_classic_walk_grad_op, (0, 0, 0, 0, 0, 0, 0, None, 2, 1), (0, 0, 0, 0))
_classic_walk_grad = plain_grad(
    "classic_walk_grad", classic_walk_grad_plain, (1, 2, 3, 4, 9), (0, 1, 2, 3))
_classic_walk = op_with_grad("classic_walk", (1, 2, 3, 4),
                             lambda args, grads: classic_walk_grad(*args, grads[0]))


@_classic_walk_grad_op.register_fake
def _classic_walk_grad_fake(alpha, blank_lp, prev_tok_masked, diag_closed, diag_open,
                            label, label_length, blank, noise, grad):
    return (torch.empty_like(blank_lp), torch.empty_like(prev_tok_masked),
            torch.empty_like(diag_closed), torch.empty_like(diag_open))


@_classic_walk_grad_op.register_kernel("cuda")
def _classic_walk_grad_launch(alpha, blank_lp, prev_tok_masked, diag_closed, diag_open,
                              label, label_length, blank, noise, grad):
    batch, num_t, lp1, dev = _check_classic(alpha, blank_lp, prev_tok_masked,
                                            diag_closed, diag_open, label, label_length,
                                            blank, noise)
    check_tensor(grad, (noise.shape[0], batch), torch.float32, "grad", dev)
    out = _launch_walk_grad("ctc_classic_walk_grad", "classic_walk_grad",
                            (alpha, blank_lp, prev_tok_masked, diag_closed, diag_open,
                             label_length), noise, grad, batch, num_t, lp1, 3, dev)
    classic_walk_grad.launches += 1
    return out


classic_walk_grad.launches = 0


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
    CPU tensors run :func:`simplified_walk_plain`.  Its backward is
    :func:`simplified_walk_grad`."""
    check_device(alpha, "simplified_walk")
    check_dtype((("alpha", alpha), ("blank_lp", blank_lp), ("diag_lp", diag_lp),
                 ("noise", noise)), torch.float32, "simplified_walk")
    return _simplified_walk(*(t.contiguous() for t in (
        alpha, blank_lp, diag_lp, label, label_length)), blank, noise.contiguous())


def _simplified_walk_steps(alpha, blank_lp, diag_lp, label_length, noise):
    """The simplified walk's loop over T (the edge determines the
    emission): yields, from the last frame down, ``(f, took_diag, cur_l,
    lm1, w_chosen, a_chosen)`` [S, B] of frame ``f``."""
    batch, num_t = blank_lp.shape
    num_s = noise.shape[0]
    device = alpha.device
    rng = torch.arange(batch, device=device)[None, :]
    cur_l = label_length[None, :].expand(num_s, batch)
    neg_inf = torch.full((num_s, batch), NEG_INF, device=device)
    for i in range(num_t):
        f = num_t - 1 - i
        a_prev = alpha[:, f]  # [B, Lp1]
        lm1 = torch.clamp(cur_l - 1, min=0)
        # the diagonal (emit label[cur_l-1] from l-1) is impossible at
        # cur_l == 0, where the clamped gather would offer a finite self-loop
        diag_w = torch.where(cur_l > 0, a_prev[rng, lm1] + diag_lp[:, f][rng, lm1],
                             neg_inf)
        w = torch.stack([a_prev[rng, cur_l] + blank_lp[:, f][None, :], diag_w], dim=2)
        choice = torch.argmax(w + noise[:, i], dim=2)
        took_diag = choice == 1
        prev_l = torch.where(took_diag, lm1, cur_l)
        yield (f, took_diag, cur_l, lm1, torch.gather(w, 2, choice[..., None])[..., 0],
               a_prev[rng, prev_l])
        cur_l = prev_l


def simplified_walk_plain(alpha: Tensor, blank_lp: Tensor, diag_lp: Tensor,
                          label: Tensor, label_length: Tensor, blank: Tensor,
                          noise: Tensor) -> Tuple[Tensor, Tensor]:
    """The plain version of the kernel ``simplified_walk``."""
    rng = torch.arange(blank_lp.shape[0], device=alpha.device)[None, :]
    acc = torch.zeros((noise.shape[0], blank_lp.shape[0]), device=alpha.device)
    emits = []
    for f, took_diag, cur_l, lm1, w, a in _simplified_walk_steps(
            alpha, blank_lp, diag_lp, label_length, noise):
        acc = acc + (w - a)
        emits.append(torch.where(took_diag, label[rng, lm1], blank))
    return acc, _emissions(emits, noise.shape[0], *blank_lp.shape, alpha.device)


_simplified_walk_op = kernel_op("simplified_walk", simplified_walk_plain)
register_fold(_simplified_walk_op, (0, 0, 0, 0, 0, None, 2), (1, 1))


@_simplified_walk_op.register_fake
def _simplified_walk_fake(alpha, blank_lp, diag_lp, label, label_length, blank, noise):
    return _walk_fake(alpha, noise)


def _check_simplified(alpha, blank_lp, diag_lp, label, label_length, blank, noise):
    return _check_walk(alpha, blank_lp, (diag_lp,), label, label_length, blank, noise, (),
                       lambda t, b: (t, b, 2))


@_simplified_walk_op.register_kernel("cuda")
def _simplified_walk_launch(alpha, blank_lp, diag_lp, label, label_length, blank, noise):
    batch, num_t, lp1, dev = _check_simplified(alpha, blank_lp, diag_lp, label,
                                               label_length, blank, noise)
    out = _launch_walk("ctc_simplified_walk", "simplified_walk",
                       (alpha, blank_lp, diag_lp, label, label_length, blank), noise,
                       batch, num_t, lp1, dev)
    simplified_walk_scan.launches += 1
    return out


simplified_walk_scan.launches = 0


def simplified_walk_grad(alpha, blank_lp, diag_lp, label, label_length, blank, noise,
                         grad) -> Tuple[Tensor, Tensor]:
    """The gradients of ``acc`` under the cotangent ``grad`` [S, B]: ``(d
    blank_lp [B, T], d diag_lp [B, T, Lp1])``, the gradient autograd takes
    through :func:`simplified_walk_plain`.

    The op ``ctc_port::simplified_walk_grad``: CUDA tensors launch
    csrc/walk.cu; CPU tensors run :func:`simplified_walk_grad_plain`."""
    check_device(alpha, "simplified_walk_grad")
    check_dtype((("alpha", alpha), ("blank_lp", blank_lp), ("diag_lp", diag_lp),
                 ("noise", noise), ("grad", grad)), torch.float32, "simplified_walk_grad")
    return _simplified_walk_grad(*(t.contiguous() for t in (
        alpha, blank_lp, diag_lp, label, label_length)), blank, noise.contiguous(),
        grad.contiguous())


def simplified_walk_grad_plain(alpha: Tensor, blank_lp: Tensor, diag_lp: Tensor,
                               label: Tensor, label_length: Tensor, blank: Tensor,
                               noise: Tensor, grad: Tensor) -> Tuple[Tensor, Tensor]:
    """The plain version of the kernel ``simplified_walk_grad``, out of
    place: ``grad[s, b]`` to ``blank_lp`` where sample ``s`` took the
    horizontal, to ``diag_lp`` at lane ``l-1`` where it took the diagonal
    from ``l > 0`` (at ``l = 0`` the diagonal is the constant ``-inf``), the
    samples in order (:func:`sample_sum`)."""
    steps = _simplified_walk_steps(alpha, blank_lp, diag_lp, label_length, noise)
    took_diag, cur_l, lm1 = _picks([step[1:4] for step in steps], 3, noise.shape[0],
                                   *blank_lp.shape, alpha.device)
    return (sample_sum(grad, ~took_diag),
            sample_sum(grad, took_diag & (cur_l > 0), lm1, diag_lp.shape[2]))


_simplified_walk_grad_op = kernel_op("simplified_walk_grad", simplified_walk_grad_plain)
register_fold(_simplified_walk_grad_op, (0, 0, 0, 0, 0, None, 2, 1), (0, 0))
_simplified_walk_grad = plain_grad(
    "simplified_walk_grad", simplified_walk_grad_plain, (1, 2, 7), (0, 1))
_simplified_walk = op_with_grad("simplified_walk", (1, 2),
                                lambda args, grads: simplified_walk_grad(*args, grads[0]))


@_simplified_walk_grad_op.register_fake
def _simplified_walk_grad_fake(alpha, blank_lp, diag_lp, label, label_length, blank,
                               noise, grad):
    return torch.empty_like(blank_lp), torch.empty_like(diag_lp)


@_simplified_walk_grad_op.register_kernel("cuda")
def _simplified_walk_grad_launch(alpha, blank_lp, diag_lp, label, label_length, blank,
                                 noise, grad):
    batch, num_t, lp1, dev = _check_simplified(alpha, blank_lp, diag_lp, label,
                                               label_length, blank, noise)
    check_tensor(grad, (noise.shape[0], batch), torch.float32, "grad", dev)
    out = _launch_walk_grad("ctc_simplified_walk_grad", "simplified_walk_grad",
                            (alpha, blank_lp, diag_lp, label_length), noise, grad, batch,
                            num_t, lp1, 1, dev)
    simplified_walk_grad.launches += 1
    return out


simplified_walk_grad.launches = 0


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
