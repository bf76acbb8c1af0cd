"""The topologies: pure log-space path vs the CUDA kernel path, and the
saturation guard.

Counterpart of ``ClassicTopology`` and ``SimplifiedTopology`` in
``tf_seq2seq_losses_tpu/ops/topology.py``, as one :class:`Topology` that
each topology parametrises with its pure module, its block-float kernel
functions, its exact log-space functions and its feasibility rule.

The block-float kernels flush a lattice entry that falls 2^-126 below its
window's neighbourhood; a feasible row whose fast loss comes out +inf is
then recomputed exactly.  The guard's contract, ported without the XLA
control-flow structure that served it there:

* ``flushed = isposinf(fast_loss) & feasible``;
* every flushed row is recomputed, in rounds of ``repair_bucket2`` rows,
  each on its own rows' time axis, through the log-space kernels
  (``log_fallback``; a time axis of one chunk and a label whose lanes they
  hold) or the pure path in float64, and scattered back;
* clean rows keep their fast values bit for bit;
* NaN inputs flow through (NaN is not +inf).

Finding the flushed rows is a ``nonzero()``, which waits for the device:
one host synchronisation per guarded call (and a few more per call that
repairs rows).
"""

from __future__ import annotations

import torch

from tf_seq2seq_losses_tpu_torch.ops import classic as _classic
from tf_seq2seq_losses_tpu_torch.ops import core as _core
from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice as _kernels
from tf_seq2seq_losses_tpu_torch.ops import cuda_simplified as _skernels
from tf_seq2seq_losses_tpu_torch.ops import log_lattice as _log
from tf_seq2seq_losses_tpu_torch.ops import simplified as _simplified
from tf_seq2seq_losses_tpu_torch.ops.core import CtcContext
from tf_seq2seq_losses_tpu_torch.utils.config import get_config


def kernels_enabled(ctx: CtcContext) -> bool:
    return get_config().kernels_enabled(ctx.logproba.device)


def _classic_feasible(ctx: CtcContext) -> torch.Tensor:
    """Per-sample feasibility by lengths: adjacent repeated labels each need
    an extra blank frame."""
    lab = ctx.label
    idx = torch.arange(lab.shape[1], device=lab.device)
    rep = (
        (lab == torch.roll(lab, 1, dims=1))
        & (idx[None, :] > 0)
        & (idx[None, :] < ctx.label_length[:, None])
    )
    repeats = rep.to(torch.int64).sum(dim=1)
    return ctx.logit_length >= ctx.label_length + repeats


def _simplified_feasible(ctx: CtcContext) -> torch.Tensor:
    return ctx.logit_length >= ctx.label_length


# the fields of a context with a time axis (dim 1)
_TIME_FIELDS = ("logproba", "raw_logproba", "logit_length_mask", "blank_lp")


def take_ctx(ctx: CtcContext, idx: torch.Tensor) -> CtcContext:
    """Gather a mini-batch of samples out of a context (repair rounds), its
    time axis cut to the longest ``logit_length`` among them (one step at
    least): a short row of a long batch is repaired on its own length,
    where the log-space kernels serve it."""
    sub = {name: val if name == "blank_index" else val.index_select(0, idx)
           for name, val in ctx._asdict().items()}
    num_t = int(sub["logit_length"].max().clamp(1, ctx.logproba.shape[1]))
    for name in _TIME_FIELDS:
        sub[name] = sub[name][:, :num_t]
    return CtcContext(**sub)


def _repair_rounds(ctx: CtcContext, rows: torch.Tensor, bucket: int):
    """``rows`` in rounds of at most ``bucket``, shortest first, the rows
    that fit one chunk apart from the longer ones: a round runs on its
    longest row's time axis (:func:`take_ctx`), and a short row is left to
    the log-space kernels, which serve one chunk."""
    lens = ctx.logit_length.index_select(0, rows)
    order = torch.argsort(lens, stable=True)
    rows = rows.index_select(0, order)
    short = int((lens <= _kernels.chunk_steps()).sum())  # host sync
    return [r for part in (rows[:short], rows[short:])
            for r in torch.split(part, bucket) if r.numel()]


def _guarded(fast_value, exact_fn, pure_fn, loss_like, feasible, ctx, aux=None):
    """``fast_value`` with every flushed feasible row recomputed exactly.

    ``exact_fn``/``pure_fn`` take a (mini-batch) context, plus the gathered
    rows of ``aux`` when it is given.  The mini-batch's time axis is cut to
    its rows' lengths (:func:`take_ctx`); a repaired gradient or d_logits
    is zero past ``logit_length``, so the steps cut off are zeros.
    ``pure_fn`` runs in float64 (``core.float64_context``), its result cast
    back."""
    cfg = get_config()
    if not cfg.guard:
        return fast_value
    flushed = torch.isposinf(loss_like) & feasible
    rows = torch.nonzero(flushed)[:, 0]  # host sync
    if rows.numel() == 0:
        return fast_value
    fn = exact_fn if cfg.log_fallback else pure_fn
    out = fast_value.clone()
    for idx in _repair_rounds(ctx, rows, cfg.repair_bucket2):
        sub = take_ctx(ctx, idx)
        if not cfg.log_fallback:
            sub = _core.float64_context(sub)
        mini = fn(sub) if aux is None else fn(sub, aux.index_select(0, idx))
        if out.dim() == 3:  # zeros past the cut time axis
            mini = torch.nn.functional.pad(mini, (0, 0, 0, out.shape[1] - mini.shape[1]))
        out[idx] = mini.to(out.dtype)
    return out


def compose_dlogits(ctx: CtcContext, grad, loss, d_loss):
    """``d_loss * (grad + softmax * valid)``, ``valid = (t < logit_length) &
    isfinite(loss)``: the analytic log-softmax cotangent."""
    num_t = ctx.logproba.shape[1]
    mask = (
        torch.arange(num_t, device=grad.device)[None, :] < ctx.logit_length[:, None]
    ) & torch.isfinite(loss)[:, None]
    return d_loss[:, None, None] * (grad + torch.exp(ctx.logproba) * mask[:, :, None])


class Topology:
    """One CTC topology: its pure path, its kernel path and the guard that
    repairs the kernel path's flushed rows.

    ``pure`` is the pure log-space module (``alpha``, ``beta``, ``gamma``,
    ``combine``, ``loss``); ``loss_fast``, ``loss_and_pack``,
    ``gradient_with_loss`` and ``streamed_acts`` (the acts step of the
    streamed scheme, which the fused epilogue B12 assembles) are the
    block-float kernel path;
    ``loss_exact`` and ``loss_and_gradient_log_exact`` the exact log-space
    kernels that repair it; ``feasible`` gives the rows whose loss is
    finite by their lengths; ``kernels_hold(ctx, training)`` whether the
    kernel path's kernels hold the label's lanes (a label that they do not
    hold takes the pure path, as the JAX package computes any width).
    """

    def __init__(self, name, pure, feasible, loss_fast, loss_and_pack,
                 gradient_with_loss, streamed_acts, loss_exact,
                 loss_and_gradient_log_exact, kernels_hold):
        self.name = name
        self.alpha = pure.alpha
        self.beta = pure.beta
        self.gamma = pure.gamma
        self.combine = pure.combine
        self.loss = pure.loss
        self.feasible = feasible
        self._loss_fast = loss_fast
        self._loss_and_pack = loss_and_pack
        self._gradient_with_loss = gradient_with_loss
        self._streamed_acts = streamed_acts
        self._loss_exact = loss_exact
        self._loss_and_gradient_log_exact = loss_and_gradient_log_exact
        self._kernels_hold = kernels_hold

    def _kernel_path(self, ctx: CtcContext, training: bool) -> bool:
        return kernels_enabled(ctx) and self._kernels_hold(ctx, training)

    def pure_loss(self, c: CtcContext):
        return self.loss(c, self.alpha(c))

    def _pure_grad(self, c: CtcContext):
        return _core.gradient(self, c)

    def _exact_grad(self, c: CtcContext):
        return -torch.exp(self._loss_and_gradient_log_exact(c)[1])

    def _guarded_loss(self, ctx: CtcContext, fast):
        return _guarded(
            fast, self._loss_exact, self.pure_loss, fast, self.feasible(ctx), ctx
        )

    def loss_fast(self, ctx: CtcContext):
        """Forward-only loss: the forward kernel in mode final on the
        kernel path."""
        if not self._kernel_path(ctx, training=False):
            return self.pure_loss(ctx)
        return self._guarded_loss(ctx, self._loss_fast(ctx))

    def loss_and_pack_fast(self, ctx: CtcContext):
        """Training forward: the guarded loss plus the pack that the
        backward reads (see ``cuda_lattice.classic_loss_and_pack``); the
        pack is None on the pure path."""
        if not self._kernel_path(ctx, training=True):
            return self.pure_loss(ctx), None
        fast, pack = self._loss_and_pack(ctx)
        return self._guarded_loss(ctx, fast), pack

    def gradient_fast(self, ctx: CtcContext, pack=None):
        """Gradient w.r.t. log-probabilities; the backward kernel on the
        kernel path."""
        if not self._kernel_path(ctx, training=True):
            return self._pure_grad(ctx)
        fast, fast_loss = self._gradient_with_loss(ctx, None, pack)
        return _guarded(
            fast, self._exact_grad, self._pure_grad, fast_loss, self.feasible(ctx), ctx
        )

    def dlogits_fast(self, ctx: CtcContext, d_loss, pack=None):
        """Logits cotangent ``d_loss * (grad + softmax * valid)`` on the
        kernel path (the backward kernel), guarded at the d_logits level.
        With ``fused_epilogue`` and a pack of the streamed scheme, kernel
        B12 assembles it from the acts in one pass
        (``cuda_lattice.fused_epilogue_ok``); the rows the guard repairs
        are composed unfused either way."""

        def pure(c, dl):
            loss = self.pure_loss(c)
            return compose_dlogits(c, _core.gradient(self, c, loss), loss, dl)

        def exact(c, dl):
            loss, grad_log = self._loss_and_gradient_log_exact(c)
            return compose_dlogits(c, -torch.exp(grad_log), loss, dl)

        if not self._kernel_path(ctx, training=True):
            return pure(ctx, d_loss)
        if _kernels.fused_epilogue_ok(ctx, pack):
            fast, fast_loss = _kernels.streamed_dlogits(
                ctx, d_loss, *self._streamed_acts(ctx, pack))
        else:
            grad, fast_loss = self._gradient_with_loss(ctx, None, pack)
            fast = compose_dlogits(ctx, grad, fast_loss, d_loss)
        return _guarded(
            fast, exact, pure, fast_loss, self.feasible(ctx), ctx, aux=d_loss
        )


CLASSIC = Topology(
    "classic", _classic, _classic_feasible,
    loss_fast=_kernels.classic_loss_fast,
    loss_and_pack=_kernels.classic_loss_and_pack,
    gradient_with_loss=_kernels.classic_gradient_with_loss,
    streamed_acts=_kernels.classic_streamed_acts,
    loss_exact=_log.classic_loss_exact,
    loss_and_gradient_log_exact=_log.classic_loss_and_gradient_log_exact,
    kernels_hold=_kernels.classic_kernels_hold,
)
SIMPLIFIED = Topology(
    "simplified", _simplified, _simplified_feasible,
    loss_fast=_skernels.simplified_loss_fast,
    loss_and_pack=_skernels.simplified_loss_and_pack,
    gradient_with_loss=_skernels.simplified_gradient_with_loss,
    streamed_acts=_skernels.simplified_streamed_acts,
    loss_exact=_log.simplified_loss_exact,
    loss_and_gradient_log_exact=_log.simplified_loss_and_gradient_log_exact,
    kernels_hold=_skernels.simplified_kernels_hold,
)
TOPOLOGIES = {t.name: t for t in (CLASSIC, SIMPLIFIED)}
