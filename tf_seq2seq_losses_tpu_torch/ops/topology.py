"""The classic topology: pure log-space path vs the CUDA kernel path, and the
saturation guard.

Counterpart of ``ClassicTopology`` in ``tf_seq2seq_losses_tpu/ops/topology.py``.
The block-float kernels flush a lattice entry that falls 2^-126 below its
window's neighbourhood; a feasible row whose fast loss comes out +inf is
then recomputed exactly.  The guard's contract, ported without the XLA
control-flow structure that served it there:

* ``flushed = isposinf(fast_loss) & feasible``;
* every flushed row is recomputed, in rounds of ``repair_bucket2`` rows,
  through the log-space kernels (``log_fallback``, single-chunk) or the
  pure path, and scattered back;
* clean rows keep their fast values bit for bit;
* NaN inputs flow through (NaN is not +inf).

Finding the flushed rows is a ``nonzero()``, which waits for the device:
one host synchronisation per guarded call.
"""

from __future__ import annotations

import torch

from tf_seq2seq_losses_tpu_torch.ops import classic as _classic
from tf_seq2seq_losses_tpu_torch.ops import core as _core
from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice as _kernels
from tf_seq2seq_losses_tpu_torch.ops import log_lattice as _log
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


def take_ctx(ctx: CtcContext, idx: torch.Tensor) -> CtcContext:
    """Gather a mini-batch of samples out of a context (repair rounds)."""
    return CtcContext(
        **{
            name: val if name == "blank_index" else val.index_select(0, idx)
            for name, val in ctx._asdict().items()
        }
    )


def _guarded(fast_value, exact_fn, pure_fn, loss_like, feasible, ctx, aux=None):
    """``fast_value`` with every flushed feasible row recomputed exactly.

    ``exact_fn``/``pure_fn`` take a (mini-batch) context, plus the gathered
    rows of ``aux`` when it is given."""
    cfg = get_config()
    if not cfg.guard:
        return fast_value
    flushed = torch.isposinf(loss_like) & feasible
    rows = torch.nonzero(flushed)[:, 0]  # host sync
    if rows.numel() == 0:
        return fast_value
    fn = exact_fn if cfg.log_fallback else pure_fn
    out = fast_value.clone()
    for idx in torch.split(rows, cfg.repair_bucket2):
        sub = take_ctx(ctx, idx)
        mini = fn(sub) if aux is None else fn(sub, aux.index_select(0, idx))
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


def _pure_loss(c: CtcContext):
    return _classic.loss(c, _classic.alpha(c))


def _pure_grad(c: CtcContext):
    return _core.gradient(ClassicTopology, c)


def _exact_grad(c: CtcContext):
    return -torch.exp(_log.classic_gradient_log_exact(c))


class ClassicTopology:
    name = "classic"

    @staticmethod
    def alpha(ctx):
        return _classic.alpha(ctx)

    @staticmethod
    def beta(ctx):
        return _classic.beta(ctx)

    @staticmethod
    def gamma(ctx):
        return _classic.gamma(ctx)

    @staticmethod
    def combine(ctx, a, b):
        return _classic.combine(ctx, a, b)

    @staticmethod
    def loss(ctx, alpha_tensor):
        return _classic.loss(ctx, alpha_tensor)

    @staticmethod
    def loss_fast(ctx: CtcContext):
        """Forward-only loss: kernel B1 (mode final) on the kernel path."""
        if not kernels_enabled(ctx):
            return _pure_loss(ctx)
        fast = _kernels.classic_loss_fast(ctx)
        return _guarded(
            fast, _log.classic_loss_exact, _pure_loss, fast,
            _classic_feasible(ctx), ctx,
        )

    @staticmethod
    def loss_and_pack_fast(ctx: CtcContext):
        """Training forward: the guarded loss plus the residual pack (kernel
        B2, mode resid); the pack is None on the pure path."""
        if not kernels_enabled(ctx):
            return _pure_loss(ctx), None
        fast, pack = _kernels.classic_loss_and_pack(ctx)
        loss = _guarded(
            fast, _log.classic_loss_exact, _pure_loss, fast,
            _classic_feasible(ctx), ctx,
        )
        return loss, pack

    @staticmethod
    def gradient_fast(ctx: CtcContext, pack=None):
        """Gradient w.r.t. log-probabilities; kernel B3 on the kernel path."""
        if not kernels_enabled(ctx):
            return _pure_grad(ctx)
        fast, fast_loss = _kernels.classic_gradient_with_loss(ctx, None, pack)
        return _guarded(
            fast, _exact_grad, _pure_grad, fast_loss, _classic_feasible(ctx), ctx
        )

    @staticmethod
    def dlogits_fast(ctx: CtcContext, d_loss, pack=None):
        """Logits cotangent ``d_loss * (grad + softmax * valid)`` on the
        kernel path (kernel B3), guarded at the d_logits level."""

        def pure(c, dl):
            loss = _pure_loss(c)
            return compose_dlogits(c, _core.gradient(ClassicTopology, c, loss), loss, dl)

        def exact(c, dl):
            loss, grad_log = _log.classic_loss_and_gradient_log_exact(c)
            return compose_dlogits(c, -torch.exp(grad_log), loss, dl)

        grad, fast_loss = _kernels.classic_gradient_with_loss(ctx, None, pack)
        fast = compose_dlogits(ctx, grad, fast_loss, d_loss)
        return _guarded(
            fast, exact, pure, fast_loss, _classic_feasible(ctx), ctx, aux=d_loss
        )


CLASSIC = ClassicTopology()
