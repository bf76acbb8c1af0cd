"""The nested custom-autograd chain: loss -> analytic grad -> analytic
Hessian -> error.

Counterpart of ``tf_seq2seq_losses_tpu/ops/autodiff.py::build_chain`` as
nested ``torch.autograd.Function``s.  Where the JAX package builds one
chain per topology, each Function here takes the topology object
(``ops/topology.py``) as a non-differentiable argument:

* level 0, :class:`LossFromLogits`: logits -> loss; its backward is the
  analytic log-softmax cotangent ``d_loss * (grad + softmax * mask)``;
* level 1, :class:`Loss`: log-probabilities -> loss; backward
  ``d_loss * grad``;
* level 2, :class:`Gradient`: the analytic gradient; its backward contracts
  the cotangent with the analytic Hessian;
* level 3, :class:`Hessian`: its backward raises.

Inside ``Function.forward`` grad mode is off, so the forward kernel's mode
is chosen from ``ctx.needs_input_grad[0]``: the training forward, which
keeps a pack for the backward (streamed residuals, or the residual-free
scheme's carries), when a backward will follow, the final-carry forward
otherwise.  Backwards are built from differentiable ops on the saved inputs
(the log-softmax is recomputed there), so double backward works; the pack
is saved state that is never differentiated.
"""

from __future__ import annotations

import torch

from tf_seq2seq_losses_tpu_torch.ops import core
from tf_seq2seq_losses_tpu_torch.ops.topology import compose_dlogits, kernels_enabled
from tf_seq2seq_losses_tpu_torch.utils.config import get_config
from tf_seq2seq_losses_tpu_torch.utils.numerics import logit_to_logproba

# gradient slots of labels, label_length, logit_length, blank and topology
_NO_GRAD = (None, None, None, None, None)


def _context(logprobas, labels, label_length, logit_length, blank):
    return core.make_context(labels, logprobas, label_length, logit_length, blank)


class Hessian(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logprobas, labels, label_length, logit_length, blank, topology):
        c = _context(logprobas, labels, label_length, logit_length, blank)
        return core.hessian(topology, c, topology.pure_loss(c))

    @staticmethod
    def backward(ctx, d_hessian):
        raise NotImplementedError(
            "Third order derivative over the ctc loss function is not implemented."
        )


class Gradient(torch.autograd.Function):
    """Analytic gradient w.r.t. log-probabilities; ``pack`` optionally holds
    the training forward's residuals (kernel path)."""

    @staticmethod
    def forward(ctx, logprobas, labels, label_length, logit_length, blank, topology,
                pack):
        c = _context(logprobas, labels, label_length, logit_length, blank)
        ctx.save_for_backward(logprobas)
        ctx.args = (labels, label_length, logit_length, blank, topology)
        return topology.gradient_fast(c, pack)

    @staticmethod
    def backward(ctx, d_gradient):
        (logprobas,) = ctx.saved_tensors
        hess = Hessian.apply(logprobas, *ctx.args)
        cotangent = torch.einsum("bxy,btvxy->btv", d_gradient, hess)
        return (cotangent,) + _NO_GRAD + (None,)


class Loss(torch.autograd.Function):
    """Loss from log-probabilities treated as free parameters."""

    @staticmethod
    def forward(ctx, logprobas, labels, label_length, logit_length, blank, topology):
        c = _context(logprobas, labels, label_length, logit_length, blank)
        ctx.args = (labels, label_length, logit_length, blank, topology)
        if ctx.needs_input_grad[0]:
            loss, ctx.pack = topology.loss_and_pack_fast(c)
            ctx.save_for_backward(logprobas)
        else:
            loss = topology.loss_fast(c)
        return loss

    @staticmethod
    def backward(ctx, d_loss):
        (logprobas,) = ctx.saved_tensors
        grad = Gradient.apply(logprobas, *ctx.args, ctx.pack)
        return (d_loss[:, None, None] * grad,) + _NO_GRAD


class LossFromLogits(torch.autograd.Function):
    """Loss from logits with the log-softmax cotangent applied analytically:
    every valid frame's gradient row sums to -1, so
    ``d_logits = d_loss * (grad + softmax * mask)`` with
    ``mask = (t < logit_length) & isfinite(loss)``.

    On the kernel path the backward is ``topology.dlogits_fast``, guarded at
    the d_logits level; under ``guard_mode="grad"`` it guards the gradient
    (``Gradient``) and composes the cotangent after it, as the JAX
    package's ``llf_bwd`` does when ``dlogits_ok`` is false."""

    @staticmethod
    def forward(ctx, logits, labels, label_length, logit_length, blank, topology):
        logprobas = logit_to_logproba(logits, dim=2)
        c = _context(logprobas, labels, label_length, logit_length, blank)
        ctx.args = (labels, label_length, logit_length, blank, topology)
        if ctx.needs_input_grad[0]:
            loss, ctx.pack = topology.loss_and_pack_fast(c)
            ctx.save_for_backward(logits, loss)
        else:
            loss = topology.loss_fast(c)
        return loss

    @staticmethod
    def backward(ctx, d_loss):
        logits, loss = ctx.saved_tensors
        logprobas = logit_to_logproba(logits, dim=2)
        *lengths, topology = ctx.args
        c = _context(logprobas, *lengths)
        if (not torch.is_grad_enabled() and kernels_enabled(c)
                and get_config().guard_mode != "grad"):
            # the main path: kernel gradient, guarded at the d_logits level
            return (topology.dlogits_fast(c, d_loss, ctx.pack),) + _NO_GRAD
        # differentiable composition (double backward, the pure path, or
        # guard_mode="grad": the guarded gradient, then the cotangent)
        grad = Gradient.apply(logprobas, *ctx.args, ctx.pack)
        return (compose_dlogits(c, grad, loss, d_loss),) + _NO_GRAD
