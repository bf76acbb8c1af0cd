"""The nested custom-autograd chain: loss -> analytic grad -> analytic
Hessian -> error, under plain autograd and under ``torch.func``.

Counterpart of ``tf_seq2seq_losses_tpu/ops/autodiff.py::build_chain`` as
nested ``torch.autograd.Function``s in the ``setup_context`` form, which
``torch.func`` (``vmap``, ``grad``, ``vjp``, ``jacrev``) requires.  Where
the JAX package builds one chain per topology, each Function here takes
the topology object (``ops/topology.py``) as a non-differentiable
argument:

* level 0, :class:`LossFromLogits`: logits -> loss; its backward is
  :class:`DLogits`, the analytic log-softmax cotangent
  ``d_loss * (grad + softmax * mask)``, the counterpart of the JAX
  package's ``dlogits_fused``: on the kernel path (unless ``guard_mode``
  is "grad") ``topology.dlogits_fast``, the fused epilogue where it
  applies, guarded at the d_logits level; otherwise the guarded
  :class:`Gradient`'s value composed with the softmax term.  Its backward
  differentiates the unfused composition, so a second derivative at the
  logits level is the same with the fusion on or off;
* level 1, :class:`Loss`: log-probabilities -> loss; backward
  ``d_loss * grad``;
* level 2, :class:`Gradient`: the analytic gradient; its backward contracts
  the cotangent with the analytic Hessian;
* level 3, :class:`Hessian`: its backward raises.

A ``setup_context`` forward has no ``ctx``, so the forward kernel's mode
comes in as the argument ``training`` (:func:`training`, computed by the
API from grad mode and the input's ``requires_grad``): the training
forward, which keeps a pack for the backward (streamed residuals, or the
residual-free scheme's carries), or the final-carry forward.  The pack is
not an output: a :class:`PackHolder` passed in as an argument carries it
from the forward to ``setup_context`` and on to the backward's Functions,
opaque to the transforms (a ``GuardedPack``'s flushed count and the chunk
plan have no batch dimension that ``vmap`` could map).

``vmap``: each Function's rule (:func:`_fold`), the counterpart of
``pallas_call``'s batching rule, moves the mapped dimension to the front,
expands the arguments that are not mapped (labels shared across groups),
folds the groups into the batch, calls the Function once on the folded
batch of G x B rows and unfolds the result.  The kernels then launch once
for the whole folded batch.  CTC is elementwise over the batch, so on the
pure path and on clean kernel rows the folded call equals a loop over the
groups bit for bit; the guard, however, sees the folded batch, and under
``guard_struct="cond"`` picks its tier from the flushed rows of all G x B
rows: past ``repair_bucket2`` of them it reroutes the whole folded batch
where a loop over the groups might not.  The result under ``vmap`` is
defined as the folded call's.  A mapped ``blank_index`` raises
``ValueError``: one blank serves the folded batch.

Under ``vmap`` of ``grad`` the folded forward fills the holder, while
the backward of the node that records it runs group by group on batched
tensors; no data-dependent operation (the guard's ``nonzero``, a kernel
launch) may run there, so every backward does its work inside a Function
with a fold rule (:class:`DLogits`, :class:`Gradient`,
:class:`Hessian`), and those see the folded shapes that the pack was
filled for.  Under a ``vmap`` that maps a cotangent alone (``jacrev``'s
basis over a backward), the pack does not fit the fold, and the folded
call runs without it (:func:`_fold_consumer`).  Backwards are built from differentiable ops and these
Functions, so ``jacrev`` of ``grad`` (or ``create_graph=True``) gives
the analytic Hessian's contraction and a third derivative raises
``NotImplementedError``.  Forward mode (``torch.func.jvp``, ``jacfwd``,
``hessian``, ``torch.autograd.forward_ad``) raises ``TypeError``, as the
JAX package's ``custom_vjp`` does.

``torch.compile(fullgraph=True)`` traces the chain through the appliers
(``apply_loss_from_logits`` and the others), which apply each Function
without its ``jvp`` rule under compile; the pack rides the holder from the
traced forward to the traced backward.  A compiled loss's backward is
AOTAutograd's, which refuses a double backward; a compiled
``ctc_loss_hessian`` on an input that requires grad raises when it is
traced (its backward raises).
"""

from __future__ import annotations

import torch

from tf_seq2seq_losses_tpu_torch.ops import core
from tf_seq2seq_losses_tpu_torch.ops.topology import (
    compose_dlogits,
    kernels_enabled,
    valid_softmax,
)
from tf_seq2seq_losses_tpu_torch.utils.config import get_config
from tf_seq2seq_losses_tpu_torch.utils.numerics import logit_to_logproba

# gradient slots of labels, label_length, logit_length, blank and topology
_NO_GRAD = (None, None, None, None, None)

_NO_FORWARD_MODE = (
    "can't apply forward-mode autodiff (jvp) to the ctc loss: its derivatives "
    "are reverse-mode rules (as the JAX package's custom_vjp); take second "
    "derivatives as jacrev of grad"
)


class PackHolder:
    """The training forward's pack (None until a training forward fills
    it, and on the pure path), handed from the forward to the backward."""

    __slots__ = ("pack",)

    def __init__(self):
        self.pack = None


def training(x: torch.Tensor) -> bool:
    """Whether a backward may follow a forward on ``x``: the forward then
    keeps a pack (training mode), else it runs the final-carry kernel."""
    return torch.is_grad_enabled() and x.requires_grad


def _context(logprobas, labels, label_length, logit_length, blank):
    return core.make_context(labels, logprobas, label_length, logit_length, blank)


def _fold(function, info, in_dims, args, n_batched):
    """The ``vmap`` rule: ``function`` once on the groups folded into the
    batch.  The first ``n_batched`` arguments have a batch dimension (the
    blank index follows them): a mapped one moves its mapped dimension to
    the front, one that is not mapped is expanded over the groups, and
    both fold ``[G, B, ...]`` into ``[G * B, ...]``; the result unfolds to
    ``[G, B, ...]``."""
    if in_dims[n_batched] is not None:
        raise ValueError(
            "vmap maps blank_index: the folded batch takes one blank_index; "
            "pass the same blank_index to every group (unmapped)"
        )
    groups = info.batch_size
    device = next(a.device for a, d in zip(args, in_dims) if d is not None)
    folded = list(args)
    for i in range(n_batched):
        x = torch.as_tensor(args[i], device=device)
        if in_dims[i] is None:
            x = x.expand(groups, *x.shape)
        else:
            x = x.movedim(in_dims[i], 0)
        folded[i] = x.flatten(0, 1)
    return function.apply(*folded).unflatten(0, (groups, -1)), 0


def _fold_loss(function, info, in_dims, args):
    """:func:`_fold` for a loss: the folded forward also trains where the
    mapped input requires grad below the ``vmap`` (a ``.backward()``
    through plain autograd follows)."""
    *head, train, holder = args
    return _fold(function, info, in_dims, (*head, train or training(head[0]), holder), 4)


def _fold_consumer(function, info, in_dims, args, n_batched):
    """:func:`_fold` for a Function that reads the pack: where the
    log-probabilities are not mapped, only a cotangent is (``jacrev``'s
    basis over a backward), and the pack, filled by a forward on the
    unmapped batch, does not fit the fold: the folded call runs without
    it."""
    if in_dims[0] is None:
        args = args[:-1] + (None,)
    return _fold(function, info, in_dims, args, n_batched)


def _pack(holder):
    return None if holder is None else holder.pack


def _hessian_vjp(logprobas, args, cotangent):
    """``cotangent`` contracted with the analytic Hessian (differentiable:
    its derivative is the Hessian's backward, which raises)."""
    hess = apply_hessian(logprobas, *args)
    return torch.einsum("bxy,btvxy->btv", cotangent, hess)


class _ReverseOnly(torch.autograd.Function):
    @staticmethod
    def jvp(ctx, *tangents):
        raise TypeError(_NO_FORWARD_MODE)


def _applier(function):
    """``function.apply``, which under ``torch.compile`` applies a subclass
    that keeps the base's ``jvp`` instead: Dynamo refuses a Function that
    defines one, and a compiled graph has no forward-mode rules anyway."""
    traced = type(function.__name__, (function,), {
        "jvp": staticmethod(torch.autograd.Function.jvp),
        "__module__": function.__module__, "__qualname__": function.__qualname__})

    def apply(*args):
        return (traced if torch.compiler.is_compiling() else function).apply(*args)

    return apply


class Hessian(_ReverseOnly):
    @staticmethod
    def forward(logprobas, labels, label_length, logit_length, blank, topology):
        c = _context(logprobas, labels, label_length, logit_length, blank)
        return core.hessian(topology, c, topology.pure_loss(c))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, d_hessian):
        raise NotImplementedError(
            "Third order derivative over the ctc loss function is not implemented."
        )

    @staticmethod
    def vmap(info, in_dims, *args):
        return _fold(Hessian, info, in_dims, args, 4)


class Gradient(_ReverseOnly):
    """Analytic gradient w.r.t. log-probabilities; ``holder`` (a
    :class:`PackHolder` or None) may hold the training forward's pack
    (kernel path)."""

    @staticmethod
    def forward(logprobas, labels, label_length, logit_length, blank, topology, holder):
        c = _context(logprobas, labels, label_length, logit_length, blank)
        return topology.gradient_fast(c, _pack(holder))

    @staticmethod
    def setup_context(ctx, inputs, output):
        logprobas, *args, _holder = inputs
        ctx.save_for_backward(logprobas)
        ctx.args = tuple(args)

    @staticmethod
    def backward(ctx, d_gradient):
        (logprobas,) = ctx.saved_tensors
        return (_hessian_vjp(logprobas, ctx.args, d_gradient),) + _NO_GRAD + (None,)

    @staticmethod
    def vmap(info, in_dims, *args):
        return _fold_consumer(Gradient, info, in_dims, args, 4)


class DLogits(_ReverseOnly):
    """The logits cotangent ``d_loss * (grad + softmax * mask)``, ``mask =
    (t < logit_length) & isfinite(loss)``, from log-probabilities: the JAX
    package's ``dlogits_fused``.  The forward takes the kernel route
    (``topology.dlogits_fast``) where the kernels are on and ``guard_mode``
    is not "grad", else the guarded gradient composed after it; the
    backward is the vector-Jacobian product of the unfused composition
    (the analytic Hessian for the gradient), whichever route ran."""

    @staticmethod
    def forward(logprobas, d_loss, loss, labels, label_length, logit_length, blank,
                topology, holder):
        c = _context(logprobas, labels, label_length, logit_length, blank)
        pack = _pack(holder)
        if kernels_enabled(c) and get_config().guard_mode != "grad":
            return topology.dlogits_fast(c, d_loss, pack)
        return compose_dlogits(c, topology.gradient_fast(c, pack), loss, d_loss)

    @staticmethod
    def setup_context(ctx, inputs, output):
        logprobas, d_loss, loss, *args, _holder = inputs
        ctx.save_for_backward(logprobas, d_loss, loss)
        ctx.args = tuple(args)

    @staticmethod
    def backward(ctx, u):
        logprobas, d_loss, loss = ctx.saved_tensors
        softmax = valid_softmax(logprobas, ctx.args[2], loss)
        weighted = d_loss[:, None, None] * u
        d_lp = _hessian_vjp(logprobas, ctx.args, weighted) + weighted * softmax
        d_dl = None
        if ctx.needs_input_grad[1]:
            grad = apply_gradient(logprobas, *ctx.args, None)
            d_dl = (u * (grad + softmax)).sum(dim=(1, 2))
        return (d_lp, d_dl, None) + _NO_GRAD + (None,)

    @staticmethod
    def vmap(info, in_dims, *args):
        return _fold_consumer(DLogits, info, in_dims, args, 6)


class Loss(_ReverseOnly):
    """Loss from log-probabilities treated as free parameters."""

    @staticmethod
    def forward(logprobas, labels, label_length, logit_length, blank, topology,
                training, holder):
        c = _context(logprobas, labels, label_length, logit_length, blank)
        if training:
            loss, holder.pack = topology.loss_and_pack_fast(c)
            return loss
        return topology.loss_fast(c)

    @staticmethod
    def setup_context(ctx, inputs, output):
        logprobas, *args, _training, holder = inputs
        ctx.save_for_backward(logprobas)
        ctx.args, ctx.holder = tuple(args), holder

    @staticmethod
    def backward(ctx, d_loss):
        (logprobas,) = ctx.saved_tensors
        grad = apply_gradient(logprobas, *ctx.args, ctx.holder)
        return (d_loss[:, None, None] * grad,) + _NO_GRAD + (None, None)

    @staticmethod
    def vmap(info, in_dims, *args):
        return _fold_loss(Loss, info, in_dims, args)


class LossFromLogits(_ReverseOnly):
    """Loss from logits with the log-softmax cotangent applied analytically
    (:class:`DLogits`): every valid frame's gradient row sums to -1, so
    ``d_logits = d_loss * (grad + softmax * mask)``."""

    @staticmethod
    def forward(logits, labels, label_length, logit_length, blank, topology,
                training, holder):
        return Loss.forward(logit_to_logproba(logits, dim=2), labels, label_length,
                            logit_length, blank, topology, training, holder)

    @staticmethod
    def setup_context(ctx, inputs, output):
        logits, *args, _training, holder = inputs
        ctx.save_for_backward(logits, output)
        ctx.args, ctx.holder = tuple(args), holder

    @staticmethod
    def backward(ctx, d_loss):
        logits, loss = ctx.saved_tensors
        logprobas = logit_to_logproba(logits, dim=2)
        d_logits = apply_dlogits(logprobas, d_loss, loss.detach(), *ctx.args,
                                 ctx.holder)
        return (d_logits,) + _NO_GRAD + (None, None)

    @staticmethod
    def vmap(info, in_dims, *args):
        return _fold_loss(LossFromLogits, info, in_dims, args)


apply_hessian = _applier(Hessian)
apply_gradient = _applier(Gradient)
apply_dlogits = _applier(DLogits)
apply_loss = _applier(Loss)
apply_loss_from_logits = _applier(LossFromLogits)
