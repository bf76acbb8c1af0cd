"""The Hessian-vector product of the CTC loss w.r.t. log-probabilities.

Counterpart of the JAX package's ``ctc_loss_hessian_vector_product``, which
applies ``jax.jvp`` to the pure analytic gradient, its ``lax.scan``s
included (``tf_seq2seq_losses_tpu/api.py``).  Here the tangent of each
recursion comes from a tangent scan op (``ops/pure_scan.py``: one kernel
launch on CUDA tensors, the loop over (value, tangent) pairs on CPU
tensors), and only the vectorised glue around them takes its tangent from
``torch.func.jvp``: the terms' gathers before the scans, and after them
the loss pick, ``core.gradient_log``'s ``combine`` and ``-exp``.  No
forward-mode AD runs through a loop over T, so the product runs under a
CUDA graph's capture, ``torch.compile(fullgraph=True)`` (the two scan ops
opaque in the graph) and ``torch.func.vmap`` (their ops fold the groups
into the batch).

The recursions run in float64 (``core.float64_context``), as the guard's
pure repairs do: in float32 their log-space values near -1e3 keep only
about 6e-5 of a unit, and the product drifts 1e-3 from float64 at T=500.
"""

from __future__ import annotations

import torch

from tf_seq2seq_losses_tpu_torch.ops import core, pure_scan

SCANS = {  # topology: (alpha's tangent scan, beta's)
    "classic": (pure_scan.classic_alpha_jvp64, pure_scan.classic_beta_jvp64),
    "simplified": (pure_scan.simplified_alpha_jvp64, pure_scan.simplified_beta_jvp64),
}


def _with_logproba(ctx: core.CtcContext, logproba: torch.Tensor) -> core.CtcContext:
    """``ctx`` at the (forced) log-probabilities ``logproba``."""
    return ctx._replace(logproba=logproba,
                        blank_lp=core.take_blank_logproba(logproba, ctx.blank_index))


def scan_inputs(name: str, ctx: core.CtcContext, vector: torch.Tensor):
    """``(c64, t_lp, terms, t_terms)`` at the float32 context ``ctx`` of
    topology ``name`` along ``vector`` [B, T, V]: the float64 context, the
    tangent of its forced log-probabilities (``vector`` below
    ``logit_length``, 0 past it, where the forced blank rows are
    constants), and the tangent scans' terms with their tangents
    (``torch.func.jvp`` of ``pure_scan.scan_terms``)."""
    c64 = core.float64_context(ctx)
    t_lp = torch.where(ctx.logit_length_mask[:, :, None], vector.double(), 0.0)
    terms, t_terms = torch.func.jvp(
        lambda x: pure_scan.scan_terms(name, _with_logproba(c64, x)), (c64.logproba,),
        (t_lp,))
    return c64, t_lp, terms, t_terms


def hvp(topology, ctx: core.CtcContext, vector: torch.Tensor) -> torch.Tensor:
    """``Hessian @ vector`` [B, T, V] in float64 for ``topology`` (a
    ``topology.Topology``) at the float32 context ``ctx``: the tangent of
    ``core.gradient`` along ``vector`` [B, T, V].

    The terms and their tangents come from :func:`scan_inputs`, alpha and
    beta with theirs from the topology's two tangent scans, and the
    gradient's tangent from ``torch.func.jvp`` of the loss pick and
    ``-exp(core.gradient_log(...))`` at alpha and beta."""
    c64, t_lp, terms, t_terms = scan_inputs(topology.name, ctx, vector)
    alpha_scan, beta_scan = SCANS[topology.name]
    alpha, t_alpha = alpha_scan(*terms, *t_terms)
    beta, t_beta = beta_scan(*terms, *t_terms, c64.label_length)

    def gradient(x, a, b):
        c = _with_logproba(c64, x)
        loss = topology.loss(c, a)
        return -torch.exp(core.gradient_log(topology, c, loss, a, b))

    return torch.func.jvp(gradient, (c64.logproba, alpha, beta),
                          (t_lp, t_alpha, t_beta))[1]
