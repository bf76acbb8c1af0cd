"""Public API of the PyTorch port: the classic and simplified CTC losses,
their analytic derivatives, token posteriors, the Hessian-vector product,
forced alignment, alignment sampling, and greedy and beam-search decoding.

Signatures follow ``tf_seq2seq_losses_tpu/api.py`` (the ``tf.nn.ctc_loss``
argument order with batch-major tensors); where the JAX package takes a
PRNG key, the port takes a ``torch.Generator``.  Every function computes on
the device of ``logits``/``logprobas``: the losses, their gradient and the
posteriors through the CUDA kernels for CUDA tensors and the pure
log-space path for CPU tensors (see ``utils/config.py``); the
Hessian-vector product, alignment, sampling and decoding run their
PyTorch code on either device, as the JAX package runs them as XLA
programs.  Logits that are not a tensor (a numpy array, a list) go to the
current CUDA device, as the JAX package puts them on its accelerator;
without a CUDA device they raise ``ValueError``: pass a CPU tensor to
compute on the CPU.  Integer outputs are int32, as the JAX package's.
"""

from __future__ import annotations

from functools import cached_property
from typing import Optional, Union

import torch

from tf_seq2seq_losses_tpu_torch.ops import align as _align
from tf_seq2seq_losses_tpu_torch.ops import core as _core
from tf_seq2seq_losses_tpu_torch.ops import decode as _decode
from tf_seq2seq_losses_tpu_torch.ops import hvp as _hvp
from tf_seq2seq_losses_tpu_torch.ops import sample as _sample
from tf_seq2seq_losses_tpu_torch.ops.autodiff import (
    PackHolder,
    apply_gradient,
    apply_hessian,
    apply_loss,
    apply_loss_from_logits,
    training,
)
from tf_seq2seq_losses_tpu_torch.ops.topology import TOPOLOGIES, Topology

IntLike = Union[int, torch.Tensor]


def _check_topology(topology: str) -> Topology:
    if topology not in TOPOLOGIES:
        raise ValueError(
            f"unknown topology {topology!r}; expected one of {sorted(TOPOLOGIES)}"
        )
    return TOPOLOGIES[topology]


def ctc_loss_from_logproba(
    labels, logprobas, label_length, logit_length, blank_index: IntLike,
    topology: str = "classic",
) -> torch.Tensor:
    """CTC loss treating log-probabilities as free parameters; the first
    derivative is the analytic gradient, the second the analytic Hessian,
    a third raises."""
    topo = _check_topology(topology)
    logprobas = _core.values_tensor(logprobas)
    return apply_loss(logprobas, labels, label_length, logit_length, blank_index, topo,
                      training(logprobas), PackHolder())


def ctc_loss(
    labels, logits, label_length, logit_length, blank_index: IntLike,
    topology: str = "classic",
) -> torch.Tensor:
    """CTC loss from logits [B, T, V]; reduced-precision logits compute in
    float32 (the gradient comes back in the input dtype)."""
    topo = _check_topology(topology)
    logits = _core.values_tensor(logits)
    if logits.ndim != 3:
        raise ValueError(
            f"logits must be rank 3 [batch, time, vocab], got shape {tuple(logits.shape)}"
        )
    logits = logits.to(torch.float32)
    return apply_loss_from_logits(logits, labels, label_length, logit_length,
                                  blank_index, topo, training(logits), PackHolder())


def classic_ctc_loss(
    labels, logits, label_length, logit_length, blank_index: IntLike = 0
) -> torch.Tensor:
    """Classic (Graves) CTC loss: repeated non-blank labels merge on decode.
    Infeasible samples get ``+inf`` loss and a zero gradient."""
    return ctc_loss(labels, logits, label_length, logit_length, blank_index, "classic")


def simplified_ctc_loss(
    labels, logits, label_length, logit_length, blank_index: IntLike = 0
) -> torch.Tensor:
    """Simplified CTC loss: blanks removed, no repeated-token merge
    (``a_bb_ccc_c -> abbccccc``).  Infeasible samples (label longer than
    logits) get ``+inf`` loss and a zero gradient."""
    return ctc_loss(labels, logits, label_length, logit_length, blank_index,
                    "simplified")


def ctc_loss_gradient(
    labels, logprobas, label_length, logit_length, blank_index: IntLike,
    topology: str = "classic",
) -> torch.Tensor:
    """Analytic loss gradient w.r.t. ``logprobas``."""
    topo = _check_topology(topology)
    return apply_gradient(_core.values_tensor(logprobas), labels, label_length,
                          logit_length, blank_index, topo, None)


def ctc_loss_hessian(
    labels, logprobas, label_length, logit_length, blank_index: IntLike,
    topology: str = "classic",
) -> torch.Tensor:
    """Analytic Hessian [B, T, V, T, V] w.r.t. ``logprobas`` (small shapes:
    O(T^2 L^2) memory)."""
    topo = _check_topology(topology)
    return apply_hessian(_core.values_tensor(logprobas), labels, label_length,
                         logit_length, blank_index, topo)


def ctc_token_posteriors(
    labels, logprobas, label_length, logit_length, blank_index: IntLike,
    topology: str = "classic",
) -> torch.Tensor:
    """Per-frame token posteriors ``P(token v emitted at frame t | labels)``
    [B, T, V]: minus the loss gradient w.r.t. log-probabilities.  Each valid
    frame's posteriors sum to 1; frames past ``logit_length`` and infeasible
    samples are all zero.  On CUDA tensors this is the gradient's kernel
    path (and its guard)."""
    return -ctc_loss_gradient(labels, logprobas, label_length, logit_length,
                              blank_index, topology)


def ctc_forced_alignment(
    labels, logprobas, label_length, logit_length, blank_index: IntLike,
    topology: str = "classic",
) -> tuple:
    """Viterbi forced alignment: ``(alignment [B, T] int32, path_logproba
    [B])``.  ``alignment[b, t]`` is the token (or blank) that the most
    probable valid path emits at frame ``t``; infeasible samples get
    ``-inf`` and all-blank frames, frames past ``logit_length`` are blank
    (``ops/align.py``)."""
    topo = _check_topology(topology)
    ctx = _core.make_context(labels, logprobas, label_length, logit_length, blank_index)
    path_lp, alignment = _align.VITERBI[topo.name](ctx)
    return alignment, path_lp


def ctc_sample_alignments(
    labels, logprobas, label_length, logit_length, blank_index: IntLike,
    generator: Optional[torch.Generator], num_samples: int = 1,
    topology: str = "classic",
) -> tuple:
    """Exact samples from the alignment posterior ``P(path | label,
    logits)``: ``(alignments [B, S, T] int32, path_logprobas [B, S])``.

    Forward filtering, backward sampling (``ops/sample.py``): one alpha
    pass shared by the ``S`` samples, then a Gumbel-max walk backwards,
    its noise drawn from ``generator`` (a generator of the log-probabilities'
    device; None draws from PyTorch's default one).  Frames past
    ``logit_length`` are blank; infeasible samples get ``-inf`` and
    all-blank alignments."""
    topo = _check_topology(topology)
    if num_samples < 1:
        raise ValueError(f"num_samples must be >= 1, got {num_samples}")
    ctx = _core.make_context(labels, logprobas, label_length, logit_length, blank_index)
    return _sample.sample(ctx, topo.name, generator, num_samples)


def _decode_inputs(logprobas, logit_length, blank_index):
    logprobas = _core.values_tensor(logprobas)
    if logprobas.ndim != 3:
        raise ValueError(f"logprobas must be rank 3, got {tuple(logprobas.shape)}")
    device = logprobas.device
    # the blank index a device fill: no host-to-device copy under capture
    return (logprobas, torch.as_tensor(logit_length, device=device),
            _core.index_tensor(blank_index, device))


def ctc_greedy_decode(
    logprobas, logit_length, blank_index: IntLike, topology: str = "classic",
    max_length: Optional[int] = None,
) -> tuple:
    """Best-path (greedy) decoding: ``(tokens [B, Lcap] int32, lengths [B]
    int32, log_probs [B])``, the ``tf.nn.ctc_greedy_decoder`` analogue.  The
    arg-max token per frame below ``logit_length``, consecutive repeats
    collapsed for ``topology='classic'`` (blank removal alone for
    ``'simplified'``), blanks dropped, survivors left-compacted; the score
    is the greedy frame path's log-probability.  ``Lcap`` is ``max_length``,
    by default T."""
    topo = _check_topology(topology)
    logprobas, logit_length, blank = _decode_inputs(logprobas, logit_length, blank_index)
    l_cap = logprobas.shape[1] if max_length is None else max_length
    return _decode.greedy_decode(logprobas, logit_length, blank, l_cap,
                                 topo.name == "classic")


def ctc_beam_search_decode(
    logprobas, logit_length, blank_index: IntLike, beam_width: int = 8,
    topology: str = "classic", max_length: Optional[int] = None,
) -> tuple:
    """CTC prefix beam search: ``(tokens [B, K, Lcap] int32, lengths [B, K]
    int32, log_probs [B, K])``, beams sorted by descending total
    probability (``ops/decode.py``).  Duplicate prefixes merge exactly; with
    ``beam_width`` at least the number of reachable prefixes the scores are
    the sequences' exact total CTC probabilities.  ``topology='classic'``
    collapses repeats, ``'simplified'`` removes blanks only.  Frames past
    ``logit_length`` are ignored."""
    topo = _check_topology(topology)
    logprobas, logit_length, blank = _decode_inputs(logprobas, logit_length, blank_index)
    if beam_width < 1:
        raise ValueError(f"beam_width must be >= 1, got {beam_width}")
    l_cap = logprobas.shape[1] if max_length is None else max_length
    return _decode.beam_search(logprobas, logit_length, blank, beam_width, l_cap,
                               topo.name == "classic")


def ctc_loss_hessian_vector_product(
    labels, logprobas, label_length, logit_length, blank_index: IntLike, vector,
    topology: str = "classic",
) -> torch.Tensor:
    """``Hessian @ vector`` [B, T, V] float32 in O(B·T·(L+V)) memory.

    The tangent of the pure analytic gradient along ``vector``, as the JAX
    package applies ``jax.jvp``: the alpha and beta recursions carry their
    tangents beside their values in the tangent scan kernels (one launch
    each on CUDA tensors, their loops on CPU tensors), the glue around them
    takes its tangent from ``torch.func.jvp`` (``ops/hvp.py``), and the
    [B, T, V, T, V] Hessian is never built.  Equals ``einsum('btvxy,bxy->btv',
    ctc_loss_hessian(...), vector)``; infeasible samples and steps past
    ``logit_length`` give exact zeros.  No host synchronisation: the call
    runs under a CUDA graph's capture, ``torch.compile(fullgraph=True)`` and
    ``torch.func.vmap``.

    Primal and tangent are cast to float32, as the JAX package casts them;
    the recursions then run in float64 (``core.float64_context``, as the
    guard's pure repairs do): in float32 their log-space values near -1e3
    keep only about 6e-5 of a unit, and the product drifts 1e-3 from
    float64 at T=500."""
    topo = _check_topology(topology)
    logprobas = _core.values_tensor(logprobas).to(torch.float32)
    vector = torch.as_tensor(vector, device=logprobas.device).to(torch.float32)
    if vector.shape != logprobas.shape:
        raise ValueError(
            "ctc_loss_hessian_vector_product: vector must match logprobas "
            f"shape {tuple(logprobas.shape)}, got {tuple(vector.shape)}"
        )
    ctx = _core.make_context(labels, logprobas, label_length, logit_length, blank_index)
    return _hvp.hvp(topo, ctx, vector).to(torch.float32)


class BaseCtcLossData:
    """Eager, cached view over the functional core for one input batch:
    ``.alpha``, ``.beta``, ``.gamma``, ``.loss``, ``.gradient``,
    ``.hessian`` and ``.logarithmic_logproba_gradient`` (pure path).  The
    topology is the subclass's ``_topology_name``."""

    _topology_name = "classic"

    def __init__(self, labels, logprobas, label_length, logit_length,
                 blank_index: IntLike = 0):
        self._topology = _check_topology(self._topology_name)
        self._ctx = _core.make_context(
            labels, logprobas, label_length, logit_length, blank_index
        )

    @cached_property
    def alpha(self) -> torch.Tensor:
        return self._topology.alpha(self._ctx)

    @cached_property
    def beta(self) -> torch.Tensor:
        return self._topology.beta(self._ctx)

    @cached_property
    def gamma(self) -> torch.Tensor:
        return self._topology.gamma(self._ctx)

    @cached_property
    def loss(self) -> torch.Tensor:
        return self._topology.loss(self._ctx, self.alpha)

    @cached_property
    def logarithmic_logproba_gradient(self) -> torch.Tensor:
        return _core.gradient_log(self._topology, self._ctx, self.loss)

    @cached_property
    def gradient(self) -> torch.Tensor:
        return -torch.exp(self.logarithmic_logproba_gradient)

    @cached_property
    def hessian(self) -> torch.Tensor:
        return _core.hessian(self._topology, self._ctx, self.loss)


class ClassicCtcLossData(BaseCtcLossData):
    """Classic topology data object."""

    _topology_name = "classic"


class SimplifiedCtcLossData(BaseCtcLossData):
    """Simplified topology data object."""

    _topology_name = "simplified"
