"""Gradients through the scores of forced alignment, sampling and beam search.

The scans behind them are custom ops (``ctc_port::classic_viterbi``,
``simplified_viterbi``, ``classic_walk``, ``simplified_walk``,
``beam_search``).  Their backwards are ops of their own
(``ctc_port::classic_viterbi_grad`` and the others, beam search's
``ctc_port::beam_search_grad``; ``cuda_lattice.op_with_grad``).  So
``path_logproba``, the samples' path
log-probabilities and the beam scores are differentiable as the loops
are: the gradient is bit for bit autograd through the loops (the wrappers
patched to them), ``torch.func.grad`` and
``torch.compile(fullgraph=True, backend="aot_eager")`` give the same bits as
``.backward()``, and all equal ``jax.grad`` of the JAX package's function on
the same numpy inputs (B=4, T=12, V=5 as the JAX tests, an infeasible row,
an empty label, a short row) within 1e-6, the walks fed the JAX package's
own Gumbel draw.  The scores of infeasible rows (``-inf``) are left out of
the differentiated sum, as a user would.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tf_seq2seq_losses_tpu as jctc
from tests.test_torch_port_align import extras_inputs, torch_args
from tf_seq2seq_losses_tpu_torch import api
from tf_seq2seq_losses_tpu_torch.ops import align, core, decode, sample

TOPOLOGIES = ["classic", "simplified"]
ATOL = 1e-6
NUM_S = 4
BEAM = 4


def finite_sum(scores):
    return torch.where(torch.isfinite(scores), scores, 0.0).sum()


def jax_finite_sum(scores):
    return jnp.where(jnp.isfinite(scores), scores, 0.0).sum()


def inputs(blank, seed):
    labels, lp, ll, gl = extras_inputs(blank, seed=seed)
    return (labels, lp, ll, gl), torch_args(labels, lp, ll, gl)


def scores(kind, topology, blank, labels, ll, gl, noise=None):
    """The score of ``kind`` as a function of the log-probabilities."""
    if kind == "alignment":
        return lambda x: finite_sum(
            api.ctc_forced_alignment(labels, x, ll, gl, blank, topology)[1])
    if kind == "samples":
        return lambda x: finite_sum(sample.WALKS[topology](
            core.make_context(labels, x, ll, gl, blank), noise)[1])
    return lambda x: finite_sum(api.ctc_beam_search_decode(x, gl, blank, BEAM,
                                                           topology)[2])


def jax_scores(kind, topology, blank, labels, ll, gl, key):
    if kind == "alignment":
        return lambda x: jax_finite_sum(
            jctc.ctc_forced_alignment(labels, x, ll, gl, blank, topology)[1])
    if kind == "samples":
        return lambda x: jax_finite_sum(
            jctc.ctc_sample_alignments(labels, x, ll, gl, blank, key, NUM_S, topology)[1])
    return lambda x: jax_finite_sum(
        jctc.ctc_beam_search_decode(x, gl, blank, BEAM, topology)[2])


def setup(kind, topology, blank):
    """``(numpy args, torch score, jax score)`` on the JAX tests' inputs,
    the walk fed ``jax.random.gumbel`` of the JAX sampler's key."""
    np_args, t_args = inputs(blank, seed=40 + blank)
    labels, lp, ll, gl = t_args
    key = jax.random.PRNGKey(blank + 5)
    noise = None
    if kind == "samples":
        ctx = core.make_context(*t_args, blank)
        noise = torch.tensor(np.asarray(
            jax.random.gumbel(key, sample.noise_shape(topology, NUM_S, ctx))))
    n_labels, _, n_ll, n_gl = np_args
    return (np_args, scores(kind, topology, blank, labels, ll, gl, noise),
            jax_scores(kind, topology, blank, n_labels, n_ll, n_gl, key))


def grad_of(fn, lp):
    x = lp.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(fn(x), x)
    return g


@contextlib.contextmanager
def plain_scans():
    """The wrappers of Viterbi and the walks, and beam search's op, patched
    to their loops, which autograd differentiates directly."""
    patches = ((align, "classic_viterbi_scan", align.classic_viterbi_plain),
               (align, "simplified_viterbi_scan", align.simplified_viterbi_plain),
               (sample, "classic_walk_scan", sample.classic_walk_plain),
               (sample, "simplified_walk_scan", sample.simplified_walk_plain),
               (decode, "_beam_search", decode.beam_search_plain))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    try:
        for mod, name, fn in patches:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@pytest.mark.parametrize("blank", [0, 2])
@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("kind", ["alignment", "samples", "beam"])
def test_score_gradient_matches_jax(kind, topology, blank):
    np_args, fn, jax_fn = setup(kind, topology, blank)
    lp = torch.tensor(np_args[1])
    got = grad_of(fn, lp)
    want = np.asarray(jax.grad(jax_fn)(jnp.asarray(np_args[1])))
    assert got.abs().sum() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=ATOL, atol=ATOL)


@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("kind", ["alignment", "samples", "beam"])
def test_score_gradient_is_the_loops(kind, topology):
    """Bit for bit autograd through the plain loops."""
    np_args, fn, _ = setup(kind, topology, 0)
    lp = torch.tensor(np_args[1])
    got = grad_of(fn, lp)
    with plain_scans():
        want = grad_of(fn, lp)
    assert torch.equal(got, want)


@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("kind", ["alignment", "samples", "beam"])
def test_score_gradient_under_func_grad(kind, topology):
    np_args, fn, _ = setup(kind, topology, 0)
    lp = torch.tensor(np_args[1])
    assert torch.equal(torch.func.grad(fn)(lp), grad_of(fn, lp))


@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("kind", ["alignment", "samples", "beam"])
def test_score_gradient_under_compile(kind, topology):
    np_args, fn, _ = setup(kind, topology, 0)
    lp = torch.tensor(np_args[1])
    torch._dynamo.reset()
    compiled = torch.compile(fn, fullgraph=True, backend="aot_eager")
    assert torch.equal(grad_of(compiled, lp), grad_of(fn, lp))


def test_no_gradient_asked_calls_the_op_alone():
    """Without a gradient the op is called directly: the scores carry no
    autograd node."""
    np_args, t_args = inputs(0, seed=40)
    _, path_lp = api.ctc_forced_alignment(*t_args, 0)
    assert path_lp.grad_fn is None
    lp = t_args[1].clone().requires_grad_(True)
    _, path_lp = api.ctc_forced_alignment(t_args[0], lp, t_args[2], t_args[3], 0)
    assert path_lp.grad_fn is not None
