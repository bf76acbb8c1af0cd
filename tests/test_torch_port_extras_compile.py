"""Forced alignment, sampling and decoding under
``torch.compile(fullgraph=True)`` on the CPU (``backend="aot_eager"``).

The counterpart of ``jax.jit`` over the JAX package's extras, as its own
tests jit them.  The time loops are custom ops (``ctc_port::
classic_viterbi``, ``..._walk``, ``..._alpha32``, ``beam_search``), opaque
in the graph, so each function traces into one graph without a break, and
on the JAX tests' inputs (B=4, T=12, V=5, an infeasible row, an empty label,
a short row) the compiled call is the eager port bit for bit and equals
``jax.jit`` of the JAX function: alignments and tokens exactly, scores
within 1e-6.  The sampler compiles with ``generator=None`` (PyTorch's
default generator; from one seed the compiled and the eager call draw the
same samples on ``aot_eager``, which keeps PyTorch's random ops); Dynamo
cannot trace a ``torch.Generator``, and the call says so.
"""

import jax
import numpy as np
import pytest
import torch

import tf_seq2seq_losses_tpu as jctc
from tests.test_torch_port_align import extras_inputs, torch_args
from tests.test_torch_port_compile import (
    assert_same,
    compiled,
    fresh_dynamo,  # noqa: F401 (an autouse fixture)
)
from tf_seq2seq_losses_tpu_torch import api

TOPOLOGIES = ["classic", "simplified"]
ATOL = 1e-6


def assert_scores(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=ATOL, atol=ATOL)


@pytest.mark.parametrize("blank", [0, 2])
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_forced_alignment(topology, blank):
    args = extras_inputs(blank, seed=40 + blank)

    def fn(labels, lp, ll, gl):
        return api.ctc_forced_alignment(labels, lp, ll, gl, blank, topology)

    cf, graphs = compiled(fn)
    got = cf(*torch_args(*args))
    assert graphs.frame_count == 1
    assert f"ctc_port.{topology}_viterbi" in graphs.code
    assert_same(got, fn(*torch_args(*args)))
    want_align, want_lp = jax.jit(lambda *a: jctc.ctc_forced_alignment(
        *a, blank, topology))(*args)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want_align))
    assert_scores(got[1].numpy(), want_lp)


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_greedy_decode(topology):
    _, lp, _, gl = extras_inputs(0, vocab=4, seed=41)

    def fn(x, lengths):
        return api.ctc_greedy_decode(x, lengths, 0, topology)

    cf, graphs = compiled(fn)
    got = cf(torch.tensor(lp), torch.tensor(gl))
    assert graphs.frame_count == 1
    assert_same(got, fn(torch.tensor(lp), torch.tensor(gl)))
    want = jax.jit(lambda x, n: jctc.ctc_greedy_decode(x, n, 0, topology))(lp, gl)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=ATOL, atol=ATOL)


@pytest.mark.parametrize("beam_width", [1, 4])
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_beam_search(topology, beam_width):
    _, lp, _, gl = extras_inputs(0, vocab=4, seed=42)

    def fn(x, lengths):
        return api.ctc_beam_search_decode(x, lengths, 0, beam_width, topology)

    cf, graphs = compiled(fn)
    got = cf(torch.tensor(lp), torch.tensor(gl))
    assert graphs.frame_count == 1
    assert "ctc_port.beam_search" in graphs.code
    assert_same(got, fn(torch.tensor(lp), torch.tensor(gl)))
    want = jax.jit(lambda x, n: jctc.ctc_beam_search_decode(
        x, n, 0, beam_width, topology))(lp, gl)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert_scores(got[2].numpy(), want[2])


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_sampler_default_generator(topology):
    """One graph with ``generator=None``; from one seed of PyTorch's default
    generator the compiled call draws the eager call's samples."""
    args = torch_args(*extras_inputs(0, seed=43))

    def fn(labels, lp, ll, gl):
        return api.ctc_sample_alignments(labels, lp, ll, gl, 0, None, 5, topology)

    cf, graphs = compiled(fn)
    torch.manual_seed(3)
    got = cf(*args)
    assert graphs.frame_count == 1
    assert f"ctc_port.{topology}_walk" in graphs.code
    assert f"ctc_port.{topology}_alpha32" in graphs.code
    torch.manual_seed(3)
    assert_same(got, fn(*args))


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_sampler_walk_against_jax_jit(topology):
    """The compiled walk on the JAX package's draw equals ``jax.jit`` of
    ``ctc_sample_alignments`` under that key."""
    from tf_seq2seq_losses_tpu_torch.ops import core, sample

    labels, lp, ll, gl = extras_inputs(0, seed=44)
    key, num_s = jax.random.PRNGKey(8), 4

    def fn(labels, lp, ll, gl, noise):
        return sample.WALKS[topology](core.make_context(labels, lp, ll, gl, 0), noise)

    t_args = torch_args(labels, lp, ll, gl)
    shape = sample.noise_shape(topology, num_s, core.make_context(*t_args, 0))
    noise = torch.tensor(np.asarray(jax.random.gumbel(key, shape)))
    cf, graphs = compiled(fn)
    got = cf(*t_args, noise)
    assert graphs.frame_count == 1
    assert_same(got, fn(*t_args, noise))
    want_align, want_lp = jax.jit(lambda *a: jctc.ctc_sample_alignments(
        *a, 0, key, num_s, topology))(labels, lp, ll, gl)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want_align))
    want_lp = np.asarray(want_lp)
    fin = np.isfinite(want_lp)
    np.testing.assert_array_equal(np.isneginf(got[1].numpy()), np.isneginf(want_lp))
    np.testing.assert_allclose(got[1].numpy()[fin], want_lp[fin], atol=1e-5)


def test_sampler_generator_is_refused_under_compile():
    """Dynamo cannot trace a ``torch.Generator``: the compiled call raises
    with the port's message (``fullgraph=True``)."""
    args = torch_args(*extras_inputs(0, seed=45))
    gen = torch.Generator().manual_seed(0)
    cf, _ = compiled(lambda *a: api.ctc_sample_alignments(*a, 0, gen, 2))
    with pytest.raises(Exception, match="torch.Generator"):
        cf(*args)
