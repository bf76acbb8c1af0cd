"""Forced alignment, sampling and decoding under ``torch.func.vmap``.

The counterpart of ``jax.vmap`` over the JAX package's extras: a leading
group axis of labels, log-probabilities and lengths (G=3 groups of the
JAX tests' B=4, T=12, V=5 inputs, each group with an infeasible row, an
empty label and a short row).  Each op's ``vmap`` rule folds the groups
into the batch (``cuda_lattice.register_fold``), so the mapped call is bit
for bit the unmapped call on each group (rows are independent), and equal
to ``jax.vmap`` of the JAX function on the same numpy inputs: alignments
and tokens exactly, scores within 1e-6.  The walk fed a fixed noise tensor
(the JAX package's own draw for each group's key) is bit for bit the loop
over groups.  The sampler follows ``vmap``'s ``randomness`` flag:
"error" raises, "same" draws one noise tensor for every group, "different"
one per group, as PyTorch draws ``torch.rand`` under each flag.
"""

import jax
import numpy as np
import pytest
import torch

import tf_seq2seq_losses_tpu as jctc
from tests.test_torch_port_align import extras_inputs
from tf_seq2seq_losses_tpu_torch import api
from tf_seq2seq_losses_tpu_torch.ops import core, sample

TOPOLOGIES = ["classic", "simplified"]
GROUPS = 3
ATOL = 1e-6


def grouped(blank=0, vocab=5):
    """``(labels, logprobas, label_length, logit_length)`` numpy arrays with
    a leading group axis."""
    per = [extras_inputs(blank, vocab=vocab, seed=30 + g) for g in range(GROUPS)]
    return tuple(np.stack([p[k] for p in per]) for k in range(4))


def assert_scores(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=ATOL, atol=ATOL)


def assert_groups(mapped, fn, args):
    """``mapped`` (outputs with a leading group axis) bit for bit ``fn`` on
    each group of ``args``."""
    for g in range(GROUPS):
        for got, want in zip(mapped, fn(*(a[g] for a in args))):
            assert got[g].dtype == want.dtype and torch.equal(got[g], want)


@pytest.mark.parametrize("blank", [0, 2])
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_forced_alignment(topology, blank):
    args = grouped(blank)
    t_args = tuple(torch.tensor(a) for a in args)

    def fn(labels, lp, ll, gl):
        return api.ctc_forced_alignment(labels, lp, ll, gl, blank, topology)

    mapped = torch.func.vmap(fn)(*t_args)
    assert_groups(mapped, fn, t_args)
    want_align, want_lp = jax.vmap(
        lambda *a: jctc.ctc_forced_alignment(*a, blank, topology))(*args)
    np.testing.assert_array_equal(mapped[0].numpy(), np.asarray(want_align))
    assert_scores(mapped[1].numpy(), want_lp)


def test_forced_alignment_with_shared_labels():
    """Labels and lengths unmapped, log-probabilities mapped: the labels
    expand over the groups."""
    labels, lp, ll, gl = grouped()
    t_lp = torch.tensor(lp)

    def fn(x):
        return api.ctc_forced_alignment(torch.tensor(labels[0]), x, torch.tensor(ll[0]),
                                        torch.tensor(gl[0]), 0)

    mapped = torch.func.vmap(fn)(t_lp)
    assert_groups(mapped, fn, (t_lp,))


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_greedy_decode(topology):
    _, lp, _, gl = grouped(vocab=4)
    t_args = (torch.tensor(lp), torch.tensor(gl))

    def fn(x, lengths):
        return api.ctc_greedy_decode(x, lengths, 0, topology)

    mapped = torch.func.vmap(fn)(*t_args)
    assert_groups(mapped, fn, t_args)
    want = jax.vmap(lambda x, n: jctc.ctc_greedy_decode(x, n, 0, topology))(lp, gl)
    for got, w in zip(mapped[:2], want[:2]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    np.testing.assert_allclose(mapped[2].numpy(), np.asarray(want[2]), rtol=ATOL, atol=ATOL)


@pytest.mark.parametrize("beam_width", [1, 4])
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_beam_search(topology, beam_width):
    _, lp, _, gl = grouped(vocab=4)
    t_args = (torch.tensor(lp), torch.tensor(gl))

    def fn(x, lengths):
        return api.ctc_beam_search_decode(x, lengths, 0, beam_width, topology)

    mapped = torch.func.vmap(fn)(*t_args)
    assert_groups(mapped, fn, t_args)
    want = jax.vmap(lambda x, n: jctc.ctc_beam_search_decode(
        x, n, 0, beam_width, topology))(lp, gl)
    for got, w in zip(mapped[:2], want[:2]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    assert_scores(mapped[2].numpy(), want[2])


def walk(topology):
    """The walk of ``topology`` on a fixed noise tensor, from the numpy-like
    inputs of one group."""
    def fn(labels, lp, ll, gl, noise):
        ctx = core.make_context(labels, lp, ll, gl, 0)
        return sample.WALKS[topology](ctx, noise)
    return fn


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_walk_on_jax_noise(topology):
    """The walk op under ``vmap`` with each group's noise the JAX package's
    draw from that group's key: bit for bit the loop over groups, equal to
    ``jax.vmap`` of ``ctc_sample_alignments`` over the keys."""
    args = grouped()
    num_s = 4
    keys = jax.random.split(jax.random.PRNGKey(5), GROUPS)
    shape = sample.noise_shape(topology, num_s, core.make_context(
        *(torch.tensor(a[0]) for a in args), 0))
    noise = np.stack([np.asarray(jax.random.gumbel(k, shape)) for k in keys])
    t_args = tuple(torch.tensor(a) for a in args) + (torch.tensor(noise),)
    mapped = torch.func.vmap(walk(topology))(*t_args)
    assert_groups(mapped, walk(topology), t_args)
    want_align, want_lp = jax.vmap(lambda *a: jctc.ctc_sample_alignments(
        *a[:4], 0, a[4], num_s, topology))(*args, keys)
    np.testing.assert_array_equal(mapped[0].numpy(), np.asarray(want_align))
    want_lp = np.asarray(want_lp)
    np.testing.assert_array_equal(np.isneginf(mapped[1].numpy()), np.isneginf(want_lp))
    fin = np.isfinite(want_lp)
    np.testing.assert_allclose(mapped[1].numpy()[fin], want_lp[fin], atol=1e-5)


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_walk_with_shared_noise(topology):
    """An unmapped noise tensor expands over the groups."""
    args = tuple(torch.tensor(a) for a in grouped())
    ctx0 = core.make_context(*(a[0] for a in args), 0)
    noise = sample.gumbel(sample.noise_shape(topology, 3, ctx0),
                          torch.Generator().manual_seed(2), "cpu")
    fn = walk(topology)
    mapped = torch.func.vmap(fn, in_dims=(0, 0, 0, 0, None))(*args, noise)
    for g in range(GROUPS):
        for got, want in zip(mapped, fn(*(a[g] for a in args), noise)):
            assert torch.equal(got[g], want)


def sampler(topology, generator, num_s=3):
    def fn(labels, lp, ll, gl):
        return api.ctc_sample_alignments(labels, lp, ll, gl, 0, generator, num_s, topology)
    return fn


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_sampler_randomness_error(topology):
    args = tuple(torch.tensor(a) for a in grouped())
    with pytest.raises(RuntimeError, match="randomness"):
        torch.func.vmap(sampler(topology, torch.Generator().manual_seed(0)))(*args)


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_sampler_randomness_same(topology):
    """Under "same" every group draws the noise of the unmapped call: each
    group is the unmapped call from the same generator state."""
    args = tuple(torch.tensor(a) for a in grouped())
    gen = torch.Generator()
    gen.manual_seed(9)
    mapped = torch.func.vmap(sampler(topology, gen), randomness="same")(*args)
    for g in range(GROUPS):
        gen.manual_seed(9)
        for got, want in zip(mapped, sampler(topology, gen)(*(a[g] for a in args))):
            assert torch.equal(got[g], want)


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_sampler_randomness_different(topology):
    """Under "different" the groups draw one noise tensor with a leading
    group axis, as ``torch.rand`` does under that flag: group ``g`` is the
    walk on its slice ``g``."""
    args = tuple(torch.tensor(a) for a in grouped())
    gen = torch.Generator()
    gen.manual_seed(4)
    num_s = 3
    mapped = torch.func.vmap(sampler(topology, gen, num_s), randomness="different")(*args)
    ctx0 = core.make_context(*(a[0] for a in args), 0)
    gen.manual_seed(4)
    noise = sample.gumbel((GROUPS,) + sample.noise_shape(topology, num_s, ctx0), gen, "cpu")
    for g in range(GROUPS):
        for got, want in zip(mapped, walk(topology)(*(a[g] for a in args), noise[g])):
            assert torch.equal(got[g], want)
    assert not torch.equal(noise[0], noise[1])


def test_mapped_blank_index_is_refused():
    """The folded batch takes one blank index."""
    labels, lp, ll, gl = (torch.tensor(a) for a in grouped())
    blanks = torch.zeros(GROUPS, dtype=torch.int64)
    with pytest.raises(ValueError, match="blank index"):
        torch.func.vmap(lambda *a: api.ctc_forced_alignment(*a))(labels, lp, ll, gl, blanks)
