"""Alignment sampling of the port against the JAX package's
``ctc_sample_alignments``.

The walks take their Gumbel noise as an argument: fed the very draw that
the JAX package makes from its key (``jax.random.gumbel`` of the same
shape, passed as numpy), the port's walk gives the same alignments and
path log-probs within atol 1e-5 (equal -inf patterns).  The public call,
with noise from a ``torch.Generator``, gives valid paths scored by their
frame sums, and frequencies that match the enumerated posterior within 5
sigma over 4000 draws, as ``tests/test_sample_alignments.py`` holds the
JAX package.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tf_seq2seq_losses_tpu as jctc
from tests.test_beam_search import _collapse_classic, _collapse_simplified
from tests.test_torch_port_align import (
    BLANKS,
    SHAPES,
    TOPOLOGIES,
    extras_inputs,
    log_softmax,
    torch_args,
)
from tf_seq2seq_losses_tpu_torch import api
from tf_seq2seq_losses_tpu_torch.ops import core, sample

COLLAPSE = {"classic": _collapse_classic, "simplified": _collapse_simplified}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("blank", BLANKS)
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_walk_on_jax_noise_matches_jax(topology, blank, shape):
    batch, max_t, vocab, lab_w = SHAPES[shape]
    labels, lp, ll, gl = extras_inputs(blank, batch, max_t, vocab, lab_w, seed=20 + blank)
    key, num_s = jax.random.PRNGKey(blank + 3), 6
    want_align, want_lp = jctc.ctc_sample_alignments(labels, lp, ll, gl, blank, key,
                                                     num_s, topology)
    ctx = core.make_context(*torch_args(labels, lp, ll, gl), blank)
    shape_ = sample.noise_shape(topology, num_s, ctx)
    noise = np.asarray(jax.random.gumbel(key, shape_))
    got_align, got_lp = sample.WALKS[topology](ctx, torch.tensor(noise))
    assert got_align.dtype == torch.int32 and got_align.shape == (batch, num_s, max_t)
    np.testing.assert_array_equal(got_align.numpy(), np.asarray(want_align))
    want_lp = np.asarray(want_lp)
    np.testing.assert_array_equal(np.isneginf(got_lp.numpy()), np.isneginf(want_lp))
    fin = np.isfinite(want_lp)
    np.testing.assert_allclose(got_lp.numpy()[fin], want_lp[fin], atol=1e-5)
    assert np.isneginf(got_lp[3]).all() and (got_align[3] == blank).all()


@pytest.mark.parametrize("blank", BLANKS)
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_samples_are_valid_and_scored(topology, blank):
    labels, lp, ll, gl = extras_inputs(blank, *SHAPES["t24"], seed=30 + blank)
    gen = torch.Generator().manual_seed(0)
    align, path_lp = api.ctc_sample_alignments(*torch_args(labels, lp, ll, gl), blank,
                                               gen, num_samples=8, topology=topology)
    align, path_lp = align.numpy(), path_lp.numpy()
    for b in range(len(ll)):
        if b == 3:  # infeasible
            assert np.isneginf(path_lp[b]).all() and (align[b] == blank).all()
            continue
        want = tuple(int(v) for v in labels[b, :ll[b]])
        for s in range(8):
            path = align[b, s]
            assert (path[gl[b]:] == blank).all()
            assert COLLAPSE[topology](path[:gl[b]], blank) == want, (b, s, path)
            direct = sum(float(lp[b, t, path[t]]) for t in range(gl[b]))
            np.testing.assert_allclose(path_lp[b, s], direct, atol=1e-4)


def test_generator_seed_fixes_the_draw():
    args = torch_args(*extras_inputs(0))
    one = api.ctc_sample_alignments(*args, 0, torch.Generator().manual_seed(4), 5)
    two = api.ctc_sample_alignments(*args, 0, torch.Generator().manual_seed(4), 5)
    other = api.ctc_sample_alignments(*args, 0, torch.Generator().manual_seed(5), 5)
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])
    assert not torch.equal(one[0], other[0])


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_distribution_matches_enumeration(topology):
    num_t, vocab, label = 4, 3, (1, 2)
    lp = log_softmax(np.random.RandomState(11).randn(num_t, vocab))
    paths, scores = [], []
    for path in itertools.product(range(vocab), repeat=num_t):
        if COLLAPSE[topology](path, 0) == label:
            paths.append(path)
            scores.append(sum(float(lp[t, path[t]]) for t in range(num_t)))
    assert len(paths) >= 3
    probs = np.exp(np.asarray(scores))
    cond = probs / probs.sum()

    n = 4000
    align, _ = api.ctc_sample_alignments(
        torch.tensor([list(label)]), torch.tensor(lp)[None], torch.tensor([2]),
        torch.tensor([num_t]), 0, torch.Generator().manual_seed(42), num_samples=n,
        topology=topology)
    counts = {p: 0 for p in paths}
    for row in align[0].tolist():
        assert tuple(row) in counts, f"sampled an impossible path {row}"
        counts[tuple(row)] += 1
    for p, want in zip(paths, cond):
        sigma = np.sqrt(want * (1 - want) / n)
        assert abs(counts[p] / n - want) <= 5 * sigma + 1e-9, (p, counts[p] / n, want)


def test_sampled_frequencies_match_the_posteriors():
    labels, lp, ll, gl = extras_inputs(0, batch=4, max_t=6, vocab=3, lab_w=2, seed=8)
    args = torch_args(labels, lp, ll, gl)
    post = api.ctc_token_posteriors(*args, 0).numpy()
    n = 4000
    align, _ = api.ctc_sample_alignments(*args, 0, torch.Generator().manual_seed(7), n)
    emp = (align.numpy()[..., None] == np.arange(3)).mean(axis=1)  # [B, T, V]
    valid = (np.arange(6)[None, :] < gl[:, None])[..., None] & np.isfinite(
        api.ctc_loss_from_logproba(*args, 0).numpy())[:, None, None]
    sigma = np.sqrt(np.maximum(post * (1 - post), 1e-12) / n)
    valid = np.broadcast_to(valid, post.shape)
    # 1e-6: the float32 rounding of a posterior of 1 (the empty label's blanks)
    assert np.all(np.abs(emp - post)[valid] <= (5 * sigma + 1e-6)[valid])


def test_num_samples_validation_matches_jax():
    labels, lp, ll, gl = extras_inputs(0)
    with pytest.raises(ValueError, match="num_samples must be >= 1, got 0"):
        jctc.ctc_sample_alignments(labels, jnp.asarray(lp), ll, gl, 0,
                                   jax.random.PRNGKey(0), 0)
    with pytest.raises(ValueError, match="num_samples must be >= 1, got 0"):
        api.ctc_sample_alignments(*torch_args(labels, lp, ll, gl), 0,
                                  torch.Generator(), 0)


def test_gumbel_noise_has_the_gumbel_moments():
    g = sample.gumbel((200_000,), torch.Generator().manual_seed(0), "cpu")
    assert torch.isfinite(g).all()
    # mean: the Euler-Mascheroni constant; variance pi^2 / 6
    assert abs(g.mean().item() - 0.5772157) < 0.01
    assert abs(g.var().item() - np.pi**2 / 6) < 0.03
