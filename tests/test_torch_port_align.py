"""Forced alignment and token posteriors of the port against the JAX
package's ``ctc_forced_alignment`` and ``ctc_token_posteriors``.

Same float32 log-probabilities (numpy, seeded) into both.  Alignments are
equal exactly; path log-probs rtol 1e-5 + atol 1e-5 with equal -inf
patterns; posteriors atol 1e-5, rows summing to 1 on valid frames and zero
elsewhere.  Both topologies, blank index 0 and a nonzero one; every batch
has an infeasible row, a row with ``logit_length < T`` and an empty label.
``extras_inputs`` is shared by the other ``test_torch_port_*`` files of
these functions.
"""

import numpy as np
import pytest
import torch

import tf_seq2seq_losses_tpu as jctc
from tf_seq2seq_losses_tpu_torch import api
from tf_seq2seq_losses_tpu_torch.utils.config import config_override

TOPOLOGIES = ["classic", "simplified"]
BLANKS = [0, 2]
# (batch, T, V, label width): small, and the largest the tests use
SHAPES = {"small": (4, 12, 5, 4), "t24": (4, 24, 6, 6)}


def log_softmax(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float64)
    m = x.max(axis=-1, keepdims=True)
    return (x - m - np.log(np.exp(x - m).sum(axis=-1, keepdims=True))).astype(np.float32)


def extras_inputs(blank, batch=4, max_t=12, vocab=5, lab_w=4, seed=0):
    """``(labels, logprobas, label_length, logit_length)`` as numpy arrays.
    Row 0 is full length with a repeated label token, row 1 has
    ``logit_length < T``, row 2 an empty label, row 3 is infeasible (a label
    longer than its logits), further rows random."""
    rng = np.random.RandomState(seed)
    lp = log_softmax(rng.normal(size=(batch, max_t, vocab)) * 2.0)
    tokens = np.array([v for v in range(vocab) if v != blank])
    labels = rng.choice(tokens, size=(batch, lab_w)).astype(np.int32)
    labels[0, 1] = labels[0, 0]
    label_length = rng.randint(1, lab_w + 1, size=batch).astype(np.int32)
    logit_length = rng.randint(max_t // 2, max_t + 1, size=batch).astype(np.int32)
    label_length[0], logit_length[0] = lab_w, max_t
    logit_length[1] = max_t - 3
    label_length[2] = 0
    label_length[3], logit_length[3] = lab_w, lab_w - 1
    return labels, lp, label_length, logit_length


def torch_args(labels, lp, ll, gl):
    return (torch.tensor(labels), torch.tensor(lp), torch.tensor(ll), torch.tensor(gl))


def assert_scores_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("blank", BLANKS)
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_forced_alignment_matches_jax(topology, blank, shape):
    batch, max_t, vocab, lab_w = SHAPES[shape]
    labels, lp, ll, gl = extras_inputs(blank, batch, max_t, vocab, lab_w, seed=blank)
    want_align, want_lp = jctc.ctc_forced_alignment(labels, lp, ll, gl, blank, topology)
    got_align, got_lp = api.ctc_forced_alignment(*torch_args(labels, lp, ll, gl), blank,
                                                 topology)
    assert got_align.dtype == torch.int32 and got_align.shape == (batch, max_t)
    np.testing.assert_array_equal(got_align.numpy(), np.asarray(want_align))
    assert_scores_close(got_lp.numpy(), want_lp)
    assert np.isneginf(got_lp[3].item()) and (got_align[3] == blank).all()


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_forced_alignment_rescores_to_its_path_logproba(topology):
    labels, lp, ll, gl = extras_inputs(0, *SHAPES["t24"], seed=5)
    align, path_lp = api.ctc_forced_alignment(*torch_args(labels, lp, ll, gl), 0,
                                              topology)
    for b in range(len(ll)):
        if not np.isfinite(path_lp[b].item()):
            continue
        direct = sum(float(lp[b, t, align[b, t]]) for t in range(gl[b]))
        assert abs(direct - path_lp[b].item()) <= 1e-4
        assert (align[b, gl[b]:] == 0).all()


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("blank", BLANKS)
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_token_posteriors_match_jax(topology, blank, use_kernels):
    labels, lp, ll, gl = extras_inputs(blank, seed=10 + blank)
    want = np.asarray(jctc.ctc_token_posteriors(labels, lp, ll, gl, blank, topology))
    with config_override(use_kernels=use_kernels):
        got = api.ctc_token_posteriors(*torch_args(labels, lp, ll, gl), blank,
                                       topology).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    valid = np.arange(lp.shape[1])[None, :] < gl[:, None]
    valid[3] = False  # infeasible: all zero
    np.testing.assert_allclose(got.sum(axis=2)[valid], 1.0, atol=1e-5)
    assert (got[~valid] == 0).all()
    assert (got >= 0).all()
