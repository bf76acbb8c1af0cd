"""Greedy and beam-search decoding of the port against the JAX package's
``ctc_greedy_decode``, ``ctc_beam_search_decode`` and
``models.decoding``.

Same float32 log-probabilities into both.  Tokens and lengths are equal
exactly, over every beam (dead ones included); scores rtol 1e-5 + atol
1e-5 with equal -inf patterns.  Beam widths 1 and 4, and 64 on inputs
whose every reachable prefix it holds (scores then the exact totals, held
against an enumeration too).  The rolling hash is held against numpy's
uint32 arithmetic and the merge sort against ``np.lexsort``.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tf_seq2seq_losses_tpu as jctc
from tests.test_beam_search import _collapse_classic, _collapse_simplified
from tests.test_torch_port_align import (
    BLANKS,
    TOPOLOGIES,
    assert_scores_close,
    log_softmax,
)
from tf_seq2seq_losses_tpu.models import decoding as jdecoding
from tf_seq2seq_losses_tpu_torch import api, models
from tf_seq2seq_losses_tpu_torch.ops import decode


def decode_inputs(batch=4, max_t=12, vocab=5, seed=0):
    """``(logprobas, logit_length)``: row 1 shorter than T, row 2 of length
    0, a row 3 peaked on one token (long runs of repeats)."""
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(batch, max_t, vocab)) * 2.0
    x[3:4, :, 1] += 6.0
    gl = rng.randint(max_t // 2, max_t + 1, size=batch).astype(np.int32)
    gl[0], gl[1], gl[2] = max_t, max_t - 3, 0
    return log_softmax(x), gl


@pytest.mark.parametrize("max_length", [None, 3])
@pytest.mark.parametrize("blank", BLANKS)
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_greedy_decode_matches_jax(topology, blank, max_length):
    lp, gl = decode_inputs(seed=blank)
    want = jctc.ctc_greedy_decode(lp, gl, blank, topology, max_length)
    got = api.ctc_greedy_decode(torch.tensor(lp), torch.tensor(gl), blank, topology,
                                max_length)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5, atol=1e-5)


def test_greedy_decode_takes_the_first_maximum_on_ties():
    lp = np.zeros((1, 4, 3), np.float32)  # every frame a three-way tie
    lp[0, 2, 2] = 1.0
    want = jctc.ctc_greedy_decode(lp, np.array([4]), 1)
    got = api.ctc_greedy_decode(torch.tensor(lp), torch.tensor([4]), 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0][0, :2].tolist() == [0, 2]


@pytest.mark.parametrize("blank", BLANKS)
@pytest.mark.parametrize("name", ["greedy_decode_classic", "greedy_decode_simplified"])
def test_model_greedy_decoders_match_jax(name, blank):
    lp, gl = decode_inputs(seed=3 + blank)
    logits = lp * 1.5 + 0.25  # raw logits: arg-max invariant under log-softmax
    want = getattr(jdecoding, name)(jnp.asarray(logits), jnp.asarray(gl), blank)
    got = getattr(models, name)(torch.tensor(logits), torch.tensor(gl), blank)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _assert_beams_equal(got, want):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert_scores_close(got[2].numpy(), want[2])


@pytest.mark.parametrize("beam_width", [1, 4])
@pytest.mark.parametrize("blank", BLANKS)
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_beam_search_matches_jax(topology, blank, beam_width):
    lp, gl = decode_inputs(seed=7 + blank)
    want = jctc.ctc_beam_search_decode(lp, gl, blank, beam_width, topology)
    got = api.ctc_beam_search_decode(torch.tensor(lp), torch.tensor(gl), blank,
                                     beam_width, topology)
    assert got[0].dtype == torch.int32 and got[0].shape == (4, beam_width, 12)
    _assert_beams_equal(got, want)


def _enumerated(lp, num_t, blank, collapse):
    acc = {}
    for path in itertools.product(range(lp.shape[1]), repeat=num_t):
        seq = collapse(path, blank)
        score = sum(float(lp[t, path[t]]) for t in range(num_t))
        acc[seq] = np.logaddexp(acc.get(seq, -np.inf), score)
    return acc


@pytest.mark.parametrize("blank", BLANKS)
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_wide_beam_holds_every_prefix(topology, blank):
    # 64 beams hold the 31 sequences of length <= 4 over two tokens: nothing
    # is pruned, every live beam's score is its sequence's total probability
    lp, _ = decode_inputs(batch=3, max_t=4, vocab=3, seed=11 + blank)
    gl = np.array([4, 3, 2], np.int32)
    want = jctc.ctc_beam_search_decode(lp, gl, blank, 64, topology)
    got = api.ctc_beam_search_decode(torch.tensor(lp), torch.tensor(gl), blank, 64,
                                     topology)
    _assert_beams_equal(got, want)
    collapse = _collapse_classic if topology == "classic" else _collapse_simplified
    toks, lens, scores = (g.numpy() for g in got)
    for b in range(3):
        exact = _enumerated(lp[b, :gl[b]], gl[b], blank, collapse)
        live = np.isfinite(scores[b])
        assert live.sum() == len(exact)
        for k in np.nonzero(live)[0]:
            seq = tuple(int(v) for v in toks[b, k, :lens[b, k]])
            assert abs(scores[b, k] - exact[seq]) <= 1e-5


@pytest.mark.parametrize("mult", [decode.H1_MULT, decode.H2_MULT])
def test_hash_step_is_uint32_arithmetic(mult):
    rng = np.random.RandomState(0)
    h = rng.randint(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    h[:4] = [0, 2**32 - 1, 2**31, 2**31 | 7]  # the extremes and two sentinels
    tok = rng.randint(0, 1000, size=h.shape).astype(np.uint32)
    with np.errstate(over="ignore"):
        want = h * np.uint32(mult) + tok + np.uint32(1)
    got = decode.hash_step(torch.tensor(h.astype(np.int64)), mult,
                           torch.tensor(tok.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_merge_sort_is_a_stable_lexsort_over_uint32_keys():
    rng = np.random.RandomState(1)
    # few distinct values (many ties), and sentinels with bit 31 set
    h1 = rng.choice([0, 5, 2**31 | 3, 2**32 - 1], size=(3, 200)).astype(np.int64)
    h2 = rng.choice([1, 2**31, 7], size=(3, 200)).astype(np.int64)
    got = decode._lexsort(torch.tensor(h1), torch.tensor(h2)).numpy()
    for b in range(3):
        np.testing.assert_array_equal(got[b], np.lexsort((h2[b], h1[b])))


@pytest.mark.parametrize(
    "call,text",
    [
        (lambda m, lp: m.ctc_beam_search_decode(lp, [3], 0, beam_width=0),
         "beam_width must be >= 1, got 0"),
        (lambda m, lp: m.ctc_beam_search_decode(lp[0], [3], 0),
         r"logprobas must be rank 3, got \(3, 4\)"),
        (lambda m, lp: m.ctc_greedy_decode(lp[0], [3], 0),
         r"logprobas must be rank 3, got \(3, 4\)"),
        (lambda m, lp: m.ctc_greedy_decode(lp, [3], 0, topology="x"),
         "unknown topology 'x'"),
    ],
    ids=["beam_width", "beam_rank", "greedy_rank", "topology"],
)
def test_decode_validation_matches_jax(call, text):
    lp = np.log(np.full((1, 3, 4), 0.25, np.float32))
    with pytest.raises(ValueError, match=text):
        call(jctc, jnp.asarray(lp))
    with pytest.raises(ValueError, match=text):
        call(api, torch.tensor(lp))
