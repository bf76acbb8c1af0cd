"""Beam search's kernel route on the CPU: ``decode.beam_search_schedule``,
the plain model of csrc/beam_search.cu's steps (the pool sorted by ``(h1,
h2, pool index)``, each run merged at its head in pool-index order, the top
K by the composite selection key, back-pointers and the backtrack), and the
routing of the op ``ctc_port::beam_search``.

The model is held bit for bit to ``decode.beam_search_plain``, the loop that
the op runs on CPU tensors (tokens, lengths and scores of every beam, dead
ones included), and to the JAX package's ``ctc_beam_search_decode`` on the
same numpy inputs within the JAX suite's tolerance (tokens and lengths
exactly, scores rtol 1e-5 + atol 1e-5 with equal -inf patterns: the two
frameworks' exp and log round apart).  Both topologies, blanks 0 and 2,
beam widths 1, 4 and 64 (64 more than the reachable prefixes: dead
slots), ``max_length`` 0, 3 (below the decode length: slot Lcap-1
overwritten) and T; rows of length T, shorter and 0; uniform
log-probabilities (finite scores tied everywhere), -inf entries, and a
vocabulary of the blank alone.  The kernel itself runs on the card only:
``chip_smoke.py`` phase 14 holds it bit for bit to the loop there.
"""

import numpy as np
import pytest
import torch

import tf_seq2seq_losses_tpu as jctc
from tests.test_torch_port_align import BLANKS, TOPOLOGIES, assert_scores_close, log_softmax
from tf_seq2seq_losses_tpu_torch import api
from tf_seq2seq_losses_tpu_torch.ops import _build, decode

WIDTHS = [1, 4, 64]
MAX_LENGTHS = [0, 3, None]  # None: T


def beam_inputs(kind, blank, batch=4, max_t=10, vocab=5, seed=0):
    """``(logprobas, logit_length, blank)`` as numpy: row 0 of length T, row
    1 shorter, row 2 of length 0, row 3 peaked on one token.  ``uniform``:
    every entry log(1/V); ``neg_inf``: a token that rows 0 and 3 never emit
    and a frame of row 1 where only the blank is possible; ``blank_only``:
    V=1 (the blank is token 0); ``few``: T=4, V=3, fewer reachable prefixes
    (15) than 64 beams on every row."""
    rng = np.random.RandomState(seed + 13 * blank)
    if kind == "blank_only":
        vocab, blank = 1, 0
    if kind == "few":
        max_t, vocab = 4, 3
    x = rng.normal(size=(batch, max_t, vocab)) * 2.0
    x[3, :, (blank + 1) % vocab] += 6.0
    lp = log_softmax(x)
    if kind == "uniform":
        lp[:] = np.float32(-np.log(vocab))
    if kind == "neg_inf":
        lp[[0, 3], :, (blank + 2) % vocab] = -np.inf
        lp[1, 2] = -np.inf
        lp[1, 2, blank] = 0.0
    gl = np.array([max_t, max_t - 3, 0, max_t - 1], np.int64)
    return lp, gl, blank


def torch_args(lp, gl, blank, beam_width, max_length, topology):
    l_cap = lp.shape[1] if max_length is None else max_length
    return (torch.tensor(lp), torch.tensor(gl), torch.tensor(blank), beam_width, l_cap,
            topology == "classic")


def assert_bits_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype.is_floating_point:
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        else:
            assert torch.equal(g, w)


@pytest.mark.parametrize("max_length", MAX_LENGTHS)
@pytest.mark.parametrize("beam_width", WIDTHS)
@pytest.mark.parametrize("blank", BLANKS)
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_schedule_is_the_loop_bit_for_bit(topology, blank, beam_width, max_length):
    args = torch_args(*beam_inputs("mixed", blank), beam_width, max_length, topology)
    assert_bits_equal(decode.beam_search_schedule(*args), decode.beam_search_plain(*args))


@pytest.mark.parametrize("beam_width", WIDTHS)
@pytest.mark.parametrize("kind", ["uniform", "neg_inf", "blank_only", "few"])
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_schedule_is_the_loop_on_ties_and_neg_inf(topology, kind, beam_width):
    for blank in BLANKS:
        args = torch_args(*beam_inputs(kind, blank), beam_width, 4, topology)
        assert_bits_equal(decode.beam_search_schedule(*args),
                          decode.beam_search_plain(*args))


def test_the_cases_reach_dead_slots_and_the_last_slot():
    """The inputs reach what they are there for: K=64 over the ``few``
    inputs leaves dead slots (-inf scores) on every row; at Lcap=3 the
    ``mixed`` inputs have decodes longer than 3 (slot 2 written again)."""
    args = torch_args(*beam_inputs("few", 0), 64, None, "classic")
    assert bool(torch.isneginf(decode.beam_search_schedule(*args)[2]).any(dim=1).all())
    lp, gl, blank = beam_inputs("mixed", 0)
    capped = decode.beam_search_schedule(*torch_args(lp, gl, blank, 64, 3, "classic"))
    full = decode.beam_search_schedule(*torch_args(lp, gl, blank, 64, None, "classic"))
    assert int(capped[1].max()) == 3 and int(full[1].max()) > 3


@pytest.mark.parametrize("kind,beam_width,max_length",
                         [("mixed", 1, None), ("mixed", 4, None), ("mixed", 64, None),
                          ("mixed", 4, 0), ("mixed", 4, 3), ("uniform", 4, None),
                          ("neg_inf", 4, None), ("blank_only", 4, None),
                          ("few", 64, None)])
@pytest.mark.parametrize("blank", BLANKS)
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_schedule_matches_jax(topology, blank, kind, beam_width, max_length):
    lp, gl, blank = beam_inputs(kind, blank)
    want = jctc.ctc_beam_search_decode(lp, gl.astype(np.int32), blank, beam_width,
                                       topology, max_length)
    got = decode.beam_search_schedule(*torch_args(lp, gl, blank, beam_width, max_length,
                                                  topology))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert_scores_close(got[2].numpy(), want[2])


def test_selection_key_orders_as_a_stable_descending_sort():
    score = torch.tensor([[0.5, -np.inf, 0.5, np.nan, -0.0, 0.0, -np.inf, 3.0, -2.0,
                           np.inf, np.nan]], dtype=torch.float32)
    order = torch.argsort(decode.selection_key(score), dim=1, descending=True)
    want = torch.sort(score, dim=1, descending=True, stable=True).indices
    assert torch.equal(order, want)


def test_ranks_are_a_stable_argsort():
    score = torch.tensor([[1.0, -np.inf, 1.0, 2.0, -np.inf, np.nan, 0.0, -1.0]])
    rank = decode._ranks(score)
    order = torch.argsort(-score, dim=1, stable=True)
    assert torch.equal(torch.empty_like(order).scatter_(1, order, torch.arange(8)[None]),
                       rank)


# ---------------------------------------------------------------------------
# the op's routing
# ---------------------------------------------------------------------------


def test_op_is_a_kernel_op_with_a_cuda_kernel():
    assert torch._C._dispatch_has_kernel_for_dispatch_key("ctc_port::beam_search", "CUDA")
    assert "beam_search" in _build._SOURCES
    assert set(_build._SIGNATURES["beam_search"]) == {"ctc_beam_search",
                                                      "ctc_beam_search_grad",
                                                      "ctc_beam_search_smem_bytes"}


def test_op_runs_the_loop_on_cpu_tensors():
    """The op's CPU implementation is ``beam_search_plain`` itself: with the
    loop's code replaced by one that raises, the op raises."""
    args = torch_args(*beam_inputs("mixed", 0), 4, None, "classic")
    assert_bits_equal(torch.ops.ctc_port.beam_search(*args),
                      decode.beam_search_plain(*args))

    def raising(*_):
        raise LookupError("the loop ran")

    code = decode.beam_search_plain.__code__
    decode.beam_search_plain.__code__ = raising.__code__
    try:
        with pytest.raises(LookupError, match="the loop ran"):
            torch.ops.ctc_port.beam_search(*args)
    finally:
        decode.beam_search_plain.__code__ = code


@pytest.mark.parametrize("blank", [-1, 5])
def test_op_raises_on_a_blank_outside_the_vocabulary_on_cpu_tensors(blank):
    """The loop raises on a blank outside [0, V) (the kernel gives NaN
    scores instead: phase 14 of ``chip_smoke.py``)."""
    logprobas, logit_length, _ = beam_inputs("mixed", 0)
    args = torch_args(logprobas, logit_length, blank, 4, None, "classic")
    assert args[0].shape[2] == 5
    with pytest.raises((IndexError, RuntimeError), match="out of"):
        torch.ops.ctc_port.beam_search(*args)


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_vmap_over_groups_is_the_unmapped_call(topology):
    lp, gl, blank = beam_inputs("mixed", 2, batch=8)
    gl = np.resize(np.array([10, 7, 0, 9], np.int64), 8)
    x, n = torch.tensor(lp), torch.tensor(gl)

    def call(x_, n_):
        return api.ctc_beam_search_decode(x_, n_, blank, 4, topology)

    mapped = torch.func.vmap(call)(x.unflatten(0, (4, 2)), n.unflatten(0, (4, 2)))
    assert_bits_equal([m.flatten(0, 1) for m in mapped], call(x, n))


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_compiled_call_is_the_eager_call(topology):
    torch._dynamo.reset()
    lp, gl, blank = beam_inputs("neg_inf", 0)
    x, n = torch.tensor(lp), torch.tensor(gl)

    def call(x_, n_):
        return api.ctc_beam_search_decode(x_, n_, blank, 4, topology)

    compiled = torch.compile(call, fullgraph=True, backend="aot_eager")
    assert_bits_equal(compiled(x, n), call(x, n))
    torch._dynamo.reset()


@pytest.mark.parametrize("vocab,beam_width,staged", [(32, 8, True), (128, 4, True),
                                                     (1024, 16, False), (4000, 8, False)])
def test_pool_routes_by_shared_memory(vocab, beam_width, staged):
    """The headline's pool (K=8, V=32) and the demo's (K=4, V=128) fit one
    CTA's shared memory on an H100; K=16 at V=1024 (16400 candidates) takes
    the global scratch row."""
    need = _build.SMEM_BYTES["beam_search"](vocab, beam_width)
    assert need % 16 == 0
    assert _build.fits(("beam_search",), vocab, beam_width, torch.device("cpu")) == staged
    assert (need <= _build.SMEM_LIMIT) == staged
