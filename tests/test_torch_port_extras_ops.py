"""The custom ops of forced alignment, sampling and beam search on the CPU.

``ctc_port::classic_viterbi`` and ``ctc_port::simplified_viterbi``
(``ops/align.py``), ``ctc_port::classic_walk`` and
``ctc_port::simplified_walk`` (``ops/sample.py``), the float32 forwards
``ctc_port::classic_alpha32`` and ``ctc_port::simplified_alpha32``
(``ops/pure_scan.py``), ``ctc_port::beam_search`` and
``ctc_port::greedy_positions`` (``ops/decode.py``):
each passes ``torch.library.opcheck`` (schema, fake, dispatch), has a CUDA
kernel registered, and on CPU tensors is its plain version, the loop over
T.  Viterbi and the walks, masked, equal the JAX package's ``lax.scan``s
on the same numpy inputs (B=4, T=12, V=5 as the JAX tests, an infeasible
row, an empty label, a short row; also T=1 and -inf logits): alignments
exactly, scores within 1e-6; the walks fed the JAX package's own Gumbel
draw.  The float32 alphas are ``alpha_scan`` bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

import tf_seq2seq_losses_tpu as jctc
from tests.test_torch_port_align import extras_inputs, torch_args
from tf_seq2seq_losses_tpu_torch.ops import (
    align,
    classic,
    core,
    decode,
    pure_scan,
    sample,
    simplified,
)

TOPOLOGIES = ["classic", "simplified"]
KERNEL_OPS = ("classic_viterbi", "simplified_viterbi", "classic_walk", "simplified_walk",
              "classic_alpha32", "simplified_alpha32")
# (batch, T, V, label width, blank): the JAX tests' size, T=1, blank 2
CASES = {"jax size": (4, 12, 5, 4, 0), "T=1": (4, 1, 5, 2, 0), "blank 2": (5, 9, 6, 3, 2)}


def context(case, neg_inf=False):
    batch, max_t, vocab, lab_w, blank = CASES[case]
    labels, lp, ll, gl = extras_inputs(blank, batch, max_t, vocab, lab_w, seed=7)
    if case == "T=1":
        ll[:] = np.minimum(ll, 1)
        gl[:] = 1
        ll[3] = 2  # infeasible: two tokens in one frame
    if neg_inf:
        lp[0, :, 1] = -np.inf  # a token that row 0 can never emit
    return (labels, lp, ll, gl, blank), core.make_context(*torch_args(labels, lp, ll, gl),
                                                          blank)


def op_args(name, ctx, num_s=3, seed=0):
    """The arguments that the glue of ``ops/align.py`` and ``ops/sample.py``
    gives op ``name``."""
    topology = name.split("_")[0]
    if topology == "classic":
        t = classic.terms(ctx)
        terms = (t.blank_lp, t.prev_tok_masked, t.diag_closed, t.diag_open)
    else:
        terms = (ctx.blank_lp, core.expected_token_lp(ctx))
    terms = tuple(a.contiguous() for a in terms)
    label = (ctx.label, ctx.label_length, ctx.blank_index)
    if name.endswith("alpha32"):
        return terms
    if name.endswith("viterbi"):
        return terms + label
    alpha = (classic.alpha_scan if topology == "classic" else simplified.alpha_scan)(*terms)
    gen = torch.Generator().manual_seed(seed)
    noise = sample.gumbel(sample.noise_shape(topology, num_s, ctx), gen, "cpu")
    return (alpha,) + terms + label + (noise,)


@pytest.mark.parametrize("name", KERNEL_OPS)
def test_opcheck(name):
    """opcheck compares outputs with NaN unequal: the walk's path log-prob
    of an infeasible row is NaN (``-inf - -inf``) before ``_finish`` masks
    it, so the op is checked on the feasible rows 0-2."""
    (labels, lp, ll, gl, blank), _ = context("jax size")
    ctx = core.make_context(*(torch.tensor(a[:3]) for a in (labels, lp, ll, gl)), blank)
    op = getattr(torch.ops.ctc_port, name)
    args = op_args(name, ctx)
    torch.library.opcheck(op, args)
    with torch._subclasses.FakeTensorMode(allow_non_fake_inputs=True):
        fake = op(*args)
    want = op(*args)
    fake, want = (fake,) if torch.is_tensor(fake) else fake, (want,) if torch.is_tensor(
        want) else want
    assert [(f.shape, f.dtype) for f in fake] == [(w.shape, w.dtype) for w in want]


@pytest.mark.parametrize("merge_repeats", [True, False])
def test_beam_search_opcheck(merge_repeats):
    _, lp, _, gl = extras_inputs(0)
    args = (torch.tensor(lp), torch.tensor(gl).long(), torch.tensor(0), 3, 5, merge_repeats)
    torch.library.opcheck(torch.ops.ctc_port.beam_search, args)
    with torch._subclasses.FakeTensorMode(allow_non_fake_inputs=True):
        fake = torch.ops.ctc_port.beam_search(*args)
    want = torch.ops.ctc_port.beam_search(*args)
    assert [(f.shape, f.dtype) for f in fake] == [(w.shape, w.dtype) for w in want]
    for got, plain in zip(want, decode.beam_search_plain(*args)):
        assert torch.equal(got, plain)


@pytest.mark.parametrize("name", KERNEL_OPS)
def test_op_has_a_cuda_kernel(name):
    assert torch._C._dispatch_has_kernel_for_dispatch_key(f"ctc_port::{name}", "CUDA")


PLAIN = {
    "classic_viterbi": align.classic_viterbi_plain,
    "simplified_viterbi": align.simplified_viterbi_plain,
    "classic_walk": sample.classic_walk_plain,
    "simplified_walk": sample.simplified_walk_plain,
    "classic_alpha32": classic.alpha_scan,
    "simplified_alpha32": simplified.alpha_scan,
}
WRAPPERS = {
    "classic_viterbi": align.classic_viterbi_scan,
    "simplified_viterbi": align.simplified_viterbi_scan,
    "classic_walk": sample.classic_walk_scan,
    "simplified_walk": sample.simplified_walk_scan,
    "classic_alpha32": pure_scan.classic_alpha32,
    "simplified_alpha32": pure_scan.simplified_alpha32,
}


def same(a, b):
    """Equal bits, NaN where NaN."""
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


@pytest.mark.parametrize("neg_inf", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", KERNEL_OPS)
def test_wrapper_is_its_plain_version_on_the_cpu(name, case, neg_inf):
    """On CPU tensors a wrapper runs its plain version, counting no launch."""
    _, ctx = context(case, neg_inf)
    args = op_args(name, ctx)
    wrapper = WRAPPERS[name]
    before = wrapper.launches
    got, want = wrapper(*args), PLAIN[name](*args)
    got, want = (got,) if torch.is_tensor(got) else got, (want,) if torch.is_tensor(
        want) else want
    assert all(same(a, b) for a, b in zip(got, want))
    assert wrapper.launches == before


@pytest.mark.parametrize("neg_inf", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_viterbi_op_against_jax(topology, case, neg_inf):
    (labels, lp, ll, gl, blank), ctx = context(case, neg_inf)
    want_align, want_lp = jctc.ctc_forced_alignment(labels, lp, ll, gl, blank, topology)
    got_lp, got_align = align.VITERBI[topology](ctx)
    np.testing.assert_array_equal(got_align.numpy(), np.asarray(want_align))
    want_lp = np.asarray(want_lp)
    np.testing.assert_array_equal(np.isneginf(got_lp.numpy()), np.isneginf(want_lp))
    fin = np.isfinite(want_lp)
    np.testing.assert_allclose(got_lp.numpy()[fin], want_lp[fin], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_walk_op_on_jax_noise_against_jax(topology, case):
    (labels, lp, ll, gl, blank), ctx = context(case)
    key, num_s = jax.random.PRNGKey(11), 4
    want_align, want_lp = jctc.ctc_sample_alignments(labels, lp, ll, gl, blank, key, num_s,
                                                     topology)
    noise = np.asarray(jax.random.gumbel(key, sample.noise_shape(topology, num_s, ctx)))
    got_align, got_lp = sample.WALKS[topology](ctx, torch.tensor(noise))
    np.testing.assert_array_equal(got_align.numpy(), np.asarray(want_align))
    want_lp = np.asarray(want_lp)
    np.testing.assert_array_equal(np.isneginf(got_lp.numpy()), np.isneginf(want_lp))
    fin = np.isfinite(want_lp)
    np.testing.assert_allclose(got_lp.numpy()[fin], want_lp[fin], rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("name", ["classic_viterbi", "classic_walk", "simplified_alpha32"])
def test_float64_terms_are_refused(name):
    _, ctx = context("jax size")
    args = [a.double() if a.is_floating_point() else a for a in op_args(name, ctx)]
    with pytest.raises(TypeError, match="float32"):
        WRAPPERS[name](*args)


def test_greedy_positions_opcheck():
    """``ctc_port::greedy_positions``, the compacted slots of greedy
    decoding: the cumsum it wraps, through opcheck."""
    keep = torch.tensor(np.random.RandomState(0).rand(4, 12) > 0.5)
    torch.library.opcheck(torch.ops.ctc_port.greedy_positions, (keep,))
    assert torch.equal(torch.ops.ctc_port.greedy_positions(keep),
                       torch.cumsum(keep.long(), dim=1) - 1)
