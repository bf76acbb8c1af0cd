"""The chunked long-T path and the residual-free scheme of the classic
topology (kernels B1 with an initial carry, B10 forward mode bound and
backward), on their plain PyTorch versions, against the JAX package.

The JAX package runs its chunked path in interpret mode, as
tests/test_pallas.py does (``block_batch=2, block_time=4, chunk_time=8``:
windows of 4 steps); the port runs the same windows (``window=4``).  Loss
atol 1e-4, gradient atol 1e-5, as in tests/test_pallas.py.  Chunked against
unchunked, residual-free against streamed and the carry checks are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_seq2seq_losses_tpu.ops import core as jax_core
from tf_seq2seq_losses_tpu.ops import pallas_lattice as jax_pk
from tf_seq2seq_losses_tpu.utils.config import config_override as jax_config
from tf_seq2seq_losses_tpu_torch import api
from tf_seq2seq_losses_tpu_torch.ops import core
from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice as cl
from tf_seq2seq_losses_tpu_torch.ops import cuda_simplified as cs
from tf_seq2seq_losses_tpu_torch.ops import log_lattice as ll
from tf_seq2seq_losses_tpu_torch.utils.config import config_override
from tf_seq2seq_losses_tpu_torch.utils.numerics import logit_to_logproba

JAX_CHUNKED = dict(use_pallas=True, interpret=True, block_batch=2, block_time=4,
                   chunk_time=8)


def _case(batch=4, max_t=37, vocab=6, lab_w=10, seed=0, label_length=None,
          logit_length=None):
    rng = np.random.RandomState(seed)
    logits = rng.normal(size=(batch, max_t, vocab)).astype(np.float32)
    lp = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)
    labels = rng.randint(1, vocab, size=(batch, lab_w)).astype(np.int32)
    if label_length is None:
        label_length = rng.randint(1, lab_w + 1, size=batch)
    if logit_length is None:
        logit_length = rng.randint(max_t // 2, max_t + 1, size=batch)
    return (labels, lp, np.asarray(label_length, np.int32),
            np.asarray(logit_length, np.int32))


def _jax_ctx(case):
    labels, lp, lab_len, logit_len = case
    return jax_core.make_context(jnp.asarray(labels), jnp.asarray(lp),
                                 jnp.asarray(lab_len), jnp.asarray(logit_len), 0)


def _ctx(case):
    labels, lp, lab_len, logit_len = case
    return core.make_context(torch.tensor(labels), torch.tensor(lp),
                             torch.tensor(lab_len), torch.tensor(logit_len), 0)


def _loss_close(ours, ref, atol=1e-4):
    ours, ref = np.asarray(ours), np.asarray(ref)
    np.testing.assert_array_equal(np.isposinf(ours), np.isposinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(ours[fin], ref[fin], atol=atol, rtol=0)


def _port(ctx, **cfg):
    """(forward-only loss, training loss, gradient, fast loss, pack)."""
    with config_override(window=4, **cfg):
        fast = cl.classic_loss_fast(ctx)
        loss, pack = cl.classic_loss_and_pack(ctx)
        grad, beta_loss = cl.classic_gradient_with_loss(ctx, None, pack)
    return fast, loss, grad, beta_loss, pack


@pytest.mark.parametrize(
    "kw",
    [
        dict(seed=1),  # T = 37: 5 chunks of 8, the last one overhanging T
        # row 2 ends inside the first chunk, row 3 is empty, row 0 infeasible
        dict(seed=2, max_t=21, label_length=[9, 4, 2, 3], logit_length=[5, 21, 6, 0]),
    ],
)
def test_chunked_plain_path_matches_jax_chunked_interpret(kw):
    case = _case(**kw)
    jctx = _jax_ctx(case)
    with jax_config(**JAX_CHUNKED):
        j_loss = jax_pk.classic_loss_fast(jctx)
        j_grad, j_fast = jax_pk.classic_gradient_with_loss(jctx)
    fast, loss, grad, beta_loss, pack = _port(_ctx(case), chunk_time=8)
    assert isinstance(pack, cl.ChunkPack) and len(pack.carries) > 1
    _loss_close(fast, j_loss)
    _loss_close(loss, j_loss)
    _loss_close(beta_loss, j_fast)
    np.testing.assert_allclose(grad.numpy(), np.asarray(j_grad), atol=1e-5)


def test_residual_free_single_chunk_matches_jax():
    case = _case(seed=3, max_t=21)
    jctx = _jax_ctx(case)
    with jax_config(use_pallas=True, interpret=True, block_batch=2, block_time=4,
                    stream_residuals=False):
        j_loss, _ = jax_pk.classic_loss_and_pack(jctx)
        j_grad, j_fast = jax_pk.classic_gradient_with_loss(jctx)
    fast, loss, grad, beta_loss, pack = _port(_ctx(case), stream_residuals=False)
    assert isinstance(pack, cl.ChunkPack) and pack.bounds is not None
    _loss_close(loss, j_loss)
    _loss_close(beta_loss, j_fast)
    np.testing.assert_allclose(grad.numpy(), np.asarray(j_grad), atol=1e-5)


@pytest.mark.parametrize("seed", [4, 5])
def test_chunked_equals_unchunked_and_residual_free_equals_streamed(seed):
    ctx = _ctx(_case(seed=seed, max_t=40, logit_length=None))
    streamed = _port(ctx)
    single_rf = _port(ctx, stream_residuals=False)
    for chunk_time in (8, 16, 24):
        chunked = _port(ctx, chunk_time=chunk_time)
        for ours, ref in zip(chunked[:4], streamed[:4]):
            assert torch.equal(ours, ref)
    assert isinstance(streamed[4], cl.StreamPack)
    for ours, ref in zip(single_rf[:4], streamed[:4]):
        assert torch.equal(ours, ref)


def test_residual_free_acts_equal_the_streamed_acts():
    ctx = _ctx(_case(seed=6, max_t=24))
    blank, dcu, lm, nb, rep, lens, lab_len, k_win = cl.kernel_inputs(ctx)
    sa, saf, *carry = cl.classic_fwd(blank, dcu, lm, nb, rep, lens, k_win, "resid")
    bd0, bd1, bde, *bound_carry = cl.classic_fwd(blank, dcu, lm, nb, rep, lens, k_win,
                                                 "bound")
    for a, b in zip(carry, bound_carry):
        assert torch.equal(a, b)
    ebi = cl.ebi_from_loss(cl.pick_loss(carry[0] + carry[1], carry[2], lab_len))
    streamed = cl.classic_bwd_streamed(blank, dcu, lm, nb, rep, lens, lab_len, ebi,
                                       sa, saf, k_win)
    free = cl.classic_bwd(blank, dcu, lm, nb, rep, lens, lab_len, ebi, bd0, bd1, bde,
                          k_win)
    for a, b in zip(free, streamed):
        assert torch.equal(a, b)


def test_explicit_standard_init_equals_the_default():
    ctx = _ctx(_case(seed=7, max_t=24))
    blank, dcu, lm, nb, rep, lens, lab_len, k_win = cl.kernel_inputs(ctx)
    batch, _, lpad = dcu.shape
    init = cl.alpha_init(batch, lpad, dcu.device, 2)
    for mode in ("final", "bound"):
        ref = cl.classic_fwd_plain(blank, dcu, lm, nb, rep, lens, k_win, mode)
        ours = cl.classic_fwd_plain(blank, dcu, lm, nb, rep, lens, k_win, mode, init)
        for a, b in zip(ours, ref):
            assert torch.equal(a, b)
    ebi = torch.zeros(batch)
    bounds = cl.classic_fwd_plain(blank, dcu, lm, nb, rep, lens, k_win, "bound")[:3]
    ref = cl.classic_bwd_plain(blank, dcu, lm, nb, rep, lens, lab_len, ebi, *bounds,
                               k_win)
    ours = cl.classic_bwd_plain(blank, dcu, lm, nb, rep, lens, lab_len, ebi, *bounds,
                                k_win, cl.beta_init(lab_len, lpad, 2))
    for a, b in zip(ours, ref):
        assert torch.equal(a, b)


def test_zero_relative_length_passes_the_carry_through():
    ctx = _ctx(_case(seed=8, max_t=16))
    blank, dcu, lm, nb, rep, lens, lab_len, k_win = cl.kernel_inputs(ctx)
    batch, tpad, lpad = dcu.shape
    # a carry in mid-scan: the final carry of the whole axis
    carry = cl.classic_fwd(blank, dcu, lm, nb, rep, lens, k_win, "final")
    zero = torch.zeros_like(lens)
    out = cl.classic_fwd(blank, dcu, lm, nb, rep, zero, k_win, "final", init=carry)
    *bounds, f0, f1, fe = cl.classic_fwd(blank, dcu, lm, nb, rep, zero, k_win, "bound",
                                         init=carry)
    for a, b in zip(out, carry):
        assert torch.equal(a, b)
    for a, b in zip((f0, f1, fe), carry):
        assert torch.equal(a, b)
    for bound, c in zip(bounds, carry):
        assert all(torch.equal(bound[w], c) for w in range(tpad // k_win))
    beta = cl.beta_init(lab_len, lpad, 2)
    beta = (beta[0] * 0.5, beta[1] * 0.25, beta[2] + 3)
    pc, *beta_out = cl.classic_bwd(blank, dcu, lm, nb, rep, zero, lab_len,
                                   torch.zeros(batch), *bounds, k_win, beta)
    assert not pc.any()
    for a, b in zip(beta_out, beta):
        assert torch.equal(a, b)


def test_training_launch_plan(monkeypatch):
    # per chunk: one forward in mode final; in the backward, mode bound and
    # the residual-free scan; one chunk without streaming: bound, then one scan
    modes, scans = [], []
    real_fwd, real_bwd = cl.classic_fwd, cl.classic_bwd

    def spy_fwd(*a, **kw):
        modes.append(a[7])
        return real_fwd(*a, **kw)

    def spy_bwd(*a, **kw):
        scans.append(a[0].shape[1])
        return real_bwd(*a, **kw)

    monkeypatch.setattr(cl, "classic_fwd", spy_fwd)
    monkeypatch.setattr(cl, "classic_bwd", spy_bwd)
    ctx = _ctx(_case(seed=9, max_t=37))
    with config_override(chunk_time=16):
        loss, pack = cl.classic_loss_and_pack(ctx)
        cl.classic_gradient_with_loss(ctx, loss, pack)
    # 37 steps padded to 40, in 3 chunks of 16
    assert modes == ["final"] * 3 + ["bound"] * 3 and scans == [16] * 3
    modes.clear(), scans.clear()
    with config_override(stream_residuals=False):
        loss, pack = cl.classic_loss_and_pack(ctx)
        cl.classic_gradient_with_loss(ctx, loss, pack)
    assert modes == ["bound"] and scans == [40]


def _loss_and_dlogits(labels, logits, ll_, gl, **cfg):
    x = torch.tensor(logits, requires_grad=True)
    with config_override(**cfg):
        loss = api.classic_ctc_loss(torch.tensor(labels), x, torch.tensor(ll_),
                                    torch.tensor(gl), 0)
    torch.where(torch.isfinite(loss), loss, torch.zeros_like(loss)).sum().backward()
    return loss.detach(), x.grad


def test_dlogits_through_backward_on_the_chunked_path():
    rng = np.random.RandomState(10)
    labels = rng.randint(1, 5, size=(3, 8)).astype(np.int32)
    logits = rng.normal(size=(3, 33, 5)).astype(np.float32)
    lab_len = np.array([8, 3, 6], np.int32)
    logit_len = np.array([33, 20, 4], np.int32)  # row 2 infeasible
    ref = _loss_and_dlogits(labels, logits, lab_len, logit_len)
    ours = _loss_and_dlogits(labels, logits, lab_len, logit_len, use_kernels=True,
                             chunk_time=8)
    _loss_close(ours[0].numpy(), ref[0].numpy(), atol=1e-5)
    assert torch.isposinf(ours[0][2]) and not ours[1][2].any()
    np.testing.assert_allclose(ours[1].numpy(), ref[1].numpy(), atol=1e-5)


def test_guard_beyond_chunk_time_repairs_through_the_pure_path(monkeypatch):
    rng = np.random.RandomState(11)
    labels = rng.randint(1, 4, size=(3, 4)).astype(np.int32)
    logits = rng.normal(size=(3, 30, 5)).astype(np.float32)
    lab_len = np.array([4, 4, 3], np.int32)
    logit_len = np.array([30, 25, 30], np.int32)
    clean = _loss_and_dlogits(labels, logits, lab_len, logit_len, use_kernels=True,
                              chunk_time=8)
    # row 1: token 4 (absent from every label) at +100 and the rest at -100
    # at frame 3, so the block-float scans flush
    logits[1, 3] = -100.0
    logits[1, 3, 4] = 100.0
    calls = []
    monkeypatch.setattr(ll, "classic_log_fwd", lambda *a: calls.append(a))
    fast = _loss_and_dlogits(labels, logits, lab_len, logit_len, use_kernels=True,
                             chunk_time=8)
    pure = _loss_and_dlogits(labels, logits, lab_len, logit_len)
    assert not calls
    np.testing.assert_allclose(fast[0][1].numpy(), pure[0][1].numpy(), atol=2e-4)
    np.testing.assert_allclose(fast[1][1].numpy(), pure[1][1].numpy(), atol=2e-4)
    for i in (0, 2):
        assert torch.equal(fast[0][i], clean[0][i])
        assert torch.equal(fast[1][i], clean[1][i])


def test_forward_and_beta_losses_that_disagree_flag_the_row():
    # rows: agreeing (an ulp apart), 1e-4 of the loss apart (a lane lost
    # mass in one scan), flushed forward with a finite beta, infeasible
    # (both +inf), NaN input
    fwd = torch.tensor([7552.019, 7552.019, float("inf"), float("inf"), float("nan")])
    target = torch.tensor([7552.019 + 4.9e-4, 7551.2, 7500.0, float("inf"),
                           float("nan")])
    # beta carries m * 2^e whose losses are the targets
    e = torch.where(torch.isfinite(target), torch.floor(-target / cl.LN2),
                    torch.zeros_like(target)).to(torch.int32)
    m = torch.exp(-target.double() - e.double() * float(cl.LN2)).float()
    m = torch.where(torch.isposinf(target), torch.zeros_like(m), m)
    m = torch.where(torch.isnan(target), torch.full_like(m, float("nan")), m)
    fast = cl.beta_carry_loss(fwd, m, e, torch.full((5,), 4000))
    assert torch.isfinite(fast[0]) and abs(float(fast[0]) - 7552.0195) < 1e-3
    assert torch.isposinf(fast[1:4]).all()
    assert torch.isnan(fast[4])


def _beta_carry_of(target):
    e = torch.floor(-target / cl.LN2).to(torch.int32)
    return torch.exp(-target.double() - e.double() * float(cl.LN2)).float(), e


def test_scan_gap_limit_grows_with_the_steps():
    # a low loss: 1e-4 nats of drift over 4000 steps is rounding (under an
    # ulp of 1 a step); 1e-3 nats is not, nor 1e-4 over 100 steps
    fwd = torch.tensor([0.5, 0.5, 0.5])
    target = torch.tensor([0.5001, 0.501, 0.5001])
    fast = cl.beta_carry_loss(fwd, *_beta_carry_of(target),
                              torch.tensor([4000, 4000, 100]))
    assert torch.isfinite(fast[0]) and torch.isposinf(fast[1:]).all()


def peaked_logits(rng, labels, lab_len, logit_len, max_t, vocab, scale):
    """N(0, 1) logits plus ``scale`` on one alignment of each row: label k
    at the first frame of its share of the row's frames, blank on the rest
    (low-loss rows, as a trained model gives)."""
    logits = rng.normal(size=(len(labels), max_t, vocab)).astype(np.float32)
    for b, (u, n) in enumerate(zip(lab_len, logit_len)):
        seg = np.arange(n) * u // n
        first = np.r_[True, seg[1:] != seg[:-1]]
        logits[b, np.arange(n), np.where(first, labels[b, seg], 0)] += scale
    return logits


@pytest.mark.parametrize("topology", ["classic", "simplified"])
def test_low_loss_long_rows_are_not_flagged(topology):
    # 1200 steps in 3 chunks; losses under 1 nat, where a limit relative to
    # the loss alone would be a few ulps of 1 for the whole scan
    rng = np.random.RandomState(12)
    labels = rng.randint(1, 32, size=(3, 400)).astype(np.int32)
    lab_len = np.array([400, 300, 200], np.int32)
    logit_len = np.array([1200, 1100, 900], np.int32)
    logits = peaked_logits(rng, labels, lab_len, logit_len, 1200, 32, 12.0)
    lp = logit_to_logproba(torch.tensor(logits), 2)
    ctx = core.make_context(torch.tensor(labels), lp, torch.tensor(lab_len),
                            torch.tensor(logit_len), 0)
    fns = {"classic": (cl.classic_loss_and_pack, cl.classic_gradient_with_loss),
           "simplified": (cs.simplified_loss_and_pack,
                          cs.simplified_gradient_with_loss)}[topology]
    with config_override(use_kernels=True):
        loss, pack = fns[0](ctx)
        fast = fns[1](ctx, loss, pack)[1]
    assert (loss < 1.0).all()
    assert torch.isfinite(fast).all()
    gap = torch.abs(fast - loss)
    assert (gap < 0.1 * cl.scan_gap_limit(fast, ctx.logit_length)).all()
