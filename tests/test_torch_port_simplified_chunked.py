"""The chunked long-T path and the residual-free scheme of the simplified
topology (kernels B6 with an initial carry, B11 forward mode bound and
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
        fast = cs.simplified_loss_fast(ctx)
        loss, pack = cs.simplified_loss_and_pack(ctx)
        grad, beta_loss = cs.simplified_gradient_with_loss(ctx, None, pack)
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
        j_loss = jax_pk.simplified_loss_fast(jctx)
        j_grad, j_fast = jax_pk.simplified_gradient_with_loss(jctx)
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
        j_loss, _ = jax_pk.simplified_loss_and_pack(jctx)
        j_grad, j_fast = jax_pk.simplified_gradient_with_loss(jctx)
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
    blank, dg, lm, lens, lab_len, k_win = cs.simplified_kernel_inputs(ctx)
    sa, saf, *carry = cs.simplified_fwd(blank, dg, lens, k_win, "resid")
    bd, bde, *bound_carry = cs.simplified_fwd(blank, dg, lens, k_win, "bound")
    for a, b in zip(carry, bound_carry):
        assert torch.equal(a, b)
    ebi = cl.ebi_from_loss(cl.pick_loss(carry[0], carry[1], lab_len))
    streamed = cs.simplified_bwd_streamed(blank, dg, lens, lab_len, ebi, sa, saf, k_win)
    free = cs.simplified_bwd(blank, dg, lens, lab_len, ebi, bd, bde, k_win)
    for a, b in zip(free, streamed):
        assert torch.equal(a, b)


def test_explicit_standard_init_equals_the_default():
    ctx = _ctx(_case(seed=7, max_t=24))
    blank, dg, lm, lens, lab_len, k_win = cs.simplified_kernel_inputs(ctx)
    batch, _, lpad = dg.shape
    init = cl.alpha_init(batch, lpad, dg.device, 1)
    for mode in ("final", "bound"):
        ref = cs.simplified_fwd_plain(blank, dg, lens, k_win, mode)
        ours = cs.simplified_fwd_plain(blank, dg, lens, k_win, mode, init)
        for a, b in zip(ours, ref):
            assert torch.equal(a, b)
    ebi = torch.zeros(batch)
    bounds = cs.simplified_fwd_plain(blank, dg, lens, k_win, "bound")[:2]
    ref = cs.simplified_bwd_plain(blank, dg, lens, lab_len, ebi, *bounds, k_win)
    ours = cs.simplified_bwd_plain(blank, dg, lens, lab_len, ebi, *bounds, k_win,
                                   cl.beta_init(lab_len, lpad, 1))
    for a, b in zip(ours, ref):
        assert torch.equal(a, b)


def test_zero_relative_length_passes_the_carry_through():
    ctx = _ctx(_case(seed=8, max_t=16))
    blank, dg, lm, lens, lab_len, k_win = cs.simplified_kernel_inputs(ctx)
    batch, tpad, lpad = dg.shape
    # a carry in mid-scan: the final carry of the whole axis
    carry = cs.simplified_fwd(blank, dg, lens, k_win, "final")
    zero = torch.zeros_like(lens)
    out = cs.simplified_fwd(blank, dg, zero, k_win, "final", init=carry)
    *bounds, f, fe = cs.simplified_fwd(blank, dg, zero, k_win, "bound", init=carry)
    for a, b in zip(out, carry):
        assert torch.equal(a, b)
    for a, b in zip((f, fe), carry):
        assert torch.equal(a, b)
    for bound, c in zip(bounds, carry):
        assert all(torch.equal(bound[w], c) for w in range(tpad // k_win))
    b, be = cl.beta_init(lab_len, lpad, 1)
    beta = (b * 0.5, be + 3)
    pd, *beta_out = cs.simplified_bwd(blank, dg, zero, lab_len, torch.zeros(batch),
                                      *bounds, k_win, beta)
    assert not pd.any()
    for a, b in zip(beta_out, beta):
        assert torch.equal(a, b)


def test_training_launch_plan(monkeypatch):
    # per chunk: one forward in mode final; in the backward, mode bound and
    # the residual-free scan; one chunk without streaming: bound, then one scan
    modes, scans = [], []
    real_fwd, real_bwd = cs.simplified_fwd, cs.simplified_bwd

    def spy_fwd(*a, **kw):
        modes.append(a[4])
        return real_fwd(*a, **kw)

    def spy_bwd(*a, **kw):
        scans.append(a[0].shape[1])
        return real_bwd(*a, **kw)

    monkeypatch.setattr(cs, "simplified_fwd", spy_fwd)
    monkeypatch.setattr(cs, "simplified_bwd", spy_bwd)
    ctx = _ctx(_case(seed=9, max_t=37))
    with config_override(chunk_time=16):
        loss, pack = cs.simplified_loss_and_pack(ctx)
        cs.simplified_gradient_with_loss(ctx, loss, pack)
    # 37 steps padded to 40, in 3 chunks of 16
    assert modes == ["final"] * 3 + ["bound"] * 3 and scans == [16] * 3
    modes.clear(), scans.clear()
    with config_override(stream_residuals=False):
        loss, pack = cs.simplified_loss_and_pack(ctx)
        cs.simplified_gradient_with_loss(ctx, loss, pack)
    assert modes == ["bound"] and scans == [40]


def _loss_and_dlogits(labels, logits, ll_, gl, **cfg):
    x = torch.tensor(logits, requires_grad=True)
    with config_override(**cfg):
        loss = api.simplified_ctc_loss(torch.tensor(labels), x, torch.tensor(ll_),
                                    torch.tensor(gl), 0)
    torch.where(torch.isfinite(loss), loss, torch.zeros_like(loss)).sum().backward()
    return loss.detach(), x.grad


def test_dlogits_through_backward_on_the_chunked_path():
    rng = np.random.RandomState(10)
    labels = rng.randint(1, 5, size=(3, 8)).astype(np.int32)
    logits = rng.normal(size=(3, 21, 5)).astype(np.float32)
    lab_len = np.array([8, 3, 6], np.int32)
    logit_len = np.array([21, 14, 4], np.int32)  # row 2 infeasible
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
    monkeypatch.setattr(ll, "simplified_log_fwd", lambda *a: calls.append(a))
    fast = _loss_and_dlogits(labels, logits, lab_len, logit_len, use_kernels=True,
                             chunk_time=8)
    pure = _loss_and_dlogits(labels, logits, lab_len, logit_len)
    assert not calls
    np.testing.assert_allclose(fast[0][1].numpy(), pure[0][1].numpy(), atol=2e-4)
    np.testing.assert_allclose(fast[1][1].numpy(), pure[1][1].numpy(), atol=2e-4)
    for i in (0, 2):
        assert torch.equal(fast[0][i], clean[0][i])
        assert torch.equal(fast[1][i], clean[1][i])
