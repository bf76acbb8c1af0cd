"""The guard's repair of flushed rows in a long batch.

A repair round works on its rows' own time axis (``topology.take_ctx`` cuts
it to their longest ``logit_length``), so a short flushed row of a long,
chunked batch is repaired by the log-space kernels, which serve one chunk;
a row that spans several chunks is repaired by the pure path in float64
(``core.float64_context``), whose float32 rounding would otherwise reach
1e-2 of d_logits at T=4000.  The kernel path runs through the plain
versions on the CPU; JAX stays on the CPU (tests/conftest.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tf_seq2seq_losses_tpu as jctc
from tf_seq2seq_losses_tpu.utils.config import config_override as jax_config
from tf_seq2seq_losses_tpu_torch import api
from tf_seq2seq_losses_tpu_torch.ops import core, topology
from tf_seq2seq_losses_tpu_torch.ops import log_lattice as ll
from tf_seq2seq_losses_tpu_torch.utils.config import config_override
from tf_seq2seq_losses_tpu_torch.utils.numerics import logit_to_logproba

T, V = 40, 5
CHUNK = 16  # T=40 spans three chunks
_LOSS = {"classic": api.classic_ctc_loss, "simplified": api.simplified_ctc_loss}
_JAX_LOSS = {"classic": jctc.classic_ctc_loss, "simplified": jctc.simplified_ctc_loss}


def _batch(seed, logit_length):
    rng = np.random.RandomState(seed)
    logits = rng.normal(size=(3, T, V)).astype(np.float32)
    labels = rng.randint(1, 3, size=(3, 6)).astype(np.int32)
    return labels, logits, np.array([5, 4, 3], np.int32), np.array(logit_length, np.int32)


def _short_flushed_row():
    """Rows 0 and 2 run 40 and 37 steps; row 1 runs 8: labels [1, 2] on an
    alignment peaked at 10, and at frame 3 token 4, absent from the label,
    at +44, every other token at -44.  Every path pays e^-88 there, below
    the smallest normal float32: the block-float scans flush the row, whose
    loss is 87 nats, about the least a flush allows."""
    labels, logits, lab_len, logit_len = _batch(0, [40, 8, 37])
    labels[1, :2], lab_len[1] = [1, 2], 2
    logits[1] = 0.0
    for t, tok in enumerate([1, 1, 0, 0, 2, 2, 0, 0]):
        logits[1, t, tok] = 10.0
    logits[1, 3] = -44.0
    logits[1, 3, 4] = 44.0
    return labels, logits, lab_len, logit_len


def _long_flushed_row():
    """Row 1 runs all 40 steps, three chunks, and flushes at frame 20 (token
    4 at +100, the others at -100)."""
    labels, logits, lab_len, logit_len = _batch(1, [40, 40, 37])
    logits[1, 20] = -100.0
    logits[1, 20, 4] = 100.0
    return labels, logits, lab_len, logit_len


def _step(name, labels, logits, lab_len, logit_len, **cfg):
    x = torch.tensor(logits, requires_grad=True)
    with config_override(**cfg):
        loss = _LOSS[name](torch.tensor(labels), x, torch.tensor(lab_len),
                           torch.tensor(logit_len), 0)
        torch.where(torch.isfinite(loss), loss, torch.zeros_like(loss)).sum().backward()
    return loss.detach(), x.grad


def _context(labels, logits, lab_len, logit_len):
    return core.make_context(torch.tensor(labels), logit_to_logproba(torch.tensor(logits), 2),
                             torch.tensor(lab_len), torch.tensor(logit_len), 0)


def _spy_log_kernels(monkeypatch, name):
    """Record the (batch, padded T) of every log-space kernel launch."""
    calls = []
    for kernel in (f"{name}_log_fwd", f"{name}_log_bwd"):
        real = getattr(ll, kernel)
        monkeypatch.setattr(ll, kernel, lambda *a, _r=real: calls.append(
            tuple(a[1].shape[:2])) or _r(*a))
    return calls


def test_take_ctx_cuts_the_time_axis_to_the_longest_row():
    ctx = _context(*_batch(2, [40, 8, 37]))
    for rows, num_t in (([1], 8), ([0, 1], 40), ([1, 2], 37)):
        sub = topology.take_ctx(ctx, torch.tensor(rows))
        for name in ("logproba", "raw_logproba", "logit_length_mask", "blank_lp"):
            field = getattr(sub, name)
            assert field.shape[:2] == (len(rows), num_t)
            assert torch.equal(field, getattr(ctx, name)[rows, :num_t])


@pytest.mark.parametrize("name", ["classic", "simplified"])
def test_a_short_flushed_row_of_a_long_batch_is_repaired_by_the_log_kernels(
        name, monkeypatch):
    batch = _short_flushed_row()
    ctx = _context(*batch)
    topo = topology.TOPOLOGIES[name]
    with config_override(use_kernels=True, chunk_time=CHUNK, guard=False):
        assert torch.isposinf(topo.loss_fast(ctx)[1])
    calls = _spy_log_kernels(monkeypatch, name)
    with config_override(use_kernels=True, chunk_time=CHUNK):
        grad = topo.gradient_fast(ctx)
    loss, d_logits = _step(name, *batch, use_kernels=True, chunk_time=CHUNK)
    # the row runs 8 steps: one window-padded chunk of 8, one row a launch
    assert calls and set(calls) == {(1, 8)}
    # against the pure path on the whole, untrimmed batch: both float32,
    # the repair's acts rounded relative to a loss of 87 nats (an ulp is
    # 7.6e-6 there)
    pure_grad = topo._pure_grad(ctx)
    pure_loss, pure_d = _step(name, *batch, use_kernels=False)
    np.testing.assert_allclose(grad[1].numpy(), pure_grad[1].numpy(), atol=1e-5)
    np.testing.assert_allclose(d_logits[1].numpy(), pure_d[1].numpy(), atol=1e-5)
    np.testing.assert_allclose(loss[1].item(), pure_loss[1].item(), rtol=1e-6)
    assert not grad[1, 8:].any() and not d_logits[1, 8:].any()
    # clean rows keep their fast values
    with config_override(use_kernels=True, chunk_time=CHUNK, guard=False):
        unguarded = _step(name, *batch)
    assert torch.equal(d_logits[[0, 2]], unguarded[1][[0, 2]])


def _float64_reference(name, batch):
    """Loss and d_logits of the pure path in float64 on the port's own
    float32 log-probabilities: the repair's own arithmetic, untrimmed and
    unrounded."""
    ctx = core.float64_context(_context(*batch))
    topo = topology.TOPOLOGIES[name]
    loss = topo.loss(ctx, topo.alpha(ctx))
    grad = -torch.exp(core.gradient_log(topo, ctx, loss))
    return loss, topology.compose_dlogits(ctx, grad, loss, torch.ones_like(loss))


@pytest.mark.parametrize("log_fallback", [True, False], ids=["exact", "pure"])
@pytest.mark.parametrize("name", ["classic", "simplified"])
def test_a_long_flushed_row_is_repaired_in_float64(name, log_fallback, monkeypatch):
    batch = _long_flushed_row()
    calls = _spy_log_kernels(monkeypatch, name)
    loss, d_logits = _step(name, *batch, use_kernels=True, chunk_time=CHUNK,
                           log_fallback=log_fallback)
    assert not calls  # three chunks: the log-space kernels serve one
    loss64, d64 = _float64_reference(name, batch)
    np.testing.assert_allclose(loss[1].item(), loss64[1].item(), rtol=1e-6)
    np.testing.assert_allclose(d_logits[1].numpy(), d64[1].numpy(), atol=1e-6)
    # the JAX package's pure path in float32, at the tolerance of the
    # repaired rows against it (tests/test_torch_port_guard.py)
    labels, logits, lab_len, logit_len = batch
    jax_loss = _JAX_LOSS[name]

    def total(x):
        out = jax_loss(labels, x, lab_len, logit_len, 0)
        return jnp.sum(jnp.where(jnp.isfinite(out), out, 0.0))

    with jax_config(use_pallas=False):
        j_loss = np.asarray(jax_loss(labels, logits, lab_len, logit_len, 0))
        j_grad = np.asarray(jax.grad(total)(jnp.asarray(logits)))
    np.testing.assert_allclose(loss.numpy(), j_loss, rtol=1e-5)
    np.testing.assert_allclose(d_logits.numpy(), j_grad, atol=2e-4)


@pytest.mark.parametrize("name", ["classic", "simplified"])
def test_short_and_long_flushed_rows_are_repaired_in_rounds_of_their_own(
        name, monkeypatch):
    # row 0 flushes over its 40 steps, row 1 over its 8: the short row
    # takes the log-space kernels, the long one the pure path in float64
    labels, logits, lab_len, logit_len = _short_flushed_row()
    long_row = _long_flushed_row()
    labels[0], logits[0], lab_len[0] = long_row[0][1], long_row[1][1], long_row[2][1]
    batch = labels, logits, lab_len, logit_len
    calls = _spy_log_kernels(monkeypatch, name)
    loss, d_logits = _step(name, *batch, use_kernels=True, chunk_time=CHUNK)
    assert calls and set(calls) == {(1, 8)}
    loss64, d64 = _float64_reference(name, batch)
    np.testing.assert_allclose(loss[0].item(), loss64[0].item(), rtol=1e-6)
    np.testing.assert_allclose(d_logits[0].numpy(), d64[0].numpy(), atol=1e-6)
    np.testing.assert_allclose(d_logits[1].numpy(), d64[1].numpy(), atol=1e-5)
