"""The guard's fallback cap (``CTC_TPU_GUARD_FALLBACK_BYTES``) against the
JAX package's, after tests/test_guard_cap.py and
``test_while_struct_repairs_above_cap`` of tests/test_guard_struct.py.

The cap is shrunk so that its contract shows at toy shapes: the same
tiers run in both packages, the same warnings are given, and the same rows
keep +inf.  The JAX package runs in interpret mode, the port on its
kernels' plain versions; values rtol 1e-5 (loss) and atol 1e-4 (gradient).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tf_seq2seq_losses_tpu as jctc
from tf_seq2seq_losses_tpu.ops.topology import _est_fallback_bytes
from tf_seq2seq_losses_tpu.utils.config import config_override as jax_config
from tf_seq2seq_losses_tpu_torch import api
from tf_seq2seq_losses_tpu_torch.ops import topology
from tf_seq2seq_losses_tpu_torch.utils.config import config_override

INTERP = dict(use_pallas=True, interpret=True, block_batch=2, block_time=4)
WHOLE = "whole-batch exact reroute disabled"
DISABLED = "saturation guard disabled"


def _saturated_batch():
    """tests/test_guard_cap.py's 6-sample batch: sample 2 feasible and
    float32-saturated."""
    rand = np.random.RandomState(0)
    batch, max_t, vocab, max_l = 6, 12, 5, 5
    logits = rand.randn(batch, max_t, vocab).astype(np.float32)
    logits[2] = 0.0
    logits[2, :, 2] = 100.0
    labels = rand.randint(1, vocab, (batch, max_l)).astype(np.int32)
    labels[2, 0] = 1
    ll = np.full((batch,), 3, np.int32)
    ll[2] = 1
    gl = np.full((batch,), max_t, np.int32)
    return labels, logits, ll, gl


def _flushed_batch(n_flushed):
    """tests/test_guard_struct.py's batch of 8: the first rows flush."""
    rand = np.random.RandomState(7)
    logits = rand.randn(8, 6, 4).astype(np.float32)
    logits[:n_flushed] = 0.0
    logits[:n_flushed, :, 3] = 100.0
    labels = np.tile(np.array([[1, 2]], np.int32), (8, 1))
    return labels, logits, np.full((8,), 2, np.int32), np.full((8,), 6, np.int32)


def _finite_sum(loss):
    return np.where(np.isfinite(loss), loss, 0.0).sum()


def _both(args, **cfg):
    """``(port (loss, grad), JAX (loss, grad), port warnings, JAX warnings)``
    under ``cfg``: the gradient of the sum of the finite losses."""
    labels, logits, ll, gl = args
    x = torch.tensor(logits, requires_grad=True)
    with warnings.catch_warnings(record=True) as caught_port:
        warnings.simplefilter("always")
        with config_override(**cfg, use_kernels=True):
            loss = api.classic_ctc_loss(torch.tensor(labels), x, torch.tensor(ll),
                                        torch.tensor(gl), 0)
            torch.where(torch.isfinite(loss), loss, torch.zeros_like(loss)).sum().backward()

    def scalar(y):
        out = jctc.classic_ctc_loss(labels, y, ll, gl, 0)
        return jnp.sum(jnp.where(jnp.isfinite(out), out, 0.0))

    with warnings.catch_warnings(record=True) as caught_jax:
        warnings.simplefilter("always")
        with jax_config(**INTERP, **cfg):
            j_loss = np.asarray(jctc.classic_ctc_loss(labels, jnp.asarray(logits), ll, gl, 0))
            j_grad = np.asarray(jax.grad(scalar)(jnp.asarray(logits)))
    texts = [[str(w.message) for w in ws] for ws in (caught_port, caught_jax)]
    return (loss.detach().numpy(), x.grad.numpy()), (j_loss, j_grad), *texts


def _said(texts, what):
    return any(what in t for t in texts)


def _pure(args):
    labels, logits, ll, gl = args
    with jax_config(use_pallas=False):
        return np.asarray(jctc.classic_ctc_loss(labels, logits, ll, gl, 0))


def test_the_estimate_is_the_jax_packages():
    for args in [(2, 12, 6, False), (6, 12, 6, True), (16, 4000, 2001, False),
                 (256, 500, 251, True), (1, 1, 129, True)]:
        assert topology.est_fallback_bytes(*args) == _est_fallback_bytes(*args)
    # long T (B=256, T=4000, 2001 label lanes) at the default cap: no
    # whole-batch tier (65 GB), log-space rounds of 16 rows, not 32
    cap = topology.fallback_cap()
    assert cap == 4 << 30
    assert topology.est_fallback_bytes(256, 4000, 2001, True) > 6e10
    assert topology.est_fallback_bytes(32, 4000, 2001, True) > cap
    assert topology.est_fallback_bytes(16, 4000, 2001, True) <= cap


@pytest.mark.parametrize("struct", ["while", "cond"])
def test_gather_repair_survives_above_cap(monkeypatch, struct):
    args = _saturated_batch()
    lp1 = args[0].shape[1] + 1
    # between the bucket's working set and the full batch's
    cap = (_est_fallback_bytes(2, 12, lp1) + _est_fallback_bytes(6, 12, lp1)) // 2
    monkeypatch.setenv("CTC_TPU_GUARD_FALLBACK_BYTES", str(cap))
    (loss, grad), (j_loss, j_grad), said, j_said = _both(
        args, repair_bucket=2, guard_struct=struct)
    assert _said(said, WHOLE) == _said(j_said, WHOLE) == (struct == "cond")
    assert np.isfinite(loss).all()
    np.testing.assert_allclose(loss, _pure(args), atol=1e-4)
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
    np.testing.assert_allclose(grad, j_grad, atol=1e-4)


def test_guard_dropped_with_warning_when_nothing_fits(monkeypatch):
    args = _saturated_batch()
    monkeypatch.setenv("CTC_TPU_GUARD_FALLBACK_BYTES", "1")
    (loss, grad), (j_loss, j_grad), said, j_said = _both(args, repair_bucket=2)
    assert _said(said, DISABLED) and _said(j_said, DISABLED)
    assert set(said) <= set(j_said)
    np.testing.assert_array_equal(np.isposinf(loss), np.isposinf(j_loss))
    assert np.isposinf(loss[2]) and np.isfinite(loss[[0, 1, 3, 4, 5]]).all()
    assert (grad[2] == 0).all()
    np.testing.assert_allclose(grad, j_grad, atol=1e-4)


@pytest.mark.parametrize("struct", ["while", "cond"])
def test_while_struct_repairs_above_cap(monkeypatch, struct):
    """The cap admits a bucket2 round's working set (lane-padded), not the
    whole batch's: "while" repairs all 5 flushed rows in rounds; "cond"
    repairs the first 4 through tier 2 and leaves row 4 at +inf, with the
    warning, as the JAX package does."""
    args = _flushed_batch(5)
    cap = _est_fallback_bytes(4, 6, 3, lane_pad=True)
    monkeypatch.setenv("CTC_TPU_GUARD_FALLBACK_BYTES", str(cap))
    cfg = dict(repair_bucket=2, repair_bucket2=4, log_fallback=True,
               sort_by_length=False, guard_struct=struct)
    (loss, grad), (j_loss, j_grad), said, j_said = _both(args, **cfg)
    assert _said(said, WHOLE) == _said(j_said, WHOLE) == (struct == "cond")
    np.testing.assert_array_equal(np.isposinf(loss), np.isposinf(j_loss))
    if struct == "while":
        assert np.isfinite(loss).all()
        np.testing.assert_allclose(loss, _pure(args), rtol=1e-5)
    else:
        assert np.isposinf(loss[4]) and (grad[4] == 0).all()
        assert np.isfinite(np.delete(loss, 4)).all()
    finite = np.isfinite(loss)
    np.testing.assert_allclose(loss[finite], j_loss[finite], rtol=1e-5)
    np.testing.assert_allclose(grad, j_grad, atol=1e-4)


def test_gradient_repair_above_cap(monkeypatch):
    args = _saturated_batch()
    lp1 = args[0].shape[1] + 1
    cap = (_est_fallback_bytes(2, 12, lp1) + _est_fallback_bytes(6, 12, lp1)) // 2
    labels, logits, ll, gl = args

    def scalar(y):
        out = jctc.classic_ctc_loss(labels, y, ll, gl, 0)
        return jnp.sum(jnp.where(jnp.isfinite(out), out, 0.0))

    with jax_config(use_pallas=False):
        g_want = np.asarray(jax.grad(scalar)(jnp.asarray(logits)))
    monkeypatch.setenv("CTC_TPU_GUARD_FALLBACK_BYTES", str(cap))
    x = torch.tensor(logits, requires_grad=True)
    with config_override(repair_bucket=2, use_kernels=True):
        loss = api.classic_ctc_loss(torch.tensor(labels), x, torch.tensor(ll),
                                    torch.tensor(gl), 0)
        torch.where(torch.isfinite(loss), loss, torch.zeros_like(loss)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), g_want, atol=1e-4)
    assert _finite_sum(loss.detach().numpy()) > 0
