"""The port's saturation guard: flushed rows are repaired exactly, clean rows
keep their fast values bit for bit.

The kernel path runs through the plain versions on the CPU.  Repaired rows
are held against the port's pure path and the JAX package's pure path at
atol 2e-4 (the log-space repair's known distance from the pure oracle,
ROADMAP queue C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tf_seq2seq_losses_tpu as jctc
from tf_seq2seq_losses_tpu.utils.config import config_override as jax_config
from tf_seq2seq_losses_tpu_torch import api
from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice, log_lattice
from tf_seq2seq_losses_tpu_torch.utils.config import config_override

B, T, V, W = 6, 14, 5, 4


def _batch(seed=0):
    """Rows 1 and 4 saturate: at one frame a token outside the label gets
    +s and every other token -s (s = 1e2 and 1e10); row 3 has -inf logits
    on a token absent from its label; the others are N(0, 1)."""
    rng = np.random.RandomState(seed)
    logits = rng.normal(size=(B, T, V)).astype(np.float32)
    labels = rng.randint(1, 3, size=(B, W)).astype(np.int32)  # tokens 1, 2
    label_length = np.array([4, 3, 2, 4, 3, 1], np.int32)
    logit_length = np.array([14, 12, 10, 13, 14, 6], np.int32)
    for row, scale in ((1, 1e2), (4, 1e10)):
        logits[row, 5] = -scale
        logits[row, 5, 3] = scale
    logits[3, :, 4] = -np.inf
    return labels, logits, label_length, logit_length


def _loss_and_grad(labels, logits, ll, gl, **cfg):
    x = torch.tensor(logits, requires_grad=True)
    with config_override(**cfg):
        loss = api.classic_ctc_loss(torch.tensor(labels), x, torch.tensor(ll),
                                    torch.tensor(gl), 0)
        torch.where(torch.isfinite(loss), loss, torch.zeros_like(loss)).sum().backward()
    return loss.detach(), x.grad


def test_flushed_rows_are_repaired_and_match_pure_and_jax():
    labels, logits, ll, gl = _batch()
    lp = torch.log_softmax(torch.tensor(logits), dim=2)
    from tf_seq2seq_losses_tpu_torch.ops import core

    ctx = core.make_context(torch.tensor(labels), lp, torch.tensor(ll), torch.tensor(gl), 0)
    fast = cuda_lattice.classic_loss_fast(ctx)
    assert torch.isposinf(fast[[1, 4]]).all() and torch.isfinite(fast[[0, 2, 3, 5]]).all()

    loss_k, grad_k = _loss_and_grad(labels, logits, ll, gl, use_kernels=True)
    loss_p, grad_p = _loss_and_grad(labels, logits, ll, gl, use_kernels=False)
    assert torch.isfinite(loss_k).all() and torch.isfinite(grad_k).all()
    np.testing.assert_allclose(loss_k[1].item(), loss_p[1].item(), atol=2e-4)
    assert loss_k[4].item() == loss_p[4].item()
    np.testing.assert_allclose(grad_k[1].numpy(), grad_p[1].numpy(), atol=2e-4)

    def jf(x):
        out = jctc.classic_ctc_loss(labels, x, ll, gl, 0)
        return jnp.sum(jnp.where(jnp.isfinite(out), out, 0.0))

    with jax_config(use_pallas=False):
        j_loss = np.asarray(jctc.classic_ctc_loss(labels, logits, ll, gl, 0))
        j_grad = np.asarray(jax.grad(jf)(jnp.asarray(logits)))
    np.testing.assert_allclose(loss_k[[0, 1, 2, 3, 5]].numpy(), j_loss[[0, 1, 2, 3, 5]],
                               atol=2e-4)
    np.testing.assert_allclose(grad_k[[0, 1, 2, 3, 5]].numpy(), j_grad[[0, 1, 2, 3, 5]],
                               atol=2e-4)


def test_clean_rows_keep_their_fast_values_bit_for_bit():
    labels, logits, ll, gl = _batch(seed=1)
    guarded = _loss_and_grad(labels, logits, ll, gl, use_kernels=True)
    unguarded = _loss_and_grad(labels, logits, ll, gl, use_kernels=True, guard=False)
    clean = [0, 2, 3, 5]
    assert torch.equal(guarded[0][clean], unguarded[0][clean])
    assert torch.equal(guarded[1][clean], unguarded[1][clean])
    # without the guard the flushed rows keep +inf and a zero gradient
    assert torch.isposinf(unguarded[0][[1, 4]]).all()
    assert (unguarded[1][[1, 4]] == 0).all()


@pytest.mark.parametrize(
    "cfg", [dict(repair_bucket=1, repair_bucket2=1), dict(log_fallback=False)],
    ids=["one-row-rounds", "pure-repair"],
)
def test_repair_rounds_and_routes_agree(cfg, monkeypatch):
    labels, logits, ll, gl = _batch(seed=2)
    ref = _loss_and_grad(labels, logits, ll, gl, use_kernels=True)
    calls = []
    real = log_lattice.classic_log_fwd

    def spy(*a):
        calls.append(a[0].shape[0])
        return real(*a)

    monkeypatch.setattr(log_lattice, "classic_log_fwd", spy)
    out = _loss_and_grad(labels, logits, ll, gl, use_kernels=True, **cfg)
    np.testing.assert_allclose(out[0].numpy(), ref[0].numpy(), atol=2e-4)
    # at logits 1e10 a float32 gradient keeps no digits (loss + log-posterior
    # cancel at 2e10): only its finiteness is compared there
    rows = [0, 1, 2, 3, 5]
    np.testing.assert_allclose(out[1][rows].numpy(), ref[1][rows].numpy(), atol=2e-4)
    assert torch.isfinite(out[1]).all()
    if cfg.get("log_fallback") is False:
        assert calls == []
    else:
        assert calls and max(calls) == 1


def test_repaired_step_scans_each_way_once(monkeypatch):
    # the forward's guard repairs the loss (log-space alpha, mode final); the
    # d_logits repair takes loss and gradient from one mode-resid scan; the
    # backward reads the prepared transitions from the pack
    labels, logits, ll, gl = _batch(seed=5)
    modes, preps = [], []
    real_fwd, real_prep = log_lattice.classic_log_fwd, cuda_lattice.kernel_inputs

    def spy_fwd(*a):
        modes.append(a[-1])
        return real_fwd(*a)

    def spy_prep(c):
        preps.append(c.logproba.shape[0])
        return real_prep(c)

    monkeypatch.setattr(log_lattice, "classic_log_fwd", spy_fwd)
    monkeypatch.setattr(cuda_lattice, "kernel_inputs", spy_prep)
    loss, grad = _loss_and_grad(labels, logits, ll, gl, use_kernels=True)
    assert torch.isfinite(loss).all() and torch.isfinite(grad).all()
    assert sorted(modes) == ["final", "resid"]
    assert preps == [B]


def test_nan_inputs_flow_through():
    labels, logits, ll, gl = _batch(seed=3)
    logits[2, 0, 0] = np.nan
    loss, _ = _loss_and_grad(labels, logits, ll, gl, use_kernels=True)
    assert torch.isnan(loss[2])
    assert torch.isfinite(loss[[0, 1, 3, 4, 5]]).all()


def test_forward_only_loss_is_guarded():
    labels, logits, ll, gl = _batch(seed=4)
    args = (torch.tensor(labels), torch.tensor(logits), torch.tensor(ll),
            torch.tensor(gl), 0)
    with torch.no_grad():
        with config_override(use_kernels=True):
            fast = api.classic_ctc_loss(*args)
        pure = api.classic_ctc_loss(*args)
    np.testing.assert_allclose(fast.numpy(), pure.numpy(), atol=2e-4)
