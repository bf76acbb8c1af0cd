"""The guard's placements (``guard_mode`` "post", "pre" and "grad") against
each other and the JAX package's, after tests/test_guard_modes.py.

"post" guards the composed d_logits, "pre" branches before the backward on
the forward's flushed count, "grad" guards the gradient and composes the
cotangent after it.  The repair tiers run the same functions in every
mode, so d_logits agree bit for bit, on clean and saturated batches, with
a non-uniform cotangent (the guard gathers its rows).  Against the JAX
package in interpret mode with its tests' fixture: loss rtol 1e-5,
d_logits atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tf_seq2seq_losses_tpu as jctc
from tf_seq2seq_losses_tpu.utils.config import config_override as jax_config
from tf_seq2seq_losses_tpu_torch import api
from tf_seq2seq_losses_tpu_torch.ops import topology
from tf_seq2seq_losses_tpu_torch.utils.config import config_override

B, T, V = 8, 6, 4
INTERP = dict(use_pallas=True, interpret=True, block_batch=2, block_time=4,
              repair_bucket=2, repair_bucket2=4, sort_by_length=False)
FNS = {"classic": (jctc.classic_ctc_loss, api.classic_ctc_loss),
       "simplified": (jctc.simplified_ctc_loss, api.simplified_ctc_loss)}
WEIGHTS = np.arange(1.0, B + 1.0, dtype=np.float32)


def _args(n_flushed, vocab=V):
    """tests/test_guard_modes.py's batch: the first ``n_flushed`` rows flush."""
    rand = np.random.RandomState(0)
    logits = rand.randn(B, T, vocab).astype(np.float32)
    logits[:n_flushed] = 0.0
    logits[:n_flushed, :, vocab - 1] = 100.0
    labels = np.tile(np.array([[1, 2]], np.int32), (B, 1))
    return labels, logits, np.full((B,), 2, np.int32), np.full((B,), T, np.int32)


def _port(name, args, **cfg):
    labels, logits, ll, gl = args
    x = torch.tensor(logits, requires_grad=True)
    with config_override(**INTERP, use_kernels=True, **cfg):
        loss = FNS[name][1](torch.tensor(labels), x, torch.tensor(ll), torch.tensor(gl), 0)
        finite = torch.where(torch.isfinite(loss), loss, torch.zeros_like(loss))
        (finite * torch.tensor(WEIGHTS)).sum().backward()
    return loss.detach().numpy(), x.grad.numpy()


def _jax(name, args):
    labels, logits, ll, gl = args
    fn = FNS[name][0]

    def scalar(x):
        out = fn(labels, x, ll, gl, 0)
        return jnp.sum(jnp.where(jnp.isfinite(out), out, 0.0) * jnp.asarray(WEIGHTS))

    with jax_config(**INTERP):
        loss = np.asarray(fn(labels, jnp.asarray(logits), ll, gl, 0))
        grad = np.asarray(jax.grad(scalar)(jnp.asarray(logits)))
    return loss, grad


def _count_syncs(monkeypatch):
    calls = []
    real = topology.flushed_rows

    def spy(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(topology, "flushed_rows", spy)
    return calls


@pytest.mark.parametrize("name", ["classic", "simplified"])
@pytest.mark.parametrize("n_flushed", [0, 3, B])
def test_guard_modes_agree(name, n_flushed):
    args = _args(n_flushed)
    out = {mode: _port(name, args, guard_mode=mode) for mode in ("grad", "post", "pre")}
    for mode in ("post", "pre"):
        np.testing.assert_array_equal(out[mode][0], out["grad"][0])
        np.testing.assert_array_equal(out[mode][1], out["grad"][1],
                                      err_msg=f"{name} mode={mode} n={n_flushed}")
    j_loss, j_grad = _jax(name, args)
    np.testing.assert_allclose(out["post"][0], j_loss, rtol=1e-5)
    np.testing.assert_allclose(out["post"][1], j_grad, atol=1e-4)


@pytest.mark.parametrize("mode,n_flushed,syncs", [
    ("post", 0, 2), ("pre", 0, 1), ("pre", 3, 2), ("grad", 0, 2)])
def test_pre_takes_the_backward_sync_off_a_clean_step(mode, n_flushed, syncs,
                                                      monkeypatch):
    """The forward's guard finds the flushed rows once; "pre" reads its count
    before the backward, so a clean step's backward looks for none."""
    calls = _count_syncs(monkeypatch)
    _port("classic", _args(n_flushed), guard_mode=mode)
    assert len(calls) == syncs


def test_pre_clean_step_is_the_unguarded_step():
    args = _args(0)
    pre = _port("classic", args, guard_mode="pre")
    off = _port("classic", args, guard=False)
    np.testing.assert_array_equal(pre[1], off[1])


def test_grad_mode_composes_after_the_guarded_gradient(monkeypatch):
    calls = []
    for name in ("dlogits_fast", "gradient_fast"):
        real = getattr(topology.Topology, name)

        def spy(self, *a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(self, *a, **kw)

        monkeypatch.setattr(topology.Topology, name, spy)
    _port("classic", _args(3), guard_mode="grad")
    assert calls == ["gradient_fast"]
    calls.clear()
    _port("classic", _args(3), guard_mode="post")
    assert calls == ["dlogits_fast"]


@pytest.mark.parametrize("name", ["classic", "simplified"])
def test_fused_branch_keeps_the_post_guard_under_pre(name, monkeypatch):
    """With the fused epilogue (V=128) "pre" guards after B12, as in the JAX
    package: the same d_logits as "post", the backward's sync taken."""
    args = _args(3, vocab=128)
    post = _port(name, args, fused_epilogue=True)
    calls = _count_syncs(monkeypatch)
    pre = _port(name, args, fused_epilogue=True, guard_mode="pre")
    assert len(calls) == 2
    np.testing.assert_array_equal(pre[1], post[1])
