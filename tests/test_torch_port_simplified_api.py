"""The simplified topology through the port's public API and autograd chain,
against the JAX package's ``simplified_ctc_loss``, its custom-VJP chain,
``ctc_loss_gradient``, ``ctc_loss_hessian`` and ``SimplifiedCtcLossData``.

Tolerances: losses and first and second derivatives atol 1e-5 (pure path
against JAX; kernel path, plain versions on the CPU, against JAX at the same
tolerance); the third derivative raises the JAX package's exact text.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tf_seq2seq_losses_tpu as jctc
from tf_seq2seq_losses_tpu.utils.config import config_override as jax_config
from tf_seq2seq_losses_tpu_torch import SimplifiedCtcLossData, api
from tf_seq2seq_losses_tpu_torch.ops import cuda_simplified
from tf_seq2seq_losses_tpu_torch.utils.config import config_override

THIRD = "Third order derivative over the ctc loss function is not implemented."


def _inputs(batch=3, max_t=6, vocab=4, lab_w=3, seed=0):
    rng = np.random.RandomState(seed)
    logits = rng.normal(size=(batch, max_t, vocab)).astype(np.float32)
    labels = rng.randint(1, vocab, size=(batch, lab_w)).astype(np.int32)
    label_length = rng.randint(1, lab_w + 1, size=batch).astype(np.int32)
    logit_length = rng.randint(max_t // 2, max_t + 1, size=batch).astype(np.int32)
    label_length[-1], logit_length[-1] = lab_w, lab_w - 1  # one infeasible row
    return logits, labels, label_length, logit_length


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


def _finite_sum(loss):
    return torch.where(torch.isfinite(loss), loss, torch.zeros_like(loss)).sum()


def _jax_finite_sum(loss):
    return jnp.sum(jnp.where(jnp.isfinite(loss), loss, 0.0))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_logits_gradient_matches_jax(use_kernels):
    logits, labels, ll, gl = _inputs()

    def jf(x):
        return _jax_finite_sum(jctc.simplified_ctc_loss(labels, x, ll, gl, 0))

    with jax_config(use_pallas=False):
        ref_loss = np.asarray(jctc.simplified_ctc_loss(labels, logits, ll, gl, 0))
        ref_grad = np.asarray(jax.grad(jf)(jnp.asarray(logits)))
    x = torch.tensor(logits, requires_grad=True)
    with config_override(use_kernels=use_kernels):
        loss = api.simplified_ctc_loss(torch.tensor(labels), x, *_t(ll, gl), 0)
        _finite_sum(loss).backward()
    np.testing.assert_array_equal(np.isinf(loss.detach().numpy()), np.isinf(ref_loss))
    fin = np.isfinite(ref_loss)
    assert not fin.all()
    np.testing.assert_allclose(loss.detach().numpy()[fin], ref_loss[fin], atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), ref_grad, atol=1e-5)
    assert (x.grad[~torch.tensor(fin)] == 0).all()


@pytest.mark.parametrize("use_kernels", [False, True])
def test_double_backward_equals_analytic_hessian(use_kernels):
    logits, labels, ll, gl = _inputs(batch=2, max_t=4, vocab=3, lab_w=2, seed=2)
    lp = torch.log_softmax(torch.tensor(logits), dim=2)
    args = (torch.tensor(labels), lp, *_t(ll, gl), 0)
    hess = api.ctc_loss_hessian(*args, topology="simplified")
    u = torch.tensor(np.random.RandomState(3).normal(size=lp.shape).astype(np.float32))
    x = lp.clone().requires_grad_(True)
    with config_override(use_kernels=use_kernels):
        loss = api.ctc_loss_from_logproba(torch.tensor(labels), x, *_t(ll, gl), 0,
                                          topology="simplified")
        (g,) = torch.autograd.grad(_finite_sum(loss), x, create_graph=True)
        (hu,) = torch.autograd.grad((g * u).sum(), x, create_graph=True)
        np.testing.assert_allclose(
            g.detach().numpy(),
            api.ctc_loss_gradient(*args, topology="simplified").numpy(), atol=1e-5,
        )
        np.testing.assert_allclose(
            hu.detach().numpy(), torch.einsum("bxy,btvxy->btv", u, hess).numpy(),
            atol=1e-5,
        )
        with pytest.raises(NotImplementedError, match=THIRD):
            torch.autograd.grad(hu.sum(), x)


def test_logits_second_derivative_matches_jax():
    logits, labels, ll, gl = _inputs(batch=2, max_t=4, vocab=3, lab_w=2, seed=4)
    u = np.random.RandomState(5).normal(size=logits.shape).astype(np.float32)

    def jf(x):
        return _jax_finite_sum(jctc.simplified_ctc_loss(labels, x, ll, gl, 0))

    with jax_config(use_pallas=False):
        ref = jax.grad(lambda x: jnp.vdot(jax.grad(jf)(x), u))(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    loss = api.simplified_ctc_loss(torch.tensor(labels), x, *_t(ll, gl), 0)
    (g,) = torch.autograd.grad(_finite_sum(loss), x, create_graph=True)
    (hu,) = torch.autograd.grad((g * torch.tensor(u)).sum(), x, create_graph=True)
    np.testing.assert_allclose(hu.detach().numpy(), np.asarray(ref), atol=1e-5)
    with pytest.raises(NotImplementedError, match=THIRD):
        torch.autograd.grad(hu.sum(), x)


def test_logproba_functions_match_jax():
    logits, labels, ll, gl = _inputs(batch=2, max_t=5, vocab=3, lab_w=2, seed=6)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=2))
    jargs = (jnp.asarray(labels), jnp.asarray(lp), jnp.asarray(ll), jnp.asarray(gl), 0)
    targs = (torch.tensor(labels), torch.tensor(lp), *_t(ll, gl), 0)
    with jax_config(use_pallas=False):
        ref_loss = np.asarray(jctc.ctc_loss_from_logproba(*jargs, topology="simplified"))
        ref_grad = np.asarray(jctc.ctc_loss_gradient(*jargs, topology="simplified"))
        ref_hess = np.asarray(jctc.ctc_loss_hessian(*jargs, topology="simplified"))
    loss = api.ctc_loss_from_logproba(*targs, topology="simplified").numpy()
    fin = np.isfinite(ref_loss)
    np.testing.assert_array_equal(np.isfinite(loss), fin)
    np.testing.assert_allclose(loss[fin], ref_loss[fin], atol=1e-5)
    np.testing.assert_allclose(api.ctc_loss_gradient(*targs, "simplified").numpy(),
                               ref_grad, atol=1e-5)
    np.testing.assert_allclose(api.ctc_loss_hessian(*targs, "simplified").numpy(),
                               ref_hess, atol=1e-5)


def test_data_object_properties_match_jax():
    logits, labels, ll, gl = _inputs(batch=2, max_t=5, vocab=4, lab_w=3, seed=7)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=2))
    ours = SimplifiedCtcLossData(torch.tensor(labels), torch.tensor(lp), *_t(ll, gl))
    ref = jctc.SimplifiedCtcLossData(jnp.asarray(labels), jnp.asarray(lp),
                                     jnp.asarray(ll), jnp.asarray(gl))
    for name in ("alpha", "beta", "gamma", "logarithmic_logproba_gradient"):
        np.testing.assert_allclose(torch.exp(getattr(ours, name)).numpy(),
                                   np.exp(np.asarray(getattr(ref, name))), atol=1e-5,
                                   err_msg=name)
    for name in ("gradient", "hessian"):
        np.testing.assert_allclose(getattr(ours, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=1e-5,
                                   err_msg=name)
    fin = np.isfinite(np.asarray(ref.loss))
    np.testing.assert_allclose(ours.loss.numpy()[fin], np.asarray(ref.loss)[fin],
                               atol=1e-5)
    assert ours._topology.name == "simplified"


def test_forward_mode_follows_needs_input_grad(monkeypatch):
    logits, labels, ll, gl = _inputs(seed=8)
    modes = []
    real = cuda_simplified.simplified_fwd

    def spy(*a):
        modes.append(a[-1])
        return real(*a)

    monkeypatch.setattr(cuda_simplified, "simplified_fwd", spy)
    with config_override(use_kernels=True):
        with torch.no_grad():
            api.simplified_ctc_loss(torch.tensor(labels), torch.tensor(logits),
                                    *_t(ll, gl))
        x = torch.tensor(logits, requires_grad=True)
        api.simplified_ctc_loss(torch.tensor(labels), x, *_t(ll, gl))
    assert modes == ["final", "resid"]
