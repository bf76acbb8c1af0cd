"""The port's pure log-space simplified path against the JAX package's.

Tolerances: lattices, loss, gradient, gamma and Hessian atol 1e-5 against
the JAX pure path (``SimplifiedCtcLossData``); the hand oracles of
tests/test_simplified_ctc_loss.py at that suite's own tolerances, each case
also held against the JAX data object at 1e-5; the float64 enumeration
goldens at tests/test_golden.py's.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_seq2seq_losses_tpu import SimplifiedCtcLossData as JaxData
from tf_seq2seq_losses_tpu import simplified_ctc_loss as jax_simplified
from tf_seq2seq_losses_tpu_torch import SimplifiedCtcLossData, api
from tf_seq2seq_losses_tpu_torch.utils.config import config_override

_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _inputs(batch=3, max_t=9, vocab=5, lab_w=4, seed=0, blank=0):
    rng = np.random.RandomState(seed)
    logits = rng.normal(size=(batch, max_t, vocab)).astype(np.float32)
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    tokens = [v for v in range(vocab) if v != blank]
    labels = rng.choice(tokens, size=(batch, lab_w)).astype(np.int32)
    label_length = rng.randint(1, lab_w + 1, size=batch).astype(np.int32)
    logit_length = rng.randint(max_t // 2, max_t + 1, size=batch).astype(np.int32)
    return labels, lp.astype(np.float32), label_length, logit_length, blank


def _both(args):
    labels, lp, ll, gl, blank = args
    ours = SimplifiedCtcLossData(
        torch.tensor(labels), torch.tensor(lp), torch.tensor(ll), torch.tensor(gl), blank
    )
    ref = JaxData(jnp.asarray(labels), jnp.asarray(lp), jnp.asarray(ll),
                  jnp.asarray(gl), blank)
    return ours, ref


def _close(a, b, atol=1e-5):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=0)


def _loss_close(ours, ref, atol=1e-5):
    ours, ref = ours.numpy(), np.asarray(ref)
    np.testing.assert_array_equal(np.isposinf(ours), np.isposinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(ours[fin], ref[fin], atol=atol, rtol=0)


def _matches_jax(ours, ref, hessian=False):
    _close(torch.exp(ours.alpha), np.exp(np.asarray(ref.alpha)))
    _close(torch.exp(ours.beta), np.exp(np.asarray(ref.beta)))
    _loss_close(ours.loss, ref.loss)
    _close(ours.gradient, ref.gradient)
    if hessian:
        _close(torch.exp(ours.gamma), np.exp(np.asarray(ref.gamma)))
        _close(ours.hessian, ref.hessian)


@pytest.mark.parametrize(
    "kw",
    [
        dict(),
        dict(seed=1, max_t=10, blank=2),  # blank index != 0
        dict(seed=2, lab_w=6, max_t=12),  # labels wider than max(label_length)
        dict(seed=3, vocab=3, lab_w=7, max_t=8),  # repeats, infeasible rows
    ],
)
def test_lattices_loss_and_gradient_match_jax(kw):
    _matches_jax(*_both(_inputs(**kw)))


def test_gamma_and_hessian_match_jax():
    _matches_jax(*_both(_inputs(batch=2, max_t=4, vocab=3, lab_w=2, seed=4)),
                 hessian=True)


def _data(logits, labels, label_length, logit_length, blank_index=0):
    """Port and JAX data objects of the same logits (log-softmaxed)."""
    x = torch.tensor(np.asarray(logits, np.float32))
    lp = torch.log_softmax(x, dim=2)
    args = (labels, label_length, logit_length)
    ours = SimplifiedCtcLossData(
        torch.tensor(labels), lp, torch.tensor(label_length), torch.tensor(logit_length),
        blank_index,
    )
    ref = JaxData(*(jnp.asarray(a) for a in (args[0], lp.numpy(), *args[1:])),
                  blank_index)
    return ours, ref


def test_simple_case_exact_lattices():
    onehot = np.asarray([[[0, 1, 0], [1, 0, 0], [0, 0, 1], [1, 0, 0], [0, 1, 0]]],
                        np.float32)
    ours, ref = _data(np.log(onehot), [[1, 2, 1]], [3], [5])
    expected = np.asarray([[[1, 0, 0, 0], [0, 1, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0],
                            [0, 0, 1, 0], [0, 0, 0, 1]]], np.float32)
    np.testing.assert_array_equal(torch.exp(ours.alpha).numpy(), expected)
    np.testing.assert_array_equal(torch.exp(ours.beta).numpy(), expected)
    assert float(ours.loss[0]) < 1e-6
    _matches_jax(ours, ref, hessian=True)


def test_non_zero_blank_index():
    onehot = np.asarray([[[1, 0, 0], [0, 1, 0], [0, 0, 1], [0, 1, 0], [1, 0, 0]]],
                        np.float32)
    ours, ref = _data(np.log(onehot), [[0, 2, 0]], [3], [5], blank_index=1)
    assert float(ours.loss[0]) < 1e-6
    _matches_jax(ours, ref)


def test_shorter_logit_and_label_length():
    onehot = np.asarray([[[1, 0, 0], [0, 1, 0], [1, 0, 0], [1, 0, 0]]], np.float32)
    ours, ref = _data(np.log(onehot), [[1, 0]], [1], [3])
    assert float(ours.loss[0]) == 0.0
    _matches_jax(ours, ref)


def test_label_longer_than_logits_is_infinite_with_zero_gradient():
    ours, ref = _data(np.zeros((1, 1, 3)), [[1, 2]], [2], [1])
    assert torch.isposinf(ours.loss[0])
    np.testing.assert_array_equal(ours.gradient.numpy(), np.zeros((1, 1, 3), np.float32))
    assert (ours.hessian == 0).all()
    _matches_jax(ours, ref, hessian=True)


@pytest.mark.parametrize("scale", [1e10, -1e10])
def test_logits_at_1e10_stay_finite(scale):
    logits = np.asarray([[[scale, 0.0, 0.0]]], np.float32)
    ours, ref = _data(logits, [[1]], [1], [1])
    assert torch.isfinite(ours.loss).all() and torch.isfinite(ours.gradient).all()
    if scale > 0:
        assert float(ours.loss[0]) == 1e10
    np.testing.assert_array_equal(ours.gradient.numpy(), [[[0.0, -1.0, 0.0]]])
    _matches_jax(ours, ref)


@pytest.mark.parametrize(
    "num_t,labels,expected_grad",
    [
        (1, [[1]], [[[0.0, -1.0, 0.0]]]),
        (2, [[1, 2]], [[[0.0, -1.0, 0.0], [0.0, 0.0, -1.0]]]),
    ],
    ids=["length-one", "length-two"],
)
def test_lengths_one_and_two(num_t, labels, expected_grad):
    ours, ref = _data(np.zeros((1, num_t, 3)), labels, [num_t], [num_t])
    assert np.isclose(float(ours.loss[0]), num_t * np.log(3), atol=1e-6)
    _close(ours.gradient, expected_grad, 1e-6)
    _matches_jax(ours, ref, hessian=True)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_zero_logit_length(use_kernels):
    labels = torch.tensor([[1, 2]])
    x = torch.zeros((1, 0, 3), requires_grad=True)
    with config_override(use_kernels=use_kernels):
        loss = api.simplified_ctc_loss(labels, x, torch.tensor([2]), torch.tensor([2]))
        loss.sum().backward()
    ref = jax_simplified(jnp.asarray([[1, 2]]), jnp.zeros((1, 0, 3)), jnp.asarray([2]),
                         jnp.asarray([2]), 0)
    assert torch.isposinf(loss[0]) and np.isposinf(np.asarray(ref)[0])
    assert x.grad.shape == (1, 0, 3)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_zero_batch_size(use_kernels):
    x = torch.zeros((0, 4, 3), requires_grad=True)
    lengths = torch.zeros((0,), dtype=torch.int64)
    with config_override(use_kernels=use_kernels):
        loss = api.simplified_ctc_loss(torch.zeros((0, 2), dtype=torch.int64), x,
                                       lengths, lengths)
        loss.sum().backward()
    assert loss.shape == (0,) and x.grad.shape == (0, 4, 3)


def test_alpha_beta_sum_is_the_loss():
    ours, _ = _both(_inputs(batch=1, max_t=6, seed=1))
    sums = torch.logsumexp(ours.alpha + ours.beta, dim=2)
    _close(sums, np.broadcast_to(-ours.loss.numpy()[:, None], sums.shape))


def _golden_cases():
    data = np.load(os.path.join(_GOLDEN, "golden_enum.npz"))
    cases = {}
    for key in data.files:
        case, field = key.split("/", 1)
        cases.setdefault(case, {})[field] = data[key]
    return [c for _, c in sorted(cases.items())
            if c["topology"].item().decode() == "simplified"]


@pytest.mark.parametrize("idx", range(4))
def test_matches_enum_goldens(idx):
    c = _golden_cases()[idx]
    args = (torch.tensor(c["labels"]), torch.tensor(c["lp"]),
            torch.tensor(c["label_len"]), torch.tensor(c["logit_len"]), int(c["blank"]))
    loss = api.ctc_loss_from_logproba(*args, topology="simplified").numpy()
    fin = np.isfinite(c["loss"])
    np.testing.assert_allclose(loss[fin], c["loss"][fin], rtol=1e-5, atol=1e-5)
    assert np.isposinf(loss[~fin]).all()
    np.testing.assert_allclose(api.ctc_loss_gradient(*args, "simplified").numpy(),
                               c["grad"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(api.ctc_loss_hessian(*args, "simplified").numpy(),
                               c["hessian"], atol=1e-4)
    with config_override(use_kernels=True):
        np.testing.assert_allclose(api.ctc_loss_gradient(*args, "simplified").numpy(),
                                   c["grad"], rtol=1e-4, atol=1e-5)
