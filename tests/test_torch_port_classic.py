"""The port's pure log-space classic path against the JAX package's.

Tolerances: lattices, loss and gradient atol 1e-5 against the JAX pure
path; the hand oracles at the JAX suite's own tolerances
(tests/test_classic_ctc_loss.py); the float64 enumeration goldens at
tests/test_golden.py's.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_seq2seq_losses_tpu import ClassicCtcLossData as JaxData
from tf_seq2seq_losses_tpu_torch import ClassicCtcLossData, api
from tf_seq2seq_losses_tpu_torch.utils.config import config_override

NEG = -np.inf
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
    ours = ClassicCtcLossData(
        torch.tensor(labels), torch.tensor(lp), torch.tensor(ll), torch.tensor(gl), blank
    )
    ref = JaxData(jnp.asarray(labels), jnp.asarray(lp), jnp.asarray(ll),
                  jnp.asarray(gl), blank)
    return ours, ref


def _close(a, b, atol=1e-5):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=0)


@pytest.mark.parametrize(
    "kw",
    [
        dict(),
        dict(seed=1, max_t=10, blank=2),  # blank index != 0
        dict(seed=2, lab_w=6, max_t=12),  # labels wider than max(label_length)
        dict(seed=3, vocab=3, lab_w=5, max_t=8),  # repeats, infeasible rows
    ],
)
def test_lattices_loss_and_gradient_match_jax(kw):
    ours, ref = _both(_inputs(**kw))
    _close(torch.exp(ours.alpha), np.exp(np.asarray(ref.alpha)))
    _close(torch.exp(ours.beta), np.exp(np.asarray(ref.beta)))
    loss, ref_loss = ours.loss.numpy(), np.asarray(ref.loss)
    np.testing.assert_array_equal(np.isinf(loss), np.isinf(ref_loss))
    fin = np.isfinite(ref_loss)
    np.testing.assert_allclose(loss[fin], ref_loss[fin], atol=1e-5, rtol=0)
    _close(ours.gradient, ref.gradient)


def test_gamma_and_hessian_match_jax():
    ours, ref = _both(_inputs(batch=2, max_t=4, vocab=3, lab_w=2, seed=4))
    _close(torch.exp(ours.gamma), np.exp(np.asarray(ref.gamma)))
    _close(ours.hessian, ref.hessian)


def _data(logits, labels, label_length, logit_length, blank_index=0):
    x = torch.tensor(np.asarray(logits, np.float32))
    return ClassicCtcLossData(
        torch.tensor(labels), torch.log_softmax(x, dim=2), torch.tensor(label_length),
        torch.tensor(logit_length), blank_index,
    )


def test_hand_oracle_single_logit():
    data = _data([[[NEG, 0.0, NEG]]], [[1]], [1], [1])
    np.testing.assert_array_equal(
        torch.exp(data.alpha).numpy(),
        np.asarray([[[[1, 0], [0, 0]], [[0, 0], [0, 1]]]], np.float32),
    )
    np.testing.assert_array_equal(
        torch.exp(data.beta).numpy(),
        np.asarray([[[[1, 1], [0, 1]], [[0, 0], [1, 1]]]], np.float32),
    )
    assert float(data.loss[0]) == 0.0
    _close(torch.exp(data.logarithmic_logproba_gradient), [[[0.0, 1.0, 0.0]]], 1e-6)


def test_hand_oracle_simple_case():
    onehot = np.asarray(
        [[[0, 1, 0], [0, 0, 1], [1, 0, 0], [0, 0, 1], [0, 1, 0]]], np.float32)
    logits = np.where(onehot > 0, 0.0, NEG).astype(np.float32)
    data = _data(logits, [[1, 2, 2, 1]], [4], [5])
    assert float(data.loss[0]) < 1e-6
    _close(torch.exp(data.logarithmic_logproba_gradient), np.exp(logits), 1e-6)


def test_hand_oracle_length_two_and_infeasible():
    data = _data(np.zeros((2, 2, 3)), [[1, 2], [1, 2]], [2, 1], [2, 2])
    assert np.isclose(float(data.loss[0]), -np.log(1 / 9), atol=1e-6)
    assert np.isclose(float(data.loss[1]), -np.log(3 / 9), atol=1e-6)
    _close(data.gradient, [[[0.0, -1.0, 0.0], [0.0, 0.0, -1.0]],
                           [[-1 / 3, -2 / 3, 0.0], [-1 / 3, -2 / 3, 0.0]]], 1e-6)
    short = _data(np.zeros((1, 2, 3)), [[1, 1]], [2], [2])
    assert torch.isposinf(short.loss[0])
    assert (short.gradient == 0).all() and (short.hessian == 0).all()


@pytest.mark.parametrize(
    "labels,ll,expected",
    [([[1, 1]], [2], np.log(3**3)), ([[1]], [1], np.log(3**3 / 6))],
)
def test_hand_oracle_counting(labels, ll, expected):
    data = _data(np.zeros((1, 3, 3)), labels, ll, [3])
    assert np.isclose(float(data.loss[0]), expected, atol=1e-5)


def test_hand_oracle_wrong_prediction():
    data = _data(np.asarray([[[0, 0, 1]]], np.float32) * 100, [[1]], [1], [1])
    np.testing.assert_array_equal(data.gradient.numpy(), [[[0.0, -1.0, 0.0]]])
    assert float(data.loss[0]) == 100.0


def test_non_trivial_blank_index_relabels():
    a = _data(np.zeros((2, 2, 3)), [[1, 2], [1, 2]], [2, 1], [2, 2])
    b = _data(np.zeros((2, 2, 3)), [[1, 0], [1, 0]], [2, 1], [2, 2], blank_index=2)
    _close(a.loss, b.loss.numpy(), 1e-6)


def _golden_cases():
    data = np.load(os.path.join(_GOLDEN, "golden_enum.npz"))
    cases = {}
    for key in data.files:
        case, field = key.split("/", 1)
        cases.setdefault(case, {})[field] = data[key]
    return [c for _, c in sorted(cases.items())
            if c["topology"].item().decode() == "classic"]


@pytest.mark.parametrize("idx", range(4))
def test_matches_enum_goldens(idx):
    c = _golden_cases()[idx]
    args = (torch.tensor(c["labels"]), torch.tensor(c["lp"]),
            torch.tensor(c["label_len"]), torch.tensor(c["logit_len"]), int(c["blank"]))
    loss = api.ctc_loss_from_logproba(*args).numpy()
    fin = np.isfinite(c["loss"])
    np.testing.assert_allclose(loss[fin], c["loss"][fin], rtol=1e-5, atol=1e-5)
    assert np.isposinf(loss[~fin]).all()
    np.testing.assert_allclose(api.ctc_loss_gradient(*args).numpy(), c["grad"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(api.ctc_loss_hessian(*args).numpy(), c["hessian"],
                               atol=1e-4)
    with config_override(use_kernels=True):
        np.testing.assert_allclose(api.ctc_loss_gradient(*args).numpy(), c["grad"],
                                   rtol=1e-4, atol=1e-5)


def test_readme_example_matches_jax_logits_entry():
    from tf_seq2seq_losses_tpu import classic_ctc_loss as jax_loss

    labels = np.asarray([[1, 2, 2, 1], [1, 2, 1, 0]], np.int32)
    ref = jax_loss(labels, jnp.zeros((2, 5, 3)), jnp.asarray([4, 3]),
                   jnp.asarray([5, 4]), 0)
    ours = api.classic_ctc_loss(torch.tensor(labels), torch.zeros(2, 5, 3),
                                torch.tensor([4, 3]), torch.tensor([5, 4]), 0)
    _close(ours, ref, 1e-6)
    _close(ours, [5.4931, 2.4485], 1e-4)
