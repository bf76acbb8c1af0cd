"""The PyTorch port's log-space primitives against the JAX package's.

Same inputs (numpy, fixed seed) through ``tf_seq2seq_losses_tpu.utils.numerics``
and ``tf_seq2seq_losses_tpu_torch.utils.numerics``; values atol 1e-6, and
derivatives through all-(-inf) slices exactly zero, never NaN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_seq2seq_losses_tpu.utils import numerics as jn
from tf_seq2seq_losses_tpu_torch.utils import numerics as tn

NEG = -np.inf


def _pairs():
    rng = np.random.RandomState(0)
    x = rng.normal(size=(64,)).astype(np.float32) * 5
    y = rng.normal(size=(64,)).astype(np.float32) * 5
    x[:4] = [NEG, NEG, np.inf, 3.0]
    y[:4] = [NEG, 2.0, np.inf, NEG]
    x[4] = y[4]  # tie
    return x, y


def _close(a, b, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=1e-6)


def test_logsumexp_matches_jax():
    x, y = _pairs()
    _close(tn.logsumexp(torch.tensor(x), torch.tensor(y)), jn.logsumexp(x, y))


def test_logsumexp_neg_inf_tie_has_zero_gradient():
    x = torch.tensor([NEG, NEG, 1.0], requires_grad=True)
    y = torch.tensor([NEG, 0.5, 1.0], requires_grad=True)
    out = tn.logsumexp(x, y)
    assert torch.isneginf(out[0])
    out.sum().backward()
    assert torch.isfinite(x.grad).all() and torch.isfinite(y.grad).all()
    assert x.grad[0] == 0 and y.grad[0] == 0
    np.testing.assert_allclose(x.grad[2].item(), 0.5, atol=1e-7)


def test_reduce_logsumexp_matches_jax_and_empty_slices():
    rng = np.random.RandomState(1)
    x = rng.normal(size=(5, 7)).astype(np.float32)
    x[1] = NEG
    x[2, :3] = NEG
    _close(tn.reduce_logsumexp(torch.tensor(x), dim=1), jn.reduce_logsumexp(x, axis=1))
    xt = torch.tensor(x, requires_grad=True)
    out = tn.reduce_logsumexp(xt, dim=1)
    assert torch.isneginf(out[1])
    out[torch.isfinite(out)].sum().backward()
    assert torch.isfinite(xt.grad).all()
    assert (xt.grad[1] == 0).all()


def test_logit_to_logproba_and_mask_match_jax():
    rng = np.random.RandomState(2)
    x = rng.normal(size=(3, 4, 5)).astype(np.float32)
    x[0, 0, 0] = 1e10
    _close(tn.logit_to_logproba(torch.tensor(x), dim=2), jn.logit_to_logproba(x, axis=2))
    mask = rng.rand(3, 4, 5) > 0.5
    _close(
        tn.apply_logarithmic_mask(torch.tensor(x), torch.tensor(mask)),
        jn.apply_logarithmic_mask(x, mask),
    )


def test_subexp_matches_jax():
    x, y = _pairs()
    x, y = x[5:], y[5:]
    y[0] = x[0]
    _close(tn.subexp(torch.tensor(x), torch.tensor(y)), jn.subexp(x, y), atol=1e-3)


def test_unsorted_segment_logsumexp_matches_jax():
    rng = np.random.RandomState(3)
    data = rng.normal(size=(10, 3)).astype(np.float32)
    ids = np.array([0, 0, 1, 3, 3, 3, 1, 0, 4, 4], np.int32)  # segment 2 empty
    ours = tn.unsorted_segment_logsumexp(torch.tensor(data), torch.tensor(ids), 5)
    ref = jn.unsorted_segment_logsumexp(jnp.asarray(data), jnp.asarray(ids), 5)
    _close(ours, ref)
    assert torch.isneginf(ours[2]).all()


@pytest.mark.parametrize("d_i", [1, -1])
def test_unfold_matches_jax(d_i):
    init = np.arange(3, dtype=np.float32)

    def step_t(c, i):
        return c * 0.5 + i

    ours = tn.unfold(torch.tensor(init), step_t, 4, d_i)
    ref = jn.unfold(jnp.asarray(init), lambda c, i: c * 0.5 + i, 4, d_i)
    _close(ours, ref)
    with pytest.raises(ValueError):
        tn.unfold(torch.tensor(init), step_t, 4, 0)


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"


@pytest.mark.parametrize("axis,size,value", [(1, 5, 7.0), (0, 4, -1.0), (1, 3, 0)])
def test_pad_until_matches_jax(axis, size, value):
    x = np.random.RandomState(1).normal(size=(2, 3)).astype(np.float32)
    ours = tn.pad_until(torch.tensor(x), size, axis=axis, pad_value=value)
    ref = jn.pad_until(jnp.asarray(x), size, axis=axis, pad_value=value)
    assert tuple(ours.shape) == ref.shape and ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    for bad in (dict(desired_size=2, axis=1), dict(desired_size=5, axis=2)):
        with pytest.raises(ValueError):
            tn.pad_until(torch.tensor(x), **bad)


@pytest.mark.parametrize("case", ["reference", "validation", "random", "no mask"])
def test_insert_zeros_matches_jax(case):
    # tests/test_numerics.py (the reference's docstring example) and
    # tests/test_validation.py's eager case; its data-dependent width
    if case == "reference":
        tensor = np.array([[1, 2, 3, 4, 5], [10, 20, 30, 40, 50]], np.int32)
        mask = np.array([[False, True, False, False, True],
                         [False, True, True, True, False]])
    elif case == "validation":
        tensor, mask = np.array([[1, 2, 3]], np.int32), np.array([[False, True, True]])
    else:
        rng = np.random.RandomState(2)
        tensor = rng.normal(size=(4, 7)).astype(np.float32)
        mask = rng.rand(4, 7) < (0.4 if case == "random" else 0.0)
    ours = tn.insert_zeros(torch.tensor(tensor), torch.tensor(mask))
    ref = np.asarray(jn.insert_zeros(jnp.asarray(tensor), jnp.asarray(mask)))
    assert ours.numpy().dtype == ref.dtype
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_reduce_max_with_default_matches_jax():
    for x, default in ((np.array([1, 5, 2], np.int32), 0),
                       (np.array([], np.int32), 7),
                       (np.array([[-1.5, -0.5]], np.float32), 3.0)):
        ours = tn.reduce_max_with_default(torch.tensor(x), default)
        ref = jn.reduce_max_with_default(jnp.asarray(x), default)
        assert ours.item() == ref.item() and ours.ndim == 0


def test_expand_transpose_reshape_match_jax():
    x = np.random.RandomState(3).normal(size=(2, 3, 4, 5, 6)).astype(np.float32)
    for ours, ref in (
        (tn.expand_many_dims(torch.zeros(5, 1, 3), [0, 4, 5]),
         jn.expand_many_dims(jnp.zeros((5, 1, 3)), [0, 4, 5])),
        (tn.smart_transpose(torch.tensor(x), [2, 1, 0]),
         jn.smart_transpose(jnp.asarray(x), [2, 1, 0])),
        (tn.smart_reshape(torch.tensor(x[:, :, :, :, 0]), [8, None, 1]),
         jn.smart_reshape(jnp.asarray(x[:, :, :, :, 0]), [8, None, 1])),
    ):
        assert tuple(ours.shape) == ref.shape
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    with pytest.raises(ValueError):
        tn.smart_transpose(torch.zeros(2, 3), [1, 0, 2])
    with pytest.raises(ValueError):
        tn.smart_reshape(torch.zeros(2, 3), [6, None, 1])
