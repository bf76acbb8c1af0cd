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
