"""The port's flagship encoder against the JAX package's
``models/encoder.py``.

The JAX parameters (``init_encoder``, numpy leaves) are carried across with
``encoder_params_from_reference``; inputs come from numpy seeds.

Tolerances.  Both dense products round their operands to bfloat16 and sum
the products in float32, but in different orders; where a float32
activation lies within an ulp of a bfloat16 rounding boundary, one side
rounds up and the other down (a "flip"): that operand moves by a bfloat16
ulp, 2^-8 of itself, and so does every value computed from it.  The blocks
act on each frame alone, so a flip in the forward moves the logits of one
frame.  Hence:

* logits: every frame within 1e-5 (float32 rounding; measured 2.4e-7)
  but at most :data:`FLIPPED_FRAMES` frames, which are within 1e-2
  (measured: 3.6e-3 on one frame at T=20 of the gradient batch, 3.6e-5
  on one frame at T=21 of seed 4);
* the loss of a batch rtol 2e-5 (the flipped frame above moves it by
  1.2e-4 of 13.4);
* parameter gradients: each tensor within 1e-2 of its largest entry (a
  flipped cotangent moves a weight-gradient entry by a bfloat16 ulp, and
  the forward flip at T=20 moves a whole backward by up to 4.7e-3 of its
  scale, measured);
* 30 SGD steps: every step's loss within 1e-4 (measured 4.7e-5, after a
  flip at step 21).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tf_seq2seq_losses_tpu as jctc
from tf_seq2seq_losses_tpu.models import encoder as jenc
from tf_seq2seq_losses_tpu_torch import api, models
from tf_seq2seq_losses_tpu_torch.models import encoder as enc
from tf_seq2seq_losses_tpu_torch.utils.config import config_override

CPU = torch.device("cpu")
FRAME_ATOL = 1e-5
FLIP_ATOL = 1e-2
FLIPPED_FRAMES = 2


def carried(key, **dims):
    params = jenc.init_encoder(key, **dims)
    return params, enc.encoder_params_from_reference(
        jax.tree_util.tree_map(np.asarray, params), device=CPU)


def assert_logits_close(got, want):
    frame_err = np.abs(got - want).max(axis=-1)
    assert (frame_err > FRAME_ATOL).sum() <= FLIPPED_FRAMES, frame_err
    assert frame_err.max() <= FLIP_ATOL, frame_err.max()


@pytest.mark.parametrize("num_t", [21, 20])
def test_encoder_shapes_and_lengths(num_t):
    model = enc.init_encoder(torch.Generator().manual_seed(0), num_features=8,
                             hidden=16, vocab=6, num_layers=2, device=CPU)
    logits = enc.apply_encoder(model, torch.zeros((3, num_t, 8)))
    assert logits.shape == (3, (num_t + 1) // 2, 6)  # ceil(T/2)
    assert logits.dtype == torch.float32
    lengths = enc.subsampled_length(torch.tensor([21, 20, 1], dtype=torch.int32))
    assert lengths.tolist() == [11, 10, 1]


def test_models_exports_the_reference_names():
    from tf_seq2seq_losses_tpu import models as jmodels

    assert models.__all__ == jmodels.__all__


@pytest.mark.parametrize("seed", [0, 4])
@pytest.mark.parametrize("num_t", [21, 20])
def test_apply_encoder_matches_jax(num_t, seed):
    params, model = carried(jax.random.PRNGKey(0), num_features=8, hidden=16,
                            vocab=6, num_layers=2)
    x = np.random.RandomState(seed).randn(3, num_t, 8).astype(np.float32)
    want = np.asarray(jenc.apply_encoder(params, jnp.asarray(x)))
    got = enc.apply_encoder(model, x).detach().numpy()
    assert got.shape == want.shape == (3, (num_t + 1) // 2, 6)
    assert_logits_close(got, want)


def test_parameters_carry_across_and_back():
    params, model = carried(jax.random.PRNGKey(2), num_features=8, hidden=16,
                            vocab=6, num_layers=2)
    assert model.stem.w.shape == (16, 8, 3)
    back = enc.encoder_params_to_reference(model)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)), back, params)


def grad_batch(num_t, seed=0):
    rng = np.random.RandomState(seed)
    features = rng.randn(3, num_t, 8).astype(np.float32)
    feature_length = np.array([num_t, num_t - 3, num_t - 6], np.int32)
    labels = rng.randint(1, 6, (3, 4)).astype(np.int32)
    label_length = np.array([4, 3, 2], np.int32)
    return features, feature_length, labels, label_length


@pytest.mark.parametrize("use_kernels", [None, True], ids=["pure", "kernels"])
@pytest.mark.parametrize("num_t", [21, 20])
def test_parameter_gradients_match_jax(num_t, use_kernels):
    """``jax.grad`` of the mean classic loss against the port's parameter
    gradients, on the pure path and on the kernels' plain versions."""
    params, model = carried(jax.random.PRNGKey(0), num_features=8, hidden=16,
                            vocab=6, num_layers=2)
    features, feature_length, labels, label_length = grad_batch(num_t)

    def jax_loss(p):
        logits = jenc.apply_encoder(p, features)
        return jnp.mean(jctc.classic_ctc_loss(
            labels, logits, label_length, jenc.subsampled_length(feature_length), 0))

    want_loss, want = jax.value_and_grad(jax_loss)(params)
    with config_override(use_kernels=use_kernels):
        loss = api.classic_ctc_loss(
            torch.tensor(labels), enc.apply_encoder(model, features),
            torch.tensor(label_length),
            enc.subsampled_length(torch.tensor(feature_length)), 0).mean()
        loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=2e-5)
    grads = enc.Encoder(8, 16, 6, 2, device=CPU)
    grads.load_state_dict({k: p.grad for k, p in model.named_parameters()})
    got = enc.encoder_params_to_reference(grads)

    def close(g, w):
        w = np.asarray(w)
        assert np.abs(g - w).max() <= 1e-2 * np.abs(w).max(), np.abs(g - w).max()

    jax.tree_util.tree_map(close, got, want)


def test_sgd_trajectory_follows_jax():
    """``tests/test_models.py``'s end-to-end case: 30 SGD steps (lr 0.1) of
    the mean classic loss, each step's loss beside JAX's."""
    params, model = carried(jax.random.PRNGKey(1), num_features=4, hidden=16,
                            vocab=5, num_layers=1)
    rng = np.random.RandomState(0)
    feats = rng.randn(2, 12, 4).astype(np.float32)
    feat_len = np.array([12, 10], np.int32)
    labels = np.array([[1, 2, 3], [4, 2, 0]], np.int32)
    label_len = np.array([3, 2], np.int32)

    def jax_loss(p):
        logits = jenc.apply_encoder(p, feats)
        return jnp.mean(jctc.classic_ctc_loss(
            labels, logits, label_len, jenc.subsampled_length(feat_len), 0))

    @jax.jit
    def jax_step(p):
        loss, grads = jax.value_and_grad(jax_loss)(p)
        return jax.tree_util.tree_map(lambda a, g: a - 0.1 * g, p, grads), loss

    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    want, got = [], []
    for _ in range(30):
        params, loss = jax_step(params)
        want.append(float(loss))
        opt.zero_grad()
        loss = api.classic_ctc_loss(
            torch.tensor(labels), enc.apply_encoder(model, feats),
            torch.tensor(label_len), enc.subsampled_length(torch.tensor(feat_len)),
            0).mean()
        loss.backward()
        opt.step()
        got.append(float(loss.detach()))
    assert np.isfinite(got).all()
    assert got[-1] < 0.5 * got[0]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_init_statistics_at_full_width():
    """The reference's defaults (F=80, H=512, V=128, 4 layers): shapes, std
    within 5% of sqrt(2 / fan_in), zero biases, unit norm scales."""
    model = enc.init_encoder(torch.Generator().manual_seed(0), device=CPU)
    assert model.stem.w.shape == (512, 80, 3)
    assert model.head.w.shape == (512, 128)
    assert len(model.blocks) == 4
    fans = {"stem.w": 3 * 80, "head.w": 512}
    for i, block in enumerate(model.blocks):
        assert block.up.w.shape == (512, 2048) and block.down.w.shape == (2048, 512)
        fans[f"blocks.{i}.up.w"] = 512
        fans[f"blocks.{i}.down.w"] = 2048
    for name, p in model.named_parameters():
        if name in fans:
            std = float(p.detach().std())
            assert abs(std / np.sqrt(2.0 / fans[name]) - 1) < 0.05, (name, std)
        elif name.endswith("scale"):
            assert bool((p == 1).all()), name
        else:
            assert bool((p == 0).all()), name
