"""The half-stream scheme of the classic topology (``half_stream``: kernel
B13, forward mode resid1 and the backward that rebuilds a0), on its plain
PyTorch versions, against the JAX package and against the fully streamed
scheme.

The JAX package runs its half-stream kernels in interpret mode
(``block_batch=2, block_time=4``: windows of 4 steps); the port runs the
same windows (``window=4``).  Loss atol 1e-4, d_logits atol 1e-5, as in
tests/test_torch_port_chunked.py.  Against the streamed scheme the port is
exact: B13 rebuilds a0 with the forward's own float operations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tf_seq2seq_losses_tpu as jctc
from tf_seq2seq_losses_tpu.utils.config import config_override as jax_config
from tf_seq2seq_losses_tpu_torch import api
from tf_seq2seq_losses_tpu_torch.ops import core
from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice as cl
from tf_seq2seq_losses_tpu_torch.ops import cuda_simplified as cs
from tf_seq2seq_losses_tpu_torch.utils.config import config_override

JAX_HALF = dict(use_pallas=True, interpret=True, block_batch=2, block_time=4,
                half_stream=True)


def _case(blank=0, seed=0, batch=4, max_t=12, vocab=6, width=4):
    """Labels with repeats (row 0 all one token), N(0, 1) logits, row 3
    infeasible (4 labels with a repeat over 2 frames)."""
    rng = np.random.RandomState(seed)
    tokens = np.array([v for v in range(vocab) if v != blank])
    labels = tokens[rng.randint(0, len(tokens), size=(batch, width))].astype(np.int32)
    labels[0] = tokens[0]
    labels[1, 1] = labels[1, 0]
    logits = rng.normal(size=(batch, max_t, vocab)).astype(np.float32)
    label_length = np.array([3, 4, 2, 4], np.int32)
    logit_length = np.array([12, 10, 7, 2], np.int32)
    return labels, logits, label_length, logit_length


def _port(labels, logits, ll, gl, ct, blank=0, **cfg):
    x = torch.tensor(logits, requires_grad=True)
    with config_override(**cfg):
        loss = api.classic_ctc_loss(torch.tensor(labels), x, torch.tensor(ll),
                                    torch.tensor(gl), blank)
        loss.backward(torch.tensor(ct))
    return loss.detach(), x.grad


def _ct(batch):
    return np.random.RandomState(7).normal(size=batch).astype(np.float32)


@pytest.mark.parametrize("blank", [0, 3])
def test_half_stream_matches_jax_half_stream_interpret(blank):
    labels, logits, ll, gl = _case(blank=blank, seed=blank)
    ct = _ct(len(labels))
    with jax_config(**JAX_HALF):
        j_loss, pull = jax.vjp(
            lambda lg: jctc.classic_ctc_loss(labels, lg, ll, gl, blank),
            jnp.asarray(logits))
        j_d = np.asarray(pull(jnp.asarray(ct))[0])
    loss, d = _port(labels, logits, ll, gl, ct, blank, use_kernels=True, window=4,
                    half_stream=True)
    j_loss = np.asarray(j_loss)
    assert np.isposinf(j_loss[3]) and torch.isposinf(loss[3])
    np.testing.assert_allclose(loss[:3].numpy(), j_loss[:3], atol=1e-4, rtol=0)
    np.testing.assert_allclose(d.numpy(), j_d, atol=1e-5, rtol=0)
    assert not d[3].any()


def _inputs(seed=1, max_t=21):
    labels, logits, ll, gl = _case(seed=seed, max_t=max_t)
    gl = np.array([21, 17, 9, 3], np.int32)
    lp = torch.log_softmax(torch.tensor(logits), dim=2)
    ctx = core.make_context(torch.tensor(labels), lp, torch.tensor(ll),
                            torch.tensor(gl), 0)
    return cl.kernel_inputs(ctx)


@pytest.mark.parametrize("window", [1, 4, 8])
def test_resid1_and_the_half_backward_equal_resid_and_b3(window):
    with config_override(window=window):
        blank, dcu, lm, nb, rep, lens, lab_len, k_win = _inputs()
    sa, saf, *carry = cl.classic_fwd(blank, dcu, lm, nb, rep, lens, k_win, "resid")
    a1, saf1, a0w, *carry1 = cl.classic_fwd(blank, dcu, lm, nb, rep, lens, k_win,
                                            "resid1")
    assert torch.equal(a1, sa[:, :, 1])
    assert torch.equal(a0w, sa[:, ::k_win, 0])
    assert torch.equal(saf1, saf)
    assert all(torch.equal(a, b) for a, b in zip(carry1, carry))
    ebi = cl.ebi_from_loss(cl.pick_loss(carry[0] + carry[1], carry[2], lab_len))
    ref = cl.classic_bwd_streamed(blank, dcu, lm, nb, rep, lens, lab_len, ebi, sa, saf,
                                  k_win)
    half = cl.classic_bwd_half(blank, dcu, lm, nb, rep, lens, lab_len, ebi, a1, saf1,
                               a0w, k_win)
    assert all(torch.equal(a, b) for a, b in zip(half, ref))
    assert half[0].abs().sum() > 0


def test_half_stream_step_equals_the_streamed_step_bit_for_bit():
    labels, logits, ll, gl = _case(seed=2, max_t=16)
    ct = _ct(len(labels))
    ref = _port(labels, logits, ll, gl, ct, use_kernels=True)
    half = _port(labels, logits, ll, gl, ct, use_kernels=True, half_stream=True)
    assert torch.equal(half[0], ref[0]) and torch.equal(half[1], ref[1])


def test_half_stream_repairs_a_saturated_row():
    # after tests/test_fold_pt.py::test_half_stream_guard_saturated: at one
    # frame row 1 puts its mass on a token absent from its label (+100, the
    # rest -100), so the block-float scans flush and the guard repairs the
    # row; atol 2e-4 is the log-space repair's distance from the pure path
    # (tests/test_torch_port_guard.py)
    labels, logits, ll, gl = _case(seed=4)
    labels[1] = [1, 2, 1, 2]
    ct = _ct(len(labels))
    clean = _port(labels, logits, ll, gl, ct, use_kernels=True, half_stream=True)
    logits[1, 5] = -100.0
    logits[1, 5, 5] = 100.0
    with config_override(use_kernels=True, half_stream=True):
        lp = torch.log_softmax(torch.tensor(logits), dim=2)
        ctx = core.make_context(torch.tensor(labels), lp, torch.tensor(ll),
                                torch.tensor(gl), 0)
        loss, pack = cl.classic_loss_and_pack(ctx)
    assert isinstance(pack, cl.HalfPack) and torch.isposinf(loss[1])
    half = _port(labels, logits, ll, gl, ct, use_kernels=True, half_stream=True)
    pure = _port(labels, logits, ll, gl, ct, use_kernels=False)
    assert torch.isfinite(half[0][1])
    np.testing.assert_allclose(half[0][1].numpy(), pure[0][1].numpy(), atol=2e-4)
    np.testing.assert_allclose(half[1][1].numpy(), pure[1][1].numpy(), atol=2e-4)
    for i in (0, 2, 3):
        assert torch.equal(half[0][i], clean[0][i])
        assert torch.equal(half[1][i], clean[1][i])


@pytest.mark.parametrize("cfg", [dict(stream_residuals=False), dict(chunk_time=8)],
                         ids=["stream_residuals=False", "beyond one chunk"])
def test_half_stream_is_ignored_off_the_streamed_scheme(cfg):
    labels, logits, ll, gl = _case(seed=5, max_t=20)
    lp = torch.log_softmax(torch.tensor(logits), dim=2)
    ctx = core.make_context(torch.tensor(labels), lp, torch.tensor(ll),
                            torch.tensor(gl), 0)
    out = {}
    for half in (False, True):
        with config_override(half_stream=half, **cfg):
            loss, pack = cl.classic_loss_and_pack(ctx)
            assert isinstance(pack, cl.ChunkPack)
            out[half] = (loss, *cl.classic_gradient_with_loss(ctx, loss, pack))
    assert all(torch.equal(a, b) for a, b in zip(out[True], out[False]))


def test_half_stream_is_ignored_by_the_simplified_topology():
    labels, logits, ll, gl = _case(seed=6)
    lp = torch.log_softmax(torch.tensor(logits), dim=2)
    ctx = core.make_context(torch.tensor(labels), lp, torch.tensor(ll),
                            torch.tensor(gl), 0)
    out = {}
    for half in (False, True):
        with config_override(half_stream=half):
            loss, pack = cs.simplified_loss_and_pack(ctx)
            assert isinstance(pack, cl.StreamPack)
            out[half] = (loss, *cs.simplified_gradient_with_loss(ctx, loss, pack))
    assert all(torch.equal(a, b) for a, b in zip(out[True], out[False]))
