"""The kernels' plain PyTorch versions against the JAX package.

On the CPU the port's kernel wrappers run their plain versions, the
counterpart of Pallas ``interpret=True``.  Compared with the JAX package's
``classic_loss_fast``, ``classic_gradient_with_loss``, ``classic_loss_exact``
and ``classic_gradient_log_exact`` (interpret mode, one tiny case) and with
its pure path (the other cases): loss atol 1e-4, gradient atol 1e-5, as in
tests/test_pallas.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_seq2seq_losses_tpu.ops import classic as jax_classic
from tf_seq2seq_losses_tpu.ops import core as jax_core
from tf_seq2seq_losses_tpu.ops import log_lattice as jax_log
from tf_seq2seq_losses_tpu.ops import pallas_lattice as jax_pk
from tf_seq2seq_losses_tpu.ops.topology import CLASSIC as JAX_CLASSIC
from tf_seq2seq_losses_tpu.utils.config import config_override as jax_config
from tf_seq2seq_losses_tpu_torch.ops import core
from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice as cl
from tf_seq2seq_losses_tpu_torch.ops import log_lattice as ll
from tf_seq2seq_losses_tpu_torch.utils.config import config_override


def _case(batch=4, max_t=37, vocab=6, lab_w=12, seed=0, blank=0, label_length=None,
          logit_length=None, tokens=None):
    rng = np.random.RandomState(seed)
    logits = rng.normal(size=(batch, max_t, vocab)).astype(np.float32)
    lp = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)
    if tokens is None:
        tokens = [v for v in range(vocab) if v != blank]
    labels = rng.choice(tokens, size=(batch, lab_w)).astype(np.int32)
    if label_length is None:
        label_length = rng.randint(1, lab_w + 1, size=batch)
    if logit_length is None:
        logit_length = rng.randint(max_t // 2, max_t + 1, size=batch)
    return (labels, lp, np.asarray(label_length, np.int32),
            np.asarray(logit_length, np.int32), np.int32(blank))


def _contexts(case):
    labels, lp, lab_len, logit_len, blank = case
    jctx = jax_core.make_context(jnp.asarray(labels), jnp.asarray(lp),
                                 jnp.asarray(lab_len), jnp.asarray(logit_len), int(blank))
    tctx = core.make_context(torch.tensor(labels), torch.tensor(lp),
                             torch.tensor(lab_len), torch.tensor(logit_len), int(blank))
    return jctx, tctx


def _loss_close(ours, ref, atol=1e-4):
    ours, ref = np.asarray(ours), np.asarray(ref)
    np.testing.assert_array_equal(np.isposinf(ours), np.isposinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(ours[fin], ref[fin], atol=atol, rtol=0)


def test_plain_versions_match_jax_kernels_interpret():
    # T = 37 is not a multiple of the window; row 2 has logit_length 0 and
    # row 3 is infeasible.
    case = _case(label_length=[5, 12, 0, 9], logit_length=[30, 37, 0, 8])
    jctx, tctx = _contexts(case)
    with jax_config(use_pallas=True, interpret=True, block_batch=2, block_time=4):
        j_loss = jax_pk.classic_loss_fast(jctx)
        j_grad, j_fast = jax_pk.classic_gradient_with_loss(jctx)
        j_exact = jax_log.classic_loss_exact(jctx)
        j_glog = jax_log.classic_gradient_log_exact(jctx)
    _loss_close(cl.classic_loss_fast(tctx), j_loss)
    grad, fast = cl.classic_gradient_with_loss(tctx)
    _loss_close(fast, j_fast)
    np.testing.assert_allclose(grad.numpy(), np.asarray(j_grad), atol=1e-5)
    _loss_close(ll.classic_loss_exact(tctx), j_exact)
    np.testing.assert_allclose(torch.exp(ll.classic_gradient_log_exact(tctx)).numpy(),
                               np.exp(np.asarray(j_glog)), atol=1e-5)


@jax.jit
def _jax_pure(labels, lp, label_length, logit_length, blank):
    jctx = jax_core.make_context(labels, lp, label_length, logit_length, blank)
    loss = jax_classic.loss(jctx, jax_classic.alpha(jctx))
    return loss, -jnp.exp(jax_core.gradient_log(JAX_CLASSIC, jctx, loss))


@pytest.mark.parametrize(
    "kw",
    [
        dict(seed=1),
        dict(seed=2, blank=2),  # blank index != 0
        dict(seed=3, tokens=(1, 2)),  # many repeated labels
        dict(seed=4, label_length=[3, 6, 2, 5]),  # labels wider than needed
        dict(seed=5, logit_length=[0, 37, 4, 11]),  # empty row
    ],
)
def test_plain_versions_match_jax_pure(kw):
    case = _case(**kw)
    j_loss, j_grad = _jax_pure(*(jnp.asarray(a) for a in case))
    _, tctx = _contexts(case)
    _loss_close(cl.classic_loss_fast(tctx), j_loss)
    loss, pack = cl.classic_loss_and_pack(tctx)
    _loss_close(loss, j_loss)
    grad, fast = cl.classic_gradient_with_loss(tctx, None, pack)
    _loss_close(fast, j_loss)
    np.testing.assert_allclose(grad.numpy(), np.asarray(j_grad), atol=1e-5)
    _loss_close(ll.classic_loss_exact(tctx), j_loss)
    np.testing.assert_allclose(
        -torch.exp(ll.classic_gradient_log_exact(tctx)).numpy(), np.asarray(j_grad),
        atol=1e-5,
    )


@pytest.mark.parametrize("precision", ["high", "medium"])
def test_act_scatter_is_exact_under_reduced_matmul_precision(precision):
    # training scripts often allow TF32 for float32 matrix products ("medium"
    # lets the CPU use bfloat16): the gradients must not follow that setting
    case = _case(seed=6)
    _, j_grad = _jax_pure(*(jnp.asarray(a) for a in case))
    _, tctx = _contexts(case)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(precision)
    try:
        grad, _ = cl.classic_gradient_with_loss(tctx)
        grad_log = ll.classic_gradient_log_exact(tctx)
    finally:
        torch.set_float32_matmul_precision(prev)
    np.testing.assert_allclose(grad.numpy(), np.asarray(j_grad), atol=1e-5)
    np.testing.assert_allclose(-torch.exp(grad_log).numpy(), np.asarray(j_grad), atol=1e-5)


def test_window_length_is_honoured():
    _, tctx = _contexts(_case(seed=7))
    ref = cl.classic_loss_fast(tctx)
    for window in (1, 3, 16):
        with config_override(window=window):
            assert cl.geometry(tctx)[0] % window == 0
            np.testing.assert_allclose(cl.classic_loss_fast(tctx).numpy(), ref.numpy(),
                                       rtol=1e-6)


def test_pow2_and_act_factor_match_jax():
    k = np.array([-300, -127, -126, -1, 0, 5, 127, 200], np.int32)
    np.testing.assert_array_equal(cl._pow2(torch.tensor(k)).numpy(),
                                  np.asarray(jax_pk._pow2(jnp.asarray(k))))
    fa = np.array([[3, -(1 << 30), 100, -5]], np.int32)
    fb = np.array([[-7, -(1 << 30), 100, -120]], np.int32)
    ebi = np.array([-9.0], np.float32)
    ours = cl._act_factor(torch.tensor(fa), torch.tensor(fb), torch.tensor(ebi))
    ref = jax_pk._act_factor(jnp.asarray(fa), jnp.asarray(fb), jnp.asarray(ebi)[:, None])
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_subnormal_mantissa_in_dead_frame_is_zeroed():
    # lane 3 holds a subnormal mantissa and its whole source neighbourhood is
    # dead: without the rule it would be rescaled by 2^127
    m0 = torch.tensor([[1.0, 0.0, 0.0, 1e-40, 0.0, 0.0]])
    m1 = torch.zeros_like(m0)
    e = torch.zeros_like(m0, dtype=torch.int32)
    (r0, r1), f, _ = cl._open_window((m0, m1), e, 2, True)
    assert r0[0, 3] == 0 and r1[0, 3] == 0
    assert r0[0, 0] == 1.0 and f[0, 3] == -(1 << 30)


def test_subnormal_transitions_flush_to_inf_and_the_guard_repairs():
    # token 1 has probability ~5e-41 (subnormal) at every frame: the only
    # mass of the label lane is subnormal, so the block-float loss must be
    # +inf (repaired by the guard), never a finite wrong value
    logits = np.zeros((1, 12, 3), np.float32)
    logits[0, :, 1] = -92.0
    from tf_seq2seq_losses_tpu_torch import api

    args = (torch.tensor([[1]]), torch.tensor(logits), torch.tensor([1]),
            torch.tensor([12]), 0)
    lp = torch.log_softmax(args[1], dim=2)
    tctx = core.make_context(args[0], lp, args[2], args[3], 0)
    assert torch.isposinf(cl.classic_loss_fast(tctx)).all()
    pure = api.classic_ctc_loss(*args)
    with config_override(use_kernels=True):
        repaired = api.classic_ctc_loss(*args)
    assert torch.isfinite(pure).all()
    np.testing.assert_allclose(repaired.numpy(), pure.numpy(), atol=2e-4)


def test_long_t_runs_on_the_kernel_path():
    # padded T = 24 beyond chunk_time = 16: two chunks of 16 steps
    _, tctx = _contexts(_case(max_t=20, seed=8))
    with config_override(chunk_time=16):
        chunked = cl.classic_loss_fast(tctx)
        # the guard's repair takes the pure path beyond chunk_time
        assert not ll.fits_log_fallback(tctx)
        ref = ll.classic_loss_exact(tctx)
    np.testing.assert_allclose(chunked.numpy(), ref.numpy(), atol=1e-4)
    np.testing.assert_allclose(ref.numpy(), ll.classic_loss_exact(tctx).numpy(),
                               atol=1e-4)


def test_empty_batch_and_time_fall_through():
    for shape in ((0, 5, 3), (2, 0, 3)):
        lp = torch.zeros(shape)
        tctx = core.make_context(torch.ones((shape[0], 2), dtype=torch.int64), lp,
                                 torch.ones(shape[0], dtype=torch.int64),
                                 torch.zeros(shape[0], dtype=torch.int64), 0)
        grad, _ = cl.classic_gradient_with_loss(tctx)
        assert grad.shape == shape
        assert cl.classic_loss_fast(tctx).shape == (shape[0],)


def test_scaled_act_does_not_underflow_in_float32():
    # two mantissas far below their frames, scaled back up by 2^200: their
    # float32 product is 0, the float64 one exact
    x = torch.tensor([2.0 ** -100, 0.75])
    y = torch.tensor([2.0 ** -100, 0.5])
    s_hi, s_lo = torch.tensor([2.0 ** 100, 1.0]), torch.tensor([2.0 ** 100, 0.25])
    assert (x * y * s_hi * s_lo)[0] == 0.0
    assert cl.scaled_act(s_hi, s_lo, x, y).tolist() == [1.0, 0.09375]
    assert cl.scaled_act(s_hi, s_lo, x, y, y).tolist() == [2.0 ** -100, 0.046875]


@pytest.mark.parametrize("topology", ["classic", "simplified"])
def test_a_nearly_forced_row_keeps_its_posterior(topology):
    # row 98 of chip_smoke.py's V=128 batch (seed 0): 245 labels over 253
    # frames without repeats.  At window 8 some lanes' mantissas sit near
    # 2^-126 of their frames in both scans, and the float32 product of the
    # two underflowed: 0.06 of frame 136's posterior went to the blank
    import chip_smoke

    labels, logits, lab_len, logit_len = (
        t[98:99] for t in chip_smoke.make_inputs(torch, 0, torch.device("cpu"),
                                                  vocab=128))
    loss64, d64 = chip_smoke.pure_float64(labels, logits, lab_len, logit_len, topology)
    step = chip_smoke.make_step(torch, chip_smoke.loss_function(topology), labels)
    with config_override(use_kernels=True):
        loss, d = step(logits, lab_len, logit_len)
    np.testing.assert_allclose(loss.numpy(), loss64.numpy(), rtol=1e-5)
    np.testing.assert_allclose(d.numpy(), d64.numpy(), atol=1e-5, rtol=0)
