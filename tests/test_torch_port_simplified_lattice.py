"""The simplified kernels' plain PyTorch versions (B6-B9) and the guard,
against the JAX package.

On the CPU the port's kernel wrappers run their plain versions, the
counterpart of Pallas ``interpret=True``.  Compared with the JAX package's
``simplified_loss_fast``, ``simplified_gradient_with_loss``,
``simplified_loss_exact`` and ``simplified_gradient_log_exact`` (interpret
mode, one tiny case) and with its pure path (the other cases, at T=20):
loss atol 1e-4, gradient atol 1e-5, as in tests/test_pallas.py.  At T=37
the JAX float32 pure simplified path is itself up to 1.8e-5 from float64
(each log-space step rounds at an ulp of the loss), so there the plain
versions are held to the port's pure path run in float64.  Repaired rows are
held against the pure paths at atol 2e-4 (the log-space repair's known
distance from the pure oracle, ROADMAP queue C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tf_seq2seq_losses_tpu as jctc
from tf_seq2seq_losses_tpu.ops import core as jax_core
from tf_seq2seq_losses_tpu.ops import log_lattice as jax_log
from tf_seq2seq_losses_tpu.ops import pallas_lattice as jax_pk
from tf_seq2seq_losses_tpu.ops import simplified as jax_simplified
from tf_seq2seq_losses_tpu.ops.topology import SIMPLIFIED as JAX_SIMPLIFIED
from tf_seq2seq_losses_tpu.utils.config import config_override as jax_config
from tf_seq2seq_losses_tpu_torch import api
from tf_seq2seq_losses_tpu_torch.ops import core
from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice as cl
from tf_seq2seq_losses_tpu_torch.ops import cuda_simplified as cs
from tf_seq2seq_losses_tpu_torch.ops import log_lattice as ll
from tf_seq2seq_losses_tpu_torch.ops import simplified
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
        j_loss = jax_pk.simplified_loss_fast(jctx)
        j_grad, j_fast = jax_pk.simplified_gradient_with_loss(jctx)
        j_exact = jax_log.simplified_loss_exact(jctx)
        j_glog = jax_log.simplified_gradient_log_exact(jctx)
    _loss_close(cs.simplified_loss_fast(tctx), j_loss)
    grad, fast = cs.simplified_gradient_with_loss(tctx)
    _loss_close(fast, j_fast)
    np.testing.assert_allclose(grad.numpy(), np.asarray(j_grad), atol=1e-5)
    _loss_close(ll.simplified_loss_exact(tctx), j_exact)
    np.testing.assert_allclose(
        torch.exp(ll.simplified_gradient_log_exact(tctx)).numpy(),
        np.exp(np.asarray(j_glog)), atol=1e-5,
    )


@jax.jit
def _jax_pure(labels, lp, label_length, logit_length, blank):
    jctx = jax_core.make_context(labels, lp, label_length, logit_length, blank)
    loss = jax_simplified.loss(jctx, jax_simplified.alpha(jctx))
    return loss, -jnp.exp(jax_core.gradient_log(JAX_SIMPLIFIED, jctx, loss))


def _pure_float64(case):
    """Loss and gradient of the port's pure path evaluated in float64."""
    labels, lp, lab_len, logit_len, blank = case
    lp64 = torch.tensor(lp).double()
    c = core.make_context(torch.tensor(labels), lp64, torch.tensor(lab_len),
                          torch.tensor(logit_len), int(blank))
    forced = torch.where(c.logit_length_mask[:, :, None], lp64, c.logproba.double())
    c = c._replace(logproba=forced, raw_logproba=lp64,
                   blank_lp=core.take_blank_logproba(forced, c.blank_index))
    loss = simplified.loss(c, simplified.alpha(c))
    return loss.numpy(), -torch.exp(core.gradient_log(simplified, c, loss)).numpy()


def _check_kernel_paths(case, ref_loss, ref_grad):
    """Both kernel paths (block-float B6/B7, log-space B8/B9) against a
    reference loss (atol 1e-4) and gradient (atol 1e-5)."""
    _, tctx = _contexts(case)
    _loss_close(cs.simplified_loss_fast(tctx), ref_loss)
    loss, pack = cs.simplified_loss_and_pack(tctx)
    _loss_close(loss, ref_loss)
    grad, fast = cs.simplified_gradient_with_loss(tctx, None, pack)
    _loss_close(fast, ref_loss)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), atol=1e-5)
    _loss_close(ll.simplified_loss_exact(tctx), ref_loss)
    e_loss, e_glog = ll.simplified_loss_and_gradient_log_exact(tctx)
    _loss_close(e_loss, ref_loss)
    np.testing.assert_allclose(-torch.exp(e_glog).numpy(), np.asarray(ref_grad),
                               atol=1e-5)


def _check_against_jax_pure(case):
    _check_kernel_paths(case, *_jax_pure(*(jnp.asarray(a) for a in case)))


_CASES = [
    dict(seed=1),
    dict(seed=2, blank=2),  # blank index != 0
    dict(seed=3, tokens=(1, 2)),  # many repeated labels
    dict(seed=4, label_length=[3, 6, 2, 5]),  # labels wider than needed
    dict(seed=5, logit_length=[0, 20, 4, 11]),  # empty and infeasible rows
]


@pytest.mark.parametrize("kw", _CASES)
def test_plain_versions_match_jax_pure(kw):
    _check_against_jax_pure(_case(max_t=20, **kw))


@pytest.mark.parametrize("window", [1, 16])
def test_plain_versions_match_jax_pure_at_other_windows(window):
    case = _case(max_t=20, seed=6)
    with config_override(window=window):
        assert cl.geometry(_contexts(case)[1])[0] % window == 0
        _check_against_jax_pure(case)


@pytest.mark.parametrize("kw", _CASES[:4] + [dict(seed=5, logit_length=[0, 37, 4, 11])])
def test_plain_versions_match_float64_at_t37(kw):
    case = _case(**kw)
    _check_kernel_paths(case, *_pure_float64(case))


def test_subnormal_transitions_flush_to_inf_and_the_guard_repairs():
    # token 1 has probability ~5e-41 (subnormal) at every frame: the only
    # mass of the label lane is subnormal, so the block-float loss must be
    # +inf (repaired by the guard), never a finite wrong value
    logits = np.zeros((1, 12, 3), np.float32)
    logits[0, :, 1] = -92.0
    args = (torch.tensor([[1]]), torch.tensor(logits), torch.tensor([1]),
            torch.tensor([12]), 0)
    tctx = core.make_context(args[0], torch.log_softmax(args[1], dim=2), *args[2:])
    assert torch.isposinf(cs.simplified_loss_fast(tctx)).all()
    pure = api.simplified_ctc_loss(*args)
    with config_override(use_kernels=True):
        repaired = api.simplified_ctc_loss(*args)
    assert torch.isfinite(pure).all()
    np.testing.assert_allclose(repaired.numpy(), pure.numpy(), atol=2e-4)


def test_long_t_runs_on_the_kernel_path():
    # padded T = 24 beyond chunk_time = 16: two chunks of 16 steps
    _, tctx = _contexts(_case(max_t=20, seed=8))
    with config_override(chunk_time=16):
        chunked = cs.simplified_loss_fast(tctx)
        # the guard's repair takes the pure path beyond chunk_time
        assert not ll.fits_log_fallback(tctx)
        ref = ll.simplified_loss_exact(tctx)
    np.testing.assert_allclose(chunked.numpy(), ref.numpy(), atol=1e-4)
    np.testing.assert_allclose(ref.numpy(), ll.simplified_loss_exact(tctx).numpy(),
                               atol=1e-4)


# ---------------------------------------------------------------------------
# the guard
# ---------------------------------------------------------------------------

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


def _loss_and_grad(labels, logits, ll_, gl, **cfg):
    x = torch.tensor(logits, requires_grad=True)
    with config_override(**cfg):
        loss = api.simplified_ctc_loss(torch.tensor(labels), x, torch.tensor(ll_),
                                       torch.tensor(gl), 0)
        torch.where(torch.isfinite(loss), loss, torch.zeros_like(loss)).sum().backward()
    return loss.detach(), x.grad


def test_flushed_rows_are_repaired_and_match_pure_and_jax():
    labels, logits, ll_, gl = _batch()
    lp = torch.log_softmax(torch.tensor(logits), dim=2)
    ctx = core.make_context(torch.tensor(labels), lp, torch.tensor(ll_),
                            torch.tensor(gl), 0)
    fast = cs.simplified_loss_fast(ctx)
    assert torch.isposinf(fast[[1, 4]]).all() and torch.isfinite(fast[[0, 2, 3, 5]]).all()

    loss_k, grad_k = _loss_and_grad(labels, logits, ll_, gl, use_kernels=True)
    loss_p, grad_p = _loss_and_grad(labels, logits, ll_, gl, use_kernels=False)
    assert torch.isfinite(loss_k).all() and torch.isfinite(grad_k).all()
    np.testing.assert_allclose(loss_k[1].item(), loss_p[1].item(), atol=2e-4)
    assert loss_k[4].item() == loss_p[4].item()
    np.testing.assert_allclose(grad_k[1].numpy(), grad_p[1].numpy(), atol=2e-4)

    def jf(x):
        out = jctc.simplified_ctc_loss(labels, x, ll_, gl, 0)
        return jnp.sum(jnp.where(jnp.isfinite(out), out, 0.0))

    with jax_config(use_pallas=False):
        j_loss = np.asarray(jctc.simplified_ctc_loss(labels, logits, ll_, gl, 0))
        j_grad = np.asarray(jax.grad(jf)(jnp.asarray(logits)))
    # at logits 1e10 a float32 gradient keeps no digits (loss and
    # log-posterior cancel at 2e10): row 4 is held to its loss above
    rows = [0, 1, 2, 3, 5]
    np.testing.assert_allclose(loss_k[rows].numpy(), j_loss[rows], atol=2e-4)
    np.testing.assert_allclose(grad_k[rows].numpy(), j_grad[rows], atol=2e-4)


def test_clean_rows_keep_their_fast_values_bit_for_bit():
    labels, logits, ll_, gl = _batch(seed=1)
    guarded = _loss_and_grad(labels, logits, ll_, gl, use_kernels=True)
    unguarded = _loss_and_grad(labels, logits, ll_, gl, use_kernels=True, guard=False)
    clean = [0, 2, 3, 5]
    assert torch.equal(guarded[0][clean], unguarded[0][clean])
    assert torch.equal(guarded[1][clean], unguarded[1][clean])
    # without the guard the flushed rows keep +inf and a zero gradient
    assert torch.isposinf(unguarded[0][[1, 4]]).all()
    assert (unguarded[1][[1, 4]] == 0).all()


def test_repaired_step_scans_each_way_once(monkeypatch):
    # the forward's guard repairs the loss (log-space alpha, mode final); the
    # d_logits repair takes loss and gradient from one mode-resid scan; the
    # training step itself runs the block-float forward in mode resid once
    labels, logits, ll_, gl = _batch(seed=5)
    log_modes, fwd_modes = [], []
    real_log, real_fwd = ll.simplified_log_fwd, cs.simplified_fwd

    def spy_log(*a):
        log_modes.append(a[-1])
        return real_log(*a)

    def spy_fwd(*a):
        fwd_modes.append(a[-1])
        return real_fwd(*a)

    monkeypatch.setattr(ll, "simplified_log_fwd", spy_log)
    monkeypatch.setattr(cs, "simplified_fwd", spy_fwd)
    loss, grad = _loss_and_grad(labels, logits, ll_, gl, use_kernels=True)
    assert torch.isfinite(loss).all() and torch.isfinite(grad).all()
    assert sorted(log_modes) == ["final", "resid"]
    assert fwd_modes == ["resid"]


@pytest.mark.parametrize(
    "cfg", [dict(repair_bucket=1, repair_bucket2=1), dict(log_fallback=False)],
    ids=["one-row-rounds", "pure-repair"],
)
def test_repair_rounds_and_routes_agree(cfg, monkeypatch):
    labels, logits, ll_, gl = _batch(seed=2)
    ref = _loss_and_grad(labels, logits, ll_, gl, use_kernels=True)
    calls = []
    real = ll.simplified_log_fwd

    def spy(*a):
        calls.append(a[0].shape[0])
        return real(*a)

    monkeypatch.setattr(ll, "simplified_log_fwd", spy)
    out = _loss_and_grad(labels, logits, ll_, gl, use_kernels=True, **cfg)
    np.testing.assert_allclose(out[0].numpy(), ref[0].numpy(), atol=2e-4)
    rows = [0, 1, 2, 3, 5]
    np.testing.assert_allclose(out[1][rows].numpy(), ref[1][rows].numpy(), atol=2e-4)
    assert torch.isfinite(out[1]).all()
    if cfg.get("log_fallback") is False:
        assert calls == []
    else:
        assert calls and max(calls) == 1


def test_forward_only_loss_is_guarded():
    labels, logits, ll_, gl = _batch(seed=4)
    args = (torch.tensor(labels), torch.tensor(logits), torch.tensor(ll_),
            torch.tensor(gl), 0)
    with torch.no_grad():
        with config_override(use_kernels=True):
            fast = api.simplified_ctc_loss(*args)
        pure = api.simplified_ctc_loss(*args)
    np.testing.assert_allclose(fast.numpy(), pure.numpy(), atol=2e-4)


@pytest.mark.parametrize(
    "call",
    [
        lambda t, v, n: cs.simplified_fwd(t[:, :, 0], t, n, 8, "final"),
        lambda t, v, n: cs.simplified_bwd_streamed(
            t[:, :, 0], t, n, n, v[:, 0], t, n, 8),
        lambda t, v, n: ll.simplified_log_fwd(t[:, :, 0], t, n, "resid"),
        lambda t, v, n: ll.simplified_log_bwd(t[:, :, 0], t, n, n, v[:, 0], t),
    ],
    ids=["simplified_fwd", "simplified_bwd_streamed", "simplified_log_fwd",
         "simplified_log_bwd"],
)
def test_kernel_wrappers_refuse_other_devices(call):
    t = torch.empty((1, 8, 32), device="meta")
    v = torch.empty((1, 32), device="meta")
    n = torch.empty(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        call(t, v, n)
