"""The fused d_logits epilogue (``fused_epilogue``: kernel B12) on its plain
PyTorch version, against the JAX package's fused epilogue and against the
port's unfused composition.

The JAX package runs its fused kernel in interpret mode at V=128, where
its gate ``fused_epilogue_ok`` holds (after tests/test_fused_epilogue.py);
at V=32 its gate keeps the unfused path while the port's B12, which has no
vocabulary rule, still runs.  d_logits atol 1e-5 against JAX (its bf16
hi/lo scatter is 2^-17 relative), 1e-6 against the port's unfused path
(the same float64 sums, another order of the float32 blank sum).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tf_seq2seq_losses_tpu as jctc
from tf_seq2seq_losses_tpu.ops.pallas_lattice import fused_epilogue_ok as jax_ok
from tf_seq2seq_losses_tpu.utils.config import config_override as jax_config
from tf_seq2seq_losses_tpu_torch import api
from tf_seq2seq_losses_tpu_torch.ops import core
from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice as cl
from tf_seq2seq_losses_tpu_torch.ops import cuda_simplified as cs
from tf_seq2seq_losses_tpu_torch.ops.topology import compose_dlogits
from tf_seq2seq_losses_tpu_torch.utils.config import config_override

INTERP = dict(use_pallas=True, interpret=True, block_batch=2, block_time=4)
FNS = {"classic": (jctc.classic_ctc_loss, api.classic_ctc_loss),
       "simplified": (jctc.simplified_ctc_loss, api.simplified_ctc_loss)}


def _inputs(vocab, seed=0, batch=4, num_t=9, max_l=4, blank=0):
    """As tests/test_fused_epilogue.py builds them, with row 0 infeasible."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(batch, num_t, vocab).astype(np.float32)
    lo = 1 if blank == 0 else 0
    labels = rng.randint(lo, vocab, size=(batch, max_l)).astype(np.int32)
    labels = np.where(labels == blank, (blank + 1) % vocab, labels).astype(np.int32)
    label_length = rng.randint(1, max_l + 1, size=batch).astype(np.int32)
    logit_length = rng.randint(num_t // 2, num_t + 1, size=batch).astype(np.int32)
    label_length[0], logit_length[0] = 4, 2
    return labels, logits, label_length, logit_length


def _ct(batch):
    return np.random.RandomState(7).randn(batch).astype(np.float32)


def _port(fn, labels, logits, ll, gl, ct, blank=0, **cfg):
    x = torch.tensor(logits, requires_grad=True)
    with config_override(**cfg):
        loss = fn(torch.tensor(labels), x, torch.tensor(ll), torch.tensor(gl), blank)
        loss.backward(torch.tensor(ct))
    return loss.detach(), x.grad


def _spy(monkeypatch):
    calls = []
    real = cl.fused_dlogits

    def spy(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(cl, "fused_dlogits", spy)
    return calls


@pytest.mark.parametrize("topology,blank", [("classic", 0), ("classic", 5),
                                            ("simplified", 0), ("simplified", 5)])
def test_fused_matches_jax_fused_interpret_at_v128(topology, blank, monkeypatch):
    jfn, fn = FNS[topology]
    labels, logits, ll, gl = _inputs(128, seed=1 + blank, blank=blank)
    ct = _ct(len(labels))
    with jax_config(**INTERP, fused_epilogue=True):
        assert jax_ok(4, 9, 128, labels.shape[1] + 1)
        _, pull = jax.vjp(lambda lg: jfn(labels, lg, ll, gl, blank),
                          jnp.asarray(logits))
        j_d = np.asarray(pull(jnp.asarray(ct))[0])
    calls = _spy(monkeypatch)
    _, d = _port(fn, labels, logits, ll, gl, ct, blank, use_kernels=True,
                 fused_epilogue=True)
    assert len(calls) == 1
    assert not d[0].any()
    np.testing.assert_allclose(d.numpy(), j_d, atol=1e-5, rtol=0)


@pytest.mark.parametrize("topology", ["classic", "simplified"])
def test_fused_matches_jax_at_v32_where_jax_stays_unfused(topology, monkeypatch):
    jfn, fn = FNS[topology]
    labels, logits, ll, gl = _inputs(32, seed=3)
    ct = _ct(len(labels))
    with jax_config(**INTERP, fused_epilogue=True):
        assert not jax_ok(4, 9, 32, labels.shape[1] + 1)
        _, pull = jax.vjp(lambda lg: jfn(labels, lg, ll, gl, 0), jnp.asarray(logits))
        j_d = np.asarray(pull(jnp.asarray(ct))[0])
    calls = _spy(monkeypatch)
    _, d = _port(fn, labels, logits, ll, gl, ct, use_kernels=True, fused_epilogue=True)
    assert len(calls) == 1
    np.testing.assert_allclose(d.numpy(), j_d, atol=1e-5, rtol=0)


@pytest.mark.parametrize("topology", ["classic", "simplified"])
def test_fused_equals_unfused(topology):
    _, fn = FNS[topology]
    labels, logits, ll, gl = _inputs(40, seed=4, num_t=13)
    ct = _ct(len(labels))
    fused = _port(fn, labels, logits, ll, gl, ct, use_kernels=True, fused_epilogue=True)
    unfused = _port(fn, labels, logits, ll, gl, ct, use_kernels=True)
    assert torch.equal(fused[0], unfused[0])
    np.testing.assert_allclose(fused[1].numpy(), unfused[1].numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("cfg,fused", [
    (dict(), False),
    (dict(fused_epilogue=True), True),
    (dict(fused_epilogue=True, half_stream=True), True),
    (dict(fused_epilogue=True, stream_residuals=False), False),
    (dict(fused_epilogue=True, chunk_time=8), False),
], ids=["off by default", "on", "half-stream pack", "residual-free", "chunked"])
def test_the_gate_takes_streamed_packs_only(cfg, fused, monkeypatch):
    labels, logits, ll, gl = _inputs(16, seed=5, num_t=20)
    calls = _spy(monkeypatch)
    ref = _port(api.classic_ctc_loss, labels, logits, ll, gl, _ct(4), use_kernels=True,
                chunk_time=cfg.get("chunk_time", 512))
    out = _port(api.classic_ctc_loss, labels, logits, ll, gl, _ct(4), use_kernels=True,
                **cfg)
    assert len(calls) == int(fused)
    assert torch.equal(out[0], ref[0])
    np.testing.assert_allclose(out[1].numpy(), ref[1].numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("topology", ["classic", "simplified"])
def test_guard_repair_inside_the_fused_branch(topology, monkeypatch):
    # row 2: at frame 3 a token absent from every label at +100, the rest at
    # -100, so the block-float scans flush and the guard recomputes the row
    # (log-space repair: atol 2e-4 from the pure path); clean rows keep the
    # fused values bit for bit
    _, fn = FNS[topology]
    labels, logits, ll, gl = _inputs(128, seed=6)
    labels = labels % 100 + 1
    ct = _ct(len(labels))
    clean = _port(fn, labels, logits, ll, gl, ct, use_kernels=True, fused_epilogue=True)
    gl[2], ll[2] = 9, 3
    logits[2, 3] = -100.0
    logits[2, 3, 120] = 100.0
    calls = _spy(monkeypatch)
    fused = _port(fn, labels, logits, ll, gl, ct, use_kernels=True, fused_epilogue=True)
    pure = _port(fn, labels, logits, ll, gl, ct, use_kernels=False)
    assert calls
    assert torch.isfinite(fused[0][2])
    np.testing.assert_allclose(fused[0][2].numpy(), pure[0][2].numpy(), atol=2e-4)
    np.testing.assert_allclose(fused[1][2].numpy(), pure[1][2].numpy(), atol=2e-4)
    for i in (0, 1, 3):
        assert torch.equal(fused[0][i], clean[0][i])
        assert torch.equal(fused[1][i], clean[1][i])


def test_double_backward_is_the_same_with_fusion_on_and_off():
    labels, logits, ll, gl = _inputs(6, seed=7, batch=2, num_t=6)
    u = torch.tensor(np.random.RandomState(8).randn(*logits.shape).astype(np.float32))
    out = []
    for fused in (False, True):
        x = torch.tensor(logits, requires_grad=True)
        with config_override(use_kernels=True, fused_epilogue=fused):
            loss = api.classic_ctc_loss(torch.tensor(labels), x, torch.tensor(ll),
                                        torch.tensor(gl), 0)
            fin = torch.where(torch.isfinite(loss), loss, torch.zeros_like(loss))
            (g,) = torch.autograd.grad(fin.sum(), x, create_graph=True)
            (hu,) = torch.autograd.grad((g * u).sum(), x)
        out.append((g.detach(), hu))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])


@pytest.mark.parametrize("vocab", [32, 128, 1000])
def test_fused_dlogits_plain_equals_the_unfused_composition(vocab):
    # the wrapper's arguments as the streamed scheme gives them, blank 3
    labels, logits, ll, gl = _inputs(vocab, seed=9, batch=8, num_t=11, blank=3)
    lp = torch.log_softmax(torch.tensor(logits), 2)
    ctx = core.make_context(torch.tensor(labels), lp, torch.tensor(ll),
                            torch.tensor(gl), 3)
    steps = ((cl.classic_loss_and_pack, cl.classic_streamed_acts),
             (cs.simplified_loss_and_pack, cs.simplified_streamed_acts))
    for loss_and_pack, acts_step in steps:
        loss, pack = loss_and_pack(ctx)
        acts, lm, fast_loss, scale = acts_step(ctx, pack)
        d_loss = torch.tensor(_ct(8))
        fused, _ = cl.streamed_dlogits(ctx, d_loss, acts, lm, fast_loss, scale)
        grad, _ = cl.streamed_gradient(ctx, acts, lm, fast_loss, scale)
        ref = compose_dlogits(ctx, grad, fast_loss, d_loss)
        assert torch.isposinf(fast_loss[0]) and not fused[0].any()
        np.testing.assert_allclose(fused.numpy(), ref.numpy(), atol=1e-6, rtol=0)
