"""The guard's structures (``guard_struct`` "while" and "cond", ``guard_tier1``)
against the JAX package's, after tests/test_guard_struct.py.

The JAX package runs its kernels in interpret mode with its own tests'
fixture (``repair_bucket=2``, ``repair_bucket2=4``); the port runs the same
config (its TPU-only knobs ignored by ``config_override``) with
``use_kernels=True`` on CPU tensors, the kernels' plain versions.  The
first ``n`` rows flush (logits 100 on a token outside the label), so n
spans clean, tier 1, the bucket, tier 2, beyond tier 2 and the whole batch.
Loss rtol 1e-5 and gradient atol 1e-4 from JAX's and from the port's pure
path in float64, as the JAX test holds them to its pure path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tf_seq2seq_losses_tpu as jctc
from tf_seq2seq_losses_tpu.utils.config import config_override as jax_config
from tf_seq2seq_losses_tpu_torch import api
from tf_seq2seq_losses_tpu_torch.ops import core, log_lattice
from tf_seq2seq_losses_tpu_torch.ops.topology import TOPOLOGIES, compose_dlogits
from tf_seq2seq_losses_tpu_torch.utils.config import config_override
from tf_seq2seq_losses_tpu_torch.utils.numerics import logit_to_logproba

BATCH, MAX_T, VOCAB = 8, 6, 4
FIXTURE = dict(use_pallas=True, interpret=True, block_batch=2, block_time=4,
               repair_bucket=2, repair_bucket2=4, log_fallback=True,
               sort_by_length=False)
FNS = {"classic": (jctc.classic_ctc_loss, api.classic_ctc_loss),
       "simplified": (jctc.simplified_ctc_loss, api.simplified_ctc_loss)}


def flushed_batch(n_flushed, seed=7, vocab=VOCAB):
    """tests/test_guard_struct.py's batch: the first ``n_flushed`` rows are
    wrong-certain (the fast path flushes, the row is feasible)."""
    rand = np.random.RandomState(seed)
    logits = rand.randn(BATCH, MAX_T, vocab).astype(np.float32)
    logits[:n_flushed] = 0.0
    logits[:n_flushed, :, vocab - 1] = 100.0
    labels = np.tile(np.array([[1, 2]], np.int32), (BATCH, 1))
    return (labels, logits, np.full((BATCH,), 2, np.int32),
            np.full((BATCH,), MAX_T, np.int32))


def jax_step(args, topology="classic", weights=None, **cfg):
    """The JAX package's loss and the gradient of its weighted finite sum."""
    fn = FNS[topology][0]
    labels, logits, ll, gl = args
    w = jnp.ones(BATCH) if weights is None else jnp.asarray(weights)

    def scalar(x):
        out = fn(labels, x, ll, gl, 0)
        return jnp.sum(jnp.where(jnp.isfinite(out), out, 0.0) * w)

    with jax_config(**cfg):
        loss = np.asarray(fn(labels, jnp.asarray(logits), ll, gl, 0))
        grad = np.asarray(jax.grad(scalar)(jnp.asarray(logits)))
    return loss, grad


def port_step(args, topology="classic", weights=None, **cfg):
    """The port's loss and the gradient of its weighted finite sum."""
    fn = FNS[topology][1]
    labels, logits, ll, gl = args
    x = torch.tensor(logits, requires_grad=True)
    w = torch.ones(BATCH) if weights is None else torch.tensor(weights)
    with config_override(**cfg):
        loss = fn(torch.tensor(labels), x, torch.tensor(ll), torch.tensor(gl), 0)
        (torch.where(torch.isfinite(loss), loss, torch.zeros_like(loss)) * w).sum().backward()
    return loss.detach().numpy(), x.grad.numpy()


def pure64(args, topology="classic"):
    """The port's pure path in float64 on the float32 logits: the loss and
    the gradient of the finite sum with respect to the logits."""
    labels, logits, ll, gl = args
    topo = TOPOLOGIES[topology]
    lp64 = logit_to_logproba(torch.tensor(logits, dtype=torch.float64), 2)
    c = core.make_context(torch.tensor(labels), lp64, torch.tensor(ll), torch.tensor(gl), 0)
    lp64 = torch.where(c.logit_length_mask[:, :, None], lp64, c.logproba.double())
    c = c._replace(logproba=lp64, raw_logproba=lp64,
                   blank_lp=core.take_blank_logproba(lp64, c.blank_index))
    loss = topo.pure_loss(c)
    grad = core.gradient(topo, c, loss)
    return loss.numpy(), compose_dlogits(c, grad, loss, torch.ones_like(loss)).numpy()


@pytest.fixture(scope="module")
def jax_values():
    """JAX's values by (struct, tier 1, n), each computed once (tier 1 is
    ignored under "cond", as there)."""
    cache = {}

    def get(struct, tier1, n_flushed):
        key = (struct, tier1 and struct == "while", n_flushed)
        if key not in cache:
            cache[key] = jax_step(flushed_batch(n_flushed), **FIXTURE,
                                  guard_struct=struct, guard_tier1=key[1])
        return cache[key]

    return get


@pytest.mark.parametrize("n_flushed", [0, 1, 2, 3, 5, 8])
@pytest.mark.parametrize("struct", ["while", "cond"])
@pytest.mark.parametrize("tier1", [True, False])
def test_struct_matches_jax_and_pure(n_flushed, struct, tier1, jax_values):
    args = flushed_batch(n_flushed)
    got, g_got = port_step(args, **FIXTURE, use_kernels=True, guard_struct=struct,
                           guard_tier1=tier1)
    want, g_want = jax_values(struct, tier1, n_flushed)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(g_got, g_want, atol=1e-4)
    pure, g_pure = pure64(args)
    np.testing.assert_allclose(got, pure, rtol=1e-5)
    np.testing.assert_allclose(g_got, g_pure, atol=1e-4)


@pytest.mark.parametrize("n_flushed", [1, 5])
def test_cond_tier1_flag_is_ignored(n_flushed):
    """guard_tier1 changes nothing under "cond", where tier 1 is structural."""
    args = flushed_batch(n_flushed)
    on = port_step(args, **FIXTURE, use_kernels=True, guard_struct="cond",
                   guard_tier1=True)
    off = port_step(args, **FIXTURE, use_kernels=True, guard_struct="cond")
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)


def test_structs_agree_on_repaired_rows():
    """n=3 is tier 2 under "cond" and one round under "while": the same
    exact values, clean rows on the fast path under both."""
    args = flushed_batch(3)
    loss_c, g_c = port_step(args, **FIXTURE, use_kernels=True, guard_struct="cond")
    loss_w, g_w = port_step(args, **FIXTURE, use_kernels=True, guard_struct="while")
    np.testing.assert_allclose(loss_w, loss_c, rtol=1e-6)
    np.testing.assert_allclose(g_w, g_c, atol=1e-6)


def _spy_log_rows(monkeypatch):
    rows = []
    real = log_lattice.classic_log_fwd

    def spy(*a):
        rows.append((a[0].shape[0], a[-1]))
        return real(*a)

    monkeypatch.setattr(log_lattice, "classic_log_fwd", spy)
    return rows


@pytest.mark.parametrize("n_flushed,tier", [(1, "pure"), (3, "gathered"),
                                            (5, "whole"), (8, "whole")])
def test_cond_tiers(n_flushed, tier, monkeypatch):
    """Tier 1 runs no log-space kernel, tier 2 runs them on the flushed rows,
    tier 3 on the whole batch and replaces the clean rows with exact
    values, within tolerance of the fast ones; "while" keeps them bit for
    bit."""
    args = flushed_batch(n_flushed)
    rows = _spy_log_rows(monkeypatch)
    loss, grad = port_step(args, **FIXTURE, use_kernels=True, guard_struct="cond")
    want = {"pure": [], "gathered": [(n_flushed, "final"), (n_flushed, "resid")],
            "whole": [(BATCH, "final"), (BATCH, "resid")]}[tier]
    assert rows == want
    clean = slice(n_flushed, None)
    fast, g_fast = port_step(args, **FIXTURE, use_kernels=True, guard=False)
    kept, g_kept = port_step(args, **FIXTURE, use_kernels=True, guard_struct="while")
    np.testing.assert_array_equal(kept[clean], fast[clean])
    np.testing.assert_array_equal(g_kept[clean], g_fast[clean])
    np.testing.assert_allclose(loss[clean], fast[clean], rtol=1e-5)
    np.testing.assert_allclose(grad[clean], g_fast[clean], atol=1e-5)
    if tier == "whole" and n_flushed < BATCH:
        assert not np.array_equal(grad[clean], g_fast[clean])
    elif tier != "whole":
        np.testing.assert_array_equal(loss[clean], fast[clean])
        np.testing.assert_array_equal(grad[clean], g_fast[clean])


def test_whole_batch_tier_keeps_infeasible_rows_at_inf():
    labels, logits, ll, gl = flushed_batch(5)
    gl = gl.copy()
    gl[7] = 1  # two labels in one frame
    loss, grad = port_step((labels, logits, ll, gl), **FIXTURE, use_kernels=True,
                           guard_struct="cond")
    assert np.isposinf(loss[7]) and (grad[7] == 0).all()
    assert np.isfinite(loss[:7]).all()
    j_loss, j_grad = jax_step((labels, logits, ll, gl), **FIXTURE, guard_struct="cond")
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
    np.testing.assert_allclose(grad, j_grad, atol=1e-4)


@pytest.mark.parametrize("struct", ["while", "cond"])
def test_bucket_zero_reroutes_the_whole_batch(struct, monkeypatch):
    """repair_bucket=0: the two-way guard, any flushed row sends the whole
    batch through the exact path, under either struct (as in JAX)."""
    args = flushed_batch(1)
    rows = _spy_log_rows(monkeypatch)
    cfg = dict(FIXTURE, repair_bucket=0, guard_struct=struct)
    loss, grad = port_step(args, **cfg, use_kernels=True)
    assert rows == [(BATCH, "final"), (BATCH, "resid")]
    j_loss, j_grad = jax_step(args, **cfg)
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
    np.testing.assert_allclose(grad, j_grad, atol=1e-4)


def test_tier1_repairs_through_the_pure_path_in_float64(monkeypatch):
    """Under "while" with guard_tier1, n <= repair_bucket takes the pure path
    (no log-space launch), 1e-6 from float64 at this size."""
    args = flushed_batch(2)
    rows = _spy_log_rows(monkeypatch)
    loss, grad = port_step(args, **FIXTURE, use_kernels=True, guard_tier1=True)
    assert rows == []
    pure, g_pure = pure64(args)
    np.testing.assert_allclose(loss[:2], pure[:2], rtol=1e-6)
    np.testing.assert_allclose(grad[:2], g_pure[:2], atol=1e-6)


@pytest.mark.parametrize("topology", ["classic", "simplified"])
def test_fused_step_under_cond_beyond_bucket2(topology, monkeypatch):
    """The fused epilogue (B12's plain version, V=128) under "cond" with
    more flushed rows than tier 2 takes: the whole batch rerouted, as the
    JAX package's fused d_logits path in interpret mode."""
    args = flushed_batch(5, vocab=128)
    weights = np.arange(1.0, BATCH + 1.0, dtype=np.float32)
    calls = []
    from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice

    real = cuda_lattice.fused_dlogits_plain

    def spy(*a):
        calls.append(a[0].shape[0])
        return real(*a)

    monkeypatch.setattr(cuda_lattice, "fused_dlogits_plain", spy)
    cfg = dict(FIXTURE, guard_struct="cond", fused_epilogue=True)
    loss, grad = port_step(args, topology, weights, **cfg, use_kernels=True)
    assert calls == [BATCH]
    j_loss, j_grad = jax_step(args, topology, weights, **cfg)
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
    np.testing.assert_allclose(grad, j_grad, atol=1e-4)
    unfused = port_step(args, topology, weights, **dict(cfg, fused_epilogue=False),
                        use_kernels=True)
    np.testing.assert_array_equal(loss, unfused[0])
    np.testing.assert_allclose(grad, unfused[1], atol=1e-6)


def test_whole_batch_reroute_of_a_chunked_batch_takes_the_pure_path(monkeypatch):
    """"cond" reroutes the whole batch on a time axis of three chunks: the
    log-space kernels serve one chunk, so the exact path is the pure path
    in float64 (``log_lattice``), 1e-6 from float64 here."""
    args = flushed_batch(5)
    rows = _spy_log_rows(monkeypatch)
    loss, grad = port_step(args, **FIXTURE, use_kernels=True, guard_struct="cond",
                           chunk_time=2, window=1)
    assert rows == []
    pure, g_pure = pure64(args)
    np.testing.assert_allclose(loss, pure, rtol=1e-6)
    np.testing.assert_allclose(grad, g_pure, atol=1e-6)
