"""The float64 pure-path scans (``ops/pure_scan.py``) and the guard's float64
repair that runs through them on the card (``ctc_port::pure_repair``).

On CPU tensors each scan op runs its plain version, the pure module's own
loop (``classic.alpha_scan`` and ``beta_scan``, ``simplified.alpha_scan``
and ``beta_scan``), so the ops are held bit for bit to ``classic.alpha``,
``classic.beta``, ``simplified.alpha`` and ``simplified.beta`` on a float64
context: with -inf logits, an infeasible row, a row of ``label_length`` 0
and a time axis of one step.  ``pure_repair`` on the CPU is held bit for
bit to its body before the kernels came (alpha by the loop,
``core.gradient_log``, whose beta is the loop's), and its loss and
d_logits to the JAX package's pure path in float32 (``use_pallas=False``)
at rtol 1e-5 and atol 2e-4, the repaired rows' tolerances
(``tests/test_torch_port_repair.py``).  The ops run through
``torch.library.opcheck`` and under ``torch.compile(fullgraph=True,
backend="aot_eager")``, their fakes' shapes and dtypes those of the real
outputs; each op, and ``pure_repair``, has a CUDA kernel registered; and
``tools/time_scans.py``'s cases of them, at a tiny size of
``chip_smoke.py``'s generators, give the pure path's lattices.  The
kernels themselves run on the card only (``chip_smoke.py`` phases 2 and
12 (d)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tf_seq2seq_losses_tpu as jctc
from tests.test_torch_port_compile import fresh_dynamo  # noqa: F401 (autouse)
from tf_seq2seq_losses_tpu.utils.config import config_override as jax_config
from tf_seq2seq_losses_tpu_torch.ops import (
    classic,
    core,
    log_lattice,
    pure_scan,
    simplified,
)
from tf_seq2seq_losses_tpu_torch.ops.topology import compose_dlogits
from tf_seq2seq_losses_tpu_torch.utils.numerics import logit_to_logproba

BATCH, MAX_T, VOCAB, WIDTH = 4, 9, 5, 4
CASES = ("random", "neg_inf_logits", "infeasible_row", "label_length_0", "one_step")
PURE = {"classic": classic, "simplified": simplified}
JAX_LOSS = {"classic": jctc.classic_ctc_loss, "simplified": jctc.simplified_ctc_loss}
SCAN_OPS = ("classic_alpha64", "classic_beta64", "simplified_alpha64",
            "simplified_beta64")


def batch(case, seed=11):
    """``(labels, logits, label_length, logit_length)`` as numpy arrays."""
    rng = np.random.RandomState(seed)
    num_t = 1 if case == "one_step" else MAX_T
    labels = rng.randint(1, VOCAB, (BATCH, WIDTH)).astype(np.int32)
    labels[0, 1] = labels[0, 0]  # a repeat: the classic topology's extra blank
    logits = rng.randn(BATCH, num_t, VOCAB).astype(np.float32)
    label_length = np.array([3, 4, 2, 1], np.int32)
    logit_length = np.array([num_t, num_t - 1, num_t, num_t - 2], np.int32).clip(1)
    if case == "one_step":
        label_length = np.array([1, 0, 1, 1], np.int32)
    if case == "neg_inf_logits":
        logits[:, 2, labels[:, 0]] = -np.inf  # a label token impossible at step 2
        logits[1, 4, 0] = -np.inf  # and blank at step 4 of row 1
    if case == "infeasible_row":
        logit_length[2] = 1
    if case == "label_length_0":
        label_length[3] = 0
    return labels, logits, label_length, logit_length


def context(case):
    labels, logits, label_length, logit_length = batch(case)
    lp = logit_to_logproba(torch.tensor(logits), 2)
    return core.make_context(torch.tensor(labels), lp, torch.tensor(label_length),
                             torch.tensor(logit_length), 0)


def assert_same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want), f"max abs diff {float((got - want).abs().max())}"


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("topology", ["classic", "simplified"])
def test_scan_ops_are_the_pure_path(topology, case):
    c64 = core.float64_context(context(case))
    alpha, beta = pure_scan.SCANS[topology](c64)
    assert alpha.dtype == torch.float64
    assert_same(alpha, PURE[topology].alpha(c64))
    assert_same(beta, PURE[topology].beta(c64))
    assert pure_scan.SCANS[topology](c64, with_beta=False)[1] is None


def old_pure_repair(topology, ctx, result):
    """``ctc_port::pure_repair``'s body before the scan kernels."""
    pure = PURE[topology]
    c64 = core.float64_context(ctx)
    alpha = pure.alpha(c64)
    loss = pure.loss(c64, alpha)
    if result == "loss":
        return [loss.float()]
    grad_log = core.gradient_log(pure, c64, loss, alpha)
    second = -torch.exp(grad_log) if result == "grad" else grad_log
    return [loss.float(), second.float()]


@pytest.mark.parametrize("result", ["loss", "grad", "grad_log"])
@pytest.mark.parametrize("topology", ["classic", "simplified"])
def test_pure_repair_on_the_cpu_is_the_loop(topology, result):
    for case in CASES:
        ctx = context(case)
        got = log_lattice.pure_repair(topology, ctx, result)
        want = old_pure_repair(topology, ctx, result)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)


@pytest.mark.parametrize("case", ["random", "neg_inf_logits", "infeasible_row"])
@pytest.mark.parametrize("topology", ["classic", "simplified"])
def test_pure_repair_against_the_jax_pure_path(topology, case):
    labels, logits, label_length, logit_length = batch(case)
    ctx = context(case)
    loss, grad = log_lattice.pure_repair(topology, ctx, "grad")
    d_logits = compose_dlogits(ctx, grad, loss, torch.ones_like(loss))
    jax_loss = JAX_LOSS[topology]

    def total(x):
        out = jax_loss(labels, x, label_length, logit_length, 0)
        return jnp.sum(jnp.where(jnp.isfinite(out), out, 0.0))

    with jax_config(use_pallas=False):
        j_loss = np.asarray(jax_loss(labels, jnp.asarray(logits), label_length,
                                     logit_length, 0))
        j_grad = np.asarray(jax.grad(total)(jnp.asarray(logits)))
    np.testing.assert_allclose(loss.numpy(), j_loss, rtol=1e-5)
    np.testing.assert_allclose(d_logits.numpy(), j_grad, atol=2e-4)


def op_args(name):
    """The arguments that ``pure_scan.SCANS`` gives op ``name``."""
    c64 = core.float64_context(context("neg_inf_logits"))
    if name.startswith("classic"):
        t = classic.terms(c64)
        args = (t.blank_lp, t.prev_tok_masked, t.diag_closed, t.diag_open)
    else:
        args = (c64.blank_lp, core.expected_token_lp(c64))
    args = tuple(a.contiguous() for a in args)
    return args + (c64.label_length,) if name.endswith("beta64") else args


@pytest.mark.parametrize("name", SCAN_OPS)
def test_scan_op_under_compile(name):
    op = getattr(torch.ops.ctc_port, name)
    args = op_args(name)
    torch.library.opcheck(op, args)
    want = op(*args)
    with torch._subclasses.FakeTensorMode(allow_non_fake_inputs=True):
        fake = op(*args)
    assert (fake.shape, fake.dtype) == (want.shape, want.dtype)
    got = torch.compile(lambda *a: op(*a), fullgraph=True, backend="aot_eager")(*args)
    assert_same(got, want)


def test_float32_terms_are_refused():
    c = context("random")
    with pytest.raises(TypeError, match="float64"):
        pure_scan.simplified_alpha64(c.blank_lp, core.expected_token_lp(c))


@pytest.mark.parametrize("name", ("pure_repair",) + SCAN_OPS)
def test_op_has_a_cuda_kernel(name):
    assert torch._C._dispatch_has_kernel_for_dispatch_key(f"ctc_port::{name}", "CUDA")


@pytest.fixture
def smoke(monkeypatch):
    import chip_smoke

    for name, value in (("BATCH", 8), ("MAX_T", 24), ("VOCAB", 8), ("LONG_T", 40)):
        monkeypatch.setattr(chip_smoke, name, value)
    return chip_smoke


@pytest.mark.parametrize("shape", ["pure_round", "long_row"])
def test_the_timing_tools_float64_cases(smoke, shape):
    """``tools/time_scans.py``'s cases of the four scans at a tiny size of
    ``chip_smoke.py``'s generators: the repair round with its infeasible
    row 0, and rows 0 and 2 of the long-T batch at full T; each case's
    output is the pure path's lattice, each bound positive."""
    from tf_seq2seq_losses_tpu_torch.tools import time_scans

    cpu = torch.device("cpu")
    ctx = getattr(time_scans, shape)(smoke, torch, cpu)
    assert ctx.logproba.shape[0] == (5 if shape == "pure_round" else 2)
    assert bool(torch.isposinf(classic.loss(ctx, classic.alpha(ctx)))[0])  # row 0
    c64 = core.float64_context(ctx)
    want = {"classic_alpha64": classic.alpha(c64), "classic_beta64": classic.beta(c64),
            "simplified_alpha64": simplified.alpha(c64),
            "simplified_beta64": simplified.beta(c64)}
    cases = time_scans.pure64_cases(smoke, ctx)
    assert set(cases) == set(SCAN_OPS)
    for name, (launch, mode, lens, window) in cases.items():
        (got,) = launch()
        assert_same(got, want[name])
        assert len(time_scans.digest(torch, (launch, mode, lens, window))) == 16
    bounds = time_scans.pure64_bounds(smoke, ctx, shape)
    assert set(bounds) == {f"{name} {shape}" for name in SCAN_OPS}
    assert all(ms > 0 for ms in bounds.values())
