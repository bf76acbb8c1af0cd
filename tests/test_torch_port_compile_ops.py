"""The ``ctc_port::`` custom ops that ``torch.compile`` keeps opaque, and the
host decisions that it folds into constants.

Each kernel wrapper's op and the float64 pure repair's run through
``torch.library.opcheck`` on CPU tensors (the plain versions) at small
shapes, in every mode and with and without a carry: its schema, its fake
(output shapes and dtypes from the inputs' shapes and static ints alone)
against its real outputs, and its tracing by AOTAutograd with dynamic
shapes.  ``_build.smem_limit`` and the guard's tier plan are constants of
a compiled graph: the card's shared memory is read when the graph is
traced (here from stand-in device properties: the routing of a CUDA
tensor is then decided without a card), and the fallback cap's warnings
are given at trace time, once, without a graph break.
"""

import types
import warnings

import numpy as np
import pytest
import torch

from tests.test_torch_port_compile import compiled, fresh_dynamo  # noqa: F401
from tests.test_torch_port_jit import BUCKETS, flushed_batch
from tf_seq2seq_losses_tpu_torch import api
from tf_seq2seq_losses_tpu_torch.ops import _build, core, log_lattice, topology
from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice as cl
from tf_seq2seq_losses_tpu_torch.ops import cuda_simplified as cs
from tf_seq2seq_losses_tpu_torch.utils.config import config_override
from tf_seq2seq_losses_tpu_torch.utils.numerics import logit_to_logproba

# 8 steps, so window 4 gives two windows
WINDOW = 4


def small_ctx(seed=3):
    rng = np.random.default_rng(seed)
    labels = torch.tensor(rng.integers(1, 5, (3, 3)))
    logits = torch.tensor(rng.normal(size=(3, 8, 5)).astype(np.float32))
    return core.make_context(labels, logit_to_logproba(logits, 2), torch.tensor([3, 2, 1]),
                             torch.tensor([8, 6, 5]), 0)


def op_cases():
    """``[(id, op, args)]``: every op at the inputs its main-path caller
    gives it."""
    ctx = small_ctx()
    with config_override(window=WINDOW):
        blank, dcu, lm, nb, rep, lens, lab_len, k = cl.kernel_inputs(ctx)
        sblank, dg, _slm, slens, slab_len, _ = cs.simplified_kernel_inputs(ctx)
        blank_l, dc_l, pt_l, _lm, _nb, _rep, _lens, _lab = log_lattice._log_inputs(ctx)
        sblank_l, dg_l, *_ = log_lattice.simplified_log_inputs(ctx)
    scan = (blank, dcu, lm, nb, rep, lens)
    none3, none2 = (None,) * 3, (None,) * 2
    sa, saf, *carry = cl.classic_fwd(*scan, k, "resid")
    a1, saf1, a0w, *_ = cl.classic_fwd(*scan, k, "resid1")
    b0, b1, be, *_ = cl.classic_fwd(*scan, k, "bound")
    ebi = cl.ebi_from_loss(cl.pick_loss(carry[0] + carry[1], carry[2], lab_len))
    ssa, ssaf, *scarry = cs.simplified_fwd(sblank, dg, slens, k, "resid")
    sbd, sbde, *_ = cs.simplified_fwd(sblank, dg, slens, k, "bound")
    sx, sa1, *_ = log_lattice.classic_log_fwd(blank_l, dc_l, pt_l, nb, rep, lens, "resid")
    lsa, _ = log_lattice.simplified_log_fwd(sblank_l, dg_l, slens, "resid")
    pc, *_ = cl.classic_bwd_streamed(*scan, lab_len, ebi, sa, saf, k)
    loss = torch.tensor([2.0, 3.0, 4.0])
    ops = torch.ops.ctc_port
    cases = [(f"classic_fwd[{m}]", ops.classic_fwd, (*scan, k, m, *none3))
             for m in ("final", "resid", "resid1", "bound")]
    cases += [
        ("classic_fwd[carry]", ops.classic_fwd, (*scan, k, "final", *carry)),
        ("classic_bwd_streamed", ops.classic_bwd_streamed,
         (*scan, lab_len, ebi, sa, saf, k)),
        ("classic_bwd_half", ops.classic_bwd_half,
         (*scan, lab_len, ebi, a1, saf1, a0w, k)),
        ("classic_bwd", ops.classic_bwd, (*scan, lab_len, ebi, b0, b1, be, k, *none3)),
        ("classic_bwd[carry]", ops.classic_bwd,
         (*scan, lab_len, ebi, b0, b1, be, k, *carry)),
        ("fused_dlogits", ops.fused_dlogits,
         (pc, cl.lane_tokens(ctx, pc.shape[2]), lm, torch.ones(3), torch.ones(3),
          lens, ctx.logproba.contiguous(), ctx.blank_index)),
    ]
    cases += [(f"simplified_fwd[{m}]", ops.simplified_fwd,
               (sblank, dg, slens, k, m, *none2)) for m in ("final", "resid", "bound")]
    cases += [
        ("simplified_fwd[carry]", ops.simplified_fwd,
         (sblank, dg, slens, k, "final", *scarry)),
        ("simplified_bwd_streamed", ops.simplified_bwd_streamed,
         (sblank, dg, slens, slab_len, ebi, ssa, ssaf, k)),
        ("simplified_bwd", ops.simplified_bwd,
         (sblank, dg, slens, slab_len, ebi, sbd, sbde, k, *none2)),
        ("simplified_bwd[carry]", ops.simplified_bwd,
         (sblank, dg, slens, slab_len, ebi, sbd, sbde, k, *scarry)),
    ]
    cases += [(f"classic_log_fwd[{m}]", ops.classic_log_fwd,
               (blank_l, dc_l, pt_l, nb, rep, lens, m)) for m in ("final", "resid")]
    cases += [("classic_log_bwd", ops.classic_log_bwd,
               (blank_l, dc_l, pt_l, nb, rep, lens, lab_len, loss, sx, sa1))]
    cases += [(f"simplified_log_fwd[{m}]", ops.simplified_log_fwd,
               (sblank_l, dg_l, slens, m)) for m in ("final", "resid")]
    cases += [("simplified_log_bwd", ops.simplified_log_bwd,
               (sblank_l, dg_l, slens, slab_len, loss, lsa))]
    cases += [(f"pure_repair[{t},{r}]", ops.pure_repair, (*ctx, t, r))
              for t in ("classic", "simplified") for r in ("loss", "grad", "grad_log")]
    return cases


CASES = op_cases()


@pytest.mark.parametrize("op,args", [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_custom_op(op, args):
    torch.library.opcheck(op, args)
    real = op(*args)
    with torch._subclasses.FakeTensorMode(allow_non_fake_inputs=True):
        fake = op(*args)
    real, fake = (list(x) if isinstance(x, (list, tuple)) else [x] for x in (real, fake))
    assert [(t.shape, t.dtype) for t in fake] == [(t.shape, t.dtype) for t in real]


def test_every_kernel_wrapper_is_an_op():
    """The twelve kernel wrappers' ops and the pure repair's."""
    names = {c[0].split("[")[0] for c in CASES}
    assert names == {
        "classic_fwd", "classic_bwd_streamed", "classic_bwd_half", "classic_bwd",
        "fused_dlogits", "simplified_fwd", "simplified_bwd_streamed", "simplified_bwd",
        "classic_log_fwd", "classic_log_bwd", "simplified_log_fwd", "simplified_log_bwd",
        "pure_repair"}


def test_card_smem_limit_is_a_trace_time_constant(monkeypatch):
    """On a CUDA device the shared memory limit comes from the device's
    properties, read once a device and folded into a compiled graph: the
    traced code routes without reading it."""
    reads = []

    def props(index):
        reads.append(index)
        return types.SimpleNamespace(shared_memory_per_block_optin=1000)

    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    monkeypatch.setattr(_build, "_optin", {})
    card = torch.device("cuda", 0)

    def route(x):
        return x + (1 if _build.fits(("classic_fwd",), 32, 8, card) else 2)

    cf, graphs = compiled(route)
    assert torch.equal(cf(torch.zeros(2)), torch.full((2,), 2.0))  # 1000 bytes hold none
    assert torch.equal(cf(torch.zeros(2)), torch.full((2,), 2.0))
    assert graphs.frame_count == 1 and reads == [0]
    assert _build.smem_limit(card) == 1000 and reads == [0]
    assert _build.smem_limit(torch.device("cpu")) == _build.SMEM_LIMIT


def test_cap_warns_at_trace_time_without_a_break(monkeypatch):
    """Under a cap that disables the whole-batch reroute ("cond") and tier
    2 (``tests/test_torch_port_jit.py``'s "bucket" cap: tier 1's one row
    repairs), the compiled step warns when it is traced, as the JAX
    package warns under ``jax.jit``, and not at the calls that reuse the
    graph; its values are the eager step's."""
    monkeypatch.setenv("CTC_TPU_GUARD_FALLBACK_BYTES", "60000")
    labels, logits, ll, gl = (torch.tensor(a) for a in flushed_batch(3))

    def loss(x):
        return api.classic_ctc_loss(labels, x, ll, gl, 0)

    with config_override(use_kernels=True, guard_struct="cond", **BUCKETS):
        cf, graphs = compiled(loss)
        with warnings.catch_warnings(record=True) as traced:
            warnings.simplefilter("always")
            got = cf(logits)
        with warnings.catch_warnings(record=True) as reused:
            warnings.simplefilter("always")
            again = cf(logits)
        want = loss(logits)
    assert graphs.frame_count == 1
    assert [str(w.message) for w in traced] == [topology._WHOLE_BATCH_DISABLED.format(
        cap_mb=0, rows=1)]
    assert not reused
    assert torch.equal(got, want) and torch.equal(again, want)
