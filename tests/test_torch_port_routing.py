"""The choice of scheme by what the card's kernels hold.

A training forward streams its residuals only where the streamed kernels'
shared memory holds the label's lanes, and the guard repairs through the
log-space kernels only where they hold them; otherwise the residual-free
scheme and the pure path take over (and give the same values).  A label
that no kernel of a call holds takes the pure path, as the JAX package
computes any width.  The
shared-memory formulas are Python mirrors of the kernel libraries'
(``_build.SMEM_BYTES``; ``chip_smoke.py`` holds them against the
libraries), and CPU tensors are routed by the H100's limit, so these tests
patch ``_build.SMEM_LIMIT`` to a small one.
"""

import numpy as np
import pytest
import torch

from tf_seq2seq_losses_tpu_torch import api
from tf_seq2seq_losses_tpu_torch.ops import _build, core, topology
from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice as cl
from tf_seq2seq_losses_tpu_torch.ops import cuda_simplified as cs
from tf_seq2seq_losses_tpu_torch.ops import log_lattice as ll
from tf_seq2seq_losses_tpu_torch.utils.config import config_override

CPU = torch.device("cpu")


def _widest(name, x=8):
    return max(lp for lp in range(32, 8192, 32) if _build.fits((name,), lp, x, CPU))


def test_the_mirrors_give_the_lanes_measured_on_the_h100():
    # the widest labels at window 8 that chip_smoke.py phase 1 prints on an
    # H100, from the libraries' own formulas
    widest = {"classic_fwd": 4832, "classic_bwd_rf": 3040, "classic_bwd": 1792,
              "classic_bwd_half": 1856, "simplified_fwd": 4832,
              "simplified_bwd_rf": 3616, "simplified_bwd": 2624,
              "classic_log_bwd": 1696, "simplified_log_fwd": 5792,
              "simplified_log_bwd": 3200}
    assert {name: _widest(name) for name in widest} == widest
    # a one-chunk step with a 2016-lane label: residual-free, pure repair
    assert not _build.fits(("classic_bwd",), 2016, 8, CPU)
    assert not _build.fits(("classic_bwd_half",), 2016, 8, CPU)
    assert _build.fits(("classic_fwd", "classic_bwd_rf"), 2016, 8, CPU)
    assert not _build.fits(("classic_log_fwd", "classic_log_bwd"), 2016, 0, CPU)
    assert _build.fits(("fused_epilogue",), 2016, 1000, CPU)


# The residual-free backwards' shared memory before their redesign: every
# per-lane value in shared memory and one staged window of transitions.
_UNSTAGED_BYTES = {
    "classic_bwd_rf": lambda lp, k: 4 * (lp * (11 + k) + k) + 4 * 4 * lp,
    "simplified_bwd_rf": lambda lp, k: 4 * (lp * (6 + k) + k) + 4 * 4 * lp,
}


@pytest.mark.parametrize("window", [1, 8, 16])
@pytest.mark.parametrize("name", sorted(_UNSTAGED_BYTES))
def test_the_staged_scans_hold_at_least_the_lanes_of_the_unstaged_ones(name, window):
    # their staging ring costs shared memory that the lanes held in
    # registers give back: no label that took the residual-free scheme
    # before may start raising
    before = max(lp for lp in range(32, 8192, 32)
                 if _UNSTAGED_BYTES[name](lp, window) <= _build.SMEM_LIMIT)
    assert _widest(name, window) >= before
    assert _widest(name, 8) >= {"classic_bwd_rf": 2496, "simplified_bwd_rf": 3200}[name]


# The forward scans' shared memory before their redesign: every per-lane
# value in shared memory and one staged window of transitions
# (ops/_build.py's formulas then).
_UNSTAGED_FWD_BYTES = {
    "classic_fwd": lambda lp, k: 4 * (lp * (8 + k) + k) + 4 * 3 * lp,
    "simplified_fwd": lambda lp, k: 4 * (lp * (4 + k) + k) + 4 * 3 * lp,
}


@pytest.mark.parametrize("window", [1, 8, 16])
@pytest.mark.parametrize("name", sorted(_UNSTAGED_FWD_BYTES))
def test_the_staged_forwards_hold_at_least_the_lanes_of_the_unstaged_ones(name, window):
    # the ring costs shared memory that the lanes held in registers give
    # back: no label that took a forward kernel before may leave it
    before = max(lp for lp in range(32, 16384, 32)
                 if _UNSTAGED_FWD_BYTES[name](lp, window) <= _build.SMEM_LIMIT)
    widest = max(lp for lp in range(32, 16384, 32)
                 if _build.fits((name,), lp, window, CPU))
    assert widest >= before
    assert _widest(name, 8) >= {"classic_fwd": 3040, "simplified_fwd": 3872}[name]


def _unstaged_streamed_bytes(lp, k):
    """The streamed one-chunk beta scans' shared memory before their
    redesign (B3 and B13 alike): every per-lane value in shared memory and
    one staged window of transitions and residual pairs."""
    return 4 * (lp * (9 + 3 * k) + k) + 12 * lp


@pytest.mark.parametrize("window", [1, 8, 16])
@pytest.mark.parametrize("name", ["classic_bwd", "classic_bwd_half"])
def test_the_staged_streamed_scans_hold_at_least_the_lanes_of_the_unstaged_ones(
        name, window):
    # the ring costs shared memory that the lanes held in registers give
    # back: no label that took the streamed scheme before may leave it
    before = max(lp for lp in range(32, 16384, 32)
                 if _unstaged_streamed_bytes(lp, window) <= _build.SMEM_LIMIT)
    assert before == {1: 3872, 8: 1600, 16: 960}[window]
    assert _widest(name, window) >= before


# B7 and B12 before their redesign (ops/_build.py's formulas then): B7 kept
# every per-lane value in shared memory beside one staged window of
# transitions and residuals; B12 one staged act row a warp, head[V] and
# next[L].
def _unstaged_b7_bytes(lp, k):
    return 4 * (lp * (5 + 2 * k) + k) + 4 * 3 * lp


def _linked_b12_bytes(lp, v):
    return 4 * (v + lp + 1) + 4 * 8 * lp


def test_the_redesigned_b7_and_b12_hold_the_labels_measured_on_the_h100():
    # the widest labels by the new mirrors: B7 at windows 1, 8 and 16, B12
    # at V = 32, 128 and 1000
    assert {k: _widest("simplified_bwd", k) for k in (1, 8, 16)} == {
        1: 5792, 8: 2624, 16: 1504}
    assert {v: _widest("fused_epilogue", v) for v in (32, 128, 1000)} == {
        32: 6432, 128: 6432, 1000: 6336}


@pytest.mark.parametrize("window", [1, 8, 16])
def test_the_staged_b7_holds_at_least_the_lanes_of_the_unstaged_one(window):
    # no simplified label that took the streamed scheme may leave it
    before = max(lp for lp in range(32, 16384, 32)
                 if _unstaged_b7_bytes(lp, window) <= _build.SMEM_LIMIT)
    assert before == {1: 5792, 8: 2400, 16: 1440}[window]
    assert _widest("simplified_bwd", window) >= before


@pytest.mark.parametrize("vocab", [32, 128, 1000])
def test_the_csr_b12_holds_the_lanes_of_the_linked_one_and_of_the_streamed_scans(
        vocab):
    before = max(lp for lp in range(32, 16384, 32)
                 if _linked_b12_bytes(lp, vocab) <= _build.SMEM_LIMIT)
    widest = max(lp for lp in range(32, 16384, 32)
                 if _build.fits(("fused_epilogue",), lp, vocab, CPU))
    assert widest >= before
    # every label that a streamed backward holds at window 1 (B13 4832
    # lanes, B3 fewer, B7 5792) keeps the fused epilogue
    for name in ("classic_bwd", "classic_bwd_half", "simplified_bwd"):
        assert widest >= max(lp for lp in range(32, 16384, 32)
                             if _build.fits((name,), lp, 1, CPU))


@pytest.mark.parametrize("topology,width", [("classic", 4831), ("simplified", 5791)])
@pytest.mark.parametrize("vocab", [32, 128, 1000])
def test_the_widest_streamed_label_at_window_1_takes_the_fused_epilogue(
        topology, width, vocab):
    # 4832 lanes: the widest label of B13 at window 1 (the half-stream
    # scheme; B3 holds fewer); 5792: of B7
    rng = np.random.RandomState(vocab)
    labels = rng.randint(1, vocab, size=(1, width)).astype(np.int32)
    logits = rng.normal(size=(1, 4, vocab)).astype(np.float32)
    ctx = _ctx(labels, logits, [2], [4])
    loss_and_pack = {"classic": cl.classic_loss_and_pack,
                     "simplified": cs.simplified_loss_and_pack}[topology]
    with config_override(window=1, half_stream=True, fused_epilogue=True):
        assert cl.geometry(ctx)[1] == width + 1
        _, pack = loss_and_pack(ctx)
        assert isinstance(pack, cl.HalfPack if topology == "classic" else cl.StreamPack)
        assert cl.fused_epilogue_ok(ctx, pack)


def test_the_staged_scans_need_aligned_rows():
    x = torch.zeros(65)
    cl.check_aligned((("x", x[:64]),), "classic_bwd")
    with pytest.raises(ValueError, match="16-byte boundary"):
        cl.check_aligned((("x", x[1:]),), "classic_bwd")


def _ctx(labels, logits, lab_len, logit_len):
    lp = torch.log_softmax(torch.tensor(logits), 2)
    return core.make_context(torch.tensor(labels), lp, torch.tensor(lab_len),
                             torch.tensor(logit_len), 0)


def _case(seed=0, batch=3, max_t=14, vocab=5, width=6):
    rng = np.random.RandomState(seed)
    labels = rng.randint(1, vocab, size=(batch, width)).astype(np.int32)
    logits = rng.normal(size=(batch, max_t, vocab)).astype(np.float32)
    lengths = np.array([6, 4, 3], np.int32), np.array([14, 12, 9], np.int32)
    return (labels, logits, *lengths)


# At 32 lanes and window 4 the streamed backwards need 2640 (classic; 2520
# half-stream) and 1872 (simplified) bytes, the residual-free scans 2008 and
# 1624 with their forwards under them: these limits leave only the
# residual-free scheme.
@pytest.mark.parametrize("topology,limit", [("classic", 2500), ("simplified", 1800)])
@pytest.mark.parametrize("half", [False, True])
def test_a_label_the_streamed_kernels_do_not_hold_takes_the_residual_free_scheme(
        topology, limit, half, monkeypatch):
    ctx = _ctx(*_case())
    loss_and_pack, grad = {
        "classic": (cl.classic_loss_and_pack, cl.classic_gradient_with_loss),
        "simplified": (cs.simplified_loss_and_pack,
                       cs.simplified_gradient_with_loss),
    }[topology]
    with config_override(window=4, half_stream=half):
        loss, pack = loss_and_pack(ctx)
        assert cl.streamed(pack)
        ref = (loss, *grad(ctx, loss, pack))
        monkeypatch.setattr(_build, "SMEM_LIMIT", limit)
        loss, pack = loss_and_pack(ctx)
        assert isinstance(pack, cl.ChunkPack) and pack.bounds is not None
        out = (loss, *grad(ctx, loss, pack))
    assert all(torch.equal(a, b) for a, b in zip(out, ref))


def test_the_fused_epilogue_needs_its_kernel_to_hold_the_lanes(monkeypatch):
    ctx = _ctx(*_case(seed=1))
    with config_override(fused_epilogue=True):
        _, pack = cl.classic_loss_and_pack(ctx)
        assert cl.fused_epilogue_ok(ctx, pack)
        need = _build.SMEM_BYTES["fused_epilogue"](32, 5)
        monkeypatch.setattr(_build, "SMEM_LIMIT", need - 1)
        assert not cl.fused_epilogue_ok(ctx, pack)


@pytest.mark.parametrize("topology", ["classic", "simplified"])
def test_a_label_the_log_kernels_do_not_hold_is_repaired_through_the_pure_path(
        topology, monkeypatch):
    labels, logits, lab_len, logit_len = _case(seed=2)
    # row 1 flushes: at frame 3 token 4, absent from its label, at +100
    labels[1] = [1, 2, 1, 3, 2, 1]
    logits[1, 3] = -100.0
    logits[1, 3, 4] = 100.0
    fn = {"classic": api.classic_ctc_loss,
          "simplified": api.simplified_ctc_loss}[topology]

    def step(**cfg):
        x = torch.tensor(logits, requires_grad=True)
        with config_override(**cfg):
            loss = fn(torch.tensor(labels), x, torch.tensor(lab_len),
                      torch.tensor(logit_len), 0)
            fin = torch.where(torch.isfinite(loss), loss, torch.zeros_like(loss))
            fin.sum().backward()
        return loss.detach(), x.grad

    ctx = _ctx(labels, logits, lab_len, logit_len)
    assert ll.fits_log_fallback(ctx, topology)
    calls = []
    for name in ("classic_log_fwd", "simplified_log_fwd"):
        real = getattr(ll, name)
        monkeypatch.setattr(ll, name,
                            lambda *a, _real=real: calls.append(a) or _real(*a))
    logspace = step(use_kernels=True)
    assert calls
    # under what B5 (4544 bytes at 32 lanes) and B9 (2496) need
    monkeypatch.setattr(_build, "SMEM_LIMIT", 2000)
    assert not ll.fits_log_fallback(ctx, topology)
    calls.clear()
    pure_repair = step(use_kernels=True)
    pure = step(use_kernels=False)
    assert not calls
    assert torch.isfinite(pure_repair[0][1])
    for ours in (pure_repair, logspace):
        np.testing.assert_allclose(ours[0][1].numpy(), pure[0][1].numpy(), atol=2e-4)
        np.testing.assert_allclose(ours[1].numpy(), pure[1].numpy(), atol=2e-4)


_WIDE = {  # label widths past what the kernels of a call hold at window 8
    # past the residual-free pair (3040 and 3616 lanes), within the forward
    ("classic", "training"): 3100, ("simplified", "training"): 3700,
    # past the forward (4832 lanes)
    ("classic", "forward"): 4900, ("simplified", "forward"): 4900,
}
_KERNELS = {
    "classic": (cl, ("classic_fwd", "classic_bwd_streamed", "classic_bwd",
                     "classic_bwd_half")),
    "simplified": (cs, ("simplified_fwd", "simplified_bwd_streamed", "simplified_bwd")),
}


@pytest.mark.parametrize("past", ["training", "forward"])
@pytest.mark.parametrize("topology", ["classic", "simplified"])
def test_a_label_no_kernel_holds_takes_the_pure_path(topology, past, monkeypatch):
    width = _WIDE[topology, past]
    rng = np.random.RandomState(7)
    labels = rng.randint(1, 5, size=(2, width)).astype(np.int32)
    logits = rng.normal(size=(2, 10, 5)).astype(np.float32)
    lab_len, logit_len = np.array([4, 3], np.int32), np.array([10, 8], np.int32)
    fn = {"classic": api.classic_ctc_loss, "simplified": api.simplified_ctc_loss}[topology]
    module, names = _KERNELS[topology]
    calls = []
    for name in names:
        real = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _n=name, _r=real, **kw:
                            calls.append(_n) or _r(*a, **kw))

    def run(**cfg):
        x = torch.tensor(logits, requires_grad=True)
        lengths = (torch.tensor(lab_len), torch.tensor(logit_len), 0)
        with config_override(**cfg):
            evaluation = fn(torch.tensor(labels), torch.tensor(logits), *lengths)
            loss = fn(torch.tensor(labels), x, *lengths)
            loss.sum().backward()
        return evaluation, loss.detach(), x.grad

    ctx = _ctx(labels, logits, lab_len, logit_len)
    fwd_name = f"{topology}_fwd"
    assert _build.fits((fwd_name,), cl.geometry(ctx)[1], 8, CPU) == (past == "training")
    kernel = run(use_kernels=True)
    pure = run(use_kernels=False)
    # the training step took the pure path, and the evaluation call too
    # where the forward does not hold the label either
    assert calls == ([fwd_name] if past == "training" else [])
    np.testing.assert_allclose(kernel[0].numpy(), pure[0].numpy(), rtol=1e-5)
    assert torch.equal(kernel[1], pure[1]) and torch.equal(kernel[2], pure[2])


# B4 and B5 before their redesign (ops/_build.py's formulas then): every
# per-lane value in shared memory beside a chunk of 8 staged steps.
_UNSTAGED_LOG_BYTES = {
    "classic_log_fwd": lambda lp: 4 * (lp * (7 + 2 * 8) + 8),
    "classic_log_bwd": lambda lp: 4 * (lp * (5 + 4 * 8) + 8),
}


@pytest.mark.parametrize("lanes", [32, 256, 1568, 1600, 3200])
def test_the_log_mirrors_follow_the_staged_kernels_formulas(lanes):
    # a ring of 8 slots (B4: dc, pt; B5: dc, pt, x, a1), the double-buffered
    # exchange, two runs of 8 blanks, a full and an empty mbarrier a slot
    assert _build.SMEM_BYTES["classic_log_fwd"](lanes, 0) == 4 * (lanes * 18 + 16) + 128
    assert _build.SMEM_BYTES["classic_log_bwd"](lanes, 0) == 4 * (lanes * 34 + 16) + 128
    # the same design with one state: B8 stages dg, B9 dg and the residual
    assert _build.SMEM_BYTES["simplified_log_fwd"](lanes, 0) == 4 * (lanes * 10 + 16) + 128
    assert _build.SMEM_BYTES["simplified_log_bwd"](lanes, 0) == 4 * (lanes * 18 + 16) + 128


def test_the_log_route_keeps_the_labels_the_unstaged_pair_held():
    # the redesigned pair holds more lanes, but the route stays where it was:
    # the widest label of the unstaged pair, bound by B5
    before = {name: max(lp for lp in range(32, 8192, 32) if f(lp) <= _build.SMEM_LIMIT)
              for name, f in _UNSTAGED_LOG_BYTES.items()}
    assert before == {"classic_log_fwd": 2496, "classic_log_bwd": 1568}
    assert ll.CLASSIC_LOG_LANES == min(before.values())
    assert {name: _widest(name, 0) for name in _UNSTAGED_LOG_BYTES} == {
        "classic_log_fwd": 3200, "classic_log_bwd": 1696}
    for lanes, held in ((ll.CLASSIC_LOG_LANES, True), (ll.CLASSIC_LOG_LANES + 32, False)):
        ctx = _ctx(np.ones((1, lanes - 1), np.int32), np.zeros((1, 4, 3), np.float32),
                   [2], [4])
        assert cl.geometry(ctx)[1] == lanes
        assert ll.fits_log_fallback(ctx) == held
        # the simplified pair keeps its own route
        assert ll.fits_log_fallback(ctx, "simplified")


def _float64_step(labels, logits, lab_len, logit_len):
    """Loss and d_logits of the classic pure path in float64 on the port's
    own float32 log-probabilities."""
    ctx = core.float64_context(_ctx(labels, logits, lab_len, logit_len))
    classic = topology.TOPOLOGIES["classic"]
    loss = classic.loss(ctx, classic.alpha(ctx))
    grad = -torch.exp(core.gradient_log(classic, ctx, loss))
    return loss, topology.compose_dlogits(ctx, grad, loss, torch.ones_like(loss))


@pytest.mark.parametrize("lanes,route", [(ll.CLASSIC_LOG_LANES, "log-space kernels"),
                                         (ll.CLASSIC_LOG_LANES + 32, "float64 pure path")])
def test_a_flushed_row_is_repaired_through_b4_and_b5_up_to_their_widest_label(
        lanes, route, monkeypatch):
    rng = np.random.RandomState(lanes)
    labels = rng.randint(1, 5, size=(2, lanes - 1)).astype(np.int32)
    logits = rng.normal(size=(2, 12, 5)).astype(np.float32)
    lab_len, logit_len = np.array([4, 6], np.int32), np.array([12, 10], np.int32)
    # row 1 flushes: at frame 3 token 4, absent from its label, at +100
    labels[1, :6] = [1, 2, 1, 3, 2, 1]
    logits[1, 3] = -100.0
    logits[1, 3, 4] = 100.0
    calls = []
    for name in ("classic_log_fwd", "classic_log_bwd"):
        real = getattr(ll, name)
        monkeypatch.setattr(ll, name, lambda *a, _n=name, _r=real: calls.append(
            (_n, a[1].shape[2])) or _r(*a))

    def step(**cfg):
        x = torch.tensor(logits, requires_grad=True)
        with config_override(**cfg):
            loss = api.classic_ctc_loss(torch.tensor(labels), x, torch.tensor(lab_len),
                                        torch.tensor(logit_len), 0)
            loss.sum().backward()
        return loss.detach(), x.grad

    loss, d_logits = step(use_kernels=True)
    with config_override(use_kernels=True, guard=False):
        assert torch.isposinf(cl.classic_loss_fast(_ctx(labels, logits, lab_len,
                                                        logit_len))[1])
    if route == "log-space kernels":
        # the loss repair (mode final), then the gradient's (resid, B5)
        assert sorted(calls) == [("classic_log_bwd", lanes), ("classic_log_fwd", lanes),
                                 ("classic_log_fwd", lanes)]
    else:
        assert not calls
    loss64, d64 = _float64_step(labels, logits, lab_len, logit_len)
    # PERF.md section 2: rows the log-space kernels repair within 2e-4, rows
    # the float64 pure path repairs held to float64 as the kernel rows are
    rtol, atol = (0.0, 2e-4) if route == "log-space kernels" else (1e-5, 1e-5)
    np.testing.assert_allclose(loss[1].item(), loss64[1].item(), rtol=rtol, atol=atol)
    np.testing.assert_allclose(d_logits[1].numpy(), d64[1].numpy(), atol=atol)
    # the clean row keeps its fast values
    unguarded = step(use_kernels=True, guard=False)
    assert torch.equal(loss[0], unguarded[0][0])
    assert torch.equal(d_logits[0], unguarded[1][0])


# B8 and B9 before their redesign (ops/_build.py's formulas then): every
# per-lane value in shared memory beside a chunk of 8 staged steps.
_UNSTAGED_SLOG_BYTES = {
    "simplified_log_fwd": lambda lp: 4 * (lp * (3 + 8) + 8),
    "simplified_log_bwd": lambda lp: 4 * (lp * (2 + 2 * 8) + 8),
}


@pytest.mark.parametrize("name", sorted(_UNSTAGED_SLOG_BYTES))
def test_the_redesigned_b8_and_b9_hold_at_least_the_lanes_of_the_unstaged_pair(name):
    before = max(lp for lp in range(32, 8192, 32)
                 if _UNSTAGED_SLOG_BYTES[name](lp) <= _build.SMEM_LIMIT)
    assert before == {"simplified_log_fwd": 5280, "simplified_log_bwd": 3200}[name]
    assert _widest(name, 0) >= before
    # the pair, bound by B9, holds the route's widest label
    assert _build.fits(tuple(_UNSTAGED_SLOG_BYTES), ll.SIMPLIFIED_LOG_LANES, 0, CPU)
    assert ll.SIMPLIFIED_LOG_LANES == min(
        max(lp for lp in range(32, 8192, 32) if f(lp) <= _build.SMEM_LIMIT)
        for f in _UNSTAGED_SLOG_BYTES.values())


@pytest.mark.parametrize("lanes,held", [(3200, True), (3232, False)])
def test_a_one_chunk_simplified_label_takes_the_log_kernels_up_to_3200_lanes(lanes, held):
    ctx = _ctx(np.ones((1, lanes - 1), np.int32), np.zeros((1, 4, 3), np.float32), [2], [4])
    assert cl.geometry(ctx)[1] == lanes and cl.chunk_plan(ctx)[0] == 1
    assert ll.fits_log_fallback(ctx, "simplified") == held
    # the classic pair stops at its own, narrower route
    assert not ll.fits_log_fallback(ctx)


def test_the_log_wrappers_refuse_labels_wider_than_their_route():
    ll._check_lanes(ll.SIMPLIFIED_LOG_LANES, "simplified", "simplified_log_fwd")
    ll._check_lanes(ll.CLASSIC_LOG_LANES, "classic", "classic_log_fwd")
    with pytest.raises(ValueError, match="at most 3200 lanes .SIMPLIFIED_LOG_LANES."):
        ll._check_lanes(ll.SIMPLIFIED_LOG_LANES + 32, "simplified", "simplified_log_bwd")
    with pytest.raises(ValueError, match="at most 1568 lanes .CLASSIC_LOG_LANES."):
        ll._check_lanes(ll.CLASSIC_LOG_LANES + 32, "classic", "classic_log_bwd")
