"""The guard's device form (``topology._guarded_device``), which a CUDA graph
captures, against its host form; the path's scalar tensors; the graphed
sharded losses' purity, through a CPU stand-in for
``make_graphed_callables``.

The device form is the JAX package's "while" struct as a program with no
host decision: ``ceil(B / rb)`` rounds of a static slice of the
flushed-first order, each gathered at the batch's full T and written back
where its rows flushed.  Here it runs outside a capture, with
``topology._on_device`` patched to say yes: every round runs and its
writes are masked by the round's predicate, which is what a replay
computes with the rounds as IF nodes.  B=8, T=12, V=5, ``repair_bucket=1``, ``repair_bucket2=2``:
four rounds of two rows.  The first ``n`` rows flush (wrong-certain
logits, as ``tests/test_torch_port_guard_struct.py``'s ``flushed_batch``
makes them), and the rows' logit lengths differ (8 to 12), so a host
round's own time axis is shorter than the device form's full T.

Every case but the chunked geometry is held to the host form bit for bit
(the kernels' plain versions, like the kernels, treat rows alone, and the
steps past a row's length are exact no-ops), and to the JAX package's
while struct in interpret mode at rtol 1e-5 (loss) and atol 1e-4
(d_logits), the JAX suite's tolerances.  On the chunked geometry
(``window=4``, ``chunk_time=8``: T=12 is two chunks) a device round at
full T goes through the float64 pure path where the host form repairs a
row of at most 8 steps with the log-space kernels on its own axis: the
device form is held to float64 (loss rtol 1e-6, d_logits atol 1e-5) and
to the host form within the log-space repair's 2e-4; with
``capture.capturing`` patched it is the device form that a capture
takes there, under either struct.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tf_seq2seq_losses_tpu as jctc
from tf_seq2seq_losses_tpu.utils.config import config_override as jax_config
from tf_seq2seq_losses_tpu_torch import api
from tf_seq2seq_losses_tpu_torch.ops import capture, core, topology
from tf_seq2seq_losses_tpu_torch.ops.topology import TOPOLOGIES, compose_dlogits
from tf_seq2seq_losses_tpu_torch.parallel import (
    make_mesh,
    sharded_ctc_loss,
    sharded_mean_ctc_loss,
)
from tf_seq2seq_losses_tpu_torch.utils.config import config_override
from tf_seq2seq_losses_tpu_torch.utils.numerics import logit_to_logproba

BATCH, MAX_T, VOCAB = 8, 12, 5
LENGTHS = (12, 9, 12, 10, 11, 12, 8, 12)
BUCKETS = dict(repair_bucket=1, repair_bucket2=2)
INTERP = dict(use_pallas=True, interpret=True, block_batch=2, block_time=4,
              sort_by_length=False)
CHUNKED = dict(window=4, chunk_time=8)
FNS = {"classic": (jctc.classic_ctc_loss, api.classic_ctc_loss),
       "simplified": (jctc.simplified_ctc_loss, api.simplified_ctc_loss)}
# the fallback cap that admits rounds of repair_bucket rows through the
# log-space kernels and not of repair_bucket2 (est_fallback_bytes: a
# lane-padded row is 53248 bytes at T=12), then the one that admits
# pure-path rows only (1248 bytes a row)
CAPS = {"bucket": 60000, "pure": 2000}


def flushed_batch(n_flushed, seed=7):
    """The first ``n_flushed`` rows are wrong-certain (the fast path
    flushes, the row is feasible); logit lengths ``LENGTHS``."""
    rand = np.random.RandomState(seed)
    logits = rand.randn(BATCH, MAX_T, VOCAB).astype(np.float32)
    logits[:n_flushed] = 0.0
    logits[:n_flushed, :, VOCAB - 1] = 100.0
    labels = np.tile(np.array([[1, 2]], np.int32), (BATCH, 1))
    return (labels, logits, np.full((BATCH,), 2, np.int32),
            np.array(LENGTHS, np.int32))


def port_step(args, topology_name="classic", device=False, **cfg):
    """The port's loss and the gradient of its finite sum, on the kernels'
    plain versions; the guard's device form with ``device``."""
    fn = FNS[topology_name][1]
    labels, logits, ll, gl = args
    x = torch.tensor(logits, requires_grad=True)
    with config_override(use_kernels=True, **cfg), pytest.MonkeyPatch.context() as mp:
        if device:
            mp.setattr(topology, "_on_device", lambda: True)
        loss = fn(torch.tensor(labels), x, torch.tensor(ll), torch.tensor(gl), 0)
        torch.where(torch.isfinite(loss), loss, torch.zeros_like(loss)).sum().backward()
    return loss.detach(), x.grad


@functools.lru_cache(maxsize=None)
def jax_step(topology_name, n_flushed, route, struct="while", **cfg):
    """The JAX package's ``struct`` ("while" by default): loss and the
    gradient of its finite sum.  ``route`` is the repair's, "exact" (the
    log-space kernels) or "pure" (the pure path, under the pure cap
    ``CAPS["pure"]``), or the name of a cap of ``CAPS`` to run under: under
    "while" the buckets, tier 1 and the cap only move the flushed rows
    between rounds and routes, and a row's repair does not depend on its
    round, so one JAX run per route serves every config that takes it."""
    fn = FNS[topology_name][0]
    labels, logits, ll, gl = flushed_batch(n_flushed)

    def scalar(x):
        out = fn(labels, x, ll, gl, 0)
        return jnp.sum(jnp.where(jnp.isfinite(out), out, 0.0))

    with pytest.MonkeyPatch.context() as mp, \
            jax_config(**{**INTERP, **BUCKETS, "guard_struct": struct, **cfg}):
        if route in CAPS:
            mp.setenv("CTC_TPU_GUARD_FALLBACK_BYTES", str(CAPS[route]))
        loss = np.asarray(fn(labels, jnp.asarray(logits), ll, gl, 0))
        grad = np.asarray(jax.grad(scalar)(jnp.asarray(logits)))
    return loss, grad


def pure64(args, topology_name="classic"):
    """The port's pure path in float64 on the float32 logits: loss and the
    gradient of the finite sum with respect to the logits."""
    labels, logits, ll, gl = args
    topo = TOPOLOGIES[topology_name]
    lp64 = logit_to_logproba(torch.tensor(logits, dtype=torch.float64), 2)
    c = core.make_context(torch.tensor(labels), lp64, torch.tensor(ll), torch.tensor(gl), 0)
    lp64 = torch.where(c.logit_length_mask[:, :, None], lp64, c.logproba.double())
    c = c._replace(logproba=lp64, raw_logproba=lp64,
                   blank_lp=core.take_blank_logproba(lp64, c.blank_index))
    loss = topo.pure_loss(c)
    grad = core.gradient(topo, c, loss)
    return loss, compose_dlogits(c, grad, loss, torch.ones_like(loss))


def assert_same(got, want):
    for a, b in zip(got, want):
        assert torch.equal(a, b), f"max abs diff {float((a - b).abs().max())}"


def assert_near_jax(got, topology_name, n_flushed, route="exact", **cfg):
    loss, grad = jax_step(topology_name, n_flushed, route, **cfg)
    np.testing.assert_allclose(got[0].numpy(), loss, rtol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), grad, atol=1e-4)


@pytest.mark.parametrize("n_flushed", [0, 1, 3, 8])
@pytest.mark.parametrize("tier1", [False, True])
@pytest.mark.parametrize("mode", ["post", "pre", "grad"])
@pytest.mark.parametrize("topology_name", ["classic", "simplified"])
def test_device_form_is_the_host_form(topology_name, mode, tier1, n_flushed):
    args = flushed_batch(n_flushed)
    cfg = dict(BUCKETS, guard_mode=mode, guard_tier1=tier1)
    got = port_step(args, topology_name, device=True, **cfg)
    assert_same(got, port_step(args, topology_name, **cfg))
    # tier 1 takes the pure path for n <= repair_bucket
    route = "pure" if tier1 and n_flushed == 1 else "exact"
    assert_near_jax(got, topology_name, n_flushed, route)


@pytest.mark.parametrize("n_flushed", [1, 3, 8])
@pytest.mark.parametrize("cap", sorted(CAPS))
@pytest.mark.parametrize("topology_name", ["classic", "simplified"])
def test_device_form_under_the_fallback_cap(topology_name, cap, n_flushed, monkeypatch):
    """The cap shrinks the rounds to ``repair_bucket`` rows of the log-space
    kernels, then to pure-path rounds: eight rounds of one row."""
    monkeypatch.setenv("CTC_TPU_GUARD_FALLBACK_BYTES", str(CAPS[cap]))
    args = flushed_batch(n_flushed)
    got = port_step(args, topology_name, device=True, **BUCKETS)
    assert_same(got, port_step(args, topology_name, **BUCKETS))
    assert_near_jax(got, topology_name, n_flushed, "exact" if cap == "bucket" else "pure")


@pytest.mark.parametrize("n_flushed", [3, 8])
@pytest.mark.parametrize("topology_name", ["classic", "simplified"])
def test_device_form_on_a_chunked_time_axis(topology_name, n_flushed):
    args = flushed_batch(n_flushed)
    got = port_step(args, topology_name, device=True, **BUCKETS, **CHUNKED)
    host = port_step(args, topology_name, **BUCKETS, **CHUNKED)
    loss64, grad64 = pure64(args, topology_name)
    np.testing.assert_allclose(got[0].numpy(), loss64.numpy(), rtol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), grad64.numpy(), atol=1e-5)
    np.testing.assert_allclose(got[0].numpy(), host[0].numpy(), rtol=2e-4)
    np.testing.assert_allclose(got[1].numpy(), host[1].numpy(), atol=2e-4)
    assert_near_jax(got, topology_name, n_flushed, **CHUNKED)


def _no_host_read(*_args, **_kwargs):
    raise AssertionError("the device form read a device value on the host")


@pytest.mark.parametrize("gate", [None, True, False])
@pytest.mark.parametrize("tier1", [False, True])
def test_device_form_reads_no_device_value(tier1, gate, monkeypatch):
    """The device form with stub repairs that compute from their inputs,
    while ``torch.nonzero``, ``Tensor.item``, ``tolist``, ``__bool__`` and
    ``__int__`` raise: the CPU's proof that a graph can capture it.  Its
    value: each flushed row (gated) replaced by the stub's, the pure stub's
    under tier 1 (n = 1 <= repair_bucket), the others kept."""
    labels, logits, ll, gl = (torch.tensor(a) for a in flushed_batch(3))
    lengths = torch.tensor(LENGTHS)
    ll[0] = 13  # row 0 infeasible: +inf but not flushed
    ctx = core.make_context(labels, logit_to_logproba(logits, 2), ll, lengths, 0)
    fast = torch.arange(BATCH, dtype=torch.float32)
    fast[[0, 1, 4, 6]] = float("inf")
    feasible = ctx.logit_length >= ctx.label_length
    aux = torch.linspace(1.0, 2.0, BATCH)
    exact = lambda c, a: c.logproba.sum(dim=(1, 2)) * a  # noqa: E731
    pure = lambda c, a: c.logproba.mean(dim=(1, 2)) * a  # noqa: E731
    gate_t = None if gate is None else torch.tensor(gate)
    for name in ("item", "tolist", "__bool__", "__int__"):
        monkeypatch.setattr(torch.Tensor, name, _no_host_read)
    monkeypatch.setattr(torch, "nonzero", _no_host_read)
    with config_override(repair_bucket=1, repair_bucket2=2, guard_tier1=tier1):
        got, n = topology._guarded_device(fast, exact, pure, fast, feasible, ctx,
                                          aux=aux, gate=gate_t)
        one, n_one = topology._guarded_device(fast, exact, pure, fast,
                                              feasible & (torch.arange(BATCH) == 4),
                                              ctx, aux=aux, gate=gate_t)
    monkeypatch.undo()
    want = fast.clone()
    want_one = fast.clone()
    if gate is not False:
        rows = [1, 4, 6]
        want[rows] = exact(ctx, aux)[rows]
        want_one[4] = (pure if tier1 else exact)(ctx, aux)[4]
    assert int(n) == (0 if gate is False else 3) and int(n_one) == (0 if gate is False else 1)
    assert torch.equal(got, want)
    assert torch.equal(one, want_one)


@pytest.mark.parametrize("n_flushed", [3, 8])
@pytest.mark.parametrize("topology_name", ["classic", "simplified"])
@pytest.mark.parametrize("struct", ["while", "cond"])
def test_a_chunked_time_axis_under_capture(struct, topology_name, n_flushed,
                                           monkeypatch):
    """Under capture (``capture.capturing`` patched; a CPU predicate's IF
    node runs its block) a time axis longer than one chunk takes the
    device form under either struct, its rounds through the float64 pure
    path: the uncaptured device form's values bit for bit, and float64's
    within 1e-5."""
    args = flushed_batch(n_flushed)
    cfg = dict(BUCKETS, guard_struct=struct, **CHUNKED)
    want = port_step(args, topology_name, device=True, **cfg)
    monkeypatch.setattr(capture, "capturing", lambda: True)
    got = port_step(args, topology_name, **cfg)
    monkeypatch.undo()
    assert_same(got, want)
    loss64, grad64 = pure64(args, topology_name)
    np.testing.assert_allclose(got[0].numpy(), loss64.numpy(), rtol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), grad64.numpy(), atol=1e-5)


class _HostData:
    """Records the calls of ``torch.tensor`` and ``torch.as_tensor`` on data
    that is not a tensor (on a card: a copy from the host) while entered."""

    def __init__(self, monkeypatch):
        self.monkeypatch = monkeypatch

    def __enter__(self):
        self.calls = []
        for name in ("tensor", "as_tensor"):
            real = getattr(torch, name)

            def spy(data, *args, _real=real, _name=name, **kwargs):
                if not isinstance(data, torch.Tensor):
                    self.calls.append((_name, data))
                return _real(data, *args, **kwargs)

            self.monkeypatch.setattr(torch, name, spy)
        return self.calls

    def __exit__(self, *exc):
        self.monkeypatch.undo()
        return False


def test_the_path_scalars_are_device_fills(monkeypatch):
    """The blank index of an int ``blank_index`` and the count of
    ``sharded_mean_ctc_loss`` are fills on the device, with no host data
    made into a tensor, and their values are the parent's: ``torch.as_tensor``
    of the int, ``torch.tensor`` of the row count."""
    labels, logits, ll, gl = (torch.tensor(a) for a in flushed_batch(3))
    mean_fn = sharded_mean_ctc_loss(make_mesh(device="cpu"))
    with _HostData(monkeypatch) as calls:
        ctx = core.make_context(labels, logit_to_logproba(logits, 2), ll, gl, 3)
        mean = mean_fn(labels, logits, ll, gl)
    assert calls == []
    assert ctx.blank_index.dtype == torch.int64 and ctx.blank_index.shape == ()
    assert torch.equal(ctx.blank_index, torch.as_tensor(np.asarray(3)).to(torch.int64))
    loss = api.classic_ctc_loss(labels, logits, ll, gl, 0)
    assert torch.equal(mean, loss.sum() / torch.tensor(float(BATCH)))


def fake_graphed_callables(fn, sample):
    """``torch.cuda.make_graphed_callables``'s aliasing on the CPU: a
    forward copies its inputs into static tensors, keeps its saved state
    in the capture (the next forward replaces it) and returns its loss as
    a detached static tensor; a backward writes the gradient into a static
    tensor and returns it detached.  Counts its captures."""
    fake_graphed_callables.captures += 1
    static_in = [a.detach().clone().requires_grad_(a.requires_grad) for a in sample]
    state = {}

    class Graphed(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *inputs):
            with torch.no_grad():
                for s, x in zip(static_in, inputs):
                    s.copy_(x)
            with torch.enable_grad():
                state["out"] = fn(*static_in)
            if "static_out" not in state:
                state["static_out"] = torch.empty_like(state["out"])
            state["static_out"].copy_(state["out"].detach())
            return state["static_out"].detach()

        @staticmethod
        def backward(ctx, grad):
            d_logits, = torch.autograd.grad(state["out"], static_in[1], grad)
            if "static_grad" not in state:
                state["static_grad"] = torch.empty_like(d_logits)
            state["static_grad"].copy_(d_logits)
            return None, state["static_grad"].detach(), None, None

    return Graphed.apply


@pytest.fixture
def graphed_on_cpu(monkeypatch):
    """The sharded losses' graphed path on CPU tensors, through
    :func:`fake_graphed_callables`."""
    from tf_seq2seq_losses_tpu_torch.parallel import sharding

    fake_graphed_callables.captures = 0
    monkeypatch.setattr(sharding, "_eager", lambda logits: False)
    monkeypatch.setattr(torch.cuda, "make_graphed_callables", fake_graphed_callables)
    return fake_graphed_callables


def graphed_loss_inputs(seed):
    labels, logits, ll, gl = flushed_batch(0, seed=seed)
    return torch.tensor(labels), torch.tensor(logits), torch.tensor(ll), torch.tensor(gl)


def eager_loss_and_grad(fn, inputs, weight=1.0):
    x = inputs[1].clone().requires_grad_(True)
    loss = fn.eager(inputs[0], x, *inputs[2:])
    (weight * loss).sum().backward()
    return loss.detach(), x.grad


@pytest.mark.parametrize("name", ["rows", "mean"])
def test_a_graphed_loss_is_pure(name, graphed_on_cpu):
    """What a graphed sharded loss returns is its own: a kept loss and a
    gradient stay what they were when later calls replay the capture; two
    forwards before one backward (gradient accumulation) each get their
    own gradient, in a second slot; a slot is reused once its backward has
    run or its autograd graph is gone; a ``no_grad`` call is the eager
    loss.  Each bit for bit the eager function's."""
    mesh = make_mesh(device="cpu")
    fn = (sharded_ctc_loss if name == "rows" else sharded_mean_ctc_loss)(mesh)
    a, b = graphed_loss_inputs(1), graphed_loss_inputs(2)
    want_a, want_b = eager_loss_and_grad(fn, a), eager_loss_and_grad(fn, b)
    # a forward and its backward, then another: the first loss and gradient stay
    xa, xb = a[1].clone().requires_grad_(True), b[1].clone().requires_grad_(True)
    loss_a = fn(a[0], xa, *a[2:])
    loss_a.sum().backward()
    loss_b = fn(b[0], xb, *b[2:])
    loss_b.sum().backward()
    assert graphed_on_cpu.captures == 1
    assert_same((loss_a.detach(), xa.grad), want_a)
    assert_same((loss_b.detach(), xb.grad), want_b)
    # two forwards, one backward of their sum: a second slot
    xa, xb = a[1].clone().requires_grad_(True), b[1].clone().requires_grad_(True)
    total = fn(a[0], xa, *a[2:]).sum() + fn(b[0], xb, *b[2:]).sum()
    total.backward()
    assert graphed_on_cpu.captures == 2
    assert torch.equal(xa.grad, want_a[1]) and torch.equal(xb.grad, want_b[1])
    # a forward whose graph is dropped before its backward frees its slot
    del total
    fn(a[0], a[1].clone().requires_grad_(True), *a[2:])
    xb = b[1].clone().requires_grad_(True)
    fn(b[0], xb, *b[2:]).sum().backward()
    assert graphed_on_cpu.captures == 2 and torch.equal(xb.grad, want_b[1])
    # forward only: a capture of its own
    with torch.no_grad():
        assert torch.equal(fn(*a), want_a[0])
        assert torch.equal(fn(a[0], xa, *a[2:]), want_a[0])
    assert graphed_on_cpu.captures == 3


def test_a_graphed_backward_after_a_later_forward_raises(graphed_on_cpu):
    """A backward retained through a graphed loss whose capture has since
    replayed another forward would read that forward's saved tensors: it
    raises."""
    fn = sharded_mean_ctc_loss(make_mesh(device="cpu"))
    a, b = graphed_loss_inputs(1), graphed_loss_inputs(2)
    xa = a[1].clone().requires_grad_(True)
    loss_a = fn(a[0], xa, *a[2:])
    loss_a.backward(retain_graph=True)
    fn(b[0], b[1].clone().requires_grad_(True), *b[2:])
    with pytest.raises(RuntimeError, match="later forward"):
        loss_a.backward()
