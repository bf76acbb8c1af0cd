"""The public loss entry points under ``torch.compile(fullgraph=True)`` on the
CPU (``backend="aot_eager"``), on the kernel path: the kernels' plain
versions behind the ``ctc_port::`` custom ops (``config_override(
use_kernels=True)``), the guard on.

Each entry point is compiled once for a training step (the loss, then
``.backward()`` of its finite sum outside the compiled function, which
runs the compiled backward) and once for a forward-only call under
``torch.no_grad()``.  Each compiles to one graph with no break (a break is
an error under ``fullgraph=True``), and its loss and gradient are the
eager port's bit for bit: the custom ops run the same plain versions, and
the glue around them is the same PyTorch code.  B=4, T=10, V=5, numpy
inputs from a seed, row 3 infeasible (+inf loss, zero gradient).

``ctc_loss_gradient``, ``ctc_loss_hessian`` and the double backward are in
``tests/test_torch_port_compile_grad.py``; the pure path, and the
comparison with ``jax.jit`` of the JAX package, in
``tests/test_torch_port_compile_pure.py``; the guard's flushed rows in
``tests/test_torch_port_compile_guard*.py``; each custom op's fake against
its real outputs in ``tests/test_torch_port_compile_ops.py``.
"""

import numpy as np
import pytest
import torch

from tf_seq2seq_losses_tpu_torch import api
from tf_seq2seq_losses_tpu_torch.utils.config import config_override
from tf_seq2seq_losses_tpu_torch.utils.numerics import logit_to_logproba

BATCH, MAX_T, VOCAB = 4, 10, 5
# (entry point, topology): None takes the entry point's own
ENTRY_POINTS = [
    ("classic_ctc_loss", None),
    ("simplified_ctc_loss", None),
    ("ctc_loss", "classic"),
    ("ctc_loss_from_logproba", "classic"),
    ("ctc_loss_from_logproba", "simplified"),
]
# the scans of a training step and a forward-only call, and of their repairs
KERNEL_OPS = {
    "classic": ("classic_fwd", "classic_bwd_streamed", "classic_log_fwd",
                "classic_log_bwd"),
    "simplified": ("simplified_fwd", "simplified_bwd_streamed", "simplified_log_fwd",
                   "simplified_log_bwd"),
}
LOGPROBA_ENTRY_POINTS = ("ctc_loss_from_logproba", "ctc_loss_gradient",
                         "ctc_loss_hessian")


def inputs(seed=0, max_t=MAX_T):
    """``(labels, logits, label_length, logit_length)`` as numpy arrays of
    ``max_t`` frames; row 3's label does not fit its 3 frames."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(1, VOCAB, (BATCH, 4)).astype(np.int32)
    logits = rng.normal(size=(BATCH, max_t, VOCAB)).astype(np.float32)
    return (labels, logits, np.array([4, 3, 2, 4], np.int32),
            np.array([max_t, max_t - 2, max_t - 3, 3], np.int32))


def entry_fn(name, topology, blank_index=0):
    """``f(labels, x, label_length, logit_length) -> (value, scalar)``: the
    entry point's value and the finite sum whose ``.backward()`` a training
    step takes."""
    fn = getattr(api, name)
    extra = () if topology is None else (topology,)

    def f(labels, x, label_length, logit_length):
        value = fn(labels, x, label_length, logit_length, blank_index, *extra)
        return value, torch.where(torch.isfinite(value), value,
                                  torch.zeros_like(value)).sum()

    return f


def torch_inputs(name, args):
    """The numpy inputs as tensors; log-probabilities for the entry points
    that take them."""
    labels, logits, ll, gl = (torch.tensor(a) for a in args)
    if name in LOGPROBA_ENTRY_POINTS:
        logits = logit_to_logproba(logits, 2)
    return labels, logits, ll, gl


def step(f, args):
    """``(value, gradient)`` of a training step of ``f``."""
    labels, x, ll, gl = args
    x = x.clone().requires_grad_(True)
    value, scalar = f(labels, x, ll, gl)
    scalar.backward()
    return value.detach(), x.grad


def forward_only(f, args):
    with torch.no_grad():
        return f(*args)[0]


class Graphs:
    """A ``torch.compile`` backend: ``aot_eager``, recording each graph
    that Dynamo hands it (``frame_count``) and the code of its modules,
    ``torch.cond``'s branches included (``code``)."""

    def __init__(self):
        self.frame_count = 0
        self.code = ""

    def __call__(self, gm, example_inputs):
        self.frame_count += 1
        self.code += "".join(m.code for m in gm.modules()
                             if isinstance(m, torch.fx.GraphModule))
        return torch._dynamo.lookup_backend("aot_eager")(gm, example_inputs)


def compiled(fn):
    """``fn`` under ``torch.compile(fullgraph=True)`` on ``aot_eager``, and
    its :class:`Graphs`."""
    graphs = Graphs()
    return torch.compile(fn, fullgraph=True, backend=graphs), graphs


@pytest.fixture(autouse=True)
def fresh_dynamo():
    """Each test traces anew: Dynamo's caches are keyed on code objects,
    which the tests' functions share."""
    torch._dynamo.reset()
    yield
    torch._dynamo.reset()


def assert_same(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b), f"max abs diff {float((a - b).abs().nan_to_num().max())}"


@pytest.mark.parametrize("name,topology", ENTRY_POINTS)
def test_compiled_entry_point_is_the_eager_port(name, topology):
    args = torch_inputs(name, inputs())
    f = entry_fn(name, topology)
    with config_override(use_kernels=True):
        cf, counter = compiled(f)
        got_step = step(cf, args)
        assert counter.frame_count == 1
        got_fwd = forward_only(cf, args)
        assert counter.frame_count == 2  # grad mode is a guard: one graph each
        want_step, want_fwd = step(f, args), forward_only(f, args)
    assert_same(got_step, want_step)
    assert_same((got_fwd,), (want_fwd,))
    assert torch.isposinf(got_step[0][3]) and not got_step[1][3].any()
    # the scans are opaque ops of the graph, the "while" guard's rounds a
    # while_loop
    scans = KERNEL_OPS[topology or name.split("_")[0]]
    assert all(f"torch.ops.ctc_port.{op}" in counter.code for op in scans)
    assert "torch.ops.higher_order.while_loop" in counter.code


def test_compiled_loss_with_another_blank():
    """A blank index other than 0 (labels over 0..V-1 but 2), passed as a
    Python int: a constant of the graph."""
    labels, logits, ll, gl = inputs(1)
    labels = np.where(labels == 2, 0, labels)
    args = torch_inputs("ctc_loss", (labels, logits, ll, gl))
    f = entry_fn("ctc_loss", "simplified", blank_index=2)
    with config_override(use_kernels=True):
        cf, counter = compiled(f)
        assert_same(step(cf, args), step(f, args))
    assert counter.frame_count == 1


def test_compiled_loss_serves_new_values_without_recompiling():
    """New logits and lengths of the same shapes reuse the graph."""
    f = entry_fn("classic_ctc_loss", None)
    with config_override(use_kernels=True):
        cf, counter = compiled(f)
        for seed in range(3):
            args = torch_inputs("classic_ctc_loss", inputs(seed))
            assert_same(step(cf, args), step(f, args))
    assert counter.frame_count == 1
