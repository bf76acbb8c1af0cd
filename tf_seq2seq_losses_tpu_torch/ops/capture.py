"""CUDA-graph capture of the port's paths: the conditional (IF) node in
which the guard's device form (``ops/topology.py``) captures its repair
rounds.

The port's counterpart of a ``jax.jit`` program is a CUDA graph, captured
once per shape and replayed.  What the JAX package expresses as a
``lax.while_loop`` whose trip count is a device value, the graph expresses
as one IF node per round: the node's body runs at a replay only where a
device predicate holds, set by a one-thread kernel (``csrc/graph_cond.cu``)
that the graph runs before the node.  PyTorch 2.11 offers no such node, so
the port builds it with the CUDA runtime.

:func:`if_node` is the block form: work launched inside it is the node's
body.  Outside a capture it runs the block unconditionally, and the caller
masks what the block writes by the same predicate, so that both give the
same values.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from tf_seq2seq_losses_tpu_torch.ops import _build

_lock = threading.Lock()
_bodies: dict = {}  # device index -> (body stream, memory pool)


def capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def prepare(device: torch.device):
    """``(stream, pool)`` into which the bodies of ``device``'s IF nodes are
    captured, made at the first call, which also loads the library's
    kernel on the device."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    with _lock:
        if index not in _bodies:
            lib = _build.lib("graph_cond")
            with torch.cuda.device(index):
                _build.check(lib.ctc_cond_load(), "ctc_cond_load")
                _bodies[index] = (torch.cuda.Stream(index), torch.cuda.MemPool())
        return _bodies[index]


class Body:
    """What :func:`if_node` yields: ``nodes``, the body graph's node count,
    set when the block ends (0 outside a capture)."""

    nodes = 0


@contextlib.contextmanager
def if_node(pred: torch.Tensor):
    """Capture the block's work as the body of an IF node on ``pred`` (a
    bool tensor of one element on the capturing device): a replay runs it
    only where ``pred`` holds at that point of the graph.

    Inside the block the current stream is the body stream and this
    thread's allocations come from the bodies' memory pool, which outlives
    the graph; the block must leave its results in tensors made before it.
    Outside a capture, and for a predicate on the CPU (which no graph
    holds), the block simply runs.  Yields a :class:`Body`."""
    body = Body()
    if not capturing() or pred.device.type != "cuda":
        yield body
        return
    device = pred.device
    stream, pool = prepare(device)
    lib = _build.lib("graph_cond")
    flag = pred.reshape(1).to(torch.bool)
    main = torch.cuda.current_stream(device)
    _build.check(lib.ctc_cond_begin(main.cuda_stream, stream.cuda_stream,
                                    flag.data_ptr()), "ctc_cond_begin")
    try:
        with torch.cuda.stream(stream), torch.cuda.use_mem_pool(pool, device):
            yield body
    finally:
        nodes = ctypes.c_size_t()
        _build.check(lib.ctc_cond_end(stream.cuda_stream, ctypes.byref(nodes)),
                     "ctc_cond_end")
        body.nodes = nodes.value
