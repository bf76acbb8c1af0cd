"""The Hessian-vector product through its tangent scans (``ops/hvp.py``)
under the transforms, on the CPU.

Under ``torch.compile(fullgraph=True, backend="aot_eager")`` the call is
one graph naming the topology's two tangent scan ops, and the graph that
AOTAutograd runs holds no ``_make_dual`` (Dynamo's own graph traces
``torch.func.jvp`` of the glue), bit for bit the eager call; under
``torch.func.vmap`` (labels mapped or shared) and ``compile(vmap)`` it is
bit for bit the call on the folded batch; and with ``capture.capturing``
patched (as a CUDA graph's capture would answer) it reads no device value
on the host and makes no tensor of host data (``_HostData``).  The route
and the JAX package are ``tests/test_torch_port_hvp_route.py``; the
kernels run on the card only (``chip_smoke.py`` phase 15).
"""

import re

import pytest
import torch
from functorch.compile import make_boxed_func
from torch._dynamo.backends.common import aot_autograd

from tests.test_torch_port_compile import (  # noqa: F401 (fresh_dynamo is autouse)
    assert_same,
    compiled,
    fresh_dynamo,
)
from tests.test_torch_port_hvp_route import GROUPS, hvp_fn, hvp_inputs
from tests.test_torch_port_jit import _HostData
from tf_seq2seq_losses_tpu_torch.ops import capture

@pytest.mark.parametrize("topology", ["classic", "simplified"])
def test_compiled_hvp_is_one_graph(topology):
    blank = 2
    args = tuple(torch.tensor(a) for a in hvp_inputs(blank))
    fn = hvp_fn(topology, blank)
    cf, graphs = compiled(fn)
    got = cf(*args)
    assert graphs.frame_count == 1
    scans = {f"torch.ops.ctc_port.{topology}_alpha_jvp64",
             f"torch.ops.ctc_port.{topology}_beta_jvp64"}
    assert set(re.findall(r"torch\.ops\.ctc_port\.\w+", graphs.code)) == scans
    assert_same((got,), (fn(*args),))
    # the graph that runs: AOTAutograd's, forward-mode AD traced away
    codes = []

    def forward_compiler(gm, _inputs):
        codes.append(gm.code)
        return make_boxed_func(gm.forward)

    torch._dynamo.reset()
    got = torch.compile(fn, fullgraph=True,
                        backend=aot_autograd(fw_compiler=forward_compiler))(*args)
    assert len(codes) == 1 and "_make_dual" not in codes[0]
    assert {f"{op}.default" for op in scans} <= set(re.findall(
        r"torch\.ops\.ctc_port\.\w+\.default", codes[0]))
    assert_same((got,), (fn(*args),))


def grouped(args, shared_labels=False):
    out = [a.unflatten(0, (GROUPS, -1)) for a in args]
    if shared_labels:  # one label array for every group
        out[0] = args[0][:args[0].shape[0] // GROUPS]
    return out


@pytest.mark.parametrize("shared_labels", [False, True])
@pytest.mark.parametrize("topology", ["classic", "simplified"])
def test_vmap_is_the_folded_call(topology, shared_labels):
    args = [torch.tensor(a) for a in hvp_inputs(0, "t24")]
    if shared_labels:
        half = args[0].shape[0] // GROUPS
        args[0] = args[0][:half].repeat(GROUPS, 1)
        args[2] = args[2][:half].repeat(GROUPS)
    fn = hvp_fn(topology, 0)
    in_dims = (None if shared_labels else 0, 0, 0, 0, 0)
    m_args = grouped(args, shared_labels)
    got = torch.func.vmap(fn, in_dims=in_dims)(*m_args)
    assert_same((got.flatten(0, 1),), (fn(*args),))


@pytest.mark.parametrize("topology", ["classic", "simplified"])
def test_compiled_vmap_is_the_folded_call(topology):
    args = [torch.tensor(a) for a in hvp_inputs(2)]
    fn = hvp_fn(topology, 2)
    cf, graphs = compiled(torch.func.vmap(fn))
    got = cf(*grouped(args))
    assert graphs.frame_count == 1
    assert_same((got.flatten(0, 1),), (fn(*args),))


def _no_host_read(*_args, **_kwargs):
    raise AssertionError("the HVP read a device value on the host")


@pytest.mark.parametrize("topology", ["classic", "simplified"])
def test_capture_reads_no_host_data(topology, monkeypatch):
    """As a CUDA graph's capture runs it: no tensor made of host data, no
    device value read on the host; the value unchanged."""
    args = tuple(torch.tensor(a) for a in hvp_inputs(2))
    want = hvp_fn(topology, 2)(*args)
    monkeypatch.setattr(capture, "capturing", lambda: True)
    for name in ("item", "tolist", "__bool__", "__int__"):
        monkeypatch.setattr(torch.Tensor, name, _no_host_read)
    monkeypatch.setattr(torch, "nonzero", _no_host_read)
    with _HostData(monkeypatch) as calls:
        got = hvp_fn(topology, 2)(*args)
    assert calls == []
    assert_same((got,), (want,))
