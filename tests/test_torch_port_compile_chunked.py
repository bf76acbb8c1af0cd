"""The chunked geometry under ``torch.compile(fullgraph=True)`` on the CPU
(``backend="aot_eager"``, the kernels' plain versions behind the custom
ops): ``window=4, chunk_time=8``, so ``tests/test_torch_port_jit.py``'s
batch (T=12) is two chunks, with n = 3 and 8 rows flushed.

Under compile the guard's rounds gather at the batch's full T, so a
flushed row is repaired through the float64 pure path (the op
``ctc_port::pure_repair``, one node of the graph) where the eager host
form repairs a row of at most 8 steps with the log-space kernels on its
own axis.  The compiled step is the eager device form's
(``topology._on_device`` patched) bit for bit, float64's within the
repair's tolerances (loss rtol 1e-6, d_logits atol 1e-5) and the host
form's within the log-space repair's 2e-4, as the device form is held in
``tests/test_torch_port_jit.py``; one graph serves both counts.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_port_compile import (
    assert_same,
    compiled,
    entry_fn,
    fresh_dynamo,  # noqa: F401 (an autouse fixture)
    step,
)
from tests.test_torch_port_jit import BUCKETS, CHUNKED, flushed_batch, port_step, pure64
from tf_seq2seq_losses_tpu_torch.utils.config import config_override

LOSSES = {"classic": "classic_ctc_loss", "simplified": "simplified_ctc_loss"}


@pytest.mark.parametrize("topology_name", ["classic", "simplified"])
def test_compiled_chunked_step(topology_name):
    cfg = {**BUCKETS, **CHUNKED}
    f = entry_fn(LOSSES[topology_name], None)
    with config_override(use_kernels=True, **cfg):
        cf, counter = compiled(f)
        got = {n: step(cf, tuple(torch.tensor(a) for a in flushed_batch(n)))
               for n in (3, 8)}
    assert counter.frame_count == 1
    assert "torch.ops.ctc_port.pure_repair" in counter.code  # one node a round
    for n, value in got.items():
        args = flushed_batch(n)
        assert_same(value, port_step(args, topology_name, device=True, **cfg))
        loss64, grad64 = pure64(args, topology_name)
        np.testing.assert_allclose(value[0].numpy(), loss64.numpy(), rtol=1e-6)
        np.testing.assert_allclose(value[1].numpy(), grad64.numpy(), atol=1e-5)
        host = port_step(args, topology_name, **cfg)
        np.testing.assert_allclose(value[0].numpy(), host[0].numpy(), rtol=2e-4)
        np.testing.assert_allclose(value[1].numpy(), host[1].numpy(), atol=2e-4)
