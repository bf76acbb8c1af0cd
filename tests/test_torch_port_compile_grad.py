"""``ctc_loss_gradient`` under ``torch.compile(fullgraph=True)`` on the CPU
(``backend="aot_eager"``, the kernels' plain versions behind the custom
ops): compiled forward only and with its backward (the analytic Hessian's
contraction), each the eager port's bit for bit.  B=2, T=4, V=3 (the
Hessian's pure recursions are traced step by step).
``ctc_loss_hessian`` and the double backward are in
``tests/test_torch_port_compile_hessian.py``.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_port_compile import (
    assert_same,
    compiled,
    entry_fn,
    forward_only,
    fresh_dynamo,  # noqa: F401 (an autouse fixture)
    step,
    torch_inputs,
)
from tf_seq2seq_losses_tpu_torch.utils.config import config_override


def small_inputs(seed=0):
    """``(labels, logits, label_length, logit_length)`` as numpy arrays;
    row 1's label does not fit its frame."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(1, 3, (2, 2)).astype(np.int32)
    logits = rng.normal(size=(2, 4, 3)).astype(np.float32)
    return labels, logits, np.array([2, 2], np.int32), np.array([4, 1], np.int32)


@pytest.mark.parametrize("topology", ["classic", "simplified"])
def test_compiled_gradient_is_the_eager_port(topology):
    args = torch_inputs("ctc_loss_gradient", small_inputs())
    f = entry_fn("ctc_loss_gradient", topology)
    with config_override(use_kernels=True):
        cf, counter = compiled(f)
        got_step = step(cf, args)
        got_fwd = forward_only(cf, args)
        want_step, want_fwd = step(f, args), forward_only(f, args)
    assert counter.frame_count == 2
    assert_same(got_step, want_step)
    assert_same((got_fwd,), (want_fwd,))
    assert not got_step[0][1].any() and not got_step[1][1].any()
