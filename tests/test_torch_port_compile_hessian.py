"""``ctc_loss_hessian`` under ``torch.compile(fullgraph=True)`` on the CPU
(``backend="aot_eager"``, the kernels' plain versions behind the custom
ops), which compiles forward only, and a double backward through a
compiled loss, which AOTAutograd refuses.  The inputs of
``tests/test_torch_port_compile_grad.py`` (B=2, T=4, V=3).
"""

import pytest
import torch

from tests.test_torch_port_compile import (
    compiled,
    entry_fn,
    fresh_dynamo,  # noqa: F401 (an autouse fixture)
    torch_inputs,
)
from tests.test_torch_port_compile_grad import small_inputs
from tf_seq2seq_losses_tpu_torch import api
from tf_seq2seq_losses_tpu_torch.utils.config import config_override


def test_double_backward_is_refused():
    """A second derivative through a compiled loss: AOTAutograd raises (the
    JAX package's ``jax.jit(jax.hessian(...))`` works; the port's eager
    chain and ``torch.func.jacrev`` give it)."""
    labels, x, ll, gl = torch_inputs("classic_ctc_loss", small_inputs())
    x = x.clone().requires_grad_(True)
    with config_override(use_kernels=True):
        cf, _ = compiled(entry_fn("classic_ctc_loss", None))
        (grad,) = torch.autograd.grad(cf(labels, x, ll, gl)[1], x, create_graph=True)
        with pytest.raises(RuntimeError,
                           match="does not currently support double backward"):
            grad.sum().backward()


def test_hessian_compiles_forward_only():
    """``ctc_loss_hessian`` compiles where its input does not require grad,
    to the eager port's value; where it does, compiling raises, naming the
    third derivative's ``NotImplementedError`` (Dynamo traces a Function's
    backward when it compiles it, and the Hessian's raises)."""
    labels, lp, ll, gl = torch_inputs("ctc_loss_hessian", small_inputs())

    def hessian(x):
        return api.ctc_loss_hessian(labels, x, ll, gl, 0)

    with config_override(use_kernels=True):
        cf, counter = compiled(hessian)
        assert torch.equal(cf(lp), hessian(lp))
        assert counter.frame_count == 1
        with pytest.raises(torch._dynamo.exc.Unsupported, match="Third order derivative"):
            cf(lp.clone().requires_grad_(True))
