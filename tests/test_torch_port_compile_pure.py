"""The loss entry points under ``torch.compile(fullgraph=True)`` on the CPU
(``backend="aot_eager"``) against the JAX package under ``jax.jit``.

On the pure path (the CPU default: the recursions traced step by step, no
custom op, no guard) the compiled training step and forward-only call are
the eager port's bit for bit.  On both paths, the pure one and the kernel
path (the kernels' plain versions behind the custom ops, as in
``tests/test_torch_port_compile.py``), the compiled value agrees with
``jax.jit`` of the same JAX entry point within atol 1e-6, the eager API
tests' tolerance (``tests/test_torch_port_api.py``), and with
``jax.jit(jax.grad(...))`` of its finite sum within atol 1e-5, the eager
autodiff tests' (``tests/test_torch_port_autodiff.py``: the float32
gradients of both packages differ by up to 2e-6 here, eager or compiled),
on the same numpy inputs (B=4, T=6, V=5, row 3 infeasible; the pure path's
recursions are traced step by step).  The entry points on
log-probabilities are in ``tests/test_torch_port_compile_pure_logproba.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tf_seq2seq_losses_tpu as jctc
from tests.test_torch_port_compile import (
    LOGPROBA_ENTRY_POINTS,
    assert_same,
    compiled,
    entry_fn,
    forward_only,
    fresh_dynamo,  # noqa: F401 (an autouse fixture)
    inputs,
    step,
    torch_inputs,
)
from tf_seq2seq_losses_tpu_torch.utils.config import config_override

ENTRY_POINTS = [("classic_ctc_loss", None), ("simplified_ctc_loss", None)]
ATOL, GRAD_ATOL = 1e-6, 1e-5
MAX_T = 6


def jax_step(name, topology, args):
    """``(value, gradient of its finite sum)`` of the JAX package's entry
    point, each under ``jax.jit``."""
    labels, x, ll, gl = args
    if name in LOGPROBA_ENTRY_POINTS:
        x = jax.nn.log_softmax(x, axis=2)
    fn = getattr(jctc, name)
    extra = () if topology is None else (topology,)

    def value(x):
        return fn(labels, x, ll, gl, 0, *extra)

    def scalar(x):
        out = value(x)
        return jnp.sum(jnp.where(jnp.isfinite(out), out, 0.0))

    return np.asarray(jax.jit(value)(x)), np.asarray(jax.jit(jax.grad(scalar))(x))


@pytest.mark.parametrize("name,topology", ENTRY_POINTS)
def test_compiled_pure_path_is_the_eager_port_and_jax(name, topology):
    check_pure_path(name, topology)


def check_pure_path(name, topology):
    """The compiled entry point on the pure path: the eager port's bit for
    bit, JAX's within the tolerances above."""
    args = inputs(max_t=MAX_T)
    t_args = torch_inputs(name, args)
    f = entry_fn(name, topology)
    cf, counter = compiled(f)
    got_step, got_fwd = step(cf, t_args), forward_only(cf, t_args)
    assert counter.frame_count == 2
    assert "ctc_port" not in counter.code  # the pure path runs no kernel op
    assert_same(got_step, step(f, t_args))
    assert_same((got_fwd,), (forward_only(f, t_args),))
    want_value, want_grad = jax_step(name, topology, tuple(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(got_step[0].numpy(), want_value, atol=ATOL)
    np.testing.assert_allclose(got_fwd.numpy(), want_value, atol=ATOL)
    np.testing.assert_allclose(got_step[1].numpy(), want_grad, atol=GRAD_ATOL)


@pytest.mark.parametrize("name,topology", ENTRY_POINTS)
def test_compiled_kernel_path_agrees_with_jax(name, topology):
    args = inputs(max_t=MAX_T)
    f = entry_fn(name, topology)
    with config_override(use_kernels=True):
        cf, _ = compiled(f)
        got = step(cf, torch_inputs(name, args))
    want_value, want_grad = jax_step(name, topology, tuple(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(got[0].numpy(), want_value, atol=ATOL)
    np.testing.assert_allclose(got[1].numpy(), want_grad, atol=GRAD_ATOL)
