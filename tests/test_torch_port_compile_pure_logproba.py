"""``tests/test_torch_port_compile_pure.py``'s check for the entry points on
log-probabilities: ``ctc_loss_from_logproba`` and ``ctc_loss_gradient``
compiled on the pure path, the eager port's bit for bit, and ``jax.jit``'s
value within atol 1e-6 and ``jax.jit(jax.grad(...))``'s within 1e-5.
"""

import pytest

from tests.test_torch_port_compile import fresh_dynamo  # noqa: F401 (autouse)
from tests.test_torch_port_compile_pure import check_pure_path


@pytest.mark.parametrize("name,topology", [("ctc_loss_from_logproba", "classic"),
                                           ("ctc_loss_gradient", "simplified")])
def test_compiled_pure_path_is_the_eager_port_and_jax(name, topology):
    check_pure_path(name, topology)
