"""``tests/test_torch_port_compile_guard.py``'s check of the compiled guard
under the placements "pre" and "grad", the "while" struct's tier 1 and
its rounds of 3 rows (a ragged last round), classic topology: one graph
for n = 0, 1, 3 and 8 flushed rows, the eager host form's loss and
d_logits bit for bit.
"""

import pytest

from tests.test_torch_port_compile import fresh_dynamo  # noqa: F401 (autouse)
from tests.test_torch_port_compile_guard import MODES, check_guard


@pytest.mark.parametrize("config", sorted(MODES))
def test_compiled_guard_is_the_host_form(config):
    check_guard("classic", MODES[config])
