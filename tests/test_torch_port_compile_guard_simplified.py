"""``tests/test_torch_port_compile_guard.py``'s checks for the simplified
topology: the compiled guard under each struct, the two-way guard and
``guard_mode="pre"``, one graph for n = 0, 1, 3 and 8 flushed rows, the
eager host form's loss and d_logits bit for bit; and the forward-only
call's guard.
"""

import pytest

from tests.test_torch_port_compile import fresh_dynamo  # noqa: F401 (autouse)
from tests.test_torch_port_compile_guard import (
    MODES,
    STRUCTS,
    check_forward_only,
    check_guard,
)

CONFIGS = {**STRUCTS, "while_pre": MODES["while_pre"]}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_compiled_guard_is_the_host_form(config):
    check_guard("simplified", CONFIGS[config])


def test_compiled_forward_only_guard():
    check_forward_only("simplified")
