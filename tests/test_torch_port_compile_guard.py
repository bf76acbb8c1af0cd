"""The saturation guard under ``torch.compile(fullgraph=True)`` on the CPU
(``backend="aot_eager"``, the kernels' plain versions behind the custom
ops), classic topology, under each ``guard_struct`` and the two-way guard;
``tests/test_torch_port_compile_guard_modes.py`` runs the other placements
and tier 1, ``tests/test_torch_port_compile_guard_simplified.py`` the
simplified topology.

Under compile the guard takes its device form (``topology._on_device``:
``torch.compiler.is_compiling()``): the "while" struct's rounds one
``while_loop`` on the flushed count, each other decision a ``torch.cond``
on a predicate of it; the graph has no host read, so one graph serves
every count.  The batch is
``tests/test_torch_port_jit.py``'s (B=8, T=12, V=5, logit lengths 8 to 12,
the first ``n`` rows wrong-certain, ``repair_bucket=1, repair_bucket2=2``:
four "while" rounds), at n = 0, 1, 3 and 8 rows flushed.  Each config
compiles once, and every n is the eager host form's loss and d_logits bit
for bit (the device form's values are the host form's on one chunk;
``tests/test_torch_port_jit.py`` holds both to the JAX package).
"""

import pytest
import torch

from tests.test_torch_port_compile import (
    assert_same,
    compiled,
    entry_fn,
    forward_only,
    fresh_dynamo,  # noqa: F401 (an autouse fixture)
    step,
)
from tests.test_torch_port_jit import BUCKETS, flushed_batch, port_step
from tf_seq2seq_losses_tpu_torch.utils.config import config_override

N_FLUSHED = (0, 1, 3, 8)
# each struct under "post", and the two-way guard (repair_bucket 0)
STRUCTS = {
    "while": dict(guard_struct="while"),
    "cond": dict(guard_struct="cond"),
    "two_way": dict(repair_bucket=0),
}
# the other two placements, tier 1 of the "while" struct, and "while"
# rounds of 3 rows, whose last round would pass the batch's end (it takes
# rows 5 to 7, row 5 again)
MODES = {
    "while_pre": dict(guard_struct="while", guard_mode="pre"),
    "cond_grad": dict(guard_struct="cond", guard_mode="grad"),
    "while_tier1": dict(guard_struct="while", guard_tier1=True),
    "while_ragged": dict(guard_struct="while", repair_bucket2=3),
}
LOSSES = {"classic": "classic_ctc_loss", "simplified": "simplified_ctc_loss"}


def tensors(args):
    return tuple(torch.tensor(a) for a in args)


def check_guard(topology_name, config):
    """Compile the training step once under ``config`` (a dict of
    :data:`STRUCTS` or :data:`MODES`) and hold it at every n to the eager
    host form; one graph in all."""
    cfg = {**BUCKETS, **config}
    f = entry_fn(LOSSES[topology_name], None)
    with config_override(use_kernels=True, **cfg):
        cf, counter = compiled(f)
        got = {n: step(cf, tensors(flushed_batch(n))) for n in N_FLUSHED}
    assert counter.frame_count == 1, f"{counter.frame_count} graphs for one config"
    # the "while" rounds are one while_loop, the other decisions torch.cond
    rounds = cfg.get("guard_struct", "while") == "while" and cfg["repair_bucket"] > 0
    assert ("torch.ops.higher_order.while_loop" in counter.code) == rounds
    assert "torch.ops.higher_order.cond" in counter.code or rounds
    for n in N_FLUSHED:
        assert_same(got[n], port_step(flushed_batch(n), topology_name, **cfg))


def check_forward_only(topology_name):
    """The forward-only call's guard (the loss alone): one graph, the eager
    loss bit for bit at every n."""
    f = entry_fn(LOSSES[topology_name], None)
    with config_override(use_kernels=True, **BUCKETS):
        cf, counter = compiled(f)
        for n in N_FLUSHED:
            args = tensors(flushed_batch(n))
            assert torch.equal(forward_only(cf, args), forward_only(f, args))
    assert counter.frame_count == 1


@pytest.mark.parametrize("config", sorted(STRUCTS))
def test_compiled_guard_is_the_host_form(config):
    check_guard("classic", STRUCTS[config])


def test_compiled_forward_only_guard():
    check_forward_only("classic")
