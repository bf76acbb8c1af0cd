"""A row that only the backward flags: the scan-gap flag
(``cuda_lattice.flush_signal``) is the guard's signal only.

The port's backward sets a row's flush signal to +inf where its beta scan
and the forward disagree by more than ``cuda_lattice.scan_gap_limit``; the
JAX package has no such flag.  Here the limit is patched negative for one
row of a clean batch (``tests/test_torch_port_jit.py``'s, B=8, T=12, V=5),
so the flag fires there and nowhere else, on the kernels' plain versions:

* under ``guard_mode="pre"`` the forward found no flushed row, so the
  backward runs unguarded: the row keeps its fast gradient, bit for bit the
  unpatched run's and within atol 1e-4 of the JAX package's "pre" in
  interpret mode (loss rtol 1e-5), and its loss the forward's;
* under "post" and "grad" the guard repairs the row: within 2e-4 of the
  pure path in float64 (the log-space repair's tolerance), the other rows
  bit for bit the unpatched run's;
* the guard's device form gives the host form's values bit for bit.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_port_jit import (
    BATCH,
    BUCKETS,
    assert_near_jax,
    assert_same,
    flushed_batch,
    port_step,
    pure64,
)
from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice

FLAGGED = 3


def flag_one_row(monkeypatch):
    """Patch ``scan_gap_limit`` to -1 for row ``FLAGGED`` of a whole batch."""
    real = cuda_lattice.scan_gap_limit

    def limit(loss, n_steps):
        out = real(loss, n_steps)
        if out.shape[0] != BATCH:
            return out
        return torch.where(torch.arange(BATCH) == FLAGGED, -torch.ones_like(out), out)

    monkeypatch.setattr(cuda_lattice, "scan_gap_limit", limit)


@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("topology_name", ["classic", "simplified"])
def test_pre_gives_a_row_only_the_backward_flags_its_fast_gradient(
        topology_name, device, monkeypatch):
    args = flushed_batch(0)
    cfg = dict(BUCKETS, guard_mode="pre")
    clean = port_step(args, topology_name, device=device, **cfg)
    flag_one_row(monkeypatch)
    got = port_step(args, topology_name, device=device, **cfg)
    assert got[1][FLAGGED].abs().sum() > 0
    assert_same(got, clean)
    assert_same(got, port_step(args, topology_name, **cfg))
    assert_near_jax(got, topology_name, 0, guard_mode="pre")


@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("mode", ["post", "grad"])
@pytest.mark.parametrize("topology_name", ["classic", "simplified"])
def test_post_and_grad_repair_a_row_only_the_backward_flags(topology_name, mode, device,
                                                            monkeypatch):
    args = flushed_batch(0)
    cfg = dict(BUCKETS, guard_mode=mode)
    clean = port_step(args, topology_name, **cfg)
    flag_one_row(monkeypatch)
    got = port_step(args, topology_name, device=device, **cfg)
    assert_same(got, port_step(args, topology_name, **cfg))
    others = torch.arange(BATCH) != FLAGGED
    assert_same((got[0], got[1][others]), (clean[0], clean[1][others]))
    assert not torch.equal(got[1][FLAGGED], clean[1][FLAGGED])
    _, d64 = pure64(args, topology_name)
    np.testing.assert_allclose(got[1][FLAGGED].numpy(), d64[FLAGGED].numpy(), atol=2e-4)
