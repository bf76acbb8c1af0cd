"""The guard's device form under ``guard_struct="cond"`` and the two-way
guard of ``repair_bucket=0``, which a CUDA graph captures as one IF node a
tier, against the host form and the JAX package's "cond" struct.

As in ``tests/test_torch_port_jit.py`` (whose batch, steps and caps these
reuse), the device form runs outside a capture with
``topology._on_device`` patched: every tier's body runs and its writes are
masked by the tier's predicate, which is what a replay computes.  B=8,
T=12, V=5, ``repair_bucket=1``, ``repair_bucket2=2``: n = 1 flushed row
takes tier 1 (the pure path), n = 2 tier 2 (the log-space kernels on the
first two rows of the flushed-first order), n = 3 and 8 the whole batch
(every row through the log-space kernels); under the caps of ``CAPS`` the
whole batch does not fit and tier 2 neither, so n > 1 repairs the first
flushed row through the pure path and the others keep +inf.  With
``repair_bucket=0`` any flushed row reroutes the whole batch.

Each case is held to the host form bit for bit, and to the JAX package's
"cond" struct in interpret mode at rtol 1e-5 (loss) and atol 1e-4
(d_logits), the JAX suite's tolerances.
"""

import pytest
import torch

from tests.test_torch_port_jit import (
    BATCH,
    BUCKETS,
    CAPS,
    LENGTHS,
    _HostData,
    _no_host_read,
    assert_near_jax,
    assert_same,
    flushed_batch,
    port_step,
)
from tf_seq2seq_losses_tpu_torch.ops import core, topology
from tf_seq2seq_losses_tpu_torch.utils.config import config_override
from tf_seq2seq_losses_tpu_torch.utils.numerics import logit_to_logproba

COND = dict(BUCKETS, guard_struct="cond")


def assert_device_is_host_and_near_jax(topology_name, n_flushed, route="exact", **cfg):
    """The port's step under ``cfg`` with the device form, against the host
    form and against the JAX package's struct of ``cfg`` (its buckets
    ``BUCKETS`` but for a ``repair_bucket`` of 0) under the cap ``route``
    names, if any."""
    args = flushed_batch(n_flushed)
    got = port_step(args, topology_name, device=True, **cfg)
    assert_same(got, port_step(args, topology_name, **cfg))
    jax_cfg = {} if cfg["repair_bucket"] else dict(repair_bucket=0)
    assert_near_jax(got, topology_name, n_flushed, route,
                    struct=cfg.get("guard_struct", "while"), **jax_cfg)


@pytest.mark.parametrize("n_flushed", [0, 1, 2, 3, 8])
@pytest.mark.parametrize("mode", ["post", "pre", "grad"])
@pytest.mark.parametrize("topology_name", ["classic", "simplified"])
def test_cond_device_form_is_the_host_form(topology_name, mode, n_flushed):
    assert_device_is_host_and_near_jax(topology_name, n_flushed, guard_mode=mode, **COND)


@pytest.mark.parametrize("n_flushed", [0, 1, 8])
@pytest.mark.parametrize("topology_name", ["classic", "simplified"])
def test_two_way_guard_device_form_is_the_host_form(topology_name, n_flushed):
    """``repair_bucket=0``: the whole batch on ``n > 0`` (the default
    struct, "while", takes the two-way guard too)."""
    assert_device_is_host_and_near_jax(topology_name, n_flushed,
                                       **dict(BUCKETS, repair_bucket=0))


@pytest.mark.parametrize("n_flushed", [1, 3, 8])
@pytest.mark.parametrize("cap", sorted(CAPS))
@pytest.mark.parametrize("topology_name", ["classic", "simplified"])
def test_cond_device_form_under_the_fallback_cap(topology_name, cap, n_flushed,
                                                 monkeypatch):
    """Over the cap the whole batch and tier 2 are off: the first flushed
    row through the pure path, the others at +inf (both forms warn)."""
    monkeypatch.setenv("CTC_TPU_GUARD_FALLBACK_BYTES", str(CAPS[cap]))
    with pytest.warns(UserWarning, match="whole-batch exact reroute disabled"):
        assert_device_is_host_and_near_jax(topology_name, n_flushed, cap, **COND)


@pytest.mark.parametrize("gate", [None, True, False])
@pytest.mark.parametrize("case", ["tier1", "tier2", "whole", "two-way"])
def test_cond_device_form_reads_no_device_value(case, gate, monkeypatch):
    """The "cond" device form with stub repairs that compute from their
    inputs, while ``torch.nonzero``, ``Tensor.item``, ``tolist``,
    ``__bool__`` and ``__int__`` raise and no host data becomes a tensor:
    the CPU's proof that a graph can capture it.  Its value: tier 1 (one
    flushed row) the pure stub's on that row, tier 2 (two rows) the exact
    stub's on them, the whole batch (three rows, or one with
    ``repair_bucket=0``) the exact stub's on every row, infeasible row 0
    included; nothing where the gate is False."""
    labels, logits, ll, gl = (torch.tensor(a) for a in flushed_batch(3))
    ll[0] = 13  # row 0 infeasible: +inf but not flushed
    ctx = core.make_context(labels, logit_to_logproba(logits, 2), ll,
                            torch.tensor(LENGTHS), 0)
    fast = torch.arange(BATCH, dtype=torch.float32)
    fast[[0, 1, 4, 6]] = float("inf")
    rows = {"tier1": [4], "tier2": [1, 4], "whole": [1, 4, 6], "two-way": [4]}[case]
    feasible = (ctx.logit_length >= ctx.label_length) & torch.isin(
        torch.arange(BATCH), torch.tensor(rows))
    aux = torch.linspace(1.0, 2.0, BATCH)
    exact = lambda c, a: c.logproba.sum(dim=(1, 2)) * a  # noqa: E731
    pure = lambda c, a: c.logproba.mean(dim=(1, 2)) * a  # noqa: E731
    gate_t = None if gate is None else torch.tensor(gate)
    cfg = dict(COND, repair_bucket=0) if case == "two-way" else COND
    for name in ("item", "tolist", "__bool__", "__int__"):
        monkeypatch.setattr(torch.Tensor, name, _no_host_read)
    monkeypatch.setattr(torch, "nonzero", _no_host_read)
    with config_override(**cfg), _HostData(pytest.MonkeyPatch()) as calls:
        got, n = topology._guarded_device(fast, exact, pure, fast, feasible, ctx,
                                          aux=aux, gate=gate_t)
    monkeypatch.undo()
    want = fast.clone()
    if gate is not False:
        if case in ("whole", "two-way"):
            want = exact(ctx, aux)
        else:
            want[rows] = (pure if case == "tier1" else exact)(ctx, aux)[rows]
    assert calls == []
    assert int(n) == (0 if gate is False else len(rows))
    assert torch.equal(got, want)
