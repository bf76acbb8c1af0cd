"""The Hessian-vector product through its tangent scans (``ops/hvp.py``)
against the route it replaced and against the JAX package, on the CPU.

``ctc_loss_hessian_vector_product`` takes alpha and beta with their
tangents from the tangent scan ops and the glue's tangent from
``torch.func.jvp``.  Here it is held bit for bit to the route before the
scans (``torch.autograd.forward_ad`` through the pure path's loops in
float64, computed in the test; else within 1e-12 relative), also with those
loops patched to raise (no AD runs through them), and within atol 1e-5 of
``jax.jit`` and ``jax.vmap`` of the JAX package's HVP (float32 there,
float64 here, as ``tests/test_torch_port_hvp.py`` holds the eager call).
The transforms are ``tests/test_torch_port_hvp_transforms.py``; the
kernels run on the card only (``chip_smoke.py`` phase 15).
"""

import inspect

import jax
import numpy as np
import pytest
import torch
from torch.autograd import forward_ad

import tf_seq2seq_losses_tpu as jctc
from tests.test_torch_port_align import SHAPES, extras_inputs
from tests.test_torch_port_compile import assert_same
from tf_seq2seq_losses_tpu_torch import api
from tf_seq2seq_losses_tpu_torch.ops import classic, core, simplified
from tf_seq2seq_losses_tpu_torch.ops.topology import TOPOLOGIES

GROUPS = 2


def hvp_inputs(blank, shape="small", seed=70):
    """``(labels, logprobas, label_length, logit_length, vector)`` as numpy
    arrays: the extras' rows (an infeasible row, an empty label, a short
    row) and a N(0, 1) vector."""
    batch, max_t, vocab, lab_w = SHAPES[shape]
    labels, lp, ll, gl = extras_inputs(blank, batch, max_t, vocab, lab_w, seed=seed + blank)
    vector = np.random.RandomState(seed).normal(size=lp.shape).astype(np.float32)
    return labels, lp, ll, gl, vector


def forward_ad_route(topology, labels, lp, ll, gl, blank, vector):
    """The HVP before the tangent scans: ``forward_ad`` through
    ``core.gradient`` on the float64 context, the pure path's loops."""
    with forward_ad.dual_level():
        ctx = core.float64_context(core.make_context(
            labels, forward_ad.make_dual(lp, vector), ll, gl, blank))
        grad = core.gradient(TOPOLOGIES[topology], ctx)
        return forward_ad.unpack_dual(grad).tangent.to(torch.float32)


def hvp_fn(topology, blank):
    def fn(labels, lp, ll, gl, vector):
        return api.ctc_loss_hessian_vector_product(labels, lp, ll, gl, blank, vector,
                                                   topology)
    return fn


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("blank", [0, 2])
@pytest.mark.parametrize("topology", ["classic", "simplified"])
def test_hvp_is_the_forward_ad_route(topology, blank, shape):
    args = tuple(torch.tensor(a) for a in hvp_inputs(blank, shape))
    want = forward_ad_route(topology, *args[:4], blank, args[4])
    got = hvp_fn(topology, blank)(*args)
    assert got.dtype == torch.float32 and got.shape == want.shape
    if not torch.equal(got, want):  # else within 1e-12 relative
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=0)


def _refuse(*_args, **_kw):
    raise AssertionError("the HVP ran the pure path's loop over T")


@pytest.mark.parametrize("topology", ["classic", "simplified"])
def test_no_autodiff_through_the_loops(topology, monkeypatch):
    """The loops of the pure path patched to raise: the value unchanged (on
    CPU tensors the scan ops run their own loops over (value, tangent)
    pairs); and the entry point holds no ``forward_ad``."""
    args = tuple(torch.tensor(a) for a in hvp_inputs(2))
    want = hvp_fn(topology, 2)(*args)
    for module in (classic, simplified):
        for name in ("alpha_scan", "beta_scan", "alpha", "beta"):
            monkeypatch.setattr(module, name, _refuse)
    assert_same((hvp_fn(topology, 2)(*args),), (want,))
    assert "forward_ad" not in inspect.getsource(api.ctc_loss_hessian_vector_product)
    assert not hasattr(api, "forward_ad")


@pytest.mark.parametrize("topology", ["classic", "simplified"])
def test_hvp_against_jax_jit_and_vmap(topology):
    blank = 2
    labels, lp, ll, gl, vector = hvp_inputs(blank)

    def jax_hvp(lab, x, n, m, v):
        return jctc.ctc_loss_hessian_vector_product(lab, x, n, m, blank, v, topology)

    args = (labels, lp, ll, gl, vector)
    got = hvp_fn(topology, blank)(*(torch.tensor(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.jit(jax_hvp)(*args)), atol=1e-5)
    grouped = [a.reshape((GROUPS, -1) + a.shape[1:]) for a in args]
    want = np.asarray(jax.vmap(jax_hvp)(*grouped))
    mapped = torch.func.vmap(hvp_fn(topology, blank))(*(torch.tensor(a) for a in grouped))
    np.testing.assert_allclose(mapped.numpy(), want, atol=1e-5)
