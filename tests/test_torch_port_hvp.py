"""The port's Hessian-vector product against the JAX package's
``ctc_loss_hessian_vector_product`` and the Hessian contraction.

Forward mode (``torch.func.jvp``) over the pure analytic gradient: equal
to JAX's HVP and to ``einsum('btvxy,bxy->btv', ctc_loss_hessian(...), v)``
within atol 1e-5, exact zeros on infeasible rows, bf16 accepted (within
1e-2 of float32, as the JAX suite holds it), a wrong vector shape raising
the JAX package's message, and a shape whose full Hessian would take over
1 GB run in seconds without ever building it (held there against the
central difference of the float64 gradient: the port's recursions run in
float64, the JAX package's in float32).
"""

import time

import numpy as np
import pytest
import torch

import tf_seq2seq_losses_tpu as jctc
from tests.test_torch_port_align import (
    BLANKS,
    SHAPES,
    TOPOLOGIES,
    extras_inputs,
    torch_args,
)
from tf_seq2seq_losses_tpu_torch import api
from tf_seq2seq_losses_tpu_torch.ops import autodiff, core
from tf_seq2seq_losses_tpu_torch.ops import topology as port_topology


def _vector(shape, seed=1):
    return np.random.RandomState(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("blank", BLANKS)
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_hvp_matches_jax(topology, blank, shape):
    batch, max_t, vocab, lab_w = SHAPES[shape]
    labels, lp, ll, gl = extras_inputs(blank, batch, max_t, vocab, lab_w, seed=40 + blank)
    v = _vector(lp.shape)
    want = np.asarray(jctc.ctc_loss_hessian_vector_product(labels, lp, ll, gl, blank, v,
                                                           topology))
    got = api.ctc_loss_hessian_vector_product(*torch_args(labels, lp, ll, gl), blank,
                                              torch.tensor(v), topology)
    assert got.dtype == torch.float32 and got.shape == lp.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert (got[3] == 0).all()  # infeasible
    assert (got[1, gl[1]:] == 0).all()  # past logit_length


@pytest.mark.parametrize("blank", BLANKS)
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_hvp_equals_the_hessian_contraction(topology, blank):
    labels, lp, ll, gl = extras_inputs(blank, batch=4, max_t=6, vocab=4, lab_w=3,
                                       seed=50 + blank)
    v = torch.tensor(_vector(lp.shape, seed=2))
    args = torch_args(labels, lp, ll, gl)
    hess = api.ctc_loss_hessian(*args, blank, topology)
    want = torch.einsum("btvxy,bxy->btv", hess, v)
    got = api.ctc_loss_hessian_vector_product(*args, blank, v, topology)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_hvp_zero_for_infeasible_samples(topology):
    labels = torch.tensor([[1, 2, 2, 1], [1, 2, 1, 0]])
    lp = torch.zeros((2, 2, 3)) - np.log(3.0)
    got = api.ctc_loss_hessian_vector_product(labels, lp, torch.tensor([4, 3]),
                                              torch.tensor([2, 2]), 0,
                                              torch.ones((2, 2, 3)), topology)
    assert (got == 0).all()


def test_hvp_accepts_bf16_and_validates_the_vector_shape():
    labels, lp, ll, gl = extras_inputs(0, batch=4, max_t=6, vocab=4, lab_w=3, seed=3)
    v = _vector(lp.shape)
    args = torch_args(labels, lp, ll, gl)
    want = api.ctc_loss_hessian_vector_product(*args, 0, torch.tensor(v))
    got = api.ctc_loss_hessian_vector_product(args[0], args[1].to(torch.bfloat16),
                                              *args[2:], 0, torch.tensor(v))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-2)
    text = (r"ctc_loss_hessian_vector_product: vector must match logprobas shape "
            r"\(4, 6, 4\), got \(4, 5, 4\)")
    with pytest.raises(ValueError, match=text):
        jctc.ctc_loss_hessian_vector_product(labels, lp, ll, gl, 0, v[:, :-1])
    with pytest.raises(ValueError, match=text):
        api.ctc_loss_hessian_vector_product(*args, 0, torch.tensor(v[:, :-1]))


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_hvp_never_builds_the_hessian(topology, monkeypatch):
    # [4, 128, 64, 128, 64] float32 would be 1.07 GB; the HVP keeps first-
    # order memory and runs in seconds
    batch, max_t, vocab = 4, 128, 64
    assert batch * (max_t * vocab) ** 2 * 4 > 1e9

    def refuse(*_args, **_kw):
        raise AssertionError("the HVP built the full Hessian")

    monkeypatch.setattr(core, "hessian", refuse)
    monkeypatch.setattr(autodiff.Hessian, "forward", refuse)
    labels, lp, ll, gl = extras_inputs(0, batch, max_t, vocab, lab_w=16, seed=60)
    v = _vector(lp.shape, seed=4)
    args = torch_args(labels, lp, ll, gl)
    t0 = time.perf_counter()
    got = api.ctc_loss_hessian_vector_product(*args, 0, torch.tensor(v), topology)
    seconds = time.perf_counter() - t0
    assert seconds < 20, seconds
    # oracle: the central difference of the float64 analytic gradient (the
    # JAX package's float32 product is itself 2e-4 off at this length)
    eps, v64 = 1e-4, torch.tensor(v, dtype=torch.float64)
    lp64 = args[1].double()
    want = (_gradient64(args, lp64 + eps * v64, topology)
            - _gradient64(args, lp64 - eps * v64, topology)) / (2 * eps)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def _gradient64(args, lp64, topology):
    """The pure analytic gradient at float64 log-probabilities ``lp64``."""
    labels, _, ll, gl = args
    c = core.make_context(labels, lp64, ll, gl, 0)
    forced = torch.where(c.logit_length_mask[:, :, None], lp64, c.logproba.double())
    c = c._replace(logproba=forced, raw_logproba=lp64,
                   blank_lp=core.take_blank_logproba(forced, c.blank_index))
    return core.gradient(port_topology.TOPOLOGIES[topology], c)
