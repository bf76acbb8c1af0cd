"""The gradient of beam search's scores: the backward op
``ctc_port::beam_search_grad`` (``ops/decode.py``), whose CUDA kernels are
``classic_beam_search_grad`` and ``simplified_beam_search_grad``
(csrc/beam_search.cu) and whose plain version is
``decode.beam_search_grad_plain``.

On ``beam_inputs`` of the beam kernel's tests (uniform log-probabilities,
``-inf`` entries, a vocabulary of the blank alone, K=64 over fewer
reachable prefixes, ``max_length`` 0, 3 and T, rows of length T, shorter
and 0), both topologies, blanks 0 and 2:

* the plain version is bit for bit autograd through the loop
  (``decode.beam_search_plain``) under the finite-sum cotangent and under a
  seeded N(0, 1) cotangent on the finite beams;
* the gradient of the finite scores' sum through ``api.ctc_beam_search_decode``
  is within 1e-6 of ``jax.grad`` of the JAX package's, on the same numpy
  inputs (infeasible rows' ``-inf`` scores left out of both sums);
* ``torch.func.grad``, ``torch.func.vmap(torch.func.grad(...))`` over 4
  groups and ``torch.compile(fullgraph=True, backend="aot_eager")`` give
  ``.backward()``'s bits, through the backward op;
* the op has a CUDA kernel, runs its plain version on CPU tensors, passes
  ``opcheck``; no gradient asked, the forward op runs alone; a backward
  never runs the forward's loop again;
* a second derivative (a double backward contracted with a seeded vector)
  is within 1e-6 of ``jax.hessian`` of the JAX package's score;
* the sums' orders (``decode.lane_sum``, ``beam_sum``) are ``torch.sum``'s
  on the CPU.

The kernels run on the card only: ``chip_smoke.py`` phase 14 (e) holds them
bit for bit to the plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tf_seq2seq_losses_tpu as jctc
from tests.test_torch_port_align import TOPOLOGIES
from tests.test_torch_port_beam_kernel import beam_inputs, torch_args
from tests.test_torch_port_compile import fresh_dynamo  # noqa: F401 (autouse)
from tests.test_torch_port_extras_grad_ops import OpNames, raising
from tf_seq2seq_losses_tpu_torch import api
from tf_seq2seq_losses_tpu_torch.ops import _build, decode

ATOL = 1e-6
# (kind of beam_inputs, beam width, max_length (None: T), blank); cases of
# one shape, width and max_length share a JAX compile
CASES = [("mixed", 4, None, 0), ("mixed", 4, 0, 2), ("mixed", 4, 3, 0),
         ("uniform", 4, 3, 2), ("neg_inf", 4, None, 2), ("blank_only", 4, None, 0),
         ("few", 64, None, 2)]


def finite_sum(scores):
    return torch.where(torch.isfinite(scores), scores, 0.0).sum()


def case_args(case, topology):
    kind, beam_width, max_length, blank = case
    lp, gl, blank = beam_inputs(kind, blank)
    return (lp, gl, blank), torch_args(lp, gl, blank, beam_width, max_length, topology)


def loop_grad(args, cot):
    """Autograd through the loop under the cotangent ``cot`` [B, K]."""
    x = args[0].clone().requires_grad_(True)
    (g,) = torch.autograd.grad(decode.beam_search_plain(x, *args[1:])[2], x, cot)
    return g


def score_fn(gl, blank, beam_width, topology, max_length):
    return lambda x: finite_sum(api.ctc_beam_search_decode(
        x, torch.tensor(gl), blank, beam_width, topology, max_length)[2])


def jax_score_fn(gl, blank, beam_width, topology, max_length):
    def fn(x):
        s = jctc.ctc_beam_search_decode(x, gl.astype(np.int32), blank, beam_width, topology,
                                        max_length)[2]
        return jnp.where(jnp.isfinite(s), s, 0.0).sum()
    return fn


def grad_of(fn, lp):
    x = lp.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(fn(x), x)
    return g


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_plain_is_autograd_through_the_loop(topology, case):
    _, args = case_args(case, topology)
    scores = decode.beam_search_plain(*args)[2]
    finite = torch.isfinite(scores)
    gen = torch.Generator().manual_seed(case[1] + 7 * case[3])
    for cot in (finite.to(torch.float32),
                torch.where(finite, torch.randn(scores.shape, generator=gen), 0.0)):
        got = decode.beam_search_grad_plain(*args, cot)
        assert torch.equal(got, loop_grad(args, cot))
        assert got.abs().sum() > 0 or not finite.any()


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_gradient_matches_jax(topology, case):
    (lp, gl, blank), args = case_args(case, topology)
    beam_width, max_length = case[1], case[2]
    got = grad_of(score_fn(gl, blank, beam_width, topology, max_length), args[0])
    want = np.asarray(jax.grad(jax_score_fn(gl, blank, beam_width, topology, max_length))(
        jnp.asarray(lp)))
    np.testing.assert_allclose(got.numpy(), want, rtol=ATOL, atol=ATOL)


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_func_grad_vmap_and_compile_are_backward(topology):
    lp, _, blank = beam_inputs("neg_inf", 2, batch=8)
    gl = np.resize(np.array([10, 7, 0, 9], np.int64), 8)
    x, n = torch.tensor(lp), torch.tensor(gl)

    def total(x_, n_):
        return finite_sum(api.ctc_beam_search_decode(x_, n_, blank, 4, topology)[2])

    want = grad_of(lambda x_: total(x_, n), x)
    assert want.abs().sum() > 0
    assert torch.equal(torch.func.grad(total)(x, n), want)
    mapped = torch.func.vmap(torch.func.grad(total))(x.unflatten(0, (4, 2)),
                                                     n.unflatten(0, (4, 2)))
    # each group's sum is its own score: the folded gradient's rows
    assert torch.equal(mapped.flatten(0, 1), want)
    compiled = torch.compile(lambda x_: total(x_, n), fullgraph=True, backend="aot_eager")
    x_c = x.clone().requires_grad_(True)
    out = compiled(x_c)
    with OpNames() as ops:
        (got,) = torch.autograd.grad(out, x_c)
    assert torch.equal(got, want)
    assert "ctc_port.beam_search_grad" in ops.names


def test_op_is_a_kernel_op_with_a_cuda_kernel():
    assert torch._C._dispatch_has_kernel_for_dispatch_key("ctc_port::beam_search_grad", "CUDA")
    assert "ctc_beam_search_grad" in _build._SIGNATURES["beam_search"]
    assert decode.classic_beam_search_grad.launches == 0
    assert decode.simplified_beam_search_grad.launches == 0


def test_op_runs_the_plain_version_on_cpu_tensors(monkeypatch):
    _, args = case_args(CASES[0], "classic")
    cot = torch.ones((4, 4))
    assert torch.equal(torch.ops.ctc_port.beam_search_grad(*args, cot),
                       decode.beam_search_grad_plain(*args, cot))
    monkeypatch.setattr(decode.beam_search_grad_plain, "__code__", raising.__code__)
    with pytest.raises(AssertionError, match="ran again"):
        torch.ops.ctc_port.beam_search_grad(*args, cot)


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_backward_runs_the_grad_op_not_the_loop(topology, monkeypatch):
    (_, gl, blank), args = case_args(CASES[0], topology)
    fn = score_fn(gl, blank, 4, topology, None)
    want = grad_of(fn, args[0])
    x = args[0].clone().requires_grad_(True)
    total = fn(x)
    monkeypatch.setattr(decode.beam_search_plain, "__code__", raising.__code__)
    with OpNames() as ops:
        (got,) = torch.autograd.grad(total, x)
    assert torch.equal(got, want)
    assert "ctc_port.beam_search_grad" in ops.names
    assert "ctc_port.beam_search" not in ops.names


def test_no_gradient_asked_runs_the_forward_op_alone():
    _, args = case_args(CASES[0], "classic")
    with OpNames() as ops:
        scores = api.ctc_beam_search_decode(args[0], args[1], args[2], 4)[2]
    assert scores.grad_fn is None
    assert "ctc_port.beam_search" in ops.names
    assert "ctc_port.beam_search_grad" not in ops.names
    x = args[0].clone().requires_grad_(True)
    assert api.ctc_beam_search_decode(x, args[1], args[2], 4)[2].grad_fn is not None


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_opcheck(topology):
    _, args = case_args(CASES[2], topology)
    cot = torch.randn((4, 4), generator=torch.Generator().manual_seed(3))
    torch.library.opcheck(torch.ops.ctc_port.beam_search_grad.default, args + (cot,))
    with torch._subclasses.FakeTensorMode(allow_non_fake_inputs=True):
        fake = torch.ops.ctc_port.beam_search_grad(*args, cot)
    assert (fake.shape, fake.dtype) == (args[0].shape, torch.float32)


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_second_derivative_matches_jax(topology):
    """A double backward (``create_graph=True``) runs the backward op's plain
    version again; contracted with a seeded vector, it is ``jax.hessian``
    of the JAX package's score contracted with the same vector."""
    rng = np.random.RandomState(11)
    lp = np.log(rng.dirichlet(np.ones(3), size=(2, 4))).astype(np.float32)
    gl = np.array([4, 3], np.int64)
    vec = rng.normal(size=lp.shape).astype(np.float32)
    fn = score_fn(gl, 0, 4, topology, None)
    x = torch.tensor(lp).requires_grad_(True)
    (g,) = torch.autograd.grad(fn(x), x, create_graph=True)
    (got,) = torch.autograd.grad((g * torch.tensor(vec)).sum(), x)
    hess = np.asarray(jax.hessian(jax_score_fn(gl, 0, 4, topology, None))(jnp.asarray(lp)))
    want = np.einsum("abcxyz,xyz->abc", hess, vec)
    assert np.abs(want).sum() > 0
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=ATOL, atol=ATOL)


@pytest.mark.parametrize("shape", [(3, 5, 7), (3, 6, 8), (2, 9, 33), (2, 20, 70), (1, 64, 5)])
def test_sums_are_torch_sums_on_the_cpu(shape):
    """``decode.lane_sum`` over the last axis and ``decode.beam_sum`` over
    the beams give ``torch.sum``'s bits on the CPU, below a vector and past
    it (``decode.SUM_LANES``), past a block of 16 beams."""
    rng = np.random.RandomState(sum(shape))
    x = torch.tensor((rng.normal(size=shape)
                      * 10.0 ** rng.randint(-4, 5, size=shape)).astype(np.float32))
    assert torch.equal(decode.lane_sum(x), x.sum(-1))
    assert torch.equal(decode.beam_sum(x), x.sum(-2))
