"""The backward ops of forced alignment's and the sampling walk's scores.

``ctc_port::classic_viterbi_grad`` and ``ctc_port::simplified_viterbi_grad``
(``ops/align.py``), ``ctc_port::classic_walk_grad`` and
``ctc_port::simplified_walk_grad`` (``ops/sample.py``) are the backwards of
the Viterbi and walk ops (``cuda_lattice.op_with_grad``).  On the JAX tests'
inputs (``extras_inputs``: B=4, T=12, V=5, an infeasible row, an empty
label, a short row; blanks 0 and 2; both topologies):

* each plain version, out of place, is bit for bit autograd through the
  forward's loop (``align.*_viterbi_plain``, ``sample.*_walk_plain``) under
  the finite-sum cotangent, under a seeded random cotangent on the feasible
  rows, and on uniform log-probabilities, where finite ties are everywhere
  (also with a random cotangent on every row, where ``-inf`` ties spread
  it); and within 1e-6 of ``jax.vjp`` of the JAX function on the same numpy
  inputs, the walk fed ``jax.random.gumbel`` of the JAX sampler's key;
* ``torch.func.vmap(torch.func.grad(score))`` over 4 groups is bit for
  bit the loop over the groups and within 1e-6 of
  ``jax.vmap(jax.grad(...))``;
* a score's backward runs the grad op, never the forward's loop: that loop
  patched to raise after the forward, the gradient is unchanged;
* ``torch.compile(fullgraph=True, backend="aot_eager")`` of the score, its
  backward AOTAutograd's, gives the eager gradient bit for bit;
* each op passes ``torch.library.opcheck`` and has a CUDA kernel; a
  derivative of the gradient runs the op's plain version again: zero in
  the log-probabilities, the transposed Jacobian in the cotangent.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import tf_seq2seq_losses_tpu as jctc
from tests.test_torch_port_align import extras_inputs, torch_args
from tests.test_torch_port_compile import fresh_dynamo  # noqa: F401 (autouse)
from tf_seq2seq_losses_tpu_torch import api
from tf_seq2seq_losses_tpu_torch.ops import align, classic, core, sample, simplified

TOPOLOGIES = ["classic", "simplified"]
GRAD_OPS = ("classic_viterbi_grad", "simplified_viterbi_grad", "classic_walk_grad",
            "simplified_walk_grad")
FORWARD = {
    "classic_viterbi_grad": align.classic_viterbi_plain,
    "simplified_viterbi_grad": align.simplified_viterbi_plain,
    "classic_walk_grad": sample.classic_walk_plain,
    "simplified_walk_grad": sample.simplified_walk_plain,
}
PLAIN = {
    "classic_viterbi_grad": align.classic_viterbi_grad_plain,
    "simplified_viterbi_grad": align.simplified_viterbi_grad_plain,
    "classic_walk_grad": sample.classic_walk_grad_plain,
    "simplified_walk_grad": sample.simplified_walk_grad_plain,
}
COTANGENTS = ("finite_sum", "random", "uniform")
ATOL = 1e-6
NUM_S = 4
GROUPS = 4


def numpy_inputs(blank, cotangent, seed=40):
    labels, lp, ll, gl = extras_inputs(blank, seed=seed + blank)
    if cotangent == "uniform":
        lp = np.full_like(lp, np.log(1.0 / lp.shape[-1]))
    return labels, lp, ll, gl


def jax_noise(topology, blank, ctx, num_s=NUM_S):
    """``(key, noise)``: the JAX sampler's key and its Gumbel draw, the
    walk's noise."""
    key = jax.random.PRNGKey(blank + 5)
    shape = sample.noise_shape(topology, num_s, ctx)
    return key, torch.tensor(np.asarray(jax.random.gumbel(key, shape)))


def op_inputs(name, blank, cotangent):
    """``(terms, the rest of the op's arguments)`` of the forward op behind
    ``name``, as the glue of ``ops/align.py`` and ``ops/sample.py`` gives
    them; the walk over the plain alpha and the JAX sampler's noise."""
    topology = name.split("_")[0]
    ctx = core.make_context(*torch_args(*numpy_inputs(blank, cotangent)), blank)
    if topology == "classic":
        t = classic.terms(ctx)
        terms = (t.blank_lp, t.prev_tok_masked, t.diag_closed, t.diag_open)
    else:
        terms = (ctx.blank_lp, core.expected_token_lp(ctx))
    terms = tuple(x.contiguous() for x in terms)
    label = (ctx.label, ctx.label_length, ctx.blank_index)
    if "viterbi" in name:
        return terms, (), label
    alpha = (classic.alpha_scan if topology == "classic" else simplified.alpha_scan)(*terms)
    return terms, (alpha,), label + (jax_noise(topology, blank, ctx)[1],)


def cotangent_for(score, cotangent, every_row=False):
    """The cotangent of a score [B] or [S, B]: 1 on its finite entries, or a
    seeded normal draw there (on every entry with ``every_row``)."""
    finite = torch.isfinite(score)
    if cotangent == "finite_sum":
        return finite.to(score.dtype)
    draw = torch.tensor(np.random.RandomState(7).normal(size=score.shape).astype(np.float32))
    return draw if every_row else torch.where(finite, draw, 0.0)


def autograd_of_loop(name, terms, head, tail, cot):
    """Autograd through the forward's plain loop: the terms' gradients."""
    forward = FORWARD[name]
    _, vjp = torch.func.vjp(lambda *x: forward(*head, *x, *tail)[0], *terms)
    return vjp(cot)


@pytest.mark.parametrize("cotangent", COTANGENTS)
@pytest.mark.parametrize("blank", [0, 2])
@pytest.mark.parametrize("name", GRAD_OPS)
def test_plain_is_autograd_through_the_loop(name, blank, cotangent):
    terms, head, tail = op_inputs(name, blank, cotangent)
    score = FORWARD[name](*head, *terms, *tail)[0]
    cot = cotangent_for(score, cotangent)
    got = PLAIN[name](*head, *terms, *tail, cot)
    want = autograd_of_loop(name, terms, head, tail, cot)
    assert len(got) == len(terms)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)
    assert sum(float(a.abs().sum()) for a in got) > 0
    # the op on CPU tensors is its plain version
    via_op = getattr(torch.ops.ctc_port, name)(*head, *terms, *tail, cot)
    assert all(torch.equal(a, b) for a, b in zip(via_op, got))


@pytest.mark.parametrize("name", GRAD_OPS)
def test_plain_is_autograd_on_every_row(name):
    """A random cotangent on the infeasible row too, on uniform
    log-probabilities: ties of ``-inf`` against ``-inf`` split it there."""
    terms, head, tail = op_inputs(name, 0, "uniform")
    score = FORWARD[name](*head, *terms, *tail)[0]
    cot = cotangent_for(score, "random", every_row=True)
    got = PLAIN[name](*head, *terms, *tail, cot)
    for a, b in zip(got, autograd_of_loop(name, terms, head, tail, cot)):
        assert torch.equal(a, b)


def scores(kind, topology, blank, labels, ll, gl, noise=None):
    """The port's score [B] or [B, S] as a function of the log-probs."""
    if kind == "viterbi":
        return lambda x: api.ctc_forced_alignment(labels, x, ll, gl, blank, topology)[1]
    return lambda x: sample.WALKS[topology](core.make_context(labels, x, ll, gl, blank),
                                            noise)[1]


def jax_scores(kind, topology, blank, labels, ll, gl, key):
    if kind == "viterbi":
        return lambda x: jctc.ctc_forced_alignment(labels, x, ll, gl, blank, topology)[1]
    return lambda x: jctc.ctc_sample_alignments(labels, x, ll, gl, blank, key, NUM_S,
                                                topology)[1]


@pytest.mark.parametrize("cotangent", COTANGENTS)
@pytest.mark.parametrize("blank", [0, 2])
@pytest.mark.parametrize("name", GRAD_OPS)
def test_gradient_matches_jax(name, blank, cotangent):
    """The score's gradient in the log-probabilities, through the grad op,
    against ``jax.vjp`` of the JAX function under the same cotangent."""
    topology, kind = name.split("_")[:2]
    np_args = numpy_inputs(blank, cotangent)
    labels, lp, ll, gl = torch_args(*np_args)
    key, noise = jax_noise(topology, blank, core.make_context(labels, lp, ll, gl, blank))
    fn = scores(kind, topology, blank, labels, ll, gl, noise)
    score, vjp = torch.func.vjp(fn, lp)
    cot = cotangent_for(score, cotangent)
    (got,) = vjp(cot)
    n_labels, _, n_ll, n_gl = np_args
    _, jax_vjp = jax.vjp(jax_scores(kind, topology, blank, n_labels, n_ll, n_gl, key),
                         jnp.asarray(np_args[1]))
    (want,) = jax_vjp(jnp.asarray(cot.numpy()))
    assert got.abs().sum() > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATOL, atol=ATOL)


def grouped(blank):
    per = [extras_inputs(blank, seed=30 + g) for g in range(GROUPS)]
    return tuple(np.stack([p[k] for p in per]) for k in range(4))


def finite_sum(x):
    return torch.where(torch.isfinite(x), x, 0.0).sum()


def jax_finite_sum(x):
    return jnp.where(jnp.isfinite(x), x, 0.0).sum()


@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("kind", ["viterbi", "walk"])
def test_vmap_of_grad(kind, topology):
    """The fault's regression test: ``vmap(grad)`` returns, bit for bit the
    loop over the groups, within 1e-6 of ``jax.vmap(jax.grad)``."""
    blank = 0
    np_args = grouped(blank)
    labels, lp, ll, gl = (torch.tensor(a) for a in np_args)
    ctx = core.make_context(labels[0], lp[0], ll[0], gl[0], blank)
    keys = jax.random.split(jax.random.PRNGKey(11), GROUPS)
    shape = sample.noise_shape(topology, NUM_S, ctx)
    noise = torch.tensor(np.stack([np.asarray(jax.random.gumbel(k, shape)) for k in keys]))

    def score(lab, x, ll_, gl_, n):
        return finite_sum(scores(kind, topology, blank, lab, ll_, gl_, n)(x))

    got = torch.func.vmap(torch.func.grad(score, argnums=1))(labels, lp, ll, gl, noise)
    for g in range(GROUPS):
        want = torch.func.grad(score, argnums=1)(labels[g], lp[g], ll[g], gl[g], noise[g])
        assert torch.equal(got[g], want)
    assert got.abs().sum() > 0

    def jax_score(lab, x, ll_, gl_, key):
        return jax_finite_sum(jax_scores(kind, topology, blank, lab, ll_, gl_, key)(x))

    want = jax.vmap(jax.grad(jax_score, argnums=1))(*(jnp.asarray(a) for a in np_args), keys)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATOL, atol=ATOL)


class OpNames(TorchDispatchMode):
    """Records the name of every op dispatched under it."""

    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


def raising(*args, **kwargs):
    raise AssertionError("the forward's plain loop ran again in the backward")


def kind_setup(kind, topology, blank=0):
    np_args = numpy_inputs(blank, "finite_sum")
    labels, lp, ll, gl = torch_args(*np_args)
    _, noise = jax_noise(topology, blank, core.make_context(labels, lp, ll, gl, blank))
    return lp, scores(kind, topology, blank, labels, ll, gl, noise)


@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("kind", ["viterbi", "walk"])
def test_backward_runs_the_grad_op_not_the_loop(kind, topology, monkeypatch):
    lp, fn = kind_setup(kind, topology)
    x = lp.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(finite_sum(fn(x)), x)
    x = lp.clone().requires_grad_(True)
    total = finite_sum(fn(x))
    loop = getattr(align if kind == "viterbi" else sample, f"{topology}_{kind}_plain")
    monkeypatch.setattr(loop, "__code__", raising.__code__)
    with OpNames() as ops:
        (got,) = torch.autograd.grad(total, x)
    assert torch.equal(got, want)
    assert f"ctc_port.{topology}_{kind}_grad" in ops.names
    assert f"ctc_port.{topology}_{kind}" not in ops.names


@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("kind", ["viterbi", "walk"])
def test_compiled_gradient_is_eager(kind, topology):
    lp, fn = kind_setup(kind, topology)

    def total(x):
        return finite_sum(fn(x))

    x = lp.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(total(x), x)
    compiled = torch.compile(total, fullgraph=True, backend="aot_eager")
    x = lp.clone().requires_grad_(True)
    out = compiled(x)
    with OpNames() as ops:
        (got,) = torch.autograd.grad(out, x)
    assert torch.equal(got, want)
    assert f"ctc_port.{topology}_{kind}_grad" in ops.names


@pytest.mark.parametrize("name", GRAD_OPS)
def test_opcheck(name):
    terms, head, tail = op_inputs(name, 0, "random")
    cot = cotangent_for(FORWARD[name](*head, *terms, *tail)[0], "random")
    op = getattr(torch.ops.ctc_port, name)
    args = head + terms + tail + (cot,)
    torch.library.opcheck(op, args)
    with torch._subclasses.FakeTensorMode(allow_non_fake_inputs=True):
        fake = op(*args)
    assert [(f.shape, f.dtype) for f in fake] == [(t.shape, t.dtype) for t in terms]
    assert torch._C._dispatch_has_kernel_for_dispatch_key(f"ctc_port::{name}", "CUDA")


@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("kind", ["viterbi", "walk"])
def test_second_derivatives(kind, topology):
    """A derivative of the gradient runs the backward op's plain version
    again (``cuda_lattice.plain_grad``).  The scores are piecewise linear in
    the log-probabilities, so ``jacrev(grad)`` is zero, as ``jax.hessian``
    of the JAX function is; the gradient is linear in the cotangent, so
    ``jacrev`` of the VJP in its cotangent is the transposed Jacobian."""
    lp, fn = kind_setup(kind, topology)
    hess = torch.func.jacrev(torch.func.grad(lambda x: finite_sum(fn(x))))(lp)
    assert hess.shape == lp.shape + lp.shape and not hess.any()
    score, vjp = torch.func.vjp(fn, lp)
    finite = torch.isfinite(score)
    cot = torch.zeros_like(score)
    transposed = torch.func.jacrev(lambda c: vjp(torch.where(finite, c, 0.0))[0])(cot)
    jac = torch.func.jacrev(lambda x: torch.where(finite, fn(x), 0.0))(lp)
    assert torch.equal(transposed, jac.movedim(tuple(range(score.dim())),
                                               tuple(range(-score.dim(), 0))))
    assert jac.abs().sum() > 0


@pytest.mark.parametrize("lanes", range(1, 8))
def test_lane_sum_is_torch_sum_below_8_lanes(lanes):
    """``align.lane_sum``'s order is ``torch.sum``'s on the CPU at these
    widths, autograd's order for ``blank_lp``'s gradient."""
    rng = np.random.RandomState(lanes)
    x = torch.tensor((rng.normal(size=(64, 3, lanes))
                      * 10.0 ** rng.randint(-4, 5, size=(64, 3, lanes))).astype(np.float32))
    assert torch.equal(align.lane_sum(x), x.sum(-1))
