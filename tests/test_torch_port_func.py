"""The port's loss under ``torch.func`` against the JAX package's loss under
its transforms, after tests/test_vmap.py, tests/test_logits_vjp.py and
tests/test_hessian.py.

``torch.func.vmap`` over the four loss entry points and over
``torch.func.grad``, with labels mapped and shared, against ``jax.vmap``
(and ``jax.grad``) on the JAX package's pure path: atol 1e-5; and bit for
bit against a loop of the port's own calls (CTC is elementwise over the
batch, and the folded call's clean rows are the loop's).  ``grad`` bit for
bit ``.backward()`` (and ``create_graph=True``) on the kernel path under
every guard placement, fused and unfused.  ``jacrev(grad)`` at the
log-probability and logits levels against ``jax.jacrev(jax.grad)``: atol
1e-5 (tests/test_hessian.py's kernel test holds JAX to 1e-4; the port's
Hessian is the pure path's on every route, so it meets the tighter one);
its diagonal batch blocks are ``ctc_loss_hessian``'s bit for bit, the
blocks across rows exactly 0, and it is the same with the fusion on and off.  A third
derivative raises ``NotImplementedError``, forward mode (``jvp``,
``jacfwd``, ``hessian``, ``forward_ad`` dual tensors) ``TypeError``.
Infeasible rows keep ``+inf`` and zero gradient; saturated rows repaired
by the guard are 2e-4 from the pure path (the log-space repair's
tolerance); under ``guard_struct="cond"`` the folded batch's tier is the
result.  ``use_kernels=True`` runs the kernels' plain versions on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import forward_ad
from torch.func import grad, jacfwd, jacrev, jvp, vjp, vmap

import tf_seq2seq_losses_tpu as jctc
from tf_seq2seq_losses_tpu.utils.config import config_override as jax_config
from tf_seq2seq_losses_tpu_torch import api
from tf_seq2seq_losses_tpu_torch.ops import core, cuda_lattice, log_lattice
from tf_seq2seq_losses_tpu_torch.ops.topology import TOPOLOGIES as TOPOLOGY_OBJECTS
from tf_seq2seq_losses_tpu_torch.utils.config import config_override

THIRD = "Third order derivative over the ctc loss function is not implemented."
TOPOLOGIES = ["classic", "simplified"]
# tests/test_vmap.py's shapes
G, B, T, V, L = 3, 2, 6, 4, 3


def _stacked(seed=0):
    """tests/test_vmap.py's stacked inputs, with row 0 of group 1 infeasible
    in both topologies (three labels, one frame); logits and their
    log-softmax, both float32."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(1, V, (G, B, L)).astype(np.int32)
    logits = rng.randn(G, B, T, V).astype(np.float32)
    ll = rng.randint(1, L + 1, (G, B)).astype(np.int32)
    gl = rng.randint(3, T + 1, (G, B)).astype(np.int32)
    ll[1, 0], gl[1, 0] = L, 1
    return labels, logits, _log_softmax(logits), ll, gl


def _log_softmax(x):
    m = x.max(axis=-1, keepdims=True)
    return (x - m - np.log(np.exp(x - m).sum(axis=-1, keepdims=True))).astype(np.float32)


def _fns(entry, topology):
    """``(port, jax, level)``: the entry point's loss as ``f(labels, x,
    label_length, logit_length)`` in both packages, and whether ``x`` is
    logits or log-probabilities."""
    if entry == "named":
        port = {"classic": api.classic_ctc_loss, "simplified": api.simplified_ctc_loss}
        jfn = {"classic": jctc.classic_ctc_loss, "simplified": jctc.simplified_ctc_loss}
        return (lambda la, x, a, b: port[topology](la, x, a, b, 0),
                lambda la, x, a, b: jfn[topology](la, x, a, b, 0), "logits")
    port = {"ctc_loss": api.ctc_loss,
            "ctc_loss_from_logproba": api.ctc_loss_from_logproba}[entry]
    jfn = {"ctc_loss": jctc.ctc_loss,
           "ctc_loss_from_logproba": jctc.ctc_loss_from_logproba}[entry]
    level = "logits" if entry == "ctc_loss" else "logproba"
    return (lambda la, x, a, b: port(la, x, a, b, 0, topology),
            lambda la, x, a, b: jfn(la, x, a, b, 0, topology=topology), level)


def _finite_sum(loss):
    return torch.where(torch.isfinite(loss), loss, torch.zeros_like(loss)).sum()


def _jax_finite_sum(loss):
    return jnp.sum(jnp.where(jnp.isfinite(loss), loss, 0.0))


def _values(level, inputs):
    labels, logits, lp, ll, gl = inputs
    return labels, (logits if level == "logits" else lp), ll, gl


@functools.lru_cache(maxsize=None)
def _jax_vmap(entry, topology, what, shared=False):
    """``jax.vmap`` of the loss (``what="loss"``) or of the gradient of its
    finite sum, on the JAX package's pure path; labels and lengths of
    group 0 shared across the groups where ``shared``."""
    _, jfn, level = _fns(entry, topology)
    labels, x, ll, gl = _values(level, _stacked())
    if what == "grad":
        one = jax.grad(lambda x_, la, a, b: _jax_finite_sum(jfn(la, x_, a, b)))
    else:
        def one(x_, la, a, b):
            return jfn(la, x_, a, b)
    axes = (0, None, None, None) if shared else 0
    args = (x, labels[0], ll[0], gl[0]) if shared else (x, labels, ll, gl)
    with jax_config(use_pallas=False):
        return np.asarray(jax.vmap(one, in_axes=axes)(*map(jnp.asarray, args)))


def _assert_matches_jax(got, want, atol=1e-5):
    got = got.detach().numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=atol)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("entry", ["named", "ctc_loss", "ctc_loss_from_logproba"])
def test_vmap_loss(entry, topology, use_kernels):
    port, _, level = _fns(entry, topology)
    labels, x, ll, gl = map(torch.tensor, _values(level, _stacked()))
    with config_override(use_kernels=use_kernels):
        got = vmap(lambda x_, la, a, b: port(la, x_, a, b))(x, labels, ll, gl)
        loop = torch.stack([port(labels[i], x[i], ll[i], gl[i]) for i in range(G)])
    assert got.shape == (G, B)
    assert torch.equal(got, loop)
    assert torch.isposinf(got[1, 0])
    _assert_matches_jax(got, _jax_vmap(entry, topology, "loss"))


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("entry", ["named", "ctc_loss_from_logproba"])
def test_vmap_grad(entry, topology, use_kernels):
    port, _, level = _fns(entry, topology)
    labels, x, ll, gl = map(torch.tensor, _values(level, _stacked()))
    with config_override(use_kernels=use_kernels):
        got = vmap(grad(lambda x_, la, a, b: _finite_sum(port(la, x_, a, b))))(
            x, labels, ll, gl)
        loop = []
        for i in range(G):
            xi = x[i].clone().requires_grad_(True)
            _finite_sum(port(labels[i], xi, ll[i], gl[i])).backward()
            loop.append(xi.grad)
    assert torch.equal(got, torch.stack(loop))
    assert (got[1, 0] == 0).all()
    _assert_matches_jax(got, _jax_vmap(entry, topology, "grad"))


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_vmap_shared_labels(topology, use_kernels):
    """Labels and lengths not mapped (``in_dims=None``): the fold expands
    them over the groups."""
    port, _, _ = _fns("named", topology)
    labels, x, _, ll, gl = map(torch.tensor, _stacked())
    shared = (labels[0], ll[0], gl[0])
    dims = (0, None, None, None)
    with config_override(use_kernels=use_kernels):
        loss = vmap(lambda x_, la, a, b: port(la, x_, a, b), in_dims=dims)(x, *shared)
        d_x = vmap(grad(lambda x_, la, a, b: _finite_sum(port(la, x_, a, b))),
                   in_dims=dims)(x, *shared)
        loop = torch.stack([port(*shared[:1], x[i], *shared[1:]) for i in range(G)])
    assert torch.equal(loss, loop)
    _assert_matches_jax(loss, _jax_vmap("named", topology, "loss", shared=True))
    _assert_matches_jax(d_x, _jax_vmap("named", topology, "grad", shared=True))


def test_vmap_mapped_blank_raises():
    port = api.ctc_loss_from_logproba
    labels, _, lp, ll, gl = map(torch.tensor, _stacked())
    with pytest.raises(ValueError, match="blank_index"):
        vmap(lambda x_, la, a, b, k: port(la, x_, a, b, k))(
            lp, labels, ll, gl, torch.zeros(G, dtype=torch.int64))


def test_vmap_then_backward_trains_once(monkeypatch):
    """``vmap`` of the loss on logits that require grad, then plain
    ``.backward()``: the folded forward keeps its pack (mode resid, no
    second forward in the backward), and the gradient is the loop's."""
    modes = []
    real = cuda_lattice.classic_fwd

    def spy(*a):
        modes.append(a[-1])
        return real(*a)

    monkeypatch.setattr(cuda_lattice, "classic_fwd", spy)
    port, _, _ = _fns("named", "classic")
    labels, logits, _, ll, gl = map(torch.tensor, _stacked())
    with config_override(use_kernels=True):
        x = logits.clone().requires_grad_(True)
        _finite_sum(vmap(lambda x_, la, a, b: port(la, x_, a, b))(x, labels, ll, gl)
                    ).backward()
        assert modes == ["resid"]
        loop = []
        for i in range(G):
            xi = logits[i].clone().requires_grad_(True)
            _finite_sum(port(labels[i], xi, ll[i], gl[i])).backward()
            loop.append(xi.grad)
    assert torch.equal(x.grad, torch.stack(loop))


# ---- grad against .backward() on the kernel path ----------------------------

N_FLUSHED, BATCH = 3, 8
WEIGHTS = torch.arange(1.0, BATCH + 1.0)


def _flushed(n_flushed=N_FLUSHED, batch=BATCH, seed=0):
    """tests/test_guard_modes.py's batch: the first ``n_flushed`` rows flush
    (logits 100 on a token outside the label), the last is infeasible."""
    rand = np.random.RandomState(seed)
    logits = rand.randn(batch, T, V).astype(np.float32)
    logits[:n_flushed] = 0.0
    logits[:n_flushed, :, V - 1] = 100.0
    labels = np.tile(np.array([[1, 2]], np.int32), (batch, 1))
    gl = np.full((batch,), T, np.int32)
    gl[-1] = 1
    return labels, logits, np.full((batch,), 2, np.int32), gl


@pytest.mark.parametrize("guard_mode", ["post", "pre", "grad"])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_grad_equals_backward(topology, fused, guard_mode):
    """``torch.func.grad``, ``torch.func.vjp`` and ``create_graph=True``
    take the same route as ``.backward()``: the d_logits bit for bit."""
    port, _, _ = _fns("named", topology)
    labels, logits, ll, gl = map(torch.tensor, _flushed())

    def scalar(x):
        return (torch.where(torch.isfinite(loss := port(labels, x, ll, gl)), loss,
                            torch.zeros_like(loss)) * WEIGHTS).sum()

    with config_override(use_kernels=True, fused_epilogue=fused, guard_mode=guard_mode):
        x = logits.clone().requires_grad_(True)
        scalar(x).backward()
        x2 = logits.clone().requires_grad_(True)
        (d_graph,) = torch.autograd.grad(scalar(x2), x2, create_graph=True)
        d_func = grad(scalar)(logits)
        total, pullback = vjp(scalar, logits)
        (d_vjp,) = pullback(torch.ones_like(total))
    assert torch.equal(d_func, x.grad)
    assert torch.equal(d_vjp, x.grad)
    assert torch.equal(d_graph.detach(), x.grad)
    assert (x.grad[-1] == 0).all()


# ---- the Hessian -------------------------------------------------------------

def _hessian_inputs(topology):
    """tests/test_logits_vjp.py's batch: two rows of T=5, V=3."""
    labels = np.array([[1, 2, 2, 1], [1, 2, 1, 0]], np.int32)
    logits = np.random.RandomState(0).randn(2, 5, 3).astype(np.float32)
    return labels, logits, _log_softmax(logits), np.array([4, 3], np.int32), \
        np.array([5, 4], np.int32)


@functools.lru_cache(maxsize=None)
def _jax_hessian(entry, topology):
    _, jfn, level = _fns(entry, topology)
    labels, x, ll, gl = _values(level, _hessian_inputs(topology))
    with jax_config(use_pallas=False):
        return np.asarray(jax.jacrev(jax.grad(
            lambda x_: _jax_finite_sum(jfn(labels, x_, ll, gl))))(jnp.asarray(x)))


def _port_hessian(entry, topology, **cfg):
    port, _, level = _fns(entry, topology)
    labels, x, ll, gl = map(torch.tensor, _values(level, _hessian_inputs(topology)))
    with config_override(**cfg):
        return jacrev(grad(lambda x_: _finite_sum(port(labels, x_, ll, gl))))(x)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("entry", ["named", "ctc_loss_from_logproba"])
def test_hessian_matches_jax(entry, topology, use_kernels):
    hess = _port_hessian(entry, topology, use_kernels=use_kernels)
    np.testing.assert_allclose(hess.numpy(), _jax_hessian(entry, topology), atol=1e-5)
    for b in range(2):
        assert (hess[b, :, :, 1 - b] == 0).all()
    if entry == "ctc_loss_from_logproba":
        labels, _, lp, ll, gl = map(torch.tensor, _hessian_inputs(topology))
        blocks = api.ctc_loss_hessian(labels, lp, ll, gl, 0, topology)
        for b in range(2):
            assert torch.equal(hess[b, :, :, b], blocks[b])


def _float64_loss(labels, x, ll, gl, topology, level):
    """The pure path's loss in float64 (PyTorch's autograd through the
    recursions: an oracle independent of the analytic chain)."""
    lp = torch.log_softmax(x, 2) if level == "logits" else x
    c = core.float64_context(core.make_context(labels, lp, ll, gl, 0))
    return TOPOLOGY_OBJECTS[topology].pure_loss(c)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("entry", ["named", "ctc_loss_from_logproba"])
def test_hessian_of_squared_loss(entry, topology, use_kernels):
    """The sum of squared losses: the cotangent ``d_loss = 2 loss`` depends
    on the input, so the second derivative also flows through the
    cotangent's slot (``DLogits``'s ``d_loss``, ``Loss``'s product).  Held
    to the double backward of the pure path in float64 (rtol 1e-5, atol
    3e-5: a Hessian entry carries 2 loss, about 10, times the analytic
    Hessian's float32 rounding).  The JAX package's ``jacrev(grad)`` lacks
    exactly the term ``2 g g^T`` there (its custom_vjp forward computes the
    loss on ``stop_gradient``'ed inputs, so an outer derivative sees the
    loss as a constant): JAX's plus ``2 g g^T`` meets the same tolerance."""
    port, jfn, level = _fns(entry, topology)
    labels, x, ll, gl = _values(level, _hessian_inputs(topology))
    with jax_config(use_pallas=False):
        jax_hess = jax.jacrev(jax.grad(
            lambda x_: jnp.sum(jfn(labels, x_, ll, gl) ** 2)))(jnp.asarray(x))
    labels, x, ll, gl = map(torch.tensor, (labels, x, ll, gl))
    with config_override(use_kernels=use_kernels):
        hess = jacrev(grad(lambda x_: (port(labels, x_, ll, gl) ** 2).sum()))(x)
    x64 = x.double()
    want = torch.autograd.functional.hessian(
        lambda x_: (_float64_loss(labels, x_, ll, gl, topology, level) ** 2).sum(), x64)
    g64 = torch.autograd.functional.jacobian(
        lambda x_: _float64_loss(labels, x_, ll, gl, topology, level), x64)
    outer = 2 * torch.einsum("bijk,blmn->ijklmn", g64, g64)
    np.testing.assert_allclose(hess.numpy(), want.numpy(), rtol=1e-5, atol=3e-5)
    np.testing.assert_allclose(np.asarray(jax_hess) + outer.numpy(), want.numpy(),
                               rtol=1e-5, atol=3e-5)


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_hessian_same_with_fusion_on_and_off(topology):
    fused = _port_hessian("named", topology, use_kernels=True, fused_epilogue=True)
    unfused = _port_hessian("named", topology, use_kernels=True, fused_epilogue=False)
    assert torch.equal(fused, unfused)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("entry", ["named", "ctc_loss_from_logproba"])
def test_third_derivative_raises(entry, use_kernels):
    port, _, level = _fns(entry, "classic")
    labels, x, ll, gl = map(torch.tensor, _values(level, _hessian_inputs("classic")))
    with config_override(use_kernels=use_kernels), \
            pytest.raises(NotImplementedError, match=THIRD):
        jacrev(jacrev(grad(lambda x_: _finite_sum(port(labels, x_, ll, gl)))))(x)


def _dual_call(scalar, x):
    with forward_ad.dual_level():
        return scalar(forward_ad.make_dual(x, torch.ones_like(x)))


@pytest.mark.parametrize("transform", ["jvp", "jacfwd", "hessian", "forward_ad"])
def test_forward_mode_raises(transform):
    port, _, _ = _fns("named", "classic")
    labels, x, _, ll, gl = map(torch.tensor, _hessian_inputs("classic"))

    def scalar(x_):
        return _finite_sum(port(labels, x_, ll, gl))

    call = {"jvp": lambda: jvp(scalar, (x,), (torch.ones_like(x),)),
            "jacfwd": lambda: jacfwd(scalar)(x),
            "hessian": lambda: torch.func.hessian(scalar)(x),
            "forward_ad": lambda: _dual_call(scalar, x)}[transform]
    with pytest.raises(TypeError, match="forward-mode"):
        call()


# ---- infeasible and saturated rows, and the guard's tier under vmap ---------

@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_vmap_infeasible_rows(topology, use_kernels):
    """Row 0 of every group is infeasible (three labels over two frames;
    classic repeats need more): +inf loss and exactly zero gradient."""
    port, _, _ = _fns("named", topology)
    labels, logits, _, ll, gl = _stacked(seed=1)
    ll[:, 0], gl[:, 0] = L, 2
    labels, x, ll, gl = map(torch.tensor, (labels, logits, ll, gl))
    with config_override(use_kernels=use_kernels):
        loss = vmap(lambda x_, la, a, b: port(la, x_, a, b))(x, labels, ll, gl)
        d_x = vmap(grad(lambda x_, la, a, b: _finite_sum(port(la, x_, a, b))))(
            x, labels, ll, gl)
    assert torch.isposinf(loss[:, 0]).all() and torch.isfinite(loss[:, 1]).all()
    assert (d_x[:, 0] == 0).all() and (d_x[:, 1] != 0).any()


def _grouped(groups, n_flushed):
    """``groups`` groups of :func:`_flushed` batches of 4 rows, the first
    ``n_flushed`` of each saturated."""
    parts = [_flushed(n_flushed, batch=4, seed=g) for g in range(groups)]
    return [torch.tensor(np.stack(a)) for a in zip(*parts)]


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_vmap_saturated_rows(topology):
    """The guard repairs the flushed rows of the folded batch: loss and
    gradient 2e-4 from the pure path, as the log-space repair is held."""
    port, _, _ = _fns("named", topology)
    labels, logits, ll, gl = _grouped(2, 2)
    step = vmap(grad(lambda x_, la, a, b: _finite_sum(port(la, x_, a, b))))
    with config_override(use_kernels=True):
        loss = vmap(port)(labels, logits, ll, gl)
        d_x = step(logits, labels, ll, gl)
    with config_override(use_kernels=False):
        p_loss = vmap(port)(labels, logits, ll, gl)
        p_d = step(logits, labels, ll, gl)
    assert torch.isfinite(loss[:, :2]).all()
    np.testing.assert_allclose(loss.numpy(), p_loss.numpy(), atol=2e-4)
    np.testing.assert_allclose(d_x.numpy(), p_d.numpy(), atol=2e-4)


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_vmap_cond_takes_the_folded_batch_tier(topology, monkeypatch):
    """Under ``guard_struct="cond"`` with repair buckets of 2 and 4, each
    group of 4 rows has 3 flushed (tier 2: a gathered round of 3 rows);
    folded, the 6 flushed rows of 8 exceed the bucket and the whole batch
    is rerouted.  The vmap result is the folded call's, bit for bit."""
    port, _, _ = _fns("named", topology)
    labels, logits, ll, gl = _grouped(2, 3)
    name = f"{topology}_log_fwd"
    rows, real = [], getattr(log_lattice, name)

    def spy(*a):
        rows.append(a[0].shape[0])
        return real(*a)

    monkeypatch.setattr(log_lattice, name, spy)
    step = grad(lambda x_, la, a, b: _finite_sum(port(la, x_, a, b)))
    with config_override(use_kernels=True, guard_struct="cond", repair_bucket=2,
                         repair_bucket2=4):
        loss = vmap(port)(labels, logits, ll, gl)
        d_x = vmap(step)(logits, labels, ll, gl)
        assert rows and set(rows) == {8}
        folded = [t.flatten(0, 1) for t in (labels, logits, ll, gl)]
        f_loss = port(*folded)
        f_d = step(folded[1], folded[0], *folded[2:])
        del rows[:]
        port(labels[0], logits[0], ll[0], gl[0])
        assert set(rows) == {3}
    assert torch.equal(loss.flatten(), f_loss)
    assert torch.equal(d_x.flatten(0, 1), f_d)
