"""The HVP's tangent scans (``ops/pure_scan.py``: ``classic_alpha_jvp64``,
``classic_beta_jvp64``, ``simplified_alpha_jvp64``, ``simplified_beta_jvp64``)
on the CPU, where each op runs its plain version, the loop over (value,
tangent) pairs (``classic.alpha_scan_jvp`` and ``beta_scan_jvp``,
``simplified.alpha_scan_jvp`` and ``beta_scan_jvp``).

The plain versions are held bit for bit to ``torch.func.jvp`` of the loops
they extend (``alpha_scan``, ``beta_scan``) on the float64 contexts of
``tests/test_torch_port_pure_scan.py`` (-inf logits, an infeasible row, a
``label_length`` of 0, one step), with the tangents that the HVP gives the
terms (``hvp.scan_inputs``) and with N(0, 1) tangents on every entry, -inf
ones included, where the classic lattices keep nonzero tangents on -inf
entries that the kernels must write alike; their values are the float64
scans' bits.  The ops run through ``torch.library.opcheck``, their fakes
give the outputs' shapes, ``vmap`` folds the groups into one call of the
op, float32 terms are refused, each op has a CUDA kernel registered, and
the shared-memory mirrors give 64 and 32 bytes a lane.  The kernels run on
the card only (``chip_smoke.py`` phase 15).
"""

import numpy as np
import pytest
import torch

from tests.test_torch_port_compile import fresh_dynamo  # noqa: F401 (autouse)
from tests.test_torch_port_pure_scan import CASES, assert_same, context
from tf_seq2seq_losses_tpu_torch.ops import _build, classic, core, hvp, pure_scan
from tf_seq2seq_losses_tpu_torch.ops import simplified

PURE = {"classic": classic, "simplified": simplified}
JVP_OPS = ("classic_alpha_jvp64", "classic_beta_jvp64", "simplified_alpha_jvp64",
           "simplified_beta_jvp64")
TANGENTS = ("hvp", "random")


def scan_args(topology, case, tangents="hvp", seed=5):
    """``(terms, their tangents, label_length)`` of ``topology``'s tangent
    scans on the float64 form of ``case``'s context: the HVP's tangents
    along a N(0, 1) vector, or N(0, 1) tangents on every entry."""
    ctx = context(case)
    rng = np.random.RandomState(seed)
    vector = torch.tensor(rng.normal(size=ctx.logproba.shape), dtype=torch.float32)
    c64, _, terms, t_terms = hvp.scan_inputs(topology, ctx, vector)
    if tangents == "random":
        t_terms = tuple(torch.tensor(rng.normal(size=t.shape)) for t in terms)
    contiguous = tuple(t.contiguous() for t in terms + t_terms)
    n = len(terms)
    return contiguous[:n], contiguous[n:], c64.label_length


@pytest.mark.parametrize("tangents", TANGENTS)
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("topology", ["classic", "simplified"])
def test_plain_versions_are_jvp_of_the_loops(topology, case, tangents):
    pure = PURE[topology]
    terms, t_terms, lab = scan_args(topology, case, tangents)
    alpha = pure.alpha_scan_jvp(*terms, *t_terms)
    beta = pure.beta_scan_jvp(*terms, *t_terms, lab)
    want_alpha = torch.func.jvp(pure.alpha_scan, terms, t_terms)
    want_beta = torch.func.jvp(lambda *t: pure.beta_scan(*t, lab), terms, t_terms)
    for got, want in zip(alpha + beta, want_alpha + want_beta):
        assert_same(got, want)
    # the values are the float64 scans'
    assert_same(alpha[0], pure.alpha_scan(*terms))
    assert_same(beta[0], pure.beta_scan(*terms, lab))
    # the ops run the plain versions on CPU tensors
    ops = hvp.SCANS[topology]
    for got, want in zip(ops[0](*terms, *t_terms) + ops[1](*terms, *t_terms, lab),
                         alpha + beta):
        assert_same(got, want)
    if tangents == "random" and topology == "classic":
        # -inf entries whose tangent is not 0: the kernels write them too
        assert bool(((alpha[1] != 0) & torch.isneginf(alpha[0])).any())


def op_args(name):
    terms, t_terms, lab = scan_args(name.split("_")[0], "neg_inf_logits")
    return terms + t_terms + ((lab,) if "beta" in name else ())


@pytest.mark.parametrize("name", JVP_OPS)
def test_op_check_and_fake(name):
    op = getattr(torch.ops.ctc_port, name)
    args = op_args(name)
    torch.library.opcheck(op, args)
    want = op(*args)
    with torch._subclasses.FakeTensorMode(allow_non_fake_inputs=True):
        fake = op(*args)
    for f, w in zip(fake, want):
        assert (f.shape, f.dtype) == (w.shape, w.dtype)


@pytest.mark.parametrize("name", JVP_OPS)
def test_vmap_folds_the_groups_into_one_call(name, monkeypatch):
    """``vmap`` over two groups of the batch calls the op once on the
    folded batch (its label lengths mapped too), bit for bit."""
    args = op_args(name)
    want = getattr(pure_scan, name)(*args)
    calls = []
    plain = getattr(PURE[name.split("_")[0]],
                    ("alpha" if "alpha" in name else "beta") + "_scan_jvp")

    def spy(*a):
        calls.append(a[0].shape[0])
        return plain(*a)

    monkeypatch.setattr(PURE[name.split("_")[0]], plain.__name__, spy)
    got = torch.func.vmap(getattr(pure_scan, name))(*(a.unflatten(0, (2, -1))
                                                      for a in args))
    assert calls == [args[0].shape[0]]
    for g, w in zip(got, want):
        assert_same(g.flatten(0, 1), w)


@pytest.mark.parametrize("name", JVP_OPS)
def test_op_has_a_cuda_kernel(name):
    assert torch._C._dispatch_has_kernel_for_dispatch_key(f"ctc_port::{name}", "CUDA")


def test_float32_terms_and_tangents_are_refused():
    terms, t_terms, _ = scan_args("simplified", "random")
    with pytest.raises(TypeError, match="float64"):
        pure_scan.simplified_alpha_jvp64(*terms, t_terms[0].float(), t_terms[1])
    terms, t_terms, lab = scan_args("classic", "random")
    with pytest.raises(TypeError, match="float64"):
        pure_scan.classic_beta_jvp64(*(t.float() for t in terms), *t_terms, lab)


def test_shared_memory_of_the_staged_tangent_scans():
    """Two carries of a value and a tangent a state: 64 bytes a lane
    classic, 32 simplified, so an H100's 232448 bytes hold 3632 and 7264
    lanes, half the float64 scans'."""
    for name, per_lane, widest in (("classic_jvp64", 64, 3632),
                                   ("simplified_jvp64", 32, 7264)):
        assert _build.SMEM_BYTES[name](100, 0) == 100 * per_lane
        assert _build.fits((name,), widest, 0, torch.device("cpu"))
        assert not _build.fits((name,), widest + 1, 0, torch.device("cpu"))
        pure64 = name.replace("jvp64", "pure64")
        assert _build.SMEM_BYTES[name](widest, 0) == 2 * _build.SMEM_BYTES[pure64](widest, 0)


@pytest.fixture
def smoke(monkeypatch):
    import chip_smoke

    for name, value in (("BATCH", 8), ("MAX_T", 24), ("VOCAB", 8), ("LONG_T", 40)):
        monkeypatch.setattr(chip_smoke, name, value)
    return chip_smoke


@pytest.mark.parametrize("shape", ["hvp_rows", "hvp_long_t_row"])
def test_the_timing_tools_tangent_cases(smoke, shape):
    """``tools/time_scans.py``'s cases of the four tangent scans at a tiny
    size of ``chip_smoke.py``'s generators: each case's outputs are the
    plain versions', each bound positive."""
    from tf_seq2seq_losses_tpu_torch.tools import time_scans

    cpu = torch.device("cpu")
    ctx, vector = time_scans.hvp_case(smoke, torch, cpu, shape)
    cases = time_scans.jvp64_cases(smoke, ctx, vector)
    assert set(cases) == set(JVP_OPS)
    for name, (_kern, plain, args) in smoke.jvp64_args(ctx, vector).items():
        launch = cases[name][0]
        for got, want in zip(launch(), plain(*args)):
            assert_same(got, want)
        assert len(time_scans.digest(torch, cases[name])) == 16
    bounds = time_scans.jvp64_bounds(smoke, ctx, vector, shape)
    assert set(bounds) == {f"{name} {shape}" for name in JVP_OPS}
    assert all(ms > 0 for ms in bounds.values())
    assert ctx.logproba.shape[0] == (smoke.HVP_ROWS if shape == "hvp_rows" else 2)
    assert core.float64_context(ctx).logproba.dtype == torch.float64
