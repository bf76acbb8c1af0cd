"""The cases of ``tools/time_scans.py`` for the streamed one-chunk beta
scans: B3 (``classic_bwd_streamed``) over mode resid's residuals, B13
(``classic_bwd_half``) over mode resid1's and B7
(``simplified_bwd_streamed``) over B6 mode resid's, with the act normaliser
of that forward's loss; and for the fused d_logits epilogue B12
(``fused_dlogits``) at V=128 over the streamed classic scheme's acts.
Built here at a tiny size of ``chip_smoke.py``'s headline generator on the
CPU, where the kernel wrappers run their plain versions; B13's case must
give B3's outputs bit for bit, and B7's those of B11's residual-free case
on the same chunk, as on the card, so that one digest holds each pair
against another commit."""

import pytest
import torch

from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice as cl
from tf_seq2seq_losses_tpu_torch.ops import cuda_simplified as cs
from tf_seq2seq_losses_tpu_torch.tools import time_scans
from tf_seq2seq_losses_tpu_torch.utils.config import config_override

CPU = torch.device("cpu")
STREAMED = ("classic_bwd_streamed", "classic_bwd_half")


@pytest.fixture
def smoke(monkeypatch):
    import chip_smoke

    for name, value in (("BATCH", 8), ("MAX_T", 24), ("VOCAB", 8)):
        monkeypatch.setattr(chip_smoke, name, value)
    return chip_smoke


def test_the_streamed_cases_run_their_plain_versions(smoke, monkeypatch):
    calls = []
    for name in STREAMED:
        real = getattr(cl, f"{name}_plain")
        monkeypatch.setattr(cl, f"{name}_plain",
                            lambda *a, _n=name, _r=real: calls.append(_n) or _r(*a))
    cases = time_scans.scan_cases(smoke, torch, CPU, smoke.MAX_T, 0)
    calls.clear()  # B12's case ran B3 to make its acts
    before = [getattr(cl, name).launches for name in STREAMED]
    for name in STREAMED:
        launch, mode, lens, k_win = cases[name]
        assert mode is None and k_win == 8 and lens.shape == (8,)
        pc, f0, f1, fe = launch()
        assert pc.shape[0] == 8 and pc.shape[1] % k_win == 0
        assert f0.shape == f1.shape == fe.shape == (8, pc.shape[2])
        assert bool(torch.isfinite(pc).all()) and bool((pc != 0).any())
    assert calls == list(STREAMED)
    # plain versions count no launches
    assert [getattr(cl, name).launches for name in STREAMED] == before


def test_the_half_stream_case_gives_the_streamed_outputs(smoke):
    cases = time_scans.scan_cases(smoke, torch, CPU, smoke.MAX_T, 0)
    b3, b13 = (cases[name][0]() for name in STREAMED)
    assert all(torch.equal(a, b) for a, b in zip(b3, b13))
    assert (time_scans.digest(torch, cases["classic_bwd_half"])
            == time_scans.digest(torch, cases["classic_bwd_streamed"]))


def test_every_case_has_a_bound(smoke):
    cases = time_scans.scan_cases(smoke, torch, CPU, smoke.MAX_T, 0)
    bounds = time_scans.bound_ms(smoke, torch, CPU, smoke.MAX_T, cases)
    assert set(bounds) == set(cases) and all(ms > 0 for ms in bounds.values())
    # B13 reads half of B3's residual mantissas and a window's a0
    assert bounds["classic_bwd_half"] < bounds["classic_bwd_streamed"]
    # B7 reads one residual stream, B3 two
    assert bounds["simplified_bwd_streamed"] < bounds["classic_bwd_streamed"]
    eargs = time_scans.fused_case(smoke, torch, CPU, smoke.MAX_T)
    v_ll = smoke.make_inputs(torch, 0, CPU, vocab=smoke.SLICE_VOCAB)[2]
    assert bounds["fused_dlogits"] == smoke.bound(*smoke.fused_bound(
        eargs[5], v_ll, smoke.MAX_T, smoke.SLICE_VOCAB))[0]


def test_a_time_axis_of_several_chunks_has_no_streamed_cases(smoke):
    with config_override(chunk_time=16):
        cases = time_scans.scan_cases(smoke, torch, CPU, smoke.MAX_T, 1)
    assert not {*STREAMED, "simplified_bwd_streamed", "fused_dlogits"} & set(cases)
    assert {"classic_bwd", "simplified_bwd"} <= set(cases)


def test_the_simplified_and_fused_cases_run_their_plain_versions(smoke, monkeypatch):
    calls = []
    for module, name in ((cs, "simplified_bwd_streamed"), (cl, "fused_dlogits")):
        real = getattr(module, f"{name}_plain")
        monkeypatch.setattr(module, f"{name}_plain",
                            lambda *a, _n=name, _r=real: calls.append(_n) or _r(*a))
    cases = time_scans.scan_cases(smoke, torch, CPU, smoke.MAX_T, 0)
    calls.clear()
    before = (cs.simplified_bwd_streamed.launches, cl.fused_dlogits.launches)
    launch, mode, lens, k_win = cases["simplified_bwd_streamed"]
    assert mode is None and k_win == 8 and lens.shape == (8,)
    pd, f, fe = launch()
    assert pd.shape[0] == 8 and pd.shape[1] % k_win == 0
    assert f.shape == fe.shape == (8, pd.shape[2])
    assert bool(torch.isfinite(pd).all()) and bool((pd != 0).any())
    launch, mode, lens, k_win = cases["fused_dlogits"]
    assert mode is None and k_win is None
    (out,) = launch()
    assert out.shape == (8, smoke.MAX_T, smoke.SLICE_VOCAB)
    assert bool(torch.isfinite(out).all()) and bool((out != 0).any())
    # the infeasible rows 0 and 1 get no valid step, and exact zeros
    assert lens[:2].tolist() == [0, 0] and not bool(out[:2].any())
    assert calls == ["simplified_bwd_streamed", "fused_dlogits"]
    # plain versions count no launches
    assert (cs.simplified_bwd_streamed.launches, cl.fused_dlogits.launches) == before


def test_the_streamed_simplified_case_gives_the_residual_free_outputs(smoke):
    # B11 re-expands B6 mode resid's residuals from the window boundaries
    # (simplified_bwd_rf.cu's head comment), so on one chunk its pd and beta
    # carry are B7's bit for bit
    cases = time_scans.scan_cases(smoke, torch, CPU, smoke.MAX_T, 0)
    b7, b11 = (cases[name][0]() for name in ("simplified_bwd_streamed",
                                              "simplified_bwd"))
    assert len(b7) == len(b11) == 3
    assert all(torch.equal(a, b) for a, b in zip(b7, b11))
    assert (time_scans.digest(torch, cases["simplified_bwd_streamed"])
            == time_scans.digest(torch, cases["simplified_bwd"]))
