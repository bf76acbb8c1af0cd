"""The cases of ``tools/time_scans.py`` for the streamed one-chunk beta
scans: B3 (``classic_bwd_streamed``) over mode resid's residuals and B13
(``classic_bwd_half``) over mode resid1's, with the act normaliser of that
forward's loss.  Built here at a tiny size of ``chip_smoke.py``'s headline
generator on the CPU, where the kernel wrappers run their plain versions;
B13's case must give B3's outputs bit for bit, as on the card, so that one
digest holds both against another commit."""

import pytest
import torch

from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice as cl
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


def test_a_time_axis_of_several_chunks_has_no_streamed_cases(smoke):
    with config_override(chunk_time=16):
        cases = time_scans.scan_cases(smoke, torch, CPU, smoke.MAX_T, 1)
    assert not set(STREAMED) & set(cases)
    assert {"classic_bwd", "simplified_bwd"} <= set(cases)
