"""The cases of ``tools/time_scans.py`` for the log-space scans: classic B4
(``classic_log_fwd``, modes final and resid) and B5 (``classic_log_bwd``,
over mode resid's residuals), simplified B8 (``simplified_log_fwd``, modes
final and resid) and B9 (``simplified_log_bwd``, over mode resid's
residual), at the headline and on a repair round, rows 2-5 of the headline
batch flushed at one frame and gathered by the guard's own
``topology.take_ctx`` at their own lengths.  Built here at a tiny size of
``chip_smoke.py``'s headline generator on the CPU, where the kernel
wrappers run their plain versions."""

import pytest
import torch

from tf_seq2seq_losses_tpu_torch import api
from tf_seq2seq_losses_tpu_torch.ops import core, topology
from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice as cl
from tf_seq2seq_losses_tpu_torch.ops import cuda_simplified as cs
from tf_seq2seq_losses_tpu_torch.ops import log_lattice as ll
from tf_seq2seq_losses_tpu_torch.tools import time_scans
from tf_seq2seq_losses_tpu_torch.utils.config import config_override
from tf_seq2seq_losses_tpu_torch.utils.numerics import logit_to_logproba

CPU = torch.device("cpu")
LOG = ("classic_log_fwd[final]", "classic_log_fwd[resid]", "classic_log_bwd")
SLOG = ("simplified_log_fwd[final]", "simplified_log_fwd[resid]", "simplified_log_bwd")
NAMES = {"classic": LOG, "simplified": SLOG}
TOPOLOGIES = ["classic", "simplified"]


@pytest.fixture
def smoke(monkeypatch):
    import chip_smoke

    for name, value in (("BATCH", 8), ("MAX_T", 24), ("VOCAB", 8)):
        monkeypatch.setattr(chip_smoke, name, value)
    return chip_smoke


def _cases(smoke, shape, topology="classic"):
    names = NAMES[topology]
    if shape == "headline":
        cases = time_scans.scan_cases(smoke, torch, CPU, smoke.MAX_T, 0)
        return {name: cases[name] for name in names}
    make = {"classic": time_scans.log_cases,
            "simplified": time_scans.simplified_log_cases}[topology]
    return make(torch, time_scans.repair_round(smoke, torch, CPU))


@pytest.mark.parametrize("shape", ["headline", "repair_round"])
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_the_log_cases_run_their_plain_versions(smoke, topology, shape, monkeypatch):
    fwd, bwd = (getattr(ll, f"{topology}_log_{d}") for d in ("fwd", "bwd"))
    names = NAMES[topology]
    calls = []
    for name in (f"{topology}_log_fwd_plain", f"{topology}_log_bwd_plain"):
        real = getattr(ll, name)
        monkeypatch.setattr(ll, name, lambda *a, _n=name, _r=real: calls.append(_n) or _r(*a))
    cases = _cases(smoke, shape, topology)
    calls.clear()  # building the cases ran the forward's mode resid for the backward
    before = (fwd.launches, bwd.launches)
    outs = {name: cases[name][0]() for name in names}
    assert calls == [f"{topology}_log_fwd_plain", f"{topology}_log_fwd_plain",
                     f"{topology}_log_bwd_plain"]
    # plain versions count no launches
    assert (fwd.launches, bwd.launches) == before
    final, resid, back = (outs[name] for name in names)
    # mode resid's residuals, then the carries mode final gives too; the
    # backward's acts, then its beta carries
    states = len(final)
    assert states == {"classic": 2, "simplified": 1}[topology]
    assert all(torch.equal(f, r) for f, r in zip(final, resid[-states:]))
    acts = back[0]
    assert all(x.shape == acts.shape for x in resid[:-states])
    assert acts.shape[1] % 8 == 0 and len(back) == 1 + states
    assert bool(torch.isfinite(acts).all()) and bool((acts > 0).any())
    resid_mode = {"classic": "log_resid", "simplified": "slog_resid"}[topology]
    assert [cases[name][1] for name in names] == [None, resid_mode, None]


def test_the_log_resid_digest_covers_only_the_steps_each_row_runs(smoke):
    case = _cases(smoke, "headline")["classic_log_fwd[resid]"]
    launch, mode, lens, k_win = case
    sx, sa1, f0, f1 = time_scans.written(torch, launch(), mode, lens, k_win)
    past = torch.arange(sx.shape[1])[None, :] >= lens[:, None]
    assert not sx[past].any() and not sa1[past].any()
    # the steps a row runs are kept: lane 0's a1 is -inf at step 0
    assert bool(torch.isneginf(sa1[lens > 0, 0, 0]).all())
    assert time_scans.digest(torch, case) == time_scans.digest(torch, case)


def test_the_slog_resid_digest_covers_only_the_steps_each_row_runs(smoke):
    case = _cases(smoke, "headline", "simplified")["simplified_log_fwd[resid]"]
    launch, mode, lens, k_win = case
    sa, f = time_scans.written(torch, launch(), mode, lens, k_win)
    past = torch.arange(sa.shape[1])[None, :] >= lens[:, None]
    assert not sa[past].any()
    # the steps a row runs are kept, and the carry: lane 1's alpha is -inf
    # at step 0, lane 0's 0
    assert bool(torch.isneginf(sa[lens > 0, 0, 1]).all())
    assert not sa[lens > 0, 0, 0].any()
    assert torch.equal(f, launch()[1])
    assert time_scans.digest(torch, case) == time_scans.digest(torch, case)


@pytest.mark.parametrize("shape", ["headline", "repair_round"])
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_every_log_case_has_a_bound(smoke, topology, shape):
    names = NAMES[topology]
    cases = _cases(smoke, shape, topology)
    if shape == "headline":
        bounds = time_scans.bound_ms(smoke, torch, CPU, smoke.MAX_T, cases)
        lens, label_length = cases[names[0]][2], smoke.make_inputs(torch, 0, CPU)[2]
    else:
        round_ctx = time_scans.repair_round(smoke, torch, CPU)
        bounds = time_scans.bound_ms(smoke, torch, CPU, None, cases,
                                     round_ctx.label_length)
        lens, label_length = cases[names[0]][2], round_ctx.label_length
    assert set(bounds) == set(names) and all(ms > 0 for ms in bounds.values())
    # mode resid writes its residual streams (B4 two, B8 one) more; the
    # backward reads them and writes its acts
    final, resid, back = names
    assert bounds[final] < bounds[resid] < bounds[back]
    work = smoke.kernel_bounds(lens, label_length, 8)
    assert bounds == {name: smoke.bound(*work[name])[0] for name in names}


def test_the_repair_round_holds_the_gathered_rows_at_their_own_time_axis(smoke):
    labels, logits, label_length, logit_length = smoke.make_inputs(torch, 0, CPU)
    round_ctx = time_scans.repair_round(smoke, torch, CPU)
    rows = list(time_scans.ROUND_ROWS)
    num_t = int(logit_length[rows].max())
    assert num_t < smoke.MAX_T  # the round's own time axis, not the batch's
    # their lengths are kept
    assert torch.equal(round_ctx.logit_length, logit_length[rows].long())
    assert torch.equal(round_ctx.label_length, label_length[rows].long())
    flushed = time_scans.flushed(labels, logits)
    full = core.make_context(labels, logit_to_logproba(flushed, 2), label_length,
                             logit_length, 0)
    for name in full._fields:
        ours, theirs = getattr(round_ctx, name), getattr(full, name)
        if name == "blank_index":
            assert torch.equal(ours, theirs)
        elif name in ("logproba", "raw_logproba", "logit_length_mask", "blank_lp"):
            assert torch.equal(ours, theirs[rows, :num_t])
        else:
            assert torch.equal(ours, theirs[rows])
    # only the rows of the round are flushed, at one frame
    changed = (flushed != logits).any(2)
    assert changed.nonzero().tolist() == [[r, time_scans.FLUSH_FRAME] for r in rows]
    # the B4, B5, B8 and B9 cases run on the round's rows, lengths and time
    # axis
    tpad = -(-num_t // 8) * 8
    assert ll._log_inputs(round_ctx)[1].shape[:2] == (4, tpad)
    assert ll.simplified_log_inputs(round_ctx)[1].shape[:2] == (4, tpad)
    cases = {**time_scans.log_cases(torch, round_ctx),
             **time_scans.simplified_log_cases(torch, round_ctx)}
    for launch, _mode, lens, _k_win in cases.values():
        assert torch.equal(lens, logit_length[rows])
        assert launch()[0].shape[0] == 4


@pytest.mark.parametrize("topology_name", TOPOLOGIES)
def test_the_flushed_rows_are_what_the_guard_repairs_in_one_round(smoke, topology_name,
                                                                   monkeypatch):
    labels, logits, label_length, logit_length = smoke.make_inputs(torch, 0, CPU)
    flushed = time_scans.flushed(labels, logits)
    ctx = core.make_context(labels, logit_to_logproba(flushed, 2), label_length,
                            logit_length, 0)
    loss_fast = {"classic": cl.classic_loss_fast,
                 "simplified": cs.simplified_loss_fast}[topology_name]
    with config_override(use_kernels=True):
        fast = loss_fast(ctx)
    feasible = topology.TOPOLOGIES[topology_name].feasible(ctx)
    flushed_rows = torch.nonzero(torch.isposinf(fast) & feasible)[:, 0].tolist()
    assert flushed_rows == list(time_scans.ROUND_ROWS)
    # the guard's one repair round holds the rows of the cases (shortest
    # first; each row is a CTA of its own), and its loss is B4 final's (B8
    # final's) on them, bit for bit
    rounds = []
    real = topology.take_ctx
    monkeypatch.setattr(topology, "take_ctx",
                        lambda c, idx: rounds.append(idx.tolist()) or real(c, idx))
    fn = {"classic": api.classic_ctc_loss, "simplified": api.simplified_ctc_loss}[
        topology_name]
    with config_override(use_kernels=True):
        loss = fn(labels, flushed, label_length, logit_length, 0)
    assert len(rounds) == 1 and sorted(rounds[0]) == list(time_scans.ROUND_ROWS)
    round_ctx = time_scans.repair_round(smoke, torch, CPU)
    if topology_name == "classic":
        case = time_scans.log_cases(torch, round_ctx)["classic_log_fwd[final]"]
        exact = ll._pick_log_loss(*case[0](), round_ctx.label_length)
    else:
        case = time_scans.simplified_log_cases(torch, round_ctx)[
            "simplified_log_fwd[final]"]
        exact = ll._pick_single_log_loss(case[0]()[0], round_ctx.label_length)
    assert torch.equal(loss[list(time_scans.ROUND_ROWS)], exact)
    assert bool(torch.isfinite(exact).all())


def test_a_time_axis_of_several_chunks_has_no_log_cases(smoke):
    with config_override(chunk_time=16):
        cases = time_scans.scan_cases(smoke, torch, CPU, smoke.MAX_T, 1)
    assert not (set(LOG) | set(SLOG)) & set(cases)


def test_the_precision_tool_measures_the_log_repair_against_float64():
    from tf_seq2seq_losses_tpu_torch.tools import log_precision

    short, longer = (log_precision.row_error(torch, 0, t, u, CPU)
                     for t, u in ((40, 19), (160, 79)))
    assert (short["T"], short["label_length"], short["lanes"]) == (40, 19, 32)
    assert longer["lanes"] == 96
    # float32 carries lose digits as the loss grows with T: a short row is
    # repaired within the 2e-4 that PERF.md section 2 gives the log-space
    # repair, the gradient's error grows with the row
    assert longer["loss64"] > short["loss64"] > 0
    assert 0.0 < short["grad_max_abs_err"] < longer["grad_max_abs_err"]
    assert short["grad_max_abs_err"] < 2e-4
    assert short["loss_rel_err"] < 1e-6 and longer["loss_rel_err"] < 1e-6
