"""The port's utils (profiling, debug guard, roofline model) and its entry
point, against the JAX package's ``utils`` where they compute the same
thing.  The debug guard's loss is the loss: rtol 1e-5, the tolerance of
the port's loss tests."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_seq2seq_losses_tpu.utils.debug import checked_ctc_loss as jax_checked
from tf_seq2seq_losses_tpu_torch import utils
from tf_seq2seq_losses_tpu_torch.entry import entry
from tf_seq2seq_losses_tpu_torch.utils import roofline as R
from tf_seq2seq_losses_tpu_torch.utils.config import KernelConfig
from tf_seq2seq_losses_tpu_torch.utils.debug import CheckError, checked_ctc_loss
from tf_seq2seq_losses_tpu_torch.utils.profiling import annotate, block_ms, trace_to

B, T, V, LP1 = 256, 500, 32, 251  # the headline: labels [256, 250]


def debug_inputs():
    rng = np.random.RandomState(0)
    labels = np.array([[1, 2], [2, 0]], np.int32)
    logits = rng.randn(2, 4, 3).astype(np.float32)
    return labels, logits, np.array([2, 1], np.int32), np.array([4, 3], np.int32)


def test_utils_exports_the_config_names():
    assert utils.__all__ == ["KernelConfig", "config_override", "get_config"]


def test_checked_ctc_loss_clean_inputs_match_jax():
    labels, logits, label_length, logit_length = debug_inputs()
    jerr, jloss = jax_checked(labels, jnp.asarray(logits), label_length, logit_length)
    err, loss = checked_ctc_loss(torch.tensor(labels), torch.tensor(logits),
                                 torch.tensor(label_length), torch.tensor(logit_length))
    assert jerr.get() is None and err.get() is None
    err.throw()  # no error: returns
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-5)


@pytest.mark.parametrize("fault", ["nan_logits", "negative_length"])
def test_checked_ctc_loss_reports_what_jax_reports(fault):
    labels, logits, label_length, logit_length = debug_inputs()
    if fault == "nan_logits":
        logits[0, 0, 0] = np.nan
        message = "NaN in logits"
    else:
        logit_length[1] = -1
        message = "negative length"
    jerr, _ = jax_checked(labels, jnp.asarray(logits), label_length, logit_length)
    err, _ = checked_ctc_loss(torch.tensor(labels), torch.tensor(logits),
                              torch.tensor(label_length), torch.tensor(logit_length))
    assert err.get() == message
    assert message in jerr.get()
    with pytest.raises(CheckError, match=message):
        err.throw()


def test_profiling_annotate_and_block_ms():
    with annotate("test_region"):
        x = torch.ones((4, 4)) * 2.0
    ms = block_ms(lambda: torch.sum(x), iters=2)
    assert ms >= 0.0


def test_trace_to_writes_a_trace_file(tmp_path):
    with trace_to(str(tmp_path)):
        with annotate("traced_region"):
            torch.ones((8, 8)).sum()
    files = list(tmp_path.glob("*.json"))
    assert len(files) == 1
    assert "traced_region" in files[0].read_text()


def total(streams):
    return sum(streams.values())


def test_headline_total_equals_the_hand_count():
    """Streamed scheme, unfused, at the defaults (window 8): T padded to
    504, 251 lanes to 256, 63 windows."""
    btv = B * T * V * 4
    cell = B * 504 * 256 * 4  # one float32 [B, T, L] stream
    win = B * 63 * 256 * 4  # one [B, T/K, L] stream
    blank = B * 504 * 4
    onehot = B * 256 * V * 8
    hand = (
        2 * btv  # the logits, read by the forward's and the backward's log-softmax
        + 2 * 2 * btv  # logproba, written and read by each
        + 2 * 2 * btv  # the forced-blank logproba, written and read by each
        + 3 * (cell + blank)  # transitions: written, read by B2 and B3
        + 2 * 2 * cell  # sa [B, T, 2, L]: written by B2, read by B3
        + 2 * win  # saf
        + 2 * cell  # pc: written by B3, read by the scatter
        + 2 * (2 * cell + onehot + 2 * btv)  # the float64 act scatter
        + 2 * btv + 2 * btv  # sums, gradient
        + btv  # d_logits
    )
    assert hand == 2_096_996_352
    assert total(R.classic_grad_streams(B, T, V, LP1, KernelConfig())) == hand


def test_fused_epilogue_drops_the_epilogue_round_trips_at_any_vocab():
    for vocab in (32, 128, 100):
        base = R.classic_grad_streams(B, T, vocab, LP1, KernelConfig())
        fused = R.classic_grad_streams(B, T, vocab, LP1,
                                       KernelConfig(fused_epilogue=True))
        for name in ("sums_roundtrip", "grad_roundtrip", "act_scatter_float64"):
            assert base[name] > 0 and fused[name] == 0
        assert fused["acts"] == base["acts"]
        assert total(fused) < total(base)


def test_half_stream_halves_the_residuals():
    base = R.classic_grad_streams(B, T, V, LP1, KernelConfig())
    half = R.classic_grad_streams(B, T, V, LP1, KernelConfig(half_stream=True))
    assert half["alpha_residuals"] * 2 == base["alpha_residuals"]
    assert half["window_frames"] == 2 * base["window_frames"]  # saf and a0w


def test_residual_free_swaps_residuals_for_window_bounds():
    base = R.classic_grad_streams(B, T, V, LP1, KernelConfig())
    rf = R.classic_grad_streams(B, T, V, LP1, KernelConfig(stream_residuals=False))
    assert base["window_bounds"] == 0 and rf["window_bounds"] > 0
    assert rf["alpha_residuals"] == 0 and base["alpha_residuals"] > 0
    assert rf["transitions"] * 3 == base["transitions"] * 4  # rebuilt for B10
    # fused_epilogue needs a streamed scheme
    rf_fused = R.classic_grad_streams(
        B, T, V, LP1, KernelConfig(stream_residuals=False, fused_epilogue=True))
    assert rf_fused == rf


def test_wide_labels_route_like_the_port():
    """Labels [8, 2000] (2016 lanes) exceed the streamed pair's shared
    memory: the residual-free scheme, as ``cuda_lattice`` routes them."""
    streams = R.classic_grad_streams(8, 500, V, 2001, KernelConfig())
    assert streams["alpha_residuals"] == 0 and streams["window_bounds"] > 0


def test_forward_is_less_than_grad():
    fwd = R.classic_fwd_streams(B, T, V, LP1, KernelConfig())
    grad = R.classic_grad_streams(B, T, V, LP1, KernelConfig())
    assert 0 < total(fwd) < total(grad)


def test_chunked_geometry_raises():
    with pytest.raises(NotImplementedError):
        R.classic_grad_streams(B, 4000, V, 2001, KernelConfig())
    with pytest.raises(NotImplementedError):
        R.classic_fwd_streams(B, 4000, V, 2001, KernelConfig())


def test_roofline_fields(monkeypatch):
    monkeypatch.delenv("CTC_TPU_HBM_PEAK_GBPS", raising=False)
    assert R.hbm_peak_gbps("NVIDIA H100 80GB HBM3") == 3350.0
    with pytest.raises(ValueError, match="CTC_TPU_HBM_PEAK_GBPS"):
        R.hbm_peak_gbps("some other card")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="CTC_TPU_HBM_PEAK_GBPS"):
        R.roofline({"a": 1}, 1.0)
    monkeypatch.setenv("CTC_TPU_HBM_PEAK_GBPS", "1000")
    fast = R.roofline({"a": 10**9}, 1.2)  # 1 GB at 1000 GB/s: 1 ms floor
    assert fast["hbm_floor_ms"] == 1.0 and fast["floor_ratio"] == 1.2
    assert fast["bound"] == "HBM" and fast["pct_hbm_peak"] == pytest.approx(83.3)
    slow = R.roofline({"a": 10**9}, 3.0)
    assert slow["bound"] == "compute/overhead"
    assert dataclasses.asdict(KernelConfig())  # the model takes the port's config


def test_entry_runs_on_the_cpu():
    fn, args = entry(torch.device("cpu"))
    loss = fn(*args)
    assert loss.shape == (2,) and bool(torch.isfinite(loss).all())
