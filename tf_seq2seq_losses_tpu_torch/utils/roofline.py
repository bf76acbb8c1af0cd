"""Analytic memory-traffic model and roofline accounting of the classic loss.

Counterpart of ``tf_seq2seq_losses_tpu/utils/roofline.py``, counting the
port's own streams: the tensors that the host glue (``ops/cuda_lattice.py``,
``ops/topology.py``, ``ops/autodiff.py``) and the CUDA kernels write and
read on the card, not the TPU kernels'.

Scope:

* The model covers the one-chunk geometry (window-padded T at most
  ``chunk_time``) on the kernel path.  The chunked long-T path rebuilds the
  transitions chunk by chunk and is not modelled: it raises
  ``NotImplementedError``, as does a label whose lanes no kernel of the
  call holds (the pure path).
* Counts are algorithmic round trips of the named tensors under the given
  ``KernelConfig``: ``stream_residuals``, ``half_stream`` and
  ``fused_epilogue`` change the stream set, and so does the lane fit by
  which the port routes a scheme (``_build.fits``, the H100's shared
  memory).  Padding is included, since the kernels move padded rows: lanes
  to a multiple of 32 (a warp), time to whole windows.  Elementwise passes
  that PyTorch runs between them (masks, casts of small tensors) are not.
* ``achieved_gbps`` is modelled bytes over a measured time: it says which
  bound a call sits at, not what a hardware counter would read.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from tf_seq2seq_losses_tpu_torch.ops import _build
from tf_seq2seq_losses_tpu_torch.utils.config import KernelConfig, get_config

# HBM peak by the card's name (torch.cuda.get_device_name), in GB/s: the
# H100 SXM's 3.35 TB/s from NVIDIA's data sheet, at its 700 W limit.
PEAK_GBPS_BY_NAME = {"NVIDIA H100 80GB HBM3": 3350.0}

_F32 = 4
_F64 = 8
_LANE = 32
_CPU = torch.device("cpu")  # lane fits by the mirrors: the H100's shared memory


def hbm_peak_gbps(device_name: Optional[str] = None) -> float:
    """The card's HBM peak for roofline fractions, GB/s.

    ``CTC_TPU_HBM_PEAK_GBPS`` overrides it; otherwise it is looked up by
    ``device_name`` (default: the current CUDA device's name).  Any card
    not in :data:`PEAK_GBPS_BY_NAME`, or no card, raises ``ValueError``."""
    env = os.environ.get("CTC_TPU_HBM_PEAK_GBPS")
    if env:
        return float(env)
    if device_name is None:
        if not torch.cuda.is_available():
            raise ValueError("no CUDA device to look up the HBM peak of; set "
                             "CTC_TPU_HBM_PEAK_GBPS")
        device_name = torch.cuda.get_device_name()
    if device_name not in PEAK_GBPS_BY_NAME:
        raise ValueError(f"no HBM peak known for {device_name!r}; set "
                         "CTC_TPU_HBM_PEAK_GBPS to its GB/s")
    return PEAK_GBPS_BY_NAME[device_name]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _geometry(batch: int, num_t: int, lp1: int, cfg: KernelConfig):
    """``(tpad, lpad, window, cell, win)``: the padded axes, and the bytes
    of one float32 ``[B, T, L]`` and ``[B, T/K, L]`` stream.  Raises
    ``NotImplementedError`` off the one-chunk geometry
    (``cuda_lattice.chunk_plan``)."""
    k_win = cfg.window
    tpad = _round_up(max(num_t, 1), k_win)
    lpad = _round_up(lp1, _LANE)
    chunk = max(k_win, cfg.chunk_time // k_win * k_win)
    if tpad > chunk:
        raise NotImplementedError(
            "the traffic model covers the one-chunk geometry only")
    return (tpad, lpad, k_win, batch * tpad * lpad * _F32,
            batch * (tpad // k_win) * lpad * _F32)


def _scheme(lpad: int, cfg: KernelConfig) -> str:
    """The training scheme the port routes: ``"streamed"``, ``"half"`` or
    ``"residual_free"`` (``cuda_lattice.streams_residuals`` and
    ``classic_kernels_hold``)."""
    streamed = ("classic_fwd", "classic_bwd_half" if cfg.half_stream
                else "classic_bwd")
    if cfg.stream_residuals and _build.fits(streamed, lpad, cfg.window, _CPU):
        return "half" if cfg.half_stream else "streamed"
    if _build.fits(("classic_fwd", "classic_bwd_rf"), lpad, cfg.window, _CPU):
        return "residual_free"
    raise NotImplementedError(
        f"{lpad} lanes take the pure path, which the traffic model does not cover")


def _prep_streams(batch: int, num_t: int, num_tokens: int,
                  calls: int) -> Dict[str, int]:
    """The [B, T, V] streams of ``calls`` passes through the loss's entry
    (``LossFromLogits``): each log-softmax reads the logits and writes
    ``logproba``, which the context reads; the context writes the
    forced-blank ``logproba``, which the transition gather (forward) or the
    log-softmax cotangent (backward) reads."""
    btv = batch * num_t * num_tokens * _F32
    return {
        "logits_read": calls * btv,
        "logproba_roundtrip": calls * 2 * btv,
        "masked_logproba_roundtrip": calls * 2 * btv,
    }


def classic_grad_streams(
    batch: int,
    num_t: int,
    num_tokens: int,
    lp1: int,
    cfg: Optional[KernelConfig] = None,
) -> Dict[str, int]:
    """Per-stream bytes of a classic training step, forward and backward to
    ``d_logits``, from the logits.

    * ``logits_read``, ``logproba_roundtrip``, ``masked_logproba_roundtrip``:
      :func:`_prep_streams` of the forward and of the backward, which runs
      the log-softmax and the context again.
    * ``transitions``: ``dcu [B, T, L]`` and ``blank [B, T]``, written once
      and read by the forward and the backward scan (the streamed pack
      keeps them); the residual-free backward builds them again.
    * ``alpha_residuals``: the per-step mantissas, ``sa [B, T, 2, L]``
      (``a1 [B, T, L]`` under ``half_stream``), written by the forward scan
      and read by the backward; none on the residual-free scheme.
    * ``window_frames``: ``saf [B, T/K, L]`` (and ``a0w`` under
      ``half_stream``), written and read once.
    * ``window_bounds``: the residual-free scheme's three boundary carries
      ``[T/K, B, L]``, written by mode bound and read by the backward.
    * ``acts``: the act ``pc [B, T, L]``, written by the backward scan and
      read by the act scatter or the fused epilogue.
    * ``act_scatter_float64``: the unfused act scatter's float64 copy of
      ``pc``, one-hot ``[B, L, V]`` and product ``[B, T, V]``, each written
      and read once.
    * ``sums_roundtrip``, ``grad_roundtrip``: the unfused epilogue's
      float32 token sums and gradient ``[B, T, V]``.
    * ``d_logits_write``.

    The fused epilogue (``fused_epilogue``, B12, at any vocabulary its
    shared memory holds, on a streamed scheme) reads the acts and the
    forced-blank ``logproba`` and writes ``d_logits``: the act scatter,
    sums and gradient streams are 0.
    """
    cfg = cfg or get_config()
    tpad, lpad, _k, cell, win = _geometry(batch, num_t, lp1, cfg)
    scheme = _scheme(lpad, cfg)
    btv = batch * num_t * num_tokens * _F32
    transitions = cell + batch * tpad * _F32
    streams = _prep_streams(batch, num_t, num_tokens, calls=2)
    if scheme == "residual_free":
        streams["transitions"] = 4 * transitions
        streams["alpha_residuals"] = 0
        streams["window_frames"] = 0
        streams["window_bounds"] = 2 * 3 * win
    else:
        half = scheme == "half"
        streams["transitions"] = 3 * transitions
        streams["alpha_residuals"] = 2 * (cell if half else 2 * cell)
        streams["window_frames"] = 2 * (2 * win if half else win)
        streams["window_bounds"] = 0
    streams["acts"] = 2 * cell
    fused = (cfg.fused_epilogue and scheme != "residual_free"
             and _build.fits(("fused_epilogue",), lpad, num_tokens, _CPU))
    if fused:
        streams["act_scatter_float64"] = 0
        streams["sums_roundtrip"] = 0
        streams["grad_roundtrip"] = 0
    else:
        streams["act_scatter_float64"] = 2 * (
            2 * cell + batch * lpad * num_tokens * _F64 + 2 * btv)
        streams["sums_roundtrip"] = 2 * btv
        streams["grad_roundtrip"] = 2 * btv
    streams["d_logits_write"] = btv
    return streams


def classic_fwd_streams(
    batch: int,
    num_t: int,
    num_tokens: int,
    lp1: int,
    cfg: Optional[KernelConfig] = None,
) -> Dict[str, int]:
    """Per-stream bytes of a forward-only classic call (kernel B1, mode
    final): one pass of :func:`_prep_streams`, the transitions written and
    read once; no residuals, no acts."""
    cfg = cfg or get_config()
    tpad, lpad, _k, cell, _win = _geometry(batch, num_t, lp1, cfg)
    if not _build.fits(("classic_fwd",), lpad, cfg.window, _CPU):
        raise NotImplementedError(
            f"{lpad} lanes take the pure path, which the traffic model does not cover")
    streams = _prep_streams(batch, num_t, num_tokens, calls=1)
    streams["transitions"] = 2 * (cell + batch * tpad * _F32)
    return streams


def roofline(streams: Dict[str, int], ms: float) -> Dict[str, float]:
    """Roofline fields for a measured time over a modelled stream set.

    ``hbm_floor_ms`` is the time the streams would take at the card's HBM
    peak; ``floor_ratio``, the measured time over it, is the number to read
    (1.0 = bandwidth speed of light).  ``bound`` is a coarse label: "HBM"
    within 1.5x of the floor, else "compute/overhead" (the arithmetic, the
    step chains of the scans, or launches and the host hold it, not the
    bytes)."""
    total = int(sum(streams.values()))
    peak = hbm_peak_gbps()
    achieved = total / ms / 1e6 if ms > 0 else 0.0  # bytes/ms -> GB/s
    floor_ms = total / peak / 1e6
    ratio = ms / floor_ms if floor_ms > 0 else float("inf")
    return {
        "hbm_bytes": total,
        "achieved_gbps": round(achieved, 1),
        "hbm_peak_gbps": peak,
        "pct_hbm_peak": round(100.0 * achieved / peak, 1),
        "hbm_floor_ms": round(floor_ms, 4),
        "floor_ratio": round(ratio, 3),
        "bound": "HBM" if ratio <= 1.5 else "compute/overhead",
    }
