"""Exact log-space CTC kernels: the saturation guard's repair path.

Counterpart of ``tf_seq2seq_losses_tpu/ops/log_lattice.py``:

* ``classic_log_fwd`` (csrc/classic_log.cu) is the log-space alpha scan in
  modes ``"final"`` (loss) and ``"resid"`` (streams ``x`` and ``a1``);
* ``classic_log_bwd`` (csrc/classic_log.cu) is the log-space beta scan
  over those residuals, emitting the probability-space combined act;
* ``simplified_log_fwd`` and ``simplified_log_bwd`` (csrc/simplified_log.cu)
  are the single-state pair of the simplified topology; its act is
  ``pd = exp(loss + a + dg + b[l + 1])``.

Carries are log-probabilities, so nothing flushes.  Each wrapper is a
custom op (``ctc_port::<wrapper>``): CUDA tensors launch the kernels; CPU
tensors run the plain versions.  These kernels serve a time axis of one
chunk only (a rare repair needs no chunked scan), and labels whose lanes
their shared memory holds (at most :data:`CLASSIC_LOG_LANES` and
:data:`SIMPLIFIED_LOG_LANES`): beyond either the repair takes the pure
path (:func:`fits_log_fallback`, the op ``ctc_port::pure_repair``), in
float64, cast back to float32: on the card through the float64 scan
kernels of ``ops/pure_scan.py``.
"""

from __future__ import annotations

from typing import List

import torch
from torch import Tensor

from tf_seq2seq_losses_tpu_torch.ops import _build
from tf_seq2seq_losses_tpu_torch.ops import classic as classic_mod
from tf_seq2seq_losses_tpu_torch.ops import core as core_mod
from tf_seq2seq_losses_tpu_torch.ops import pure_scan
from tf_seq2seq_losses_tpu_torch.ops import simplified as simplified_mod
from tf_seq2seq_losses_tpu_torch.ops.core import CtcContext, take_token_logprobas
from tf_seq2seq_losses_tpu_torch.ops.cuda_lattice import (
    act_scatter,
    check_aligned,
    check_device,
    check_tensor,
    chunk_plan,
    empty_outputs,
    geometry,
    kernel_lengths,
    kernel_op,
    lane_masks,
    shift_lanes,
)
from tf_seq2seq_losses_tpu_torch.utils.numerics import apply_logarithmic_mask

NEG_INF = float("-inf")


def _lae(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """-inf-safe logaddexp, the same formula as csrc/blockfloat.cuh."""
    m = torch.maximum(x, y)
    out = m + torch.log1p(torch.exp(torch.minimum(x, y) - m))
    return torch.where(m == NEG_INF, m, out)


def _log_gather_level(ctx: CtcContext, tpad: int, lpad: int):
    """``(blank_l [B, tpad], dc_l, pt_l [B, tpad, lpad])`` log-space inputs.

    Padded steps are no-ops (blank 0, transitions -inf); padded lanes are
    -inf (dead lattice positions)."""
    batch, num_t, _ = ctx.logproba.shape
    lp1 = ctx.label.shape[1]
    device = ctx.logproba.device
    dc_raw = take_token_logprobas(ctx.logproba, ctx.label)
    dc_raw = apply_logarithmic_mask(dc_raw, ctx.label_length_mask[:, None, :])
    pt_raw = take_token_logprobas(ctx.logproba, ctx.preceded_label)
    dc_l = torch.full((batch, tpad, lpad), NEG_INF, device=device)
    dc_l[:, :num_t, :lp1] = dc_raw
    pt_l = torch.full((batch, tpad, lpad), NEG_INF, device=device)
    pt_l[:, :num_t, :lp1] = pt_raw
    blank_l = torch.zeros((batch, tpad), dtype=torch.float32, device=device)
    blank_l[:, :num_t] = ctx.blank_lp
    return blank_l, dc_l, pt_l


_LOG_KERNELS = {"classic": ("classic_log_fwd", "classic_log_bwd"),
                "simplified": ("simplified_log_fwd", "simplified_log_bwd")}

# The widest label (lanes) that B4 and B5 repair: what their first design's
# shared memory held (B5's, 148 bytes a lane, on an H100).  The kernels
# hold more now, but a wider label is still repaired through the pure path
# in float64, as it was: float32 log-space carries are about 4.5e-4 from
# float64 in the gradient at T=495 (tools/log_precision.py), so a wider
# route would make those rows worse (ROADMAP C2).
CLASSIC_LOG_LANES = 1568
# The widest label (lanes) that B8 and B9 repair: what B9's shared memory
# holds on an H100 (72 bytes a lane), as in their first design.  B8's
# holds more, but the loss and the gradient of a repaired row come from one
# route, and the kernels are built for seven lanes a thread.
SIMPLIFIED_LOG_LANES = 3200
_LOG_LANES = {"classic": CLASSIC_LOG_LANES, "simplified": SIMPLIFIED_LOG_LANES}


def fits_log_fallback(ctx: CtcContext, topology: str = "classic") -> bool:
    """The log kernels of ``topology`` repair ``ctx``: its window-padded T
    is one chunk (within chunk_time), and both kernels' shared memory holds
    its label's lanes (the loss and the gradient of a repaired row come
    from one path), at most :data:`CLASSIC_LOG_LANES` or
    :data:`SIMPLIFIED_LOG_LANES`."""
    if ctx.logproba.shape[1] == 0 or chunk_plan(ctx)[0] != 1:
        return False
    lpad = geometry(ctx)[1]
    if lpad > _LOG_LANES[topology]:
        return False
    return _build.fits(_LOG_KERNELS[topology], lpad, 0, ctx.logproba.device)


def _check_lanes(lpad: int, topology: str, what: str) -> None:
    """Raise for a label wider than the log kernels of ``topology`` are
    built for."""
    if lpad > _LOG_LANES[topology]:
        raise ValueError(f"{what}: {lpad} lanes; these kernels take labels of at most "
                         f"{_LOG_LANES[topology]} lanes ({topology.upper()}_LOG_LANES)")


# ---------------------------------------------------------------------------
# kernel B4: log-space alpha scan
# ---------------------------------------------------------------------------


def classic_log_fwd_plain(blank_l, dc_l, pt_l, nb, rep, lens, mode: str):
    """Plain version of ``classic_log_fwd``."""
    batch, tpad, lpad = dc_l.shape
    device = dc_l.device
    lane = torch.arange(lpad, device=device)
    a0 = torch.where(lane == 0, 0.0, NEG_INF).expand(batch, lpad).clone()
    a1 = torch.full((batch, lpad), NEG_INF, device=device)
    nb_l = torch.where(nb > 0, 0.0, NEG_INF)
    rep_b = rep > 0
    resid = mode == "resid"
    if resid:
        sx = torch.full((batch, tpad, lpad), NEG_INF, device=device)
        sa1 = torch.full((batch, tpad, lpad), NEG_INF, device=device)
    lens_c = lens.to(torch.int64)[:, None]
    max_len = int(lens.max()) if batch else 0
    for t in range(max_len):
        run = t < lens_c
        s = _lae(a0, a1)
        x = torch.where(rep_b, s, a0)
        if resid:
            sx[:, t] = x
            sa1[:, t] = a1
        arr = shift_lanes(dc_l[:, t] + x, 1, NEG_INF)
        n0 = s + blank_l[:, t, None]
        n1 = _lae(a1 + (pt_l[:, t] + nb_l), arr)
        a0 = torch.where(run, n0, a0)
        a1 = torch.where(run, n1, a1)
    if resid:
        return sx, sa1, a0, a1
    return a0, a1


def classic_log_fwd(blank_l, dc_l, pt_l, nb, rep, lens, mode: str):
    """Log-space alpha scan.  ``mode="final"``: ``(f0, f1)``;
    ``mode="resid"``: ``(sx, sa1 [B, Tp, L], f0, f1)``.

    The op ``ctc_port::classic_log_fwd``: CUDA tensors launch
    csrc/classic_log.cu; CPU tensors run :func:`classic_log_fwd_plain`."""
    if mode not in ("final", "resid"):
        raise ValueError(f"unknown classic_log_fwd mode {mode!r}")
    check_device(dc_l, "classic_log_fwd")
    return tuple(_classic_log_fwd_op(blank_l, dc_l, pt_l, nb, rep, lens, mode))


def _classic_log_fwd_plain_op(blank_l: Tensor, dc_l: Tensor, pt_l: Tensor, nb: Tensor,
                              rep: Tensor, lens: Tensor, mode: str) -> List[Tensor]:
    return list(classic_log_fwd_plain(blank_l, dc_l, pt_l, nb, rep, lens, mode))


_classic_log_fwd_op = kernel_op("classic_log_fwd", _classic_log_fwd_plain_op)


def _log_specs(steps: torch.Tensor, resid: int, final: int):
    """``(shape, dtype)`` of a log-space scan's outputs over the rows
    ``steps`` [B, Tp, L]: ``resid`` tensors like it, then ``final`` carries
    [B, L], all float32."""
    batch, _, lpad = steps.shape
    return ([(steps.shape, torch.float32)] * resid
            + [((batch, lpad), torch.float32)] * final)


@_classic_log_fwd_op.register_fake
def _classic_log_fwd_fake(blank_l, dc_l, pt_l, nb, rep, lens, mode):
    return empty_outputs(dc_l, _log_specs(dc_l, 2 if mode == "resid" else 0, 2))


@_classic_log_fwd_op.register_kernel("cuda")
def _classic_log_fwd_launch(blank_l, dc_l, pt_l, nb, rep, lens, mode):
    batch, tpad, lpad = dc_l.shape
    dev = dc_l.device
    f32 = torch.float32
    check_tensor(blank_l, (batch, tpad), f32, "blank_l", dev)
    check_tensor(dc_l, (batch, tpad, lpad), f32, "dc_l", dev)
    check_tensor(pt_l, (batch, tpad, lpad), f32, "pt_l", dev)
    check_tensor(nb, (batch, lpad), f32, "nb", dev)
    check_tensor(rep, (batch, lpad), f32, "rep", dev)
    check_tensor(lens, (batch,), torch.int32, "lens", dev)
    check_aligned((("dc_l", dc_l), ("pt_l", pt_l)), "classic_log_fwd")
    _check_lanes(lpad, "classic", "classic_log_fwd")
    lib = _build.lib("classic_log")
    _build.check_smem(lib.ctc_classic_log_fwd_smem_bytes(lpad), "classic_log_fwd", dev)
    resid = mode == "resid"
    outs = empty_outputs(dc_l, _log_specs(dc_l, 2 if resid else 0, 2))
    *extra, f0, f1 = outs
    sx, sa1 = (t.data_ptr() for t in extra) if resid else (None, None)
    with torch.cuda.device(dev):
        err = lib.ctc_classic_log_fwd(
            blank_l.data_ptr(), dc_l.data_ptr(), pt_l.data_ptr(),
            nb.data_ptr(), rep.data_ptr(), lens.data_ptr(),
            batch, tpad, lpad, int(resid), sx, sa1, f0.data_ptr(), f1.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "classic_log_fwd")
    classic_log_fwd.launches += 1
    classic_log_fwd.mode_launches[mode] += 1
    return outs


classic_log_fwd.launches = 0
classic_log_fwd.mode_launches = {"final": 0, "resid": 0}


# ---------------------------------------------------------------------------
# kernel B5: log-space beta scan emitting the combined act
# ---------------------------------------------------------------------------


def classic_log_bwd_plain(blank_l, dc_l, pt_l, nb, rep, lens, lab_len, loss, sx,
                          sa1):
    """Plain version of ``classic_log_bwd``."""
    batch, tpad, lpad = dc_l.shape
    device = dc_l.device
    lane = torch.arange(lpad, device=device)
    b0 = torch.where(
        lane[None, :] == lab_len.to(torch.int64)[:, None], 0.0, NEG_INF
    )
    b1 = b0.clone()
    nb_l = torch.where(nb > 0, 0.0, NEG_INF)
    rep_b = rep > 0
    lo = loss[:, None]
    pc = torch.zeros((batch, tpad, lpad), dtype=torch.float32, device=device)
    lens_c = lens.to(torch.int64)[:, None]
    max_len = int(lens.max()) if batch else 0
    for t in range(max_len - 1, -1, -1):
        run = t < lens_c
        arr = shift_lanes(b1, -1, NEG_INF)
        dc = dc_l[:, t]
        pt = pt_l[:, t]
        pd = torch.exp(lo + (dc + sx[:, t]) + arr)
        ph = torch.exp(lo + sa1[:, t] + pt + b1)
        pc[:, t] = torch.where(run, pd + shift_lanes(ph, -1, 0.0), torch.zeros_like(pd))
        hc = blank_l[:, t, None] + b0
        n0 = _lae(hc, dc + arr)
        n1 = _lae(torch.where(rep_b, n0, hc), (pt + nb_l) + b1)
        b0 = torch.where(run, n0, b0)
        b1 = torch.where(run, n1, b1)
    return pc, b0, b1


def classic_log_bwd(blank_l, dc_l, pt_l, nb, rep, lens, lab_len, loss, sx, sa1):
    """Log-space beta scan: ``(pc [B, Tp, L], beta0_closed, beta0_open)``;
    ``loss`` [B] is the finite-masked loss that normalises the acts.

    The op ``ctc_port::classic_log_bwd``: CUDA tensors launch
    csrc/classic_log.cu; CPU tensors run :func:`classic_log_bwd_plain`."""
    check_device(dc_l, "classic_log_bwd")
    return tuple(_classic_log_bwd_op(blank_l, dc_l, pt_l, nb, rep, lens, lab_len, loss,
                                     sx, sa1))


def _classic_log_bwd_plain_op(blank_l: Tensor, dc_l: Tensor, pt_l: Tensor, nb: Tensor,
                              rep: Tensor, lens: Tensor, lab_len: Tensor, loss: Tensor,
                              sx: Tensor, sa1: Tensor) -> List[Tensor]:
    return list(classic_log_bwd_plain(blank_l, dc_l, pt_l, nb, rep, lens, lab_len, loss,
                                      sx, sa1))


_classic_log_bwd_op = kernel_op("classic_log_bwd", _classic_log_bwd_plain_op)


@_classic_log_bwd_op.register_fake
def _classic_log_bwd_fake(blank_l, dc_l, *_):
    return empty_outputs(dc_l, _log_specs(dc_l, 1, 2))


@_classic_log_bwd_op.register_kernel("cuda")
def _classic_log_bwd_launch(blank_l, dc_l, pt_l, nb, rep, lens, lab_len, loss, sx, sa1):
    batch, tpad, lpad = dc_l.shape
    dev = dc_l.device
    f32 = torch.float32
    check_tensor(blank_l, (batch, tpad), f32, "blank_l", dev)
    for name, t in (("dc_l", dc_l), ("pt_l", pt_l), ("sx", sx), ("sa1", sa1)):
        check_tensor(t, (batch, tpad, lpad), f32, name, dev)
    check_tensor(nb, (batch, lpad), f32, "nb", dev)
    check_tensor(rep, (batch, lpad), f32, "rep", dev)
    check_tensor(lens, (batch,), torch.int32, "lens", dev)
    check_tensor(lab_len, (batch,), torch.int32, "lab_len", dev)
    check_tensor(loss, (batch,), f32, "loss", dev)
    check_aligned((("dc_l", dc_l), ("pt_l", pt_l), ("sx", sx), ("sa1", sa1)),
                  "classic_log_bwd")
    _check_lanes(lpad, "classic", "classic_log_bwd")
    lib = _build.lib("classic_log")
    _build.check_smem(lib.ctc_classic_log_bwd_smem_bytes(lpad), "classic_log_bwd", dev)
    outs = empty_outputs(dc_l, _log_specs(dc_l, 1, 2))
    with torch.cuda.device(dev):
        err = lib.ctc_classic_log_bwd(
            blank_l.data_ptr(), dc_l.data_ptr(), pt_l.data_ptr(),
            nb.data_ptr(), rep.data_ptr(), lens.data_ptr(),
            lab_len.data_ptr(), loss.data_ptr(), sx.data_ptr(), sa1.data_ptr(),
            batch, tpad, lpad, *(t.data_ptr() for t in outs),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "classic_log_bwd")
    classic_log_bwd.launches += 1
    return outs


classic_log_bwd.launches = 0


# ---------------------------------------------------------------------------
# entry points of the kernel path
# ---------------------------------------------------------------------------


def _log_inputs(ctx: CtcContext):
    tpad, lpad, _ = geometry(ctx)
    blank_l, dc_l, pt_l = _log_gather_level(ctx, tpad, lpad)
    lm, nb, rep = lane_masks(ctx, lpad)
    lens, lab_len = kernel_lengths(ctx)
    return blank_l, dc_l, pt_l, lm, nb, rep, lens, lab_len


def _pick_log_loss(f0, f1, label_length):
    total = _lae(f0, f1)
    return -torch.gather(total, 1, label_length.to(torch.int64)[:, None])[:, 0]


def classic_loss_exact(ctx: CtcContext) -> torch.Tensor:
    """Exact classic loss through the log-space kernel B4 (mode final)."""
    batch, num_t, _ = ctx.logproba.shape
    if batch == 0 or num_t == 0 or not fits_log_fallback(ctx):
        return pure_repair("classic", ctx, "loss")[0]
    blank_l, dc_l, pt_l, _lm, nb, rep, lens, lab_len = _log_inputs(ctx)
    f0, f1 = classic_log_fwd(blank_l, dc_l, pt_l, nb, rep, lens, "final")
    return _pick_log_loss(f0, f1, lab_len)


def assemble_with_blank_identity(ctx: CtcContext, non_blank, fast_loss):
    """Log-space gradient with the blank column from the posterior identity
    ``sum_v -grad[b, t, v] = 1`` (clamped at 0: exactly -inf, zero
    gradient, under rounding)."""
    num_tokens = ctx.logproba.shape[2]
    loss_col = torch.where(
        torch.isfinite(fast_loss), fast_loss, torch.zeros_like(fast_loss)
    )[:, None, None]
    token_is_blank = (
        torch.arange(num_tokens, device=non_blank.device) == ctx.blank_index
    )
    neg_grad = torch.where(
        token_is_blank, torch.zeros_like(non_blank), torch.exp(loss_col + non_blank)
    )
    s = torch.sum(neg_grad, dim=2, keepdim=True)
    bl = torch.log(torch.clamp(1.0 - s, min=0.0)) - loss_col
    return torch.where(token_is_blank, bl, non_blank)


_PURE = {"classic": classic_mod, "simplified": simplified_mod}


def pure_repair(topology: str, ctx: CtcContext, result: str):
    """The pure path of ``topology`` on ``ctx`` in float64
    (``core.float64_context``), cast back to float32: the repair of a row
    that these kernels do not serve, and the guard's pure route.
    ``result`` is ``"loss"`` (``[loss]``), ``"grad"`` (``[loss, grad]``) or
    ``"grad_log"`` (``[loss, log(-grad)]``).

    The op ``ctc_port::pure_repair``: on CPU tensors the pure path's
    Python loops over T; on CUDA tensors the same arithmetic with alpha and
    beta from the float64 scan kernels (``ops/pure_scan.py``), a few
    launches where the loop took about ten a step, so that a CUDA graph
    captures a repair round as a few hundred nodes.  Under
    ``torch.compile`` it is one opaque node of the graph."""
    return _pure_repair_op(*ctx, topology, result)


def _repair64(ctx: CtcContext, topology: str, result: str, scans):
    """The pure repair's arithmetic on ``ctx`` in float64, with ``(alpha,
    beta)`` from ``scans(c64, with_beta)`` (beta None for ``"loss"``):
    ``loss``, ``core.gradient_log`` and its ``combine`` in float64."""
    pure = _PURE[topology]
    c64 = core_mod.float64_context(ctx)
    alpha, beta = scans(c64, result != "loss")
    loss = pure.loss(c64, alpha)
    if result == "loss":
        return [loss.float()]
    grad_log = core_mod.gradient_log(pure, c64, loss, alpha, beta)
    second = -torch.exp(grad_log) if result == "grad" else grad_log
    return [loss.float(), second.float()]


def _loop_scans(topology: str):
    """``scans`` of :func:`_repair64` through the pure path's loops."""
    pure = _PURE[topology]
    return lambda c, with_beta: (pure.alpha(c), pure.beta(c) if with_beta else None)


@torch.library.custom_op("ctc_port::pure_repair", mutates_args=())
def _pure_repair_op(logproba: Tensor, raw_logproba: Tensor, label: Tensor,
                    preceded_label: Tensor, label_length: Tensor, logit_length: Tensor,
                    blank_index: Tensor, label_length_mask: Tensor,
                    logit_length_mask: Tensor, blank_lp: Tensor, topology: str,
                    result: str) -> List[Tensor]:
    ctx = CtcContext(logproba, raw_logproba, label, preceded_label, label_length,
                     logit_length, blank_index, label_length_mask, logit_length_mask,
                     blank_lp)
    return _repair64(ctx, topology, result, _loop_scans(topology))


@_pure_repair_op.register_kernel("cuda")
def _pure_repair_launch(*args):
    *fields, topology, result = args
    return _repair64(CtcContext(*fields), topology, result, pure_scan.SCANS[topology])


@_pure_repair_op.register_fake
def _pure_repair_fake(logproba, *args):
    *_, result = args
    loss = logproba.new_empty(logproba.shape[:1], dtype=torch.float32)
    if result == "loss":
        return [loss]
    return [loss, logproba.new_empty(logproba.shape, dtype=torch.float32)]


def _safe_loss(loss: torch.Tensor) -> torch.Tensor:
    """The loss that normalises the acts: 0 for non-finite losses."""
    return torch.where(torch.isfinite(loss), loss, torch.zeros_like(loss))


def classic_loss_and_gradient_log_exact(ctx: CtcContext):
    """``(exact loss, exact log(-grad))`` through the log-space kernels B4
    (mode resid) and B5: one alpha scan yields both, so a repair of the
    gradient needs no separate loss launch."""
    batch, num_t, _ = ctx.logproba.shape
    if batch == 0 or num_t == 0 or not fits_log_fallback(ctx):
        return tuple(pure_repair("classic", ctx, "grad_log"))
    blank_l, dc_l, pt_l, lm, nb, rep, lens, lab_len = _log_inputs(ctx)
    sx, sa1, f0, f1 = classic_log_fwd(blank_l, dc_l, pt_l, nb, rep, lens, "resid")
    loss = _pick_log_loss(f0, f1, lab_len)
    pc, _b0, _b1 = classic_log_bwd(
        blank_l, dc_l, pt_l, nb, rep, lens, lab_len, _safe_loss(loss), sx, sa1
    )
    return loss, _gradient_log_from_acts(ctx, pc, lm, loss)


def _gradient_log_from_acts(ctx: CtcContext, pc, lm, loss):
    """Exact ``log(-grad)`` from a log-space beta scan's acts ``pc``, which
    were normalised by the finite-masked ``loss``."""
    safe_loss = _safe_loss(loss)
    sums = act_scatter(ctx, pc[:, :ctx.logproba.shape[1]], lm)
    non_blank = torch.log(sums) - safe_loss[:, None, None]
    combined = assemble_with_blank_identity(ctx, non_blank, loss)
    out = loss[:, None, None] + combined
    out = torch.where(
        torch.isposinf(loss)[:, None, None], torch.full_like(out, NEG_INF), out
    )
    return apply_logarithmic_mask(out, ctx.logit_length_mask[:, :, None])


def classic_gradient_log_exact(ctx: CtcContext) -> torch.Tensor:
    """Exact ``log(-grad)`` through the log-space kernels B4 (mode resid)
    and B5; same semantics as ``core.gradient_log`` on the pure path."""
    return classic_loss_and_gradient_log_exact(ctx)[1]


# ---------------------------------------------------------------------------
# simplified topology: kernels B8 and B9
# ---------------------------------------------------------------------------


def _simplified_log_gather_level(ctx: CtcContext, tpad: int, lpad: int):
    """``(blank_l [B, tpad], dg_l [B, tpad, lpad])`` log-space inputs: the
    diagonal transition ``log p[label[l]]``, -inf past label_length, on
    padded lanes and on padded steps (whose blank is 0, a no-op)."""
    batch, num_t, _ = ctx.logproba.shape
    lp1 = ctx.label.shape[1]
    device = ctx.logproba.device
    dg_raw = take_token_logprobas(ctx.logproba, ctx.label)
    dg_l = torch.full((batch, tpad, lpad), NEG_INF, device=device)
    dg_l[:, :num_t, :lp1] = apply_logarithmic_mask(
        dg_raw, ctx.label_length_mask[:, None, :]
    )
    blank_l = torch.zeros((batch, tpad), dtype=torch.float32, device=device)
    blank_l[:, :num_t] = ctx.blank_lp
    return blank_l, dg_l


def simplified_log_fwd_plain(blank_l, dg_l, lens, mode: str):
    """Plain version of ``simplified_log_fwd``."""
    batch, tpad, lpad = dg_l.shape
    device = dg_l.device
    lane = torch.arange(lpad, device=device)
    a = torch.where(lane == 0, 0.0, NEG_INF).expand(batch, lpad).clone()
    resid = mode == "resid"
    if resid:
        sa = torch.full((batch, tpad, lpad), NEG_INF, device=device)
    lens_c = lens.to(torch.int64)[:, None]
    max_len = int(lens.max()) if batch else 0
    for t in range(max_len):
        if resid:
            sa[:, t] = a
        arr = shift_lanes(a + dg_l[:, t], 1, NEG_INF)
        a = torch.where(t < lens_c, _lae(a + blank_l[:, t, None], arr), a)
    if resid:
        return sa, a
    return a


def simplified_log_fwd(blank_l, dg_l, lens, mode: str):
    """Log-space single-state alpha scan.  ``mode="final"``: ``f [B, L]``;
    ``mode="resid"``: ``(sa [B, Tp, L], f)``.

    The op ``ctc_port::simplified_log_fwd``: CUDA tensors launch
    csrc/simplified_log.cu; CPU tensors run :func:`simplified_log_fwd_plain`."""
    if mode not in ("final", "resid"):
        raise ValueError(f"unknown simplified_log_fwd mode {mode!r}")
    check_device(dg_l, "simplified_log_fwd")
    out = _simplified_log_fwd_op(blank_l, dg_l, lens, mode)
    return tuple(out) if mode == "resid" else out[0]


def _simplified_log_fwd_plain_op(blank_l: Tensor, dg_l: Tensor, lens: Tensor,
                                 mode: str) -> List[Tensor]:
    out = simplified_log_fwd_plain(blank_l, dg_l, lens, mode)
    return list(out) if mode == "resid" else [out]


_simplified_log_fwd_op = kernel_op("simplified_log_fwd", _simplified_log_fwd_plain_op)


@_simplified_log_fwd_op.register_fake
def _simplified_log_fwd_fake(blank_l, dg_l, lens, mode):
    return empty_outputs(dg_l, _log_specs(dg_l, int(mode == "resid"), 1))


@_simplified_log_fwd_op.register_kernel("cuda")
def _simplified_log_fwd_launch(blank_l, dg_l, lens, mode):
    batch, tpad, lpad = dg_l.shape
    dev = dg_l.device
    f32 = torch.float32
    check_tensor(blank_l, (batch, tpad), f32, "blank_l", dev)
    check_tensor(dg_l, (batch, tpad, lpad), f32, "dg_l", dev)
    check_tensor(lens, (batch,), torch.int32, "lens", dev)
    check_aligned((("dg_l", dg_l),), "simplified_log_fwd")
    _check_lanes(lpad, "simplified", "simplified_log_fwd")
    lib = _build.lib("simplified_log")
    _build.check_smem(
        lib.ctc_simplified_log_fwd_smem_bytes(lpad), "simplified_log_fwd", dev
    )
    resid = mode == "resid"
    outs = empty_outputs(dg_l, _log_specs(dg_l, int(resid), 1))
    *extra, f = outs
    with torch.cuda.device(dev):
        err = lib.ctc_simplified_log_fwd(
            blank_l.data_ptr(), dg_l.data_ptr(), lens.data_ptr(),
            batch, tpad, lpad, int(resid),
            extra[0].data_ptr() if resid else None, f.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "simplified_log_fwd")
    simplified_log_fwd.launches += 1
    simplified_log_fwd.mode_launches[mode] += 1
    return outs


simplified_log_fwd.launches = 0
simplified_log_fwd.mode_launches = {"final": 0, "resid": 0}


def simplified_log_bwd_plain(blank_l, dg_l, lens, lab_len, loss, sa):
    """Plain version of ``simplified_log_bwd``."""
    batch, tpad, lpad = dg_l.shape
    device = dg_l.device
    lane = torch.arange(lpad, device=device)
    b = torch.where(lane[None, :] == lab_len.to(torch.int64)[:, None], 0.0, NEG_INF)
    lo = loss[:, None]
    pd = torch.zeros((batch, tpad, lpad), dtype=torch.float32, device=device)
    lens_c = lens.to(torch.int64)[:, None]
    max_len = int(lens.max()) if batch else 0
    for t in range(max_len - 1, -1, -1):
        run = t < lens_c
        arr = shift_lanes(b, -1, NEG_INF)
        dg = dg_l[:, t]
        p = torch.exp(lo + sa[:, t] + dg + arr)
        pd[:, t] = torch.where(run, p, torch.zeros_like(p))
        b = torch.where(run, _lae(blank_l[:, t, None] + b, dg + arr), b)
    return pd, b


def simplified_log_bwd(blank_l, dg_l, lens, lab_len, loss, sa):
    """Log-space single-state beta scan: ``(pd [B, Tp, L], beta0)``, with
    ``pd = exp(loss + a + dg + b[l + 1])``; ``loss`` [B] is the
    finite-masked loss that normalises the acts.

    The op ``ctc_port::simplified_log_bwd``: CUDA tensors launch
    csrc/simplified_log.cu; CPU tensors run :func:`simplified_log_bwd_plain`."""
    check_device(dg_l, "simplified_log_bwd")
    return tuple(_simplified_log_bwd_op(blank_l, dg_l, lens, lab_len, loss, sa))


def _simplified_log_bwd_plain_op(blank_l: Tensor, dg_l: Tensor, lens: Tensor,
                                 lab_len: Tensor, loss: Tensor,
                                 sa: Tensor) -> List[Tensor]:
    return list(simplified_log_bwd_plain(blank_l, dg_l, lens, lab_len, loss, sa))


_simplified_log_bwd_op = kernel_op("simplified_log_bwd", _simplified_log_bwd_plain_op)


@_simplified_log_bwd_op.register_fake
def _simplified_log_bwd_fake(blank_l, dg_l, *_):
    return empty_outputs(dg_l, _log_specs(dg_l, 1, 1))


@_simplified_log_bwd_op.register_kernel("cuda")
def _simplified_log_bwd_launch(blank_l, dg_l, lens, lab_len, loss, sa):
    batch, tpad, lpad = dg_l.shape
    dev = dg_l.device
    f32 = torch.float32
    check_tensor(blank_l, (batch, tpad), f32, "blank_l", dev)
    check_tensor(dg_l, (batch, tpad, lpad), f32, "dg_l", dev)
    check_tensor(sa, (batch, tpad, lpad), f32, "sa", dev)
    check_tensor(lens, (batch,), torch.int32, "lens", dev)
    check_tensor(lab_len, (batch,), torch.int32, "lab_len", dev)
    check_tensor(loss, (batch,), f32, "loss", dev)
    check_aligned((("dg_l", dg_l), ("sa", sa)), "simplified_log_bwd")
    _check_lanes(lpad, "simplified", "simplified_log_bwd")
    lib = _build.lib("simplified_log")
    _build.check_smem(
        lib.ctc_simplified_log_bwd_smem_bytes(lpad), "simplified_log_bwd", dev
    )
    outs = empty_outputs(dg_l, _log_specs(dg_l, 1, 1))
    with torch.cuda.device(dev):
        err = lib.ctc_simplified_log_bwd(
            blank_l.data_ptr(), dg_l.data_ptr(), lens.data_ptr(), lab_len.data_ptr(),
            loss.data_ptr(), sa.data_ptr(), batch, tpad, lpad,
            *(t.data_ptr() for t in outs),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "simplified_log_bwd")
    simplified_log_bwd.launches += 1
    return outs


simplified_log_bwd.launches = 0


def simplified_log_inputs(ctx: CtcContext):
    """``(blank_l, dg_l, lm, lens, lab_len)``: the inputs of B8 and B9."""
    tpad, lpad, _ = geometry(ctx)
    blank_l, dg_l = _simplified_log_gather_level(ctx, tpad, lpad)
    lm, _nb, _rep = lane_masks(ctx, lpad)
    lens, lab_len = kernel_lengths(ctx)
    return blank_l, dg_l, lm, lens, lab_len


def _pick_single_log_loss(f, label_length):
    return -torch.gather(f, 1, label_length.to(torch.int64)[:, None])[:, 0]


def simplified_loss_exact(ctx: CtcContext) -> torch.Tensor:
    """Exact simplified loss through the log-space kernel B8 (mode final)."""
    batch, num_t, _ = ctx.logproba.shape
    if batch == 0 or num_t == 0 or not fits_log_fallback(ctx, "simplified"):
        return pure_repair("simplified", ctx, "loss")[0]
    blank_l, dg_l, _lm, lens, lab_len = simplified_log_inputs(ctx)
    f = simplified_log_fwd(blank_l, dg_l, lens, "final")
    return _pick_single_log_loss(f, lab_len)


def simplified_loss_and_gradient_log_exact(ctx: CtcContext):
    """``(exact loss, exact log(-grad))`` through B8 (mode resid) and B9:
    one alpha scan yields both."""
    batch, num_t, _ = ctx.logproba.shape
    if batch == 0 or num_t == 0 or not fits_log_fallback(ctx, "simplified"):
        return tuple(pure_repair("simplified", ctx, "grad_log"))
    blank_l, dg_l, lm, lens, lab_len = simplified_log_inputs(ctx)
    sa, f = simplified_log_fwd(blank_l, dg_l, lens, "resid")
    loss = _pick_single_log_loss(f, lab_len)
    pd, _b = simplified_log_bwd(blank_l, dg_l, lens, lab_len, _safe_loss(loss), sa)
    return loss, _gradient_log_from_acts(ctx, pd, lm, loss)


def simplified_gradient_log_exact(ctx: CtcContext) -> torch.Tensor:
    """Exact ``log(-grad)`` through B8 (mode resid) and B9; same semantics
    as ``core.gradient_log`` on the pure path."""
    return simplified_loss_and_gradient_log_exact(ctx)[1]
