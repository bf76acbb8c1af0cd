"""Block-float simplified CTC kernel path: host side, kernel wrappers and
their plain PyTorch versions.

Counterpart of the simplified part of
``tf_seq2seq_losses_tpu/ops/pallas_lattice.py`` on the single-chunk
geometry.  It lives in its own module beside ``cuda_lattice.py`` (the
classic path), whose geometry, block-float primitives, act scatter and
gradient assembly it shares:

* ``simplified_fwd`` (csrc/simplified_fwd.cu) is the single-state
  block-float alpha scan in modes ``"final"`` (forward-only loss) and
  ``"resid"`` (training forward, streams the residual pack);
* ``simplified_bwd_streamed`` (csrc/simplified_bwd.cu) is the beta scan over
  the residuals, emitting the loss-normalised act ``pd``.

CUDA tensors launch the kernels; CPU tensors run the plain versions (same
window schedule, same subnormal rule).  The simplified act is ``pd`` alone:
a non-blank token is emitted only by a diagonal step, so there is no
horizontal ``ph`` term and no second lane exchange.
"""

from __future__ import annotations

import torch

from tf_seq2seq_losses_tpu_torch.ops import simplified as simplified_mod
from tf_seq2seq_losses_tpu_torch.ops.core import CtcContext, take_token_logprobas
from tf_seq2seq_losses_tpu_torch.ops.cuda_lattice import (
    _act_factor,
    _flush_subnormal,
    _open_window,
    _pad_mask,
    check_single_chunk,
    check_tensor,
    ebi_from_loss,
    geometry,
    gradient_from_beta_carry,
    kernel_lengths,
    pick_loss,
    shift_lanes,
)


def simplified_transitions(ctx: CtcContext, tpad: int, lpad: int):
    """``(blank [B, tpad], dg [B, tpad, lpad])`` in probability space.

    ``dg[l] = p[label[l]] * lm[l]``: the diagonal transition, zero at lanes
    past label_length.  Padded steps are no-ops (blank 1, dg 0); padded
    lanes carry 0.  The subnormal rule of ``classic_transitions`` holds: a
    transition probability below the smallest normal f32 is 0.
    """
    batch, num_t, _ = ctx.logproba.shape
    lp1 = ctx.label.shape[1]
    device = ctx.logproba.device
    blank = torch.ones((batch, tpad), dtype=torch.float32, device=device)
    blank[:, :num_t] = _flush_subnormal(torch.exp(ctx.blank_lp))
    tok = torch.exp(take_token_logprobas(ctx.logproba, ctx.label))
    tok = torch.where(ctx.label_length_mask[:, None, :], tok, torch.zeros_like(tok))
    dg = torch.zeros((batch, tpad, lpad), dtype=torch.float32, device=device)
    dg[:, :num_t, :lp1] = _flush_subnormal(tok)
    return blank, dg


# ---------------------------------------------------------------------------
# kernel B6: single-state block-float alpha scan
# ---------------------------------------------------------------------------


def simplified_fwd_plain(blank, dg, lens, k_win: int, mode: str):
    """Plain version of ``simplified_fwd`` (same windows, same subnormal
    rule)."""
    batch, tpad, lpad = dg.shape
    device = dg.device
    lane = torch.arange(lpad, device=device)
    a = (lane == 0).to(torch.float32).expand(batch, lpad).clone()
    e = torch.zeros((batch, lpad), dtype=torch.int32, device=device)
    resid = mode == "resid"
    if resid:
        sa = torch.zeros((batch, tpad, lpad), dtype=torch.float32, device=device)
        saf = torch.zeros((batch, tpad // k_win, lpad), dtype=torch.int32, device=device)
    lens_c = lens.to(torch.int64)[:, None]
    max_len = int(lens.max()) if batch else 0
    for w in range(-(-max_len // k_win)):
        t0 = w * k_win
        act = t0 < lens_c
        (m,), f, s_arr = _open_window((a,), e, k_win, True)
        a = torch.where(act, m, a)
        e = torch.where(act, f, e)
        if resid:
            saf[:, w] = torch.where(act, f, torch.zeros_like(f))
        for t in range(t0, min(t0 + k_win, max_len)):
            run = t < lens_c
            if resid:
                sa[:, t] = torch.where(run, a, torch.zeros_like(a))
            arr = shift_lanes(a * dg[:, t], 1, 0.0) * s_arr
            a = torch.where(run, a * blank[:, t, None] + arr, a)
    if resid:
        return sa, saf, a, e
    return a, e


def simplified_fwd(blank, dg, lens, k_win: int, mode: str):
    """Single-state block-float alpha scan.  ``mode="final"``: ``(f, fe)``;
    ``mode="resid"``: ``(sa [B, Tp, L], saf [B, Tp/K, L], f, fe)``.

    CUDA tensors launch csrc/simplified_fwd.cu; CPU tensors run
    :func:`simplified_fwd_plain`."""
    if mode not in ("final", "resid"):
        raise ValueError(f"unknown simplified_fwd mode {mode!r}")
    if dg.device.type == "cpu":
        return simplified_fwd_plain(blank, dg, lens, k_win, mode)
    if dg.device.type != "cuda":
        raise ValueError(f"simplified_fwd runs on CUDA or CPU tensors, got {dg.device}")
    from tf_seq2seq_losses_tpu_torch.ops import _build

    batch, tpad, lpad = dg.shape
    dev = dg.device
    if tpad % k_win:
        raise ValueError(f"padded T {tpad} is not a multiple of the window {k_win}")
    f32 = torch.float32
    check_tensor(blank, (batch, tpad), f32, "blank", dev)
    check_tensor(dg, (batch, tpad, lpad), f32, "dg", dev)
    check_tensor(lens, (batch,), torch.int32, "lens", dev)
    lib = _build.lib("simplified_fwd")
    _build.check_smem(
        lib.ctc_simplified_fwd_smem_bytes(lpad, k_win), "simplified_fwd", dev
    )
    resid = mode == "resid"
    f = torch.empty((batch, lpad), dtype=f32, device=dev)
    fe = torch.empty((batch, lpad), dtype=torch.int32, device=dev)
    sa = saf = None
    if resid:
        sa = torch.empty((batch, tpad, lpad), dtype=f32, device=dev)
        saf = torch.empty((batch, tpad // k_win, lpad), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.ctc_simplified_fwd(
            blank.data_ptr(), dg.data_ptr(), lens.data_ptr(),
            batch, tpad, lpad, k_win, int(resid),
            sa.data_ptr() if resid else None, saf.data_ptr() if resid else None,
            f.data_ptr(), fe.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "simplified_fwd")
    simplified_fwd.launches += 1
    simplified_fwd.mode_launches[mode] += 1
    if resid:
        return sa, saf, f, fe
    return f, fe


simplified_fwd.launches = 0
simplified_fwd.mode_launches = {"final": 0, "resid": 0}


# ---------------------------------------------------------------------------
# kernel B7: streamed single-state beta scan emitting the act pd
# ---------------------------------------------------------------------------


def simplified_bwd_streamed_plain(blank, dg, lens, lab_len, ebi, sa, saf, k_win: int):
    """Plain version of ``simplified_bwd_streamed``."""
    batch, tpad, lpad = dg.shape
    device = dg.device
    lane = torch.arange(lpad, device=device)
    b = (lane[None, :] == lab_len.to(torch.int64)[:, None]).to(torch.float32)
    e = torch.zeros((batch, lpad), dtype=torch.int32, device=device)
    pd = torch.zeros((batch, tpad, lpad), dtype=torch.float32, device=device)
    lens_c = lens.to(torch.int64)[:, None]
    max_len = int(lens.max()) if batch else 0
    for w in range(-(-max_len // k_win) - 1, -1, -1):
        t0 = w * k_win
        act = t0 < lens_c
        (m,), f, s_arr = _open_window((b,), e, k_win, False)
        b = torch.where(act, m, b)
        e = torch.where(act, f, e)
        s_hi, s_lo = _act_factor(saf[:, w], f, ebi)
        for t in range(min(t0 + k_win, max_len) - 1, t0 - 1, -1):
            run = t < lens_c
            arr = shift_lanes(b, -1, 0.0) * s_arr
            dg_t = dg[:, t]
            p = (sa[:, t] * dg_t) * arr * s_hi * s_lo
            pd[:, t] = torch.where(run, p, torch.zeros_like(p))
            b = torch.where(run, blank[:, t, None] * b + dg_t * arr, b)
    return pd, b, e


def simplified_bwd_streamed(blank, dg, lens, lab_len, ebi, sa, saf, k_win: int):
    """Beta scan over the residual pack: ``(pd [B, Tp, L], b, be)``.

    CUDA tensors launch csrc/simplified_bwd.cu; CPU tensors run
    :func:`simplified_bwd_streamed_plain`."""
    if dg.device.type == "cpu":
        return simplified_bwd_streamed_plain(blank, dg, lens, lab_len, ebi, sa, saf, k_win)
    if dg.device.type != "cuda":
        raise ValueError(
            f"simplified_bwd_streamed runs on CUDA or CPU tensors, got {dg.device}"
        )
    from tf_seq2seq_losses_tpu_torch.ops import _build

    batch, tpad, lpad = dg.shape
    dev = dg.device
    if tpad % k_win:
        raise ValueError(f"padded T {tpad} is not a multiple of the window {k_win}")
    f32 = torch.float32
    check_tensor(blank, (batch, tpad), f32, "blank", dev)
    check_tensor(dg, (batch, tpad, lpad), f32, "dg", dev)
    check_tensor(lens, (batch,), torch.int32, "lens", dev)
    check_tensor(lab_len, (batch,), torch.int32, "lab_len", dev)
    check_tensor(ebi, (batch,), f32, "ebi", dev)
    check_tensor(sa, (batch, tpad, lpad), f32, "sa", dev)
    check_tensor(saf, (batch, tpad // k_win, lpad), torch.int32, "saf", dev)
    lib = _build.lib("simplified_bwd")
    _build.check_smem(
        lib.ctc_simplified_bwd_smem_bytes(lpad, k_win), "simplified_bwd_streamed", dev
    )
    pd = torch.empty((batch, tpad, lpad), dtype=f32, device=dev)
    f = torch.empty((batch, lpad), dtype=f32, device=dev)
    fe = torch.empty((batch, lpad), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.ctc_simplified_bwd_streamed(
            blank.data_ptr(), dg.data_ptr(), lens.data_ptr(), lab_len.data_ptr(),
            ebi.data_ptr(), sa.data_ptr(), saf.data_ptr(),
            batch, tpad, lpad, k_win,
            pd.data_ptr(), f.data_ptr(), fe.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "simplified_bwd_streamed")
    simplified_bwd_streamed.launches += 1
    return pd, f, fe


simplified_bwd_streamed.launches = 0


# ---------------------------------------------------------------------------
# entry points of the kernel path
# ---------------------------------------------------------------------------


def simplified_kernel_inputs(ctx: CtcContext):
    """``(blank, dg, lm, lens, lab_len, window)``: the inputs that kernels
    B6 and B7 share (``lm`` weights the act scatter)."""
    check_single_chunk(ctx)
    tpad, lpad, k_win = geometry(ctx)
    blank, dg = simplified_transitions(ctx, tpad, lpad)
    lm = _pad_mask(ctx.label_length_mask, lpad)
    lens, lab_len = kernel_lengths(ctx)
    return blank, dg, lm, lens, lab_len, k_win


def _pure_loss(ctx: CtcContext) -> torch.Tensor:
    return simplified_mod.loss(ctx, simplified_mod.alpha(ctx))


def simplified_loss_fast(ctx: CtcContext) -> torch.Tensor:
    """Forward-only block-float loss (kernel B6, mode final); may flush to
    +inf."""
    batch, num_t, _ = ctx.logproba.shape
    if batch == 0 or num_t == 0:
        return _pure_loss(ctx)
    blank, dg, _lm, lens, lab_len, k_win = simplified_kernel_inputs(ctx)
    f, fe = simplified_fwd(blank, dg, lens, k_win, "final")
    return pick_loss(f, fe, lab_len)


def simplified_loss_and_pack(ctx: CtcContext):
    """Training forward (kernel B6, mode resid): ``(fast loss, pack)``; the
    pack ``(kernel inputs, sa, saf, fast loss)`` is read back by
    :func:`simplified_gradient_with_loss`."""
    batch, num_t, _ = ctx.logproba.shape
    if batch == 0 or num_t == 0:
        return _pure_loss(ctx), None
    inputs = simplified_kernel_inputs(ctx)
    blank, dg, _lm, lens, lab_len, k_win = inputs
    sa, saf, f, fe = simplified_fwd(blank, dg, lens, k_win, "resid")
    loss = pick_loss(f, fe, lab_len)
    return loss, (inputs, sa, saf, loss)


def simplified_gradient_with_loss(ctx: CtcContext, loss=None, pack=None):
    """Block-float gradient w.r.t. log-probabilities (kernel B7 plus the act
    scatter and assembly): ``(grad [B, T, V], fast loss [B])``."""
    batch, num_t, num_tokens = ctx.logproba.shape
    if batch == 0 or num_t == 0:
        zeros = torch.zeros(
            (batch, num_t, num_tokens), dtype=torch.float32, device=ctx.logproba.device
        )
        return zeros, _pure_loss(ctx) if loss is None else loss
    if pack is None:
        _, pack = simplified_loss_and_pack(ctx)
    inputs, sa, saf, fwd_loss = pack
    blank, dg, lm, lens, lab_len, k_win = inputs
    ebi = ebi_from_loss(fwd_loss)
    pd, f, fe = simplified_bwd_streamed(blank, dg, lens, lab_len, ebi, sa, saf, k_win)
    return gradient_from_beta_carry(ctx, pd, lm, ebi, f[:, 0], fe[:, 0])
