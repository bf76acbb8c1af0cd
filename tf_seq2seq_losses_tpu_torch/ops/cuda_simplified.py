"""Block-float simplified CTC kernel path: host side, kernel wrappers and
their plain PyTorch versions.

Counterpart of the simplified part of
``tf_seq2seq_losses_tpu/ops/pallas_lattice.py``.  It lives in its own module
beside ``cuda_lattice.py`` (the classic path), whose geometry and chunk
plan, block-float primitives, packs, act scatter and gradient assembly it
shares:

* ``simplified_fwd`` (csrc/simplified_fwd.cu) is the single-state
  block-float alpha scan in modes ``"final"``, ``"resid"`` (also streams
  the residual pack) and ``"bound"`` (also writes the carry entering each
  window), from the standard t=0 carry or a given one;
* ``simplified_bwd_streamed`` (csrc/simplified_bwd.cu) is the beta scan over
  the streamed residuals, emitting the loss-normalised act ``pd``;
* ``simplified_bwd`` (csrc/simplified_bwd_rf.cu) is the residual-free beta
  scan: it re-expands alpha over each window from its boundary carry.

The time axis runs in chunks as on the classic path (see
``cuda_lattice.py``): forward-only calls scan them in mode ``"final"``; a
training step streams residuals on one chunk when ``stream_residuals``
holds and B6 and B7 hold the label's lanes, and otherwise takes the
residual-free scheme.  ``config.half_stream`` does not apply: the carry
has one state.  Each wrapper is a custom op (``ctc_port::<wrapper>``):
CUDA tensors launch the kernels; CPU tensors run the plain versions (same
window schedule, same subnormal rule).  The simplified act is ``pd`` alone: a non-blank
token is emitted only by a diagonal step, so there is no horizontal ``ph``
term and no second lane exchange.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import Tensor

from tf_seq2seq_losses_tpu_torch.ops import _build
from tf_seq2seq_losses_tpu_torch.ops import simplified as simplified_mod
from tf_seq2seq_losses_tpu_torch.ops.core import CtcContext, take_token_logprobas
from tf_seq2seq_losses_tpu_torch.ops.cuda_lattice import (
    ChunkPack,
    StreamPack,
    _act_factor,
    scaled_act,
    _empty_gradient,
    _flush_subnormal,
    _open_window,
    _pad_mask,
    _steps,
    alpha_init,
    beta_carry_scale,
    beta_init,
    beta_specs,
    carry_args,
    carry_pointers,
    check_aligned,
    check_device,
    check_tensor,
    chunk_lengths,
    chunk_plan,
    ebi_from_loss,
    empty_outputs,
    geometry,
    gradient_from_beta_carry,
    init_kw,
    kernel_lengths,
    kernel_op,
    kernels_hold,
    op_carry,
    pick_loss,
    scatter_chunk,
    shift_lanes,
    streamed_gradient,
    streams_residuals,
)


def simplified_transitions(ctx: CtcContext, lpad: int, t0: int, span: int):
    """``(blank [B, span], dg [B, span, lpad])`` of the steps
    ``t0 .. t0 + span`` in probability space.

    ``dg[l] = p[label[l]] * lm[l]``: the diagonal transition, zero at lanes
    past label_length.  Steps past T are no-ops (blank 1, dg 0); padded
    lanes carry 0.  The subnormal rule of ``classic_transitions`` holds: a
    transition probability below the smallest normal f32 is 0.
    """
    batch = ctx.logproba.shape[0]
    lp1 = ctx.label.shape[1]
    n = _steps(ctx, t0, span)
    device = ctx.logproba.device
    blank = torch.ones((batch, span), dtype=torch.float32, device=device)
    blank[:, :n] = _flush_subnormal(torch.exp(ctx.blank_lp[:, t0:t0 + n]))
    tok = torch.exp(take_token_logprobas(ctx.logproba[:, t0:t0 + n], ctx.label))
    tok = torch.where(ctx.label_length_mask[:, None, :], tok, torch.zeros_like(tok))
    dg = torch.zeros((batch, span, lpad), dtype=torch.float32, device=device)
    dg[:, :n, :lp1] = _flush_subnormal(tok)
    return blank, dg


# ---------------------------------------------------------------------------
# kernel B6/B11 forward: single-state block-float alpha scan
# ---------------------------------------------------------------------------


def _simplified_step(a, blank_t, dg_t, s_arr):
    """One windowed step of the single-state alpha carry (pure f32)."""
    return a * blank_t[:, None] + shift_lanes(a * dg_t, 1, 0.0) * s_arr


def simplified_fwd_plain(blank, dg, lens, k_win: int, mode: str, init=None):
    """Plain version of ``simplified_fwd`` (same windows, same subnormal
    rule)."""
    batch, tpad, lpad = dg.shape
    device = dg.device
    if init is None:
        a, e = alpha_init(batch, lpad, device, 1)
    else:
        a, e = (t.clone() for t in init)
    n_w = tpad // k_win
    if mode == "resid":
        sa = torch.zeros((batch, tpad, lpad), dtype=torch.float32, device=device)
        saf = torch.zeros((batch, n_w, lpad), dtype=torch.int32, device=device)
    if mode == "bound":
        bd = torch.empty((n_w, batch, lpad), dtype=torch.float32, device=device)
        bde = torch.empty((n_w, batch, lpad), dtype=torch.int32, device=device)
    lens_c = lens.to(torch.int64)[:, None]
    max_len = int(lens.max()) if batch else 0
    for w in range(n_w):
        t0 = w * k_win
        if mode == "bound":
            # the carry entering the window; past a sample's length, its final one
            bd[w], bde[w] = a, e
        if t0 >= max_len:
            continue
        act = t0 < lens_c
        (m,), f, s_arr = _open_window((a,), e, k_win, True)
        a = torch.where(act, m, a)
        e = torch.where(act, f, e)
        if mode == "resid":
            saf[:, w] = torch.where(act, f, torch.zeros_like(f))
        for t in range(t0, min(t0 + k_win, max_len)):
            run = t < lens_c
            if mode == "resid":
                sa[:, t] = torch.where(run, a, torch.zeros_like(a))
            a = torch.where(run, _simplified_step(a, blank[:, t], dg[:, t], s_arr), a)
    if mode == "resid":
        return sa, saf, a, e
    if mode == "bound":
        return bd, bde, a, e
    return a, e


_FWD_MODES = {"final": 0, "resid": 1, "bound": 2}


def simplified_fwd(blank, dg, lens, k_win: int, mode: str, init=None):
    """Single-state block-float alpha scan from ``init`` (``(a, e)`` [B, L],
    None for the t=0 carry).  ``mode="final"``: ``(f, fe)``;
    ``mode="resid"``: ``(sa [B, Tp, L], saf [B, Tp/K, L], f, fe)``;
    ``mode="bound"``: ``(b, be [Tp/K, B, L], f, fe)``, the carry entering
    each window.

    The op ``ctc_port::simplified_fwd``: CUDA tensors launch
    csrc/simplified_fwd.cu; CPU tensors run :func:`simplified_fwd_plain`."""
    if mode not in _FWD_MODES:
        raise ValueError(f"unknown simplified_fwd mode {mode!r}")
    check_device(dg, "simplified_fwd")
    return tuple(_simplified_fwd_op(blank, dg, lens, k_win, mode, *carry_args(init, 1)))


def _simplified_fwd_plain_op(blank: Tensor, dg: Tensor, lens: Tensor, k_win: int,
                             mode: str, init_a: Optional[Tensor],
                             init_e: Optional[Tensor]) -> List[Tensor]:
    return list(simplified_fwd_plain(blank, dg, lens, k_win, mode,
                                     op_carry(init_a, init_e)))


_simplified_fwd_op = kernel_op("simplified_fwd", _simplified_fwd_plain_op)


def _fwd_specs(batch: int, tpad: int, lpad: int, k_win: int, mode: str):
    """``(shape, dtype)`` of ``simplified_fwd``'s outputs in ``mode``."""
    f32, i32 = torch.float32, torch.int32
    n_w = tpad // k_win
    row, bnd = (batch, lpad), (n_w, batch, lpad)
    extra = {"final": [],
             "resid": [((batch, tpad, lpad), f32), ((batch, n_w, lpad), i32)],
             "bound": [(bnd, f32), (bnd, i32)]}[mode]
    return extra + [(row, f32), (row, i32)]


@_simplified_fwd_op.register_fake
def _simplified_fwd_fake(blank, dg, lens, k_win, mode, init_a, init_e):
    return empty_outputs(dg, _fwd_specs(*dg.shape, k_win, mode))


@_simplified_fwd_op.register_kernel("cuda")
def _simplified_fwd_launch(blank, dg, lens, k_win, mode, init_a, init_e):
    batch, tpad, lpad = dg.shape
    dev = dg.device
    if tpad % k_win:
        raise ValueError(f"padded T {tpad} is not a multiple of the window {k_win}")
    f32 = torch.float32
    check_tensor(blank, (batch, tpad), f32, "blank", dev)
    check_tensor(dg, (batch, tpad, lpad), f32, "dg", dev)
    check_tensor(lens, (batch,), torch.int32, "lens", dev)
    init_ptrs = carry_pointers(op_carry(init_a, init_e), 1, (batch, lpad), "init", dev)
    check_aligned((("dg", dg),), "simplified_fwd")
    lib = _build.lib("simplified_fwd")
    _build.check_smem(
        lib.ctc_simplified_fwd_smem_bytes(lpad, k_win), "simplified_fwd", dev
    )
    outs = empty_outputs(dg, _fwd_specs(batch, tpad, lpad, k_win, mode))
    *extra, f, fe = outs
    ptrs = [t.data_ptr() for t in extra]
    sa, saf = ptrs if mode == "resid" else (None, None)
    bd, bde = ptrs if mode == "bound" else (None, None)
    with torch.cuda.device(dev):
        err = lib.ctc_simplified_fwd(
            blank.data_ptr(), dg.data_ptr(), lens.data_ptr(), *init_ptrs,
            batch, tpad, lpad, k_win, _FWD_MODES[mode],
            sa, saf, bd, bde, f.data_ptr(), fe.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "simplified_fwd")
    simplified_fwd.launches += 1
    simplified_fwd.mode_launches[mode] += 1
    return outs


simplified_fwd.launches = 0
simplified_fwd.mode_launches = {mode: 0 for mode in _FWD_MODES}


# ---------------------------------------------------------------------------
# kernels B7 and B11 backward: single-state beta scans emitting the act pd
# ---------------------------------------------------------------------------


def _simplified_beta_plain(blank, dg, lens, lab_len, ebi, sa, saf, k_win: int,
                           init=None):
    """The beta scan over alpha residuals that the plain versions of both
    backward kernels share: ``(pd, b, be)``."""
    batch, tpad, lpad = dg.shape
    device = dg.device
    if init is None:
        b, e = beta_init(lab_len, lpad, 1)
    else:
        b, e = (t.clone() for t in init)
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
            p = scaled_act(s_hi, s_lo, sa[:, t], dg_t, arr)
            pd[:, t] = torch.where(run, p, torch.zeros_like(p))
            b = torch.where(run, blank[:, t, None] * b + dg_t * arr, b)
    return pd, b, e


def simplified_bwd_streamed_plain(blank, dg, lens, lab_len, ebi, sa, saf, k_win: int):
    """Plain version of ``simplified_bwd_streamed``."""
    return _simplified_beta_plain(blank, dg, lens, lab_len, ebi, sa, saf, k_win)


def simplified_bwd_streamed(blank, dg, lens, lab_len, ebi, sa, saf, k_win: int):
    """Beta scan over the residual pack: ``(pd [B, Tp, L], b, be)``.

    The op ``ctc_port::simplified_bwd_streamed``: CUDA tensors launch
    csrc/simplified_bwd.cu; CPU tensors run
    :func:`simplified_bwd_streamed_plain`."""
    check_device(dg, "simplified_bwd_streamed")
    return tuple(_simplified_bwd_streamed_op(blank, dg, lens, lab_len, ebi, sa, saf,
                                             k_win))


def _simplified_bwd_streamed_plain_op(blank: Tensor, dg: Tensor, lens: Tensor,
                                      lab_len: Tensor, ebi: Tensor, sa: Tensor,
                                      saf: Tensor, k_win: int) -> List[Tensor]:
    return list(simplified_bwd_streamed_plain(blank, dg, lens, lab_len, ebi, sa, saf,
                                              k_win))


_simplified_bwd_streamed_op = kernel_op("simplified_bwd_streamed",
                                        _simplified_bwd_streamed_plain_op)


def _simplified_beta_fake(blank, dg, *_):
    return empty_outputs(dg, beta_specs(dg, 1))


_simplified_bwd_streamed_op.register_fake(_simplified_beta_fake)


@_simplified_bwd_streamed_op.register_kernel("cuda")
def _simplified_bwd_streamed_launch(blank, dg, lens, lab_len, ebi, sa, saf, k_win):
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
    check_aligned((("dg", dg), ("sa", sa)), "simplified_bwd_streamed")
    lib = _build.lib("simplified_bwd")
    _build.check_smem(
        lib.ctc_simplified_bwd_smem_bytes(lpad, k_win), "simplified_bwd_streamed", dev
    )
    outs = empty_outputs(dg, beta_specs(dg, 1))
    with torch.cuda.device(dev):
        err = lib.ctc_simplified_bwd_streamed(
            blank.data_ptr(), dg.data_ptr(), lens.data_ptr(), lab_len.data_ptr(),
            ebi.data_ptr(), sa.data_ptr(), saf.data_ptr(),
            batch, tpad, lpad, k_win,
            *(t.data_ptr() for t in outs),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "simplified_bwd_streamed")
    simplified_bwd_streamed.launches += 1
    return outs


simplified_bwd_streamed.launches = 0


def _simplified_reexpand_plain(blank, dg, lens, bd, bde, k_win: int):
    """Alpha residuals ``(sa, saf)`` as ``simplified_fwd`` streams them in
    mode resid, re-expanded window by window, each from its own boundary
    carry."""
    batch, tpad, lpad = dg.shape
    sa = torch.zeros((batch, tpad, lpad), dtype=torch.float32, device=dg.device)
    saf = torch.zeros((batch, tpad // k_win, lpad), dtype=torch.int32, device=dg.device)
    lens_c = lens.to(torch.int64)[:, None]
    max_len = int(lens.max()) if batch else 0
    for w in range(-(-max_len // k_win)):
        t0 = w * k_win
        (a,), f, s_arr = _open_window((bd[w],), bde[w], k_win, True)
        saf[:, w] = torch.where(t0 < lens_c, f, torch.zeros_like(f))
        for t in range(t0, min(t0 + k_win, max_len)):
            sa[:, t] = torch.where(t < lens_c, a, torch.zeros_like(a))
            a = _simplified_step(a, blank[:, t], dg[:, t], s_arr)
    return sa, saf


def simplified_bwd_plain(blank, dg, lens, lab_len, ebi, bd, bde, k_win: int,
                         init=None):
    """Plain version of ``simplified_bwd``: the streamed beta scan over the
    residuals that the window boundaries re-expand to."""
    sa, saf = _simplified_reexpand_plain(blank, dg, lens, bd, bde, k_win)
    return _simplified_beta_plain(blank, dg, lens, lab_len, ebi, sa, saf, k_win, init)


def simplified_bwd(blank, dg, lens, lab_len, ebi, bd, bde, k_win: int, init=None):
    """Residual-free beta scan over the window boundaries ``bd, bde``
    [Tp/K, B, L] of ``simplified_fwd`` mode bound, from the beta carry
    ``init`` (``(b, e)`` [B, L]; None for the end of the lattice):
    ``(pd [B, Tp, L], b, be)``, ``pd`` as ``simplified_bwd_streamed`` emits
    it.

    The op ``ctc_port::simplified_bwd``: CUDA tensors launch
    csrc/simplified_bwd_rf.cu; CPU tensors run :func:`simplified_bwd_plain`."""
    check_device(dg, "simplified_bwd")
    return tuple(_simplified_bwd_op(blank, dg, lens, lab_len, ebi, bd, bde, k_win,
                                    *carry_args(init, 1)))


def _simplified_bwd_plain_op(blank: Tensor, dg: Tensor, lens: Tensor, lab_len: Tensor,
                             ebi: Tensor, bd: Tensor, bde: Tensor, k_win: int,
                             init_b: Optional[Tensor],
                             init_e: Optional[Tensor]) -> List[Tensor]:
    return list(simplified_bwd_plain(blank, dg, lens, lab_len, ebi, bd, bde, k_win,
                                     op_carry(init_b, init_e)))


_simplified_bwd_op = kernel_op("simplified_bwd", _simplified_bwd_plain_op)
_simplified_bwd_op.register_fake(_simplified_beta_fake)


@_simplified_bwd_op.register_kernel("cuda")
def _simplified_bwd_launch(blank, dg, lens, lab_len, ebi, bd, bde, k_win, init_b,
                           init_e):
    batch, tpad, lpad = dg.shape
    dev = dg.device
    if tpad % k_win:
        raise ValueError(f"padded T {tpad} is not a multiple of the window {k_win}")
    f32 = torch.float32
    n_w = tpad // k_win
    check_tensor(blank, (batch, tpad), f32, "blank", dev)
    check_tensor(dg, (batch, tpad, lpad), f32, "dg", dev)
    check_tensor(lens, (batch,), torch.int32, "lens", dev)
    check_tensor(lab_len, (batch,), torch.int32, "lab_len", dev)
    check_tensor(ebi, (batch,), f32, "ebi", dev)
    check_tensor(bd, (n_w, batch, lpad), f32, "bd", dev)
    check_tensor(bde, (n_w, batch, lpad), torch.int32, "bde", dev)
    check_aligned((("dg", dg), ("bd", bd), ("bde", bde)), "simplified_bwd")
    init_ptrs = carry_pointers(op_carry(init_b, init_e), 1, (batch, lpad), "init", dev)
    lib = _build.lib("simplified_bwd_rf")
    _build.check_smem(
        lib.ctc_simplified_bwd_rf_smem_bytes(lpad, k_win), "simplified_bwd", dev
    )
    ws = torch.empty((batch, k_win, lpad), dtype=f32, device=dev)
    outs = empty_outputs(dg, beta_specs(dg, 1))
    with torch.cuda.device(dev):
        err = lib.ctc_simplified_bwd_rf(
            blank.data_ptr(), dg.data_ptr(), lens.data_ptr(), lab_len.data_ptr(),
            ebi.data_ptr(), bd.data_ptr(), bde.data_ptr(), *init_ptrs,
            batch, tpad, lpad, k_win, ws.data_ptr(),
            *(t.data_ptr() for t in outs),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "simplified_bwd")
    simplified_bwd.launches += 1
    return outs


simplified_bwd.launches = 0


# ---------------------------------------------------------------------------
# entry points of the kernel path
# ---------------------------------------------------------------------------


def simplified_kernel_inputs(ctx: CtcContext):
    """``(blank, dg, lm, lens, lab_len, window)``: the inputs that kernels
    B6 and B7 share on the one-chunk streamed path (``lm`` weights the act
    scatter)."""
    tpad, lpad, k_win = geometry(ctx)
    blank, dg = simplified_transitions(ctx, lpad, 0, tpad)
    lm = _pad_mask(ctx.label_length_mask, lpad)
    lens, lab_len = kernel_lengths(ctx)
    return blank, dg, lm, lens, lab_len, k_win


def _lane_inputs(ctx: CtcContext):
    """``(lpad, window, lm, lens, lab_len)``: what every chunk's launches
    share."""
    _, lpad, k_win = geometry(ctx)
    return (lpad, k_win, _pad_mask(ctx.label_length_mask, lpad), *kernel_lengths(ctx))


def _chunk(ctx: CtcContext, c: int, chunk_t: int, lpad: int, lens):
    """``(blank, dg, lens)`` of chunk ``c``."""
    t0 = c * chunk_t
    return (*simplified_transitions(ctx, lpad, t0, chunk_t),
            chunk_lengths(lens, t0, chunk_t))


def _pure_loss(ctx: CtcContext) -> torch.Tensor:
    return simplified_mod.loss(ctx, simplified_mod.alpha(ctx))


_STREAMED = ("simplified_fwd", "simplified_bwd")  # B6 mode resid and B7


def simplified_kernels_hold(ctx: CtcContext, training: bool) -> bool:
    """``cuda_lattice.kernels_hold`` for the simplified topology."""
    return kernels_hold(ctx, "simplified_fwd", _STREAMED, "simplified_bwd_rf",
                        training)


def simplified_loss_fast(ctx: CtcContext) -> torch.Tensor:
    """Forward-only block-float loss (kernel B6 in mode final, once per
    chunk); may flush to +inf."""
    batch, num_t, _ = ctx.logproba.shape
    if batch == 0 or num_t == 0:
        return _pure_loss(ctx)
    n_chunks, chunk_t = chunk_plan(ctx)
    lpad, k_win, _lm, lens, lab_len = _lane_inputs(ctx)
    carry = None
    for c in range(n_chunks):
        blank, dg, lens_c = _chunk(ctx, c, chunk_t, lpad, lens)
        carry = simplified_fwd(blank, dg, lens_c, k_win, "final", **init_kw(carry))
    f, fe = carry
    return pick_loss(f, fe, lab_len)


def simplified_loss_and_pack(ctx: CtcContext):
    """Training forward: ``(fast loss, pack)``, by the scheme of
    ``cuda_lattice.classic_loss_and_pack``: a :class:`StreamPack` from
    kernel B6 in mode resid, or a :class:`ChunkPack` (mode bound on one
    chunk, mode final per chunk on several)."""
    batch, num_t, _ = ctx.logproba.shape
    if batch == 0 or num_t == 0:
        return _pure_loss(ctx), None
    n_chunks, chunk_t = chunk_plan(ctx)
    if streams_residuals(ctx, n_chunks, _STREAMED):
        inputs = simplified_kernel_inputs(ctx)
        blank, dg, _lm, lens, lab_len, k_win = inputs
        sa, saf, f, fe = simplified_fwd(blank, dg, lens, k_win, "resid")
        loss = pick_loss(f, fe, lab_len)
        return loss, StreamPack(inputs, sa, saf, loss)
    lpad, k_win, _lm, lens, lab_len = _lane_inputs(ctx)
    if n_chunks == 1:
        blank, dg, lens_c = _chunk(ctx, 0, chunk_t, lpad, lens)
        bd, bde, f, fe = simplified_fwd(blank, dg, lens_c, k_win, "bound")
        loss = pick_loss(f, fe, lab_len)
        return loss, ChunkPack([None], (bd, bde), loss)
    carries, carry = [], None
    for c in range(n_chunks):
        blank, dg, lens_c = _chunk(ctx, c, chunk_t, lpad, lens)
        carries.append(carry)
        carry = simplified_fwd(blank, dg, lens_c, k_win, "final", **init_kw(carry))
    f, fe = carry
    loss = pick_loss(f, fe, lab_len)
    return loss, ChunkPack(carries, None, loss)


def simplified_streamed_acts(ctx: CtcContext, pack):
    """The acts step of the streamed scheme (kernel B7): ``(acts [B, Tp,
    L], lm, backward loss [B], act scale [B])``, as
    ``cuda_lattice.classic_streamed_acts`` gives them."""
    blank, dg, lm, lens, lab_len, k_win = pack.inputs
    ebi = ebi_from_loss(pack.loss)
    pd, f, fe = simplified_bwd_streamed(blank, dg, lens, lab_len, ebi, pack.sa,
                                        pack.saf, k_win)
    return (pd, lm, *beta_carry_scale(pack.loss, ebi, f[:, 0], fe[:, 0]))


def simplified_gradient_with_loss(ctx: CtcContext, loss=None, pack=None):
    """Block-float gradient w.r.t. log-probabilities: ``(grad [B, T, V],
    backward loss [B])``, by the scheme of the pack (kernel B7, or kernel B11
    per chunk, last to first), then the act scatter and the assembly."""
    batch, num_t, num_tokens = ctx.logproba.shape
    if batch == 0 or num_t == 0:
        return _empty_gradient(ctx, loss, _pure_loss)
    if pack is None:
        _, pack = simplified_loss_and_pack(ctx)
    if isinstance(pack, StreamPack):
        return streamed_gradient(ctx, *simplified_streamed_acts(ctx, pack))
    n_chunks, chunk_t = chunk_plan(ctx)
    lpad, k_win, lm, lens, lab_len = _lane_inputs(ctx)
    ebi = ebi_from_loss(pack.loss)
    sums = torch.empty((batch, num_t, num_tokens), dtype=torch.float32,
                       device=ctx.logproba.device)

    def chunk_backward(c, beta):
        # one chunk's launches; its [B, chunk, L] tensors die on return
        blank, dg, lens_c = _chunk(ctx, c, chunk_t, lpad, lens)
        bounds = pack.bounds
        if bounds is None:
            bounds = simplified_fwd(blank, dg, lens_c, k_win, "bound",
                                    **init_kw(pack.carries[c]))[:2]
        pd, *beta = simplified_bwd(blank, dg, lens_c, lab_len, ebi, *bounds, k_win,
                                   beta)
        scatter_chunk(ctx, sums, pd, lm, c * chunk_t)
        return beta

    beta = None
    for c in range(n_chunks - 1, -1, -1):
        beta = chunk_backward(c, beta)
    b, be = beta
    return gradient_from_beta_carry(ctx, sums, pack.loss, ebi, b[:, 0], be[:, 0])
