"""Block-float classic CTC kernel path: host side, kernel wrappers and their
plain PyTorch versions.

Counterpart of ``tf_seq2seq_losses_tpu/ops/pallas_lattice.py`` for the
classic topology on the single-chunk geometry (window-padded T within
``config.chunk_time``):

* ``classic_fwd`` (csrc/classic_fwd.cu) is the block-float alpha scan in
  modes ``"final"`` (forward-only loss) and ``"resid"`` (training forward,
  streams the residual pack);
* ``classic_bwd_streamed`` (csrc/classic_bwd.cu) is the beta scan over the
  residuals, emitting the combined, loss-normalised act ``pc``.

The simplified topology's kernels (B6, B7) live in ``cuda_simplified.py``,
which shares this module's geometry, block-float primitives, act scatter and
gradient assembly.

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
version (same window schedule, same subnormal rule) for CPU tensors, the
port's analogue of Pallas ``interpret=True``.

Dropped TPU artefacts: the batch sort by ``logit_length``, the 128-lane
label padding and the ``(block_batch, block_time)`` geometry existed to
make TPU grid cells length-homogeneous and lane-aligned.  On the GPU one
CTA per sample stops at its own ``logit_length``, so nothing is sorted or
skipped; lanes are padded to a multiple of 32 (a warp) and time to a
multiple of the window.

The token scatter of the acts (``einsum('btl,blv->btv', pc, ohlm)`` in the
JAX package, outside any kernel there) is :func:`act_scatter`, a
``torch.bmm`` in float64.
"""

from __future__ import annotations

import numpy as np
import torch

from tf_seq2seq_losses_tpu_torch.ops import classic as classic_mod
from tf_seq2seq_losses_tpu_torch.ops.core import CtcContext, take_token_logprobas
from tf_seq2seq_losses_tpu_torch.utils.config import get_config

LN2 = np.float32(0.6931471805599453)
_EBIG = 1 << 30  # "minus infinity" for int exponents
_LANE = 32


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# geometry and transition prep
# ---------------------------------------------------------------------------


def geometry(ctx: CtcContext):
    """``(tpad, lpad, window)`` of the single-chunk kernel path."""
    num_t = ctx.logproba.shape[1]
    k_win = get_config().window
    return _round_up(max(num_t, 1), k_win), _round_up(ctx.label.shape[1], _LANE), k_win


def check_single_chunk(ctx: CtcContext) -> None:
    tpad, _, _ = geometry(ctx)
    chunk = get_config().chunk_time
    if tpad > chunk:
        raise NotImplementedError(
            f"padded T = {tpad} exceeds chunk_time = {chunk}: the chunked "
            "long-T kernel path is not ported yet (ROADMAP A11 and B10)"
        )


def _pad_mask(mask: torch.Tensor, lpad: int) -> torch.Tensor:
    batch, lp1 = mask.shape
    out = torch.zeros((batch, lpad), dtype=torch.float32, device=mask.device)
    out[:, :lp1] = mask.to(torch.float32)
    return out


def lane_masks(ctx: CtcContext, lpad: int):
    """``(lm, nb, rep)`` float [B, lpad]: label-length mask, preceding label
    is not blank, label differs from its predecessor (zero past Lp1)."""
    lm = _pad_mask(ctx.label_length_mask, lpad)
    nb = _pad_mask(ctx.preceded_label != ctx.blank_index, lpad)
    rep = _pad_mask(ctx.label != torch.roll(ctx.label, shifts=1, dims=1), lpad)
    return lm, nb, rep


def kernel_lengths(ctx: CtcContext):
    """``(logit_length clamped to [0, T], label_length)`` as int32."""
    num_t = ctx.logproba.shape[1]
    lens = ctx.logit_length.clamp(0, num_t).to(torch.int32)
    return lens, ctx.label_length.to(torch.int32)


def classic_transitions(ctx: CtcContext, tpad: int, lpad: int):
    """``(blank [B, tpad], dcu [B, tpad, lpad])`` in probability space.

    ``dcu`` is the folded, unmasked expected-token stream ``p[label[l]]``;
    the kernels derive the masked diagonal ``dcu * lm`` and the preceding-
    token probabilities ``dcu[l - 1]``.  Padded steps are no-ops (blank 1,
    every other transition 0); padded lanes carry 0.

    Subnormal rule, first half: a transition probability below the
    smallest normal f32 is 0, as on a TPU, which flushes subnormals.  A
    subnormal transition would otherwise feed a lane mass that the window
    rule (csrc/blockfloat.cuh) drops at the next window while the last
    window's share survives: a finite, wrong loss that the guard, which
    looks for +inf, would not repair.
    """
    batch, num_t, _ = ctx.logproba.shape
    lp1 = ctx.label.shape[1]
    device = ctx.logproba.device
    blank = torch.ones((batch, tpad), dtype=torch.float32, device=device)
    blank[:, :num_t] = _flush_subnormal(torch.exp(ctx.blank_lp))
    dcu = torch.zeros((batch, tpad, lpad), dtype=torch.float32, device=device)
    dcu[:, :num_t, :lp1] = _flush_subnormal(
        torch.exp(take_token_logprobas(ctx.logproba, ctx.label))
    )
    return blank, dcu


def act_scatter(ctx: CtcContext, pc: torch.Tensor, lm: torch.Tensor) -> torch.Tensor:
    """Token sums of the acts, ``[B, T, V]`` f32: ``sums[b, t, v]`` adds
    ``pc[b, t, l]`` over the lanes ``l <= label_length`` that hold token v.

    A ``torch.bmm`` against the label one-hot, in float64: its products are
    exact and its sums round once to float32 whatever the caller's TF32
    setting (a float32 product under TF32 rounds ``pc`` to an 11-bit
    mantissa, 5e-4 relative), and it is deterministic, which an atomic
    ``scatter_add_`` is not (clean rows stay bit for bit across batches)."""
    batch, lp1 = ctx.label.shape
    num_t, num_tokens = ctx.logproba.shape[1:]
    lpad = pc.shape[2]
    idx = torch.zeros((batch, lpad, 1), dtype=torch.int64, device=ctx.label.device)
    idx[:, :lp1, 0] = ctx.label
    onehot = torch.zeros((batch, lpad, num_tokens), dtype=torch.float64, device=pc.device)
    onehot.scatter_(2, idx, lm[:, :, None].to(torch.float64))
    return torch.bmm(pc[:, :num_t].to(torch.float64), onehot).to(torch.float32)


# ---------------------------------------------------------------------------
# block-float primitives of the plain versions (csrc/blockfloat.cuh)
# ---------------------------------------------------------------------------


def _expfield(x: torch.Tensor) -> torch.Tensor:
    return (x.view(torch.int32) >> 23) & 0xFF


def _pow2(k: torch.Tensor) -> torch.Tensor:
    """2^k as f32 for int32 k in [-126, 127]; k <= -127 gives exactly 0."""
    kc = k.clamp(-126, 127)
    f = ((kc + 127) << 23).view(torch.float32)
    return torch.where(k <= -127, torch.zeros_like(f), f)


def _flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    return torch.where(_expfield(x) == 0, torch.zeros_like(x), x)


def _true_exp(mants, e):
    m = mants[0] if len(mants) == 1 else torch.maximum(*mants)
    ef = _expfield(m)
    return torch.where(ef == 0, torch.full_like(e, -_EBIG), e + (ef - 127))


def shift_lanes(x: torch.Tensor, n: int, fill) -> torch.Tensor:
    """Lane shift: ``out[l] = x[l - n]`` (n > 0) or ``x[l + |n|]`` (n < 0),
    ``fill`` where the source lane does not exist."""
    pad = torch.full_like(x[:, : abs(n)], fill)
    if n > 0:
        return torch.cat([pad, x[:, :-n]], dim=1)
    return torch.cat([x[:, -n:], pad], dim=1)


def _open_window(mants, e, k_win: int, forward: bool):
    """Frame over the source lanes ``l-K..l`` (forward) or ``l..l+K``
    (backward) for a carry of one mantissa array (simplified) or two
    (classic); returns the rescaled mantissas, the frame and ``s_arr``."""
    mants = [_flush_subnormal(m) for m in mants]
    et = _true_exp(mants, e)
    f = et
    sign = 1 if forward else -1
    for j in range(1, k_win + 1):
        if j >= et.shape[1]:
            break
        f = torch.maximum(f, shift_lanes(et, sign * j, -_EBIG))
    r = _pow2(e - f)
    s_arr = _pow2(shift_lanes(f, sign, -_EBIG) - f)
    return [m * r for m in mants], f, s_arr


def _act_factor(fa, fb, ebi):
    s = fa.to(torch.float32) + fb.to(torch.float32) - ebi[:, None]
    s = s.clamp(-252.0, 252.0).to(torch.int32)
    h = torch.div(s, 2, rounding_mode="floor")
    return _pow2(h), _pow2(s - h)


# ---------------------------------------------------------------------------
# kernel B1/B2: block-float alpha scan
# ---------------------------------------------------------------------------


def classic_fwd_plain(blank, dcu, lm, nb, rep, lens, k_win: int, mode: str):
    """Plain version of ``classic_fwd`` (same windows, same subnormal rule)."""
    batch, tpad, lpad = dcu.shape
    device = dcu.device
    lane = torch.arange(lpad, device=device)
    a0 = (lane == 0).to(torch.float32).expand(batch, lpad).clone()
    a1 = torch.zeros((batch, lpad), dtype=torch.float32, device=device)
    e = torch.zeros((batch, lpad), dtype=torch.int32, device=device)
    resid = mode == "resid"
    if resid:
        sa = torch.zeros((batch, tpad, 2, lpad), dtype=torch.float32, device=device)
        saf = torch.zeros(
            (batch, tpad // k_win, lpad), dtype=torch.int32, device=device
        )
    lens_c = lens.to(torch.int64)[:, None]
    max_len = int(lens.max()) if batch else 0
    for w in range(-(-max_len // k_win)):
        t0 = w * k_win
        act = t0 < lens_c
        (m0, m1), f, s_arr = _open_window((a0, a1), e, k_win, True)
        a0 = torch.where(act, m0, a0)
        a1 = torch.where(act, m1, a1)
        e = torch.where(act, f, e)
        if resid:
            saf[:, w] = torch.where(act, f, torch.zeros_like(f))
        for t in range(t0, min(t0 + k_win, max_len)):
            run = t < lens_c
            if resid:
                sa[:, t, 0] = torch.where(run, a0, torch.zeros_like(a0))
                sa[:, t, 1] = torch.where(run, a1, torch.zeros_like(a1))
            dcu_t = dcu[:, t]
            dc = dcu_t * lm
            dov = dc * rep
            pm = shift_lanes(dcu_t, 1, 0.0) * nb
            d = a0 * dc + a1 * dov
            arr = shift_lanes(d, 1, 0.0) * s_arr
            n0 = (a0 + a1) * blank[:, t, None]
            n1 = a1 * pm + arr
            a0 = torch.where(run, n0, a0)
            a1 = torch.where(run, n1, a1)
    if resid:
        return sa, saf, a0, a1, e
    return a0, a1, e


def check_tensor(t: torch.Tensor, shape, dtype, name: str, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def classic_fwd(blank, dcu, lm, nb, rep, lens, k_win: int, mode: str):
    """Block-float alpha scan.  ``mode="final"``: ``(f0, f1, fe)``;
    ``mode="resid"``: ``(sa [B, Tp, 2, L], saf [B, Tp/K, L], f0, f1, fe)``.

    CUDA tensors launch csrc/classic_fwd.cu; CPU tensors run
    :func:`classic_fwd_plain`."""
    if mode not in ("final", "resid"):
        raise ValueError(f"unknown classic_fwd mode {mode!r}")
    if dcu.device.type == "cpu":
        return classic_fwd_plain(blank, dcu, lm, nb, rep, lens, k_win, mode)
    if dcu.device.type != "cuda":
        raise ValueError(f"classic_fwd runs on CUDA or CPU tensors, got {dcu.device}")
    from tf_seq2seq_losses_tpu_torch.ops import _build

    batch, tpad, lpad = dcu.shape
    dev = dcu.device
    if tpad % k_win:
        raise ValueError(f"padded T {tpad} is not a multiple of the window {k_win}")
    f32 = torch.float32
    check_tensor(blank, (batch, tpad), f32, "blank", dev)
    check_tensor(dcu, (batch, tpad, lpad), f32, "dcu", dev)
    for name, t in (("lm", lm), ("nb", nb), ("rep", rep)):
        check_tensor(t, (batch, lpad), f32, name, dev)
    check_tensor(lens, (batch,), torch.int32, "lens", dev)
    lib = _build.lib("classic_fwd")
    _build.check_smem(lib.ctc_classic_fwd_smem_bytes(lpad, k_win), "classic_fwd", dev)
    resid = mode == "resid"
    f0 = torch.empty((batch, lpad), dtype=f32, device=dev)
    f1 = torch.empty_like(f0)
    fe = torch.empty((batch, lpad), dtype=torch.int32, device=dev)
    sa = saf = None
    if resid:
        sa = torch.empty((batch, tpad, 2, lpad), dtype=f32, device=dev)
        saf = torch.empty((batch, tpad // k_win, lpad), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.ctc_classic_fwd(
            blank.data_ptr(), dcu.data_ptr(), lm.data_ptr(),
            nb.data_ptr(), rep.data_ptr(), lens.data_ptr(),
            batch, tpad, lpad, k_win, int(resid),
            sa.data_ptr() if resid else None, saf.data_ptr() if resid else None,
            f0.data_ptr(), f1.data_ptr(), fe.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "classic_fwd")
    classic_fwd.launches += 1
    classic_fwd.mode_launches[mode] += 1
    if resid:
        return sa, saf, f0, f1, fe
    return f0, f1, fe


classic_fwd.launches = 0
classic_fwd.mode_launches = {"final": 0, "resid": 0}


# ---------------------------------------------------------------------------
# kernel B3: streamed beta scan emitting the combined act
# ---------------------------------------------------------------------------


def classic_bwd_streamed_plain(blank, dcu, lm, nb, rep, lens, lab_len, ebi, sa,
                               saf, k_win: int):
    """Plain version of ``classic_bwd_streamed``."""
    batch, tpad, lpad = dcu.shape
    device = dcu.device
    lane = torch.arange(lpad, device=device)
    b0 = (lane[None, :] == lab_len.to(torch.int64)[:, None]).to(torch.float32)
    b1 = b0.clone()
    e = torch.zeros((batch, lpad), dtype=torch.int32, device=device)
    pc = torch.zeros((batch, tpad, lpad), dtype=torch.float32, device=device)
    lens_c = lens.to(torch.int64)[:, None]
    max_len = int(lens.max()) if batch else 0
    for w in range(-(-max_len // k_win) - 1, -1, -1):
        t0 = w * k_win
        act = t0 < lens_c
        (m0, m1), f, s_arr = _open_window((b0, b1), e, k_win, False)
        b0 = torch.where(act, m0, b0)
        b1 = torch.where(act, m1, b1)
        e = torch.where(act, f, e)
        s_hi, s_lo = _act_factor(saf[:, w], f, ebi)
        for t in range(min(t0 + k_win, max_len) - 1, t0 - 1, -1):
            run = t < lens_c
            arr = shift_lanes(b1, -1, 0.0) * s_arr
            dcu_t = dcu[:, t]
            dc = dcu_t * lm
            dov = dc * rep
            pt = shift_lanes(dcu_t, 1, 0.0)
            pm = pt * nb
            a0 = sa[:, t, 0]
            a1 = sa[:, t, 1]
            d = a0 * dc + a1 * dov
            pd = d * arr * s_hi * s_lo
            ph = a1 * pt * b1 * s_hi * s_lo
            pc[:, t] = torch.where(run, pd + shift_lanes(ph, -1, 0.0), torch.zeros_like(pd))
            hc = blank[:, t, None] * b0
            n0 = hc + dc * arr
            n1 = hc + pm * b1 + dov * arr
            b0 = torch.where(run, n0, b0)
            b1 = torch.where(run, n1, b1)
    return pc, b0, b1, e


def classic_bwd_streamed(blank, dcu, lm, nb, rep, lens, lab_len, ebi, sa, saf,
                         k_win: int):
    """Beta scan over the residual pack: ``(pc [B, Tp, L], b0, b1, be)``.

    CUDA tensors launch csrc/classic_bwd.cu; CPU tensors run
    :func:`classic_bwd_streamed_plain`."""
    if dcu.device.type == "cpu":
        return classic_bwd_streamed_plain(
            blank, dcu, lm, nb, rep, lens, lab_len, ebi, sa, saf, k_win
        )
    if dcu.device.type != "cuda":
        raise ValueError(
            f"classic_bwd_streamed runs on CUDA or CPU tensors, got {dcu.device}"
        )
    from tf_seq2seq_losses_tpu_torch.ops import _build

    batch, tpad, lpad = dcu.shape
    dev = dcu.device
    if tpad % k_win:
        raise ValueError(f"padded T {tpad} is not a multiple of the window {k_win}")
    f32 = torch.float32
    check_tensor(blank, (batch, tpad), f32, "blank", dev)
    check_tensor(dcu, (batch, tpad, lpad), f32, "dcu", dev)
    for name, t in (("lm", lm), ("nb", nb), ("rep", rep)):
        check_tensor(t, (batch, lpad), f32, name, dev)
    check_tensor(lens, (batch,), torch.int32, "lens", dev)
    check_tensor(lab_len, (batch,), torch.int32, "lab_len", dev)
    check_tensor(ebi, (batch,), f32, "ebi", dev)
    check_tensor(sa, (batch, tpad, 2, lpad), f32, "sa", dev)
    check_tensor(saf, (batch, tpad // k_win, lpad), torch.int32, "saf", dev)
    lib = _build.lib("classic_bwd")
    _build.check_smem(
        lib.ctc_classic_bwd_smem_bytes(lpad, k_win), "classic_bwd_streamed", dev
    )
    pc = torch.empty((batch, tpad, lpad), dtype=f32, device=dev)
    f0 = torch.empty((batch, lpad), dtype=f32, device=dev)
    f1 = torch.empty_like(f0)
    fe = torch.empty((batch, lpad), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.ctc_classic_bwd_streamed(
            blank.data_ptr(), dcu.data_ptr(), lm.data_ptr(),
            nb.data_ptr(), rep.data_ptr(), lens.data_ptr(),
            lab_len.data_ptr(), ebi.data_ptr(), sa.data_ptr(), saf.data_ptr(),
            batch, tpad, lpad, k_win,
            pc.data_ptr(), f0.data_ptr(), f1.data_ptr(), fe.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "classic_bwd_streamed")
    classic_bwd_streamed.launches += 1
    return pc, f0, f1, fe


classic_bwd_streamed.launches = 0


# ---------------------------------------------------------------------------
# entry points of the kernel path
# ---------------------------------------------------------------------------


def pick_loss(mant, fe, label_length):
    """The block-float final carry ``mant * 2^fe`` as a loss, picked at
    label_length (the classic carry passes ``f0 + f1``)."""
    idx = label_length.to(torch.int64)[:, None]
    picked = torch.gather(mant, 1, idx)[:, 0]
    picked_e = torch.gather(fe, 1, idx)[:, 0]
    return -(torch.log(picked) + picked_e.to(torch.float32) * LN2)


def ebi_from_loss(loss: torch.Tensor) -> torch.Tensor:
    """Per-sample act normaliser ``floor(-loss / ln2)`` [B] f32 (0 for
    non-finite losses, whose act rows are masked downstream)."""
    safe = torch.where(torch.isfinite(loss), loss, torch.zeros_like(loss))
    return torch.floor(-safe / LN2)


def kernel_inputs(ctx: CtcContext):
    """``(blank, dcu, lm, nb, rep, lens, lab_len, window)``: the inputs that
    kernels B1, B2 and B3 share."""
    check_single_chunk(ctx)
    tpad, lpad, k_win = geometry(ctx)
    blank, dcu = classic_transitions(ctx, tpad, lpad)
    lm, nb, rep = lane_masks(ctx, lpad)
    lens, lab_len = kernel_lengths(ctx)
    return blank, dcu, lm, nb, rep, lens, lab_len, k_win


def classic_loss_fast(ctx: CtcContext) -> torch.Tensor:
    """Forward-only block-float loss (kernel B1); may flush to +inf."""
    batch, num_t, _ = ctx.logproba.shape
    if batch == 0 or num_t == 0:
        return classic_mod.loss(ctx, classic_mod.alpha(ctx))
    blank, dcu, lm, nb, rep, lens, lab_len, k_win = kernel_inputs(ctx)
    f0, f1, fe = classic_fwd(blank, dcu, lm, nb, rep, lens, k_win, "final")
    return pick_loss(f0 + f1, fe, lab_len)


def classic_loss_and_pack(ctx: CtcContext):
    """Training forward (kernel B2): ``(fast loss, pack)``.  The pack
    ``(kernel inputs, sa, saf, fast loss)`` is the port's own residual
    layout, read back by :func:`classic_gradient_with_loss`.  It keeps the
    prepared transitions (``dcu`` is half the size of ``sa``) so that the
    backward does not gather them again."""
    batch, num_t, _ = ctx.logproba.shape
    if batch == 0 or num_t == 0:
        return classic_mod.loss(ctx, classic_mod.alpha(ctx)), None
    inputs = kernel_inputs(ctx)
    blank, dcu, lm, nb, rep, lens, lab_len, k_win = inputs
    sa, saf, f0, f1, fe = classic_fwd(blank, dcu, lm, nb, rep, lens, k_win, "resid")
    loss = pick_loss(f0 + f1, fe, lab_len)
    return loss, (inputs, sa, saf, loss)


def grad_direct_assemble(ctx: CtcContext, sums, loss_for_mask, scale):
    """Probability-space gradient from the token-scattered acts:
    ``-grad = scale * sums`` for non-blank tokens, the blank column from
    the posterior identity ``sum_v -grad = 1``; infeasible samples and steps
    past logit_length are exactly zero."""
    num_tokens = ctx.logproba.shape[2]
    neg_nb = scale[:, None, None] * sums
    token_is_blank = torch.arange(num_tokens, device=sums.device) == ctx.blank_index
    zero = torch.zeros_like(neg_nb)
    s = torch.sum(torch.where(token_is_blank, zero, neg_nb), dim=2, keepdim=True)
    neg = torch.where(token_is_blank, torch.clamp(1.0 - s, min=0.0), neg_nb)
    grad = -neg
    grad = torch.where(torch.isposinf(loss_for_mask)[:, None, None], zero, grad)
    return torch.where(ctx.logit_length_mask[:, :, None], grad, zero)


def classic_gradient_with_loss(ctx: CtcContext, loss=None, pack=None):
    """Block-float gradient w.r.t. log-probabilities (kernel B3 plus the act
    scatter and assembly): ``(grad [B, T, V], fast loss [B])``.  The fast
    loss comes from the beta carry and is the guard's flush signal."""
    batch, num_t, num_tokens = ctx.logproba.shape
    if batch == 0 or num_t == 0:
        zeros = torch.zeros(
            (batch, num_t, num_tokens), dtype=torch.float32, device=ctx.logproba.device
        )
        if loss is None:
            loss = classic_mod.loss(ctx, classic_mod.alpha(ctx))
        return zeros, loss
    if pack is None:
        _, pack = classic_loss_and_pack(ctx)
    inputs, sa, saf, fwd_loss = pack
    blank, dcu, lm, nb, rep, lens, lab_len, k_win = inputs
    ebi = ebi_from_loss(fwd_loss)
    pc, f0, _f1, fe = classic_bwd_streamed(
        blank, dcu, lm, nb, rep, lens, lab_len, ebi, sa, saf, k_win
    )
    return gradient_from_beta_carry(ctx, pc, lm, ebi, f0[:, 0], fe[:, 0])


def gradient_from_beta_carry(ctx: CtcContext, acts, lm, ebi, beta0, beta0_e):
    """``(grad [B, T, V], fast loss [B])`` from a beta scan's acts and the
    mantissa and exponent of its final carry at lane 0.  The fast loss is
    the guard's flush signal."""
    beta0_e = beta0_e.to(torch.float32)
    fast_loss = -(torch.log(beta0) + beta0_e * LN2)
    # The acts were scaled by 2^-ebi; the posterior scale is
    # exp(fast_loss + ebi ln2) = 2^(ebi - e) / m for the beta carry m * 2^e.
    # Taken from the carry, not through the float32 loss, whose rounding
    # (an ulp of a loss near 1e3 is 1.2e-4) would reach the gradient.
    scale = torch.where(
        torch.isfinite(fast_loss), torch.exp2(ebi - beta0_e) / beta0, torch.exp2(ebi)
    )
    return grad_direct_assemble(ctx, act_scatter(ctx, acts, lm), fast_loss, scale), fast_loss
