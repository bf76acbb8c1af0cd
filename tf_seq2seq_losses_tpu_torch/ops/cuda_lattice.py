"""Block-float classic CTC kernel path: host side, kernel wrappers and their
plain PyTorch versions.

Counterpart of ``tf_seq2seq_losses_tpu/ops/pallas_lattice.py`` for the
classic topology:

* ``classic_fwd`` (csrc/classic_fwd.cu) is the block-float alpha scan in
  modes ``"final"`` (the final carry), ``"resid"`` (also streams the
  residual pack), ``"resid1"`` (also streams the half-stream pack: ``a1``
  per step, ``a0`` per window) and ``"bound"`` (also writes the carry
  entering each window), from the standard t=0 carry or a given one;
* ``classic_bwd_streamed`` (csrc/classic_bwd.cu) is the beta scan over the
  streamed residuals, emitting the combined, loss-normalised act ``pc``;
* ``classic_bwd_half`` (csrc/classic_bwd_half.cu) is the same scan over the
  half-stream pack, rebuilding each window's ``a0`` first;
* ``classic_bwd`` (csrc/classic_bwd_rf.cu) is the residual-free beta scan:
  it re-expands alpha over each window from its boundary carry and emits
  the same ``pc``, from a given beta carry or the standard one.

The time axis, padded to whole windows, runs in equal chunks of at most
``config.chunk_time`` steps (:func:`chunk_plan`), each chunk starting from
the carry the previous one left, so ``[B, T, L]`` tensors only ever exist
one chunk wide.  Forward-only calls scan the chunks in mode ``"final"``.
A training step streams residuals when the axis is one chunk,
``config.stream_residuals`` holds and the streamed kernels' shared memory
holds the label's lanes (B2, then B3; with ``config.half_stream``, B13's
forward and backward); otherwise it keeps the chunk-initial carries, and
the backward walks the chunks last to first, regenerating each chunk's
transitions and window boundaries (mode ``"bound"``) and chaining the beta
carry (the residual-free scheme; on one chunk the forward itself runs in
mode ``"bound"``).

The simplified topology's kernels (B6, B7, B11) live in
``cuda_simplified.py``, which shares this module's geometry, block-float
primitives, packs, act scatter and gradient assembly.

Each wrapper is a custom op, ``ctc_port::<wrapper>`` (:func:`kernel_op`),
which launches its CUDA kernel for CUDA tensors and runs its plain version
(same window schedule, same subnormal rule) for CPU tensors, the port's
analogue of Pallas ``interpret=True``; under ``torch.compile`` it is one
opaque node of the graph, its fake giving its outputs' shapes.

Dropped TPU artefacts: the batch sort by ``logit_length``, the 128-lane
label padding and the ``(block_batch, block_time)`` geometry existed to
make TPU grid cells length-homogeneous and lane-aligned.  On the GPU one
CTA per sample stops at its own ``logit_length``, so nothing is sorted or
skipped; lanes are padded to a multiple of 32 (a warp) and time to a
multiple of the window, which is also the residual-free scheme's time block.

The token scatter of the acts (``einsum('btl,blv->btv', pc, ohlm)`` in the
JAX package, outside any kernel there) is :func:`act_scatter`, a
``torch.bmm`` in float64, one chunk at a time.  On the streamed scheme,
with ``config.fused_epilogue``, ``fused_dlogits`` (csrc/fused_epilogue.cu,
kernel B12) scatters, assembles the gradient and applies the log-softmax
cotangent in one pass instead, for either topology.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch
from torch import Tensor

from tf_seq2seq_losses_tpu_torch.ops import _build
from tf_seq2seq_losses_tpu_torch.ops import classic as classic_mod
from tf_seq2seq_losses_tpu_torch.ops.core import (
    CtcContext,
    index_tensor,
    take_token_logprobas,
)
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
    """``(tpad, lpad, window)``: T padded to whole windows, lanes to a warp."""
    num_t = ctx.logproba.shape[1]
    k_win = get_config().window
    return _round_up(max(num_t, 1), k_win), _round_up(ctx.label.shape[1], _LANE), k_win


def chunk_steps() -> int:
    """The most steps of a chunk: ``config.chunk_time`` floored to whole
    windows, one window at least."""
    k_win = get_config().window
    return max(k_win, get_config().chunk_time // k_win * k_win)


def chunk_plan(ctx: CtcContext):
    """``(n_chunks, chunk_t)``: the window-padded time axis in equal chunks,
    each a whole number of windows and at most :func:`chunk_steps` steps,
    as ``_chunk_plan`` of the JAX package cuts it.
    Window boundaries fall where the one-chunk scan puts them, so the
    chunked result equals the unchunked one bit for bit.  The chunks may
    overhang T by up to a window each: those steps are no-ops."""
    tpad, _, k_win = geometry(ctx)
    cmax = chunk_steps()
    n_chunks = -(-tpad // cmax)
    return n_chunks, -(-(tpad // k_win) // n_chunks) * k_win


def chunk_lengths(lens: torch.Tensor, t0: int, chunk_t: int) -> torch.Tensor:
    """Steps each sample runs in the chunk starting at ``t0``: its length
    relative to the chunk, ``clamp(lens - t0, 0, chunk_t)``."""
    return (lens - t0).clamp(0, chunk_t).to(torch.int32)


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


def _steps(ctx: CtcContext, t0: int, span: int) -> int:
    """Steps of ``[t0, t0 + span)`` inside the time axis."""
    return max(0, min(ctx.logproba.shape[1], t0 + span) - t0)


def classic_transitions(ctx: CtcContext, lpad: int, t0: int, span: int):
    """``(blank [B, span], dcu [B, span, lpad])`` of the steps
    ``t0 .. t0 + span`` in probability space.

    ``dcu`` is the folded, unmasked expected-token stream ``p[label[l]]``;
    the kernels derive the masked diagonal ``dcu * lm`` and the preceding-
    token probabilities ``dcu[l - 1]``.  Steps past T are no-ops (blank 1,
    every other transition 0); padded lanes carry 0.

    Subnormal rule, first half: a transition probability below the
    smallest normal f32 is 0, as on a TPU, which flushes subnormals.  A
    subnormal transition would otherwise feed a lane mass that the window
    rule (csrc/blockfloat.cuh) drops at the next window while the last
    window's share survives: a finite, wrong loss that the guard, which
    looks for +inf, would not repair.
    """
    batch = ctx.logproba.shape[0]
    lp1 = ctx.label.shape[1]
    n = _steps(ctx, t0, span)
    device = ctx.logproba.device
    blank = torch.ones((batch, span), dtype=torch.float32, device=device)
    blank[:, :n] = _flush_subnormal(torch.exp(ctx.blank_lp[:, t0:t0 + n]))
    dcu = torch.zeros((batch, span, lpad), dtype=torch.float32, device=device)
    dcu[:, :n, :lp1] = _flush_subnormal(
        torch.exp(take_token_logprobas(ctx.logproba[:, t0:t0 + n], ctx.label))
    )
    return blank, dcu


def lane_tokens(ctx: CtcContext, lpad: int) -> torch.Tensor:
    """The token of each lane, ``[B, lpad]`` int32 (0 on padded lanes)."""
    batch, lp1 = ctx.label.shape
    out = torch.zeros((batch, lpad), dtype=torch.int32, device=ctx.label.device)
    out[:, :lp1] = ctx.label
    return out


def token_sums(acts: torch.Tensor, tokens: torch.Tensor, lm: torch.Tensor,
               num_tokens: int) -> torch.Tensor:
    """``sums[b, t, v]``, the acts ``acts[b, t, l]`` of the lanes with
    ``lm[b, l] = 1`` and ``tokens[b, l] = v``, ``[B, steps, V]`` f32.

    A ``torch.bmm`` against the label one-hot, in float64: its products are
    exact and its sums round once to float32 whatever the caller's TF32
    setting (a float32 product under TF32 rounds the acts to an 11-bit
    mantissa, 5e-4 relative), and it is deterministic, which an atomic
    ``scatter_add_`` is not (clean rows stay bit for bit across batches)."""
    batch, lpad = tokens.shape
    onehot = torch.zeros((batch, lpad, num_tokens), dtype=torch.float64,
                         device=acts.device)
    onehot.scatter_(2, tokens.to(torch.int64)[:, :, None],
                    lm[:, :, None].to(torch.float64))
    return torch.bmm(acts.to(torch.float64), onehot).to(torch.float32)


def act_scatter(ctx: CtcContext, pc: torch.Tensor, lm: torch.Tensor) -> torch.Tensor:
    """Token sums (:func:`token_sums`) of the acts of some steps over the
    lanes ``l < label_length``, ``[B, steps, V]`` f32."""
    return token_sums(pc, lane_tokens(ctx, pc.shape[2]), lm, ctx.logproba.shape[2])


def scatter_chunk(ctx: CtcContext, sums, acts, lm, t0: int) -> None:
    """Write the token sums of one chunk's acts into ``sums[:, t0:]``."""
    n = _steps(ctx, t0, acts.shape[1])
    if n:
        sums[:, t0:t0 + n] = act_scatter(ctx, acts[:, :n], lm)


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


def scaled_act(s_hi, s_lo, *factors):
    """An act: the product of ``factors`` scaled by ``s_hi * s_lo``, in
    float64, rounded once to float32 (``scaled_act`` of csrc/blockfloat.cuh:
    an f32 product of mantissas far below their frames underflows)."""
    out = factors[0].double()
    for f in factors[1:]:
        out = out * f.double()
    return (out * (s_hi.double() * s_lo.double())).float()


def _act_factor(fa, fb, ebi):
    s = fa.to(torch.float32) + fb.to(torch.float32) - ebi[:, None]
    s = s.clamp(-252.0, 252.0).to(torch.int32)
    h = torch.div(s, 2, rounding_mode="floor")
    return _pow2(h), _pow2(s - h)


def alpha_init(batch: int, lpad: int, device, states: int):
    """The standard t=0 carry: unit mass at lane 0 (in the closed state of
    a two-state carry), exponent 0; ``states`` mantissa arrays."""
    lane = torch.arange(lpad, device=device)
    unit = (lane == 0).to(torch.float32).expand(batch, lpad).clone()
    zeros = [torch.zeros((batch, lpad), dtype=torch.float32, device=device)
             for _ in range(states - 1)]
    return (unit, *zeros, torch.zeros((batch, lpad), dtype=torch.int32, device=device))


def beta_init(lab_len: torch.Tensor, lpad: int, states: int):
    """The standard beta carry at the end of the lattice: one-hot at
    label_length in every state, exponent 0."""
    lane = torch.arange(lpad, device=lab_len.device)
    hot = (lane[None, :] == lab_len.to(torch.int64)[:, None]).to(torch.float32)
    e = torch.zeros_like(hot, dtype=torch.int32)
    return (*[hot.clone() for _ in range(states)], e)


def init_kw(carry) -> dict:
    """Keyword arguments that start a scan from ``carry``: ``init=carry``,
    or none for the standard carry (None)."""
    return {} if carry is None else {"init": carry}


def check_tensor(t: torch.Tensor, shape, dtype, name: str, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def carry_args(carry, states: int, name: str = "init") -> tuple:
    """A carry as a kernel op's ``states + 1`` optional arguments (its
    mantissa arrays, then its exponent), Nones for the standard carry
    (``carry`` None)."""
    if carry is None:
        return (None,) * (states + 1)
    if len(carry) != states + 1:
        raise ValueError(f"{name} must hold {states + 1} arrays, got {len(carry)}")
    return tuple(carry)


def op_carry(*parts):
    """The carry of a kernel op's optional arguments (:func:`carry_args`):
    None where they are None."""
    return None if parts[0] is None else parts


def check_dtype(tensors, dtype, what: str) -> None:
    """Raise unless every tensor of ``tensors`` (pairs of name and tensor)
    is of ``dtype``."""
    for name, t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} must be {dtype}, got {t.dtype}")


def check_device(t: torch.Tensor, what: str) -> None:
    """Raise unless ``t`` lies on the CPU (the plain version runs) or on a
    CUDA device (the kernel launches)."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got {t.device}")


def kernel_op(name: str, plain):
    """Declare ``ctc_port::<name>``, the custom op of a kernel wrapper:
    ``plain`` (its plain version, typed for the op's schema) is the CPU
    implementation; the caller registers the launch with
    ``register_kernel("cuda")`` and the outputs' shapes with
    ``register_fake``.  ``torch.compile`` keeps the op opaque in its graph;
    the device of its tensors picks the implementation."""
    return torch.library.custom_op(f"ctc_port::{name}", plain, mutates_args=(),
                                   device_types="cpu")


def op_with_grad(name: str, wrt, backward):
    """The custom op ``ctc_port::<name>`` with a gradient: a callable that
    calls the op where no gradient is asked of it, and else an
    ``autograd.Function`` whose forward is the op and whose backward is
    ``backward(args, grads)``, the gradients of the arguments at the
    positions ``wrt`` (float tensors), in that order, from the saved
    arguments and the outputs' gradients.

    ``.backward()``, ``torch.autograd.grad``, ``torch.func.grad`` and
    ``torch.compile`` (AOTAutograd traces the backward) take it; so does
    ``vmap``, which maps the forward and the backward alike
    (``generate_vmap_rule``), each op folding the groups into its batch
    (:func:`register_fold`).  ``register_autograd`` on the op would refuse
    ``torch.func.grad``, and an ``autograd.Function`` around the op breaks
    Dynamo when nothing requires grad, hence the switch."""
    op = getattr(torch.ops.ctc_port, name).default

    class Grad(torch.autograd.Function):
        generate_vmap_rule = True

        @staticmethod
        def forward(*args):
            return op(*args)

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.save_for_backward(*(x for x in inputs if isinstance(x, torch.Tensor)))
            ctx.consts = [None if isinstance(x, torch.Tensor) else x for x in inputs]

        @staticmethod
        def backward(ctx, *grads):
            saved = iter(ctx.saved_tensors)
            args = [next(saved) if c is None else c for c in ctx.consts]
            res = [None] * len(args)
            for i, g in zip(wrt, backward(args, grads)):
                res[i] = g
            return tuple(res)

    def call(*args):
        if torch.is_grad_enabled() and any(args[i].requires_grad for i in wrt):
            return Grad.apply(*args)
        return op(*args)

    return call


def plain_grad(name: str, plain, wrt, outs):
    """:func:`op_with_grad` with the gradient of ``plain``, the op's plain
    version: the backward runs ``plain`` again on the saved inputs and
    pulls the gradients of the outputs at the positions ``outs`` back
    through it (``torch.func.vjp``), bit for bit the loop's own gradient,
    on CPU and CUDA tensors alike.  For a backward op, whose derivative (a
    second derivative of the score) runs its out-of-place plain version
    again; ``torch.func.grad`` tracks a backward's inputs, so the backward
    op takes this route there too."""
    def backward(args, grads):
        def pulled(*diff):
            for i, d in zip(wrt, diff):
                args[i] = d
            got = plain(*args)
            got = (got,) if isinstance(got, torch.Tensor) else got
            return tuple(got[j] for j in outs)

        _, vjp = torch.func.vjp(pulled, *(args[i] for i in wrt))
        return vjp(tuple(grads[j] for j in outs))

    return op_with_grad(name, wrt, backward)


def register_fold(op, batch_axes, out_axes) -> None:
    """Register the ``vmap`` rule of the custom op ``op``: the mapped groups
    fold into the batch, the op runs once, the outputs unfold.

    ``batch_axes`` gives, for each argument, the axis of its batch dimension
    (None for an argument without one: an int, or the blank index, which
    ``vmap`` must leave unmapped); ``out_axes`` the same for each output.  A
    mapped argument moves its groups beside its batch axis, an unmapped one
    is expanded over the groups, and both fold ``[..., G, B, ...]`` into
    ``[..., G * B, ...]``; each output unfolds at its batch axis, which is
    then its mapped dimension."""
    def rule(info, in_dims, *args):
        groups = info.batch_size
        folded = []
        for x, dim, axis in zip(args, in_dims, batch_axes):
            if axis is None:
                if dim is not None:
                    raise ValueError(
                        "vmap maps an argument without a batch axis (the blank index): "
                        "the folded batch takes one; pass the same value to every group "
                        "(unmapped)")
                folded.append(x)
                continue
            x = x.movedim(dim, 0) if dim is not None else x.expand(groups, *x.shape)
            folded.append(x.movedim(0, axis).flatten(axis, axis + 1).contiguous())
        outs = op(*folded)
        if not isinstance(outs, tuple):
            return outs.unflatten(out_axes[0], (groups, -1)), out_axes[0]
        return (tuple(o.unflatten(a, (groups, -1)) for o, a in zip(outs, out_axes)),
                tuple(out_axes))

    op.register_vmap(rule)


def empty_outputs(like: torch.Tensor, specs) -> List[torch.Tensor]:
    """New tensors on ``like``'s device, one a ``(shape, dtype)`` of
    ``specs``: a kernel op's outputs (its launch and its fake alike)."""
    return [torch.empty(shape, dtype=dtype, device=like.device) for shape, dtype in specs]


def carry_pointers(carry, states: int, shape, name: str, device):
    """Data pointers of a carry (``states`` mantissa arrays f32, then the
    exponent int32, each of ``shape``), or Nones for the standard carry
    (``carry`` None)."""
    if carry is None:
        return (None,) * (states + 1)
    *mants, e = carry
    for i, m in enumerate(mants):
        check_tensor(m, shape, torch.float32, f"{name}[{i}]", device)
    check_tensor(e, shape, torch.int32, f"{name} exponent", device)
    return tuple(t.data_ptr() for t in (*mants, e))


def check_aligned(tensors, what: str) -> None:
    """Raise unless every tensor of ``tensors`` (pairs of name and tensor)
    starts on a 16-byte boundary, as a kernel's bulk copies of its rows
    need."""
    for name, t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must start on a 16-byte boundary")


def check_scan_inputs(blank, dcu, lm, nb, rep, lens, k_win: int):
    """Check the inputs that every classic block-float scan takes (CUDA
    tensors); returns ``(batch, tpad, lpad, device)``."""
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
    return batch, tpad, lpad, dev


# ---------------------------------------------------------------------------
# kernel B1/B2/B10 forward: block-float alpha scan
# ---------------------------------------------------------------------------


def _classic_step(a0, a1, blank_t, dcu_t, lm, nb, rep, s_arr):
    """One windowed step of the two-state alpha carry (pure f32)."""
    dc = dcu_t * lm
    dov = dc * rep
    pm = shift_lanes(dcu_t, 1, 0.0) * nb
    d = a0 * dc + a1 * dov
    arr = shift_lanes(d, 1, 0.0) * s_arr
    return (a0 + a1) * blank_t[:, None], a1 * pm + arr


def classic_fwd_plain(blank, dcu, lm, nb, rep, lens, k_win: int, mode: str, init=None):
    """Plain version of ``classic_fwd`` (same windows, same subnormal rule)."""
    batch, tpad, lpad = dcu.shape
    device = dcu.device
    if init is None:
        a0, a1, e = alpha_init(batch, lpad, device, 2)
    else:
        a0, a1, e = (t.clone() for t in init)
    n_w = tpad // k_win
    if mode in ("resid", "resid1"):
        saf = torch.zeros((batch, n_w, lpad), dtype=torch.int32, device=device)
    if mode == "resid":
        sa = torch.zeros((batch, tpad, 2, lpad), dtype=torch.float32, device=device)
    if mode == "resid1":
        sa1 = torch.zeros((batch, tpad, lpad), dtype=torch.float32, device=device)
        a0w = torch.zeros((batch, n_w, lpad), dtype=torch.float32, device=device)
    if mode == "bound":
        bd0 = torch.empty((n_w, batch, lpad), dtype=torch.float32, device=device)
        bd1 = torch.empty_like(bd0)
        bde = torch.empty((n_w, batch, lpad), dtype=torch.int32, device=device)
    lens_c = lens.to(torch.int64)[:, None]
    max_len = int(lens.max()) if batch else 0
    for w in range(n_w):
        t0 = w * k_win
        if mode == "bound":
            # the carry entering the window; past a sample's length, its final one
            bd0[w], bd1[w], bde[w] = a0, a1, e
        if t0 >= max_len:
            continue
        act = t0 < lens_c
        (m0, m1), f, s_arr = _open_window((a0, a1), e, k_win, True)
        a0 = torch.where(act, m0, a0)
        a1 = torch.where(act, m1, a1)
        e = torch.where(act, f, e)
        if mode in ("resid", "resid1"):
            saf[:, w] = torch.where(act, f, torch.zeros_like(f))
        if mode == "resid1":
            a0w[:, w] = torch.where(act, a0, torch.zeros_like(a0))
        for t in range(t0, min(t0 + k_win, max_len)):
            run = t < lens_c
            if mode == "resid":
                sa[:, t, 0] = torch.where(run, a0, torch.zeros_like(a0))
                sa[:, t, 1] = torch.where(run, a1, torch.zeros_like(a1))
            if mode == "resid1":
                sa1[:, t] = torch.where(run, a1, torch.zeros_like(a1))
            n0, n1 = _classic_step(a0, a1, blank[:, t], dcu[:, t], lm, nb, rep, s_arr)
            a0 = torch.where(run, n0, a0)
            a1 = torch.where(run, n1, a1)
    if mode == "resid":
        return sa, saf, a0, a1, e
    if mode == "resid1":
        return sa1, saf, a0w, a0, a1, e
    if mode == "bound":
        return bd0, bd1, bde, a0, a1, e
    return a0, a1, e


_FWD_MODES = {"final": 0, "resid": 1, "bound": 2, "resid1": 3}


def classic_fwd(blank, dcu, lm, nb, rep, lens, k_win: int, mode: str, init=None):
    """Block-float alpha scan from ``init`` (``(a0, a1, e)`` [B, L], None
    for the t=0 carry).  ``mode="final"``: ``(f0, f1, fe)``;
    ``mode="resid"``: ``(sa [B, Tp, 2, L], saf [B, Tp/K, L], f0, f1, fe)``;
    ``mode="resid1"``: ``(a1 [B, Tp, L], saf, a0w [B, Tp/K, L], f0, f1,
    fe)``, ``a0w`` the closed mantissas at each window's first step, in its
    frame (``sa[:, w K, 0]`` of mode resid); ``mode="bound"``: ``(b0, b1,
    be [Tp/K, B, L], f0, f1, fe)``, the carry entering each window.

    The op ``ctc_port::classic_fwd``: CUDA tensors launch
    csrc/classic_fwd.cu; CPU tensors run :func:`classic_fwd_plain`."""
    if mode not in _FWD_MODES:
        raise ValueError(f"unknown classic_fwd mode {mode!r}")
    check_device(dcu, "classic_fwd")
    return tuple(_classic_fwd_op(blank, dcu, lm, nb, rep, lens, k_win, mode,
                                 *carry_args(init, 2)))


def _classic_fwd_plain_op(blank: Tensor, dcu: Tensor, lm: Tensor, nb: Tensor,
                          rep: Tensor, lens: Tensor, k_win: int, mode: str,
                          init0: Optional[Tensor], init1: Optional[Tensor],
                          init_e: Optional[Tensor]) -> List[Tensor]:
    return list(classic_fwd_plain(blank, dcu, lm, nb, rep, lens, k_win, mode,
                                  op_carry(init0, init1, init_e)))


_classic_fwd_op = kernel_op("classic_fwd", _classic_fwd_plain_op)


def _fwd_specs(batch: int, tpad: int, lpad: int, k_win: int, mode: str):
    """``(shape, dtype)`` of ``classic_fwd``'s outputs in ``mode``."""
    f32, i32 = torch.float32, torch.int32
    n_w = tpad // k_win
    row, win, bnd = (batch, lpad), (batch, n_w, lpad), (n_w, batch, lpad)
    extra = {"final": [],
             "resid": [((batch, tpad, 2, lpad), f32), (win, i32)],
             "resid1": [((batch, tpad, lpad), f32), (win, i32), (win, f32)],
             "bound": [(bnd, f32), (bnd, f32), (bnd, i32)]}[mode]
    return extra + [(row, f32), (row, f32), (row, i32)]


@_classic_fwd_op.register_fake
def _classic_fwd_fake(blank, dcu, lm, nb, rep, lens, k_win, mode, init0, init1, init_e):
    return empty_outputs(dcu, _fwd_specs(*dcu.shape, k_win, mode))


@_classic_fwd_op.register_kernel("cuda")
def _classic_fwd_launch(blank, dcu, lm, nb, rep, lens, k_win, mode, init0, init1,
                        init_e):
    batch, tpad, lpad, dev = check_scan_inputs(blank, dcu, lm, nb, rep, lens, k_win)
    init_ptrs = carry_pointers(op_carry(init0, init1, init_e), 2, (batch, lpad), "init",
                               dev)
    check_aligned((("dcu", dcu),), "classic_fwd")
    lib = _build.lib("classic_fwd")
    _build.check_smem(lib.ctc_classic_fwd_smem_bytes(lpad, k_win), "classic_fwd", dev)
    outs = empty_outputs(dcu, _fwd_specs(batch, tpad, lpad, k_win, mode))
    *extra, f0, f1, fe = outs
    resid, bd = [None] * 3, [None] * 3
    if mode.startswith("resid"):
        resid[:len(extra)] = (t.data_ptr() for t in extra)
    elif mode == "bound":
        bd = [t.data_ptr() for t in extra]
    with torch.cuda.device(dev):
        err = lib.ctc_classic_fwd(
            blank.data_ptr(), dcu.data_ptr(), lm.data_ptr(),
            nb.data_ptr(), rep.data_ptr(), lens.data_ptr(), *init_ptrs,
            batch, tpad, lpad, k_win, _FWD_MODES[mode],
            *resid, *bd, f0.data_ptr(), f1.data_ptr(), fe.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "classic_fwd")
    classic_fwd.launches += 1
    classic_fwd.mode_launches[mode] += 1
    return outs


classic_fwd.launches = 0
classic_fwd.mode_launches = {mode: 0 for mode in _FWD_MODES}


# ---------------------------------------------------------------------------
# kernels B3 and B10 backward: beta scans emitting the combined act
# ---------------------------------------------------------------------------


def _classic_beta_plain(blank, dcu, lm, nb, rep, lens, lab_len, ebi, sa, saf,
                        k_win: int, init=None):
    """The beta scan over alpha residuals that the plain versions of both
    backward kernels share: ``(pc, b0, b1, be)``."""
    batch, tpad, lpad = dcu.shape
    device = dcu.device
    if init is None:
        b0, b1, e = beta_init(lab_len, lpad, 2)
    else:
        b0, b1, e = (t.clone() for t in init)
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
            pd = scaled_act(s_hi, s_lo, d, arr)
            ph = scaled_act(s_hi, s_lo, a1, pt, b1)
            pc[:, t] = torch.where(run, pd + shift_lanes(ph, -1, 0.0), torch.zeros_like(pd))
            hc = blank[:, t, None] * b0
            n0 = hc + dc * arr
            n1 = hc + pm * b1 + dov * arr
            b0 = torch.where(run, n0, b0)
            b1 = torch.where(run, n1, b1)
    return pc, b0, b1, e


def classic_bwd_streamed_plain(blank, dcu, lm, nb, rep, lens, lab_len, ebi, sa,
                               saf, k_win: int):
    """Plain version of ``classic_bwd_streamed``."""
    return _classic_beta_plain(blank, dcu, lm, nb, rep, lens, lab_len, ebi, sa, saf,
                               k_win)


def classic_bwd_streamed(blank, dcu, lm, nb, rep, lens, lab_len, ebi, sa, saf,
                         k_win: int):
    """Beta scan over the residual pack: ``(pc [B, Tp, L], b0, b1, be)``.

    The op ``ctc_port::classic_bwd_streamed``: CUDA tensors launch
    csrc/classic_bwd.cu; CPU tensors run :func:`classic_bwd_streamed_plain`."""
    check_device(dcu, "classic_bwd_streamed")
    return tuple(_classic_bwd_streamed_op(blank, dcu, lm, nb, rep, lens, lab_len, ebi, sa,
                                          saf, k_win))


def _classic_bwd_streamed_plain_op(blank: Tensor, dcu: Tensor, lm: Tensor, nb: Tensor,
                                   rep: Tensor, lens: Tensor, lab_len: Tensor,
                                   ebi: Tensor, sa: Tensor, saf: Tensor,
                                   k_win: int) -> List[Tensor]:
    return list(classic_bwd_streamed_plain(blank, dcu, lm, nb, rep, lens, lab_len, ebi,
                                           sa, saf, k_win))


_classic_bwd_streamed_op = kernel_op("classic_bwd_streamed",
                                     _classic_bwd_streamed_plain_op)


def beta_specs(dcu: torch.Tensor, states: int):
    """``(shape, dtype)`` of a beta scan's outputs over the transitions
    ``dcu`` [B, Tp, L]: the acts [B, Tp, L], then the final carry, its
    ``states`` mantissa arrays and its exponent [B, L]."""
    batch, tpad, lpad = dcu.shape
    row = (batch, lpad)
    return ([((batch, tpad, lpad), torch.float32)] + [(row, torch.float32)] * states
            + [(row, torch.int32)])


def _classic_beta_fake(blank, dcu, *_):
    return empty_outputs(dcu, beta_specs(dcu, 2))


_classic_bwd_streamed_op.register_fake(_classic_beta_fake)


@_classic_bwd_streamed_op.register_kernel("cuda")
def _classic_bwd_streamed_launch(blank, dcu, lm, nb, rep, lens, lab_len, ebi, sa, saf,
                                 k_win):
    batch, tpad, lpad, dev = check_scan_inputs(blank, dcu, lm, nb, rep, lens, k_win)
    check_tensor(sa, (batch, tpad, 2, lpad), torch.float32, "sa", dev)
    check_aligned((("dcu", dcu), ("sa", sa)), "classic_bwd_streamed")
    out = _launch_beta("classic_bwd", "ctc_classic_bwd_streamed",
                       (blank, dcu, lm, nb, rep, lens, lab_len, ebi, sa, saf), k_win)
    classic_bwd_streamed.launches += 1
    return out


classic_bwd_streamed.launches = 0


def _launch_beta(library: str, entry: str, args, k_win: int):
    """Launch a beta scan over residuals whose arguments end with ``(lab_len,
    ebi, residuals..., saf[, a0w])`` after the transitions, masks and
    lengths: ``[pc [B, Tp, L], b0, b1, be]``."""
    blank, dcu, lm, nb, rep, lens, lab_len, ebi, _resid, saf, *_ = args
    batch, tpad, lpad = dcu.shape
    dev = dcu.device
    check_tensor(lab_len, (batch,), torch.int32, "lab_len", dev)
    check_tensor(ebi, (batch,), torch.float32, "ebi", dev)
    check_tensor(saf, (batch, tpad // k_win, lpad), torch.int32, "saf", dev)
    lib = _build.lib(library)
    _build.check_smem(getattr(lib, f"ctc_{library}_smem_bytes")(lpad, k_win), library,
                      dev)
    outs = empty_outputs(dcu, beta_specs(dcu, 2))
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(
            *(t.data_ptr() for t in args), batch, tpad, lpad, k_win,
            *(t.data_ptr() for t in outs),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, entry)
    return outs


# ---------------------------------------------------------------------------
# kernel B13: the half-stream scheme's beta scan
# ---------------------------------------------------------------------------


def _classic_rebuild_plain(blank, a1, a0w, lens, k_win: int):
    """The residual pack ``sa`` of mode resid from that of mode resid1: each
    window's ``a0`` rebuilt from its first step with the forward's own
    ``a0' = (a0 + a1) * blank``."""
    batch, tpad, lpad = a1.shape
    sa = torch.zeros((batch, tpad, 2, lpad), dtype=torch.float32, device=a1.device)
    sa[:, :, 1] = a1
    lens_c = lens.to(torch.int64)[:, None]
    max_len = int(lens.max()) if batch else 0
    for w in range(-(-max_len // k_win)):
        a0 = a0w[:, w]
        for t in range(w * k_win, min((w + 1) * k_win, max_len)):
            sa[:, t, 0] = torch.where(t < lens_c, a0, torch.zeros_like(a0))
            a0 = (a0 + a1[:, t]) * blank[:, t, None]
    return sa


def classic_bwd_half_plain(blank, dcu, lm, nb, rep, lens, lab_len, ebi, a1, saf, a0w,
                           k_win: int):
    """Plain version of ``classic_bwd_half``: the streamed beta scan over the
    residuals that the half-stream pack rebuilds to."""
    sa = _classic_rebuild_plain(blank, a1, a0w, lens, k_win)
    return _classic_beta_plain(blank, dcu, lm, nb, rep, lens, lab_len, ebi, sa, saf,
                               k_win)


def classic_bwd_half(blank, dcu, lm, nb, rep, lens, lab_len, ebi, a1, saf, a0w,
                     k_win: int):
    """Beta scan over the half-stream pack of ``classic_fwd`` mode resid1
    (``a1`` [B, Tp, L], ``saf`` and ``a0w`` [B, Tp/K, L]): ``(pc [B, Tp, L],
    b0, b1, be)``, those of ``classic_bwd_streamed`` on mode resid's pack
    bit for bit.

    The op ``ctc_port::classic_bwd_half``: CUDA tensors launch
    csrc/classic_bwd_half.cu; CPU tensors run :func:`classic_bwd_half_plain`."""
    check_device(dcu, "classic_bwd_half")
    return tuple(_classic_bwd_half_op(blank, dcu, lm, nb, rep, lens, lab_len, ebi, a1,
                                      saf, a0w, k_win))


def _classic_bwd_half_plain_op(blank: Tensor, dcu: Tensor, lm: Tensor, nb: Tensor,
                               rep: Tensor, lens: Tensor, lab_len: Tensor, ebi: Tensor,
                               a1: Tensor, saf: Tensor, a0w: Tensor,
                               k_win: int) -> List[Tensor]:
    return list(classic_bwd_half_plain(blank, dcu, lm, nb, rep, lens, lab_len, ebi, a1,
                                       saf, a0w, k_win))


_classic_bwd_half_op = kernel_op("classic_bwd_half", _classic_bwd_half_plain_op)
_classic_bwd_half_op.register_fake(_classic_beta_fake)


@_classic_bwd_half_op.register_kernel("cuda")
def _classic_bwd_half_launch(blank, dcu, lm, nb, rep, lens, lab_len, ebi, a1, saf, a0w,
                             k_win):
    batch, tpad, lpad, dev = check_scan_inputs(blank, dcu, lm, nb, rep, lens, k_win)
    check_tensor(a1, (batch, tpad, lpad), torch.float32, "a1", dev)
    check_tensor(a0w, (batch, tpad // k_win, lpad), torch.float32, "a0w", dev)
    check_aligned((("dcu", dcu), ("a1", a1), ("a0w", a0w)), "classic_bwd_half")
    args = (blank, dcu, lm, nb, rep, lens, lab_len, ebi, a1, saf, a0w)
    out = _launch_beta("classic_bwd_half", "ctc_classic_bwd_half", args, k_win)
    classic_bwd_half.launches += 1
    return out


classic_bwd_half.launches = 0


def _classic_reexpand_plain(blank, dcu, lm, nb, rep, lens, bd0, bd1, bde, k_win: int):
    """Alpha residuals ``(sa, saf)`` as ``classic_fwd`` streams them in mode
    resid, re-expanded window by window, each from its own boundary carry."""
    batch, tpad, lpad = dcu.shape
    sa = torch.zeros((batch, tpad, 2, lpad), dtype=torch.float32, device=dcu.device)
    saf = torch.zeros((batch, tpad // k_win, lpad), dtype=torch.int32,
                      device=dcu.device)
    lens_c = lens.to(torch.int64)[:, None]
    max_len = int(lens.max()) if batch else 0
    for w in range(-(-max_len // k_win)):
        t0 = w * k_win
        (a0, a1), f, s_arr = _open_window((bd0[w], bd1[w]), bde[w], k_win, True)
        saf[:, w] = torch.where(t0 < lens_c, f, torch.zeros_like(f))
        for t in range(t0, min(t0 + k_win, max_len)):
            run = t < lens_c
            sa[:, t, 0] = torch.where(run, a0, torch.zeros_like(a0))
            sa[:, t, 1] = torch.where(run, a1, torch.zeros_like(a1))
            a0, a1 = _classic_step(a0, a1, blank[:, t], dcu[:, t], lm, nb, rep, s_arr)
    return sa, saf


def classic_bwd_plain(blank, dcu, lm, nb, rep, lens, lab_len, ebi, bd0, bd1, bde,
                      k_win: int, init=None):
    """Plain version of ``classic_bwd``: the streamed beta scan over the
    residuals that the window boundaries re-expand to."""
    sa, saf = _classic_reexpand_plain(blank, dcu, lm, nb, rep, lens, bd0, bd1, bde,
                                      k_win)
    return _classic_beta_plain(blank, dcu, lm, nb, rep, lens, lab_len, ebi, sa, saf,
                               k_win, init)


def classic_bwd(blank, dcu, lm, nb, rep, lens, lab_len, ebi, bd0, bd1, bde,
                k_win: int, init=None):
    """Residual-free beta scan over the window boundaries ``bd0, bd1, bde``
    [Tp/K, B, L] of ``classic_fwd`` mode bound, from the beta carry
    ``init`` (``(b0, b1, e)`` [B, L]; None for the end of the lattice):
    ``(pc [B, Tp, L], b0, b1, be)``, ``pc`` as ``classic_bwd_streamed``
    emits it.

    The op ``ctc_port::classic_bwd``: CUDA tensors launch
    csrc/classic_bwd_rf.cu; CPU tensors run :func:`classic_bwd_plain`."""
    check_device(dcu, "classic_bwd")
    return tuple(_classic_bwd_op(blank, dcu, lm, nb, rep, lens, lab_len, ebi, bd0, bd1,
                                 bde, k_win, *carry_args(init, 2)))


def _classic_bwd_plain_op(blank: Tensor, dcu: Tensor, lm: Tensor, nb: Tensor,
                          rep: Tensor, lens: Tensor, lab_len: Tensor, ebi: Tensor,
                          bd0: Tensor, bd1: Tensor, bde: Tensor, k_win: int,
                          init0: Optional[Tensor], init1: Optional[Tensor],
                          init_e: Optional[Tensor]) -> List[Tensor]:
    return list(classic_bwd_plain(blank, dcu, lm, nb, rep, lens, lab_len, ebi, bd0, bd1,
                                  bde, k_win, op_carry(init0, init1, init_e)))


_classic_bwd_op = kernel_op("classic_bwd", _classic_bwd_plain_op)
_classic_bwd_op.register_fake(_classic_beta_fake)


@_classic_bwd_op.register_kernel("cuda")
def _classic_bwd_launch(blank, dcu, lm, nb, rep, lens, lab_len, ebi, bd0, bd1, bde,
                        k_win, init0, init1, init_e):
    batch, tpad, lpad, dev = check_scan_inputs(blank, dcu, lm, nb, rep, lens, k_win)
    f32 = torch.float32
    n_w = tpad // k_win
    check_tensor(lab_len, (batch,), torch.int32, "lab_len", dev)
    check_tensor(ebi, (batch,), f32, "ebi", dev)
    check_tensor(bd0, (n_w, batch, lpad), f32, "bd0", dev)
    check_tensor(bd1, (n_w, batch, lpad), f32, "bd1", dev)
    check_tensor(bde, (n_w, batch, lpad), torch.int32, "bde", dev)
    check_aligned((("dcu", dcu), ("bd0", bd0), ("bd1", bd1), ("bde", bde)),
                  "classic_bwd")
    init_ptrs = carry_pointers(op_carry(init0, init1, init_e), 2, (batch, lpad), "init",
                               dev)
    lib = _build.lib("classic_bwd_rf")
    _build.check_smem(lib.ctc_classic_bwd_rf_smem_bytes(lpad, k_win), "classic_bwd",
                      dev)
    ws = torch.empty((batch, k_win, 2, lpad), dtype=f32, device=dev)
    outs = empty_outputs(dcu, beta_specs(dcu, 2))
    with torch.cuda.device(dev):
        err = lib.ctc_classic_bwd_rf(
            blank.data_ptr(), dcu.data_ptr(), lm.data_ptr(), nb.data_ptr(),
            rep.data_ptr(), lens.data_ptr(), lab_len.data_ptr(), ebi.data_ptr(),
            bd0.data_ptr(), bd1.data_ptr(), bde.data_ptr(), *init_ptrs,
            batch, tpad, lpad, k_win, ws.data_ptr(),
            *(t.data_ptr() for t in outs),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "classic_bwd")
    classic_bwd.launches += 1
    return outs


classic_bwd.launches = 0


# ---------------------------------------------------------------------------
# entry points of the kernel path
# ---------------------------------------------------------------------------


class StreamPack(NamedTuple):
    """Training forward's pack of the streamed scheme (one chunk): the
    prepared kernel inputs, which the backward reads again, the residuals
    and the forward's loss."""

    inputs: tuple
    sa: torch.Tensor
    saf: torch.Tensor
    loss: torch.Tensor


class HalfPack(NamedTuple):
    """Training forward's pack of the half-stream scheme (``half_stream``,
    one chunk): the prepared kernel inputs, the open mantissas ``a1`` of
    every step, the window frames ``saf`` and the closed mantissas ``a0w``
    at each window's first step (``classic_fwd`` mode resid1), and the
    forward's loss."""

    inputs: tuple
    a1: torch.Tensor
    saf: torch.Tensor
    a0w: torch.Tensor
    loss: torch.Tensor


def streamed(pack) -> bool:
    """Whether ``pack`` is of a streamed scheme (one chunk; the acts come
    from one beta scan over residuals)."""
    return isinstance(pack, (StreamPack, HalfPack))


def streams_residuals(ctx: CtcContext, n_chunks: int, kernels) -> bool:
    """Whether a training forward takes a streamed scheme:
    ``stream_residuals``, a time axis of one chunk, and ``kernels`` (keys of
    ``_build.SMEM_BYTES``) whose shared memory holds the label's lanes.
    Otherwise it takes the residual-free scheme, whose kernels hold more."""
    if not (get_config().stream_residuals and n_chunks == 1):
        return False
    _, lpad, k_win = geometry(ctx)
    return _build.fits(kernels, lpad, k_win, ctx.logproba.device)


def kernels_hold(ctx: CtcContext, fwd: str, streamed, rf_bwd: str,
                 training: bool) -> bool:
    """Whether the kernels of a call hold the label's lanes (keys of
    ``_build.SMEM_BYTES``): the forward scan ``fwd`` for a forward-only
    call; for a training call those of the scheme its forward picks, the
    streamed pair ``streamed`` where :func:`streams_residuals` holds, else
    ``fwd`` and the residual-free backward ``rf_bwd``.  A label that they
    do not hold takes the pure path."""
    _, lpad, k_win = geometry(ctx)
    if not training:
        return _build.fits((fwd,), lpad, k_win, ctx.logproba.device)
    return (streams_residuals(ctx, chunk_plan(ctx)[0], streamed)
            or _build.fits((fwd, rf_bwd), lpad, k_win, ctx.logproba.device))


def _classic_streamed():
    """The kernels of the classic streamed scheme: B2 and B3, or with
    ``half_stream`` B13's forward (mode resid1) and backward."""
    return ("classic_fwd", "classic_bwd_half" if get_config().half_stream
            else "classic_bwd")


def classic_kernels_hold(ctx: CtcContext, training: bool) -> bool:
    """:func:`kernels_hold` for the classic topology."""
    return kernels_hold(ctx, "classic_fwd", _classic_streamed(), "classic_bwd_rf",
                        training)


class ChunkPack(NamedTuple):
    """Training forward's pack of the residual-free scheme; it holds no
    ``[B, T, L]`` tensor.  ``carries``: the alpha carry entering each chunk
    (None for the standard t=0 carry); ``bounds``: the window boundaries of
    the one chunk, written by the forward itself (None when there are
    several chunks: the backward regenerates them chunk by chunk)."""

    carries: list
    bounds: Optional[tuple]
    loss: torch.Tensor


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
    kernels B2 and B3 share on the one-chunk streamed path."""
    tpad, lpad, k_win = geometry(ctx)
    blank, dcu = classic_transitions(ctx, lpad, 0, tpad)
    lm, nb, rep = lane_masks(ctx, lpad)
    lens, lab_len = kernel_lengths(ctx)
    return blank, dcu, lm, nb, rep, lens, lab_len, k_win


def _lane_inputs(ctx: CtcContext):
    """``(lpad, window, lm, nb, rep, lens, lab_len)``: what every chunk's
    launches share."""
    _, lpad, k_win = geometry(ctx)
    return (lpad, k_win, *lane_masks(ctx, lpad), *kernel_lengths(ctx))


def _chunk(ctx: CtcContext, c: int, chunk_t: int, lpad: int, lens):
    """``(blank, dcu, lens)`` of chunk ``c``."""
    t0 = c * chunk_t
    return (*classic_transitions(ctx, lpad, t0, chunk_t),
            chunk_lengths(lens, t0, chunk_t))


def classic_loss_fast(ctx: CtcContext) -> torch.Tensor:
    """Forward-only block-float loss (kernel B1, once per chunk); may flush
    to +inf."""
    batch, num_t, _ = ctx.logproba.shape
    if batch == 0 or num_t == 0:
        return classic_mod.loss(ctx, classic_mod.alpha(ctx))
    n_chunks, chunk_t = chunk_plan(ctx)
    lpad, k_win, lm, nb, rep, lens, lab_len = _lane_inputs(ctx)
    carry = None
    for c in range(n_chunks):
        blank, dcu, lens_c = _chunk(ctx, c, chunk_t, lpad, lens)
        carry = classic_fwd(blank, dcu, lm, nb, rep, lens_c, k_win, "final",
                            **init_kw(carry))
    f0, f1, fe = carry
    return pick_loss(f0 + f1, fe, lab_len)


def classic_loss_and_pack(ctx: CtcContext):
    """Training forward: ``(fast loss, pack)``.  The streamed scheme where
    :func:`streams_residuals` holds: kernel B2 and a :class:`StreamPack` (the port's
    own residual layout, which keeps the prepared transitions: ``dcu`` is
    half the size of ``sa``), or with ``half_stream`` kernel B13's forward
    (mode resid1) and a :class:`HalfPack`.  Otherwise the residual-free
    scheme: kernel B1 in mode bound on one chunk, else in mode final per
    chunk, and a :class:`ChunkPack`."""
    batch, num_t, _ = ctx.logproba.shape
    if batch == 0 or num_t == 0:
        return classic_mod.loss(ctx, classic_mod.alpha(ctx)), None
    n_chunks, chunk_t = chunk_plan(ctx)
    half = get_config().half_stream
    if streams_residuals(ctx, n_chunks, _classic_streamed()):
        inputs = kernel_inputs(ctx)
        blank, dcu, lm, nb, rep, lens, lab_len, k_win = inputs
        mode = "resid1" if half else "resid"
        *resid, f0, f1, fe = classic_fwd(blank, dcu, lm, nb, rep, lens, k_win, mode)
        loss = pick_loss(f0 + f1, fe, lab_len)
        return loss, (HalfPack if half else StreamPack)(inputs, *resid, loss)
    lpad, k_win, lm, nb, rep, lens, lab_len = _lane_inputs(ctx)
    if n_chunks == 1:
        blank, dcu, lens_c = _chunk(ctx, 0, chunk_t, lpad, lens)
        b0, b1, be, f0, f1, fe = classic_fwd(blank, dcu, lm, nb, rep, lens_c, k_win,
                                             "bound")
        loss = pick_loss(f0 + f1, fe, lab_len)
        return loss, ChunkPack([None], (b0, b1, be), loss)
    carries, carry = [], None
    for c in range(n_chunks):
        blank, dcu, lens_c = _chunk(ctx, c, chunk_t, lpad, lens)
        carries.append(carry)
        carry = classic_fwd(blank, dcu, lm, nb, rep, lens_c, k_win, "final",
                            **init_kw(carry))
    f0, f1, fe = carry
    loss = pick_loss(f0 + f1, fe, lab_len)
    return loss, ChunkPack(carries, None, loss)


def neg_posterior(sums, scale, blank_index):
    """``-grad`` in probability space from the token sums of the acts:
    ``scale * sums`` for the non-blank tokens, the blank column from the
    posterior identity ``sum_v -grad = 1`` (clamped at 0 under rounding)."""
    neg_nb = scale[:, None, None] * sums
    token_is_blank = torch.arange(sums.shape[2], device=sums.device) == blank_index
    zero = torch.zeros_like(neg_nb)
    s = torch.sum(torch.where(token_is_blank, zero, neg_nb), dim=2, keepdim=True)
    return torch.where(token_is_blank, torch.clamp(1.0 - s, min=0.0), neg_nb)


def grad_direct_assemble(ctx: CtcContext, sums, loss, scale):
    """Probability-space gradient ``-neg_posterior`` from the
    token-scattered acts; rows whose backward ``loss`` is +inf (infeasible
    or flushed) and steps past logit_length are exactly zero."""
    grad = -neg_posterior(sums, scale, ctx.blank_index)
    zero = torch.zeros_like(grad)
    grad = torch.where(torch.isposinf(loss)[:, None, None], zero, grad)
    return torch.where(ctx.logit_length_mask[:, :, None], grad, zero)


def _empty_gradient(ctx: CtcContext, loss, pure_loss):
    batch, num_t, num_tokens = ctx.logproba.shape
    zeros = torch.zeros(
        (batch, num_t, num_tokens), dtype=torch.float32, device=ctx.logproba.device
    )
    return zeros, pure_loss(ctx) if loss is None else loss


def classic_gradient_with_loss(ctx: CtcContext, loss=None, pack=None):
    """Block-float gradient w.r.t. log-probabilities: ``(grad [B, T, V],
    backward loss [B])``, by the scheme of the pack (a :class:`StreamPack` or
    :class:`HalfPack`: :func:`classic_streamed_acts`; a :class:`ChunkPack`:
    kernel B10 per chunk, last to first), then the act scatter and the
    assembly.  The backward loss comes from the beta carry
    (:func:`carry_loss`); :func:`flush_signal` of it is the guard's."""
    batch, num_t, _ = ctx.logproba.shape
    if batch == 0 or num_t == 0:
        return _empty_gradient(
            ctx, loss, lambda c: classic_mod.loss(c, classic_mod.alpha(c))
        )
    if pack is None:
        _, pack = classic_loss_and_pack(ctx)
    if streamed(pack):
        return streamed_gradient(ctx, *classic_streamed_acts(ctx, pack))
    n_chunks, chunk_t = chunk_plan(ctx)
    lpad, k_win, lm, nb, rep, lens, lab_len = _lane_inputs(ctx)
    ebi = ebi_from_loss(pack.loss)
    sums = torch.empty((batch, num_t, ctx.logproba.shape[2]), dtype=torch.float32,
                       device=ctx.logproba.device)

    def chunk_backward(c, beta):
        # one chunk's launches; its [B, chunk, L] tensors die on return
        blank, dcu, lens_c = _chunk(ctx, c, chunk_t, lpad, lens)
        bounds = pack.bounds
        if bounds is None:
            bounds = classic_fwd(blank, dcu, lm, nb, rep, lens_c, k_win, "bound",
                                 **init_kw(pack.carries[c]))[:3]
        pc, *beta = classic_bwd(blank, dcu, lm, nb, rep, lens_c, lab_len, ebi,
                                *bounds, k_win, beta)
        scatter_chunk(ctx, sums, pc, lm, c * chunk_t)
        return beta

    beta = None
    for c in range(n_chunks - 1, -1, -1):
        beta = chunk_backward(c, beta)
    b0, _b1, be = beta
    return gradient_from_beta_carry(ctx, sums, pack.loss, ebi, b0[:, 0], be[:, 0])


# Forward and beta scans compute -log P of one lattice in float32.  Every
# operation rounds relative to the (positive) mass it carries, so the two
# P drift apart by a relative error that grows with the steps (a few
# 2^-24 a step at worst, far less as roundings cancel), and each scan
# rounds its loss once.  The limit allows 2^-24 nats a step and 4 to 8
# ulps of the loss; a larger gap means that one scan lost mass that
# mattered (a lane fell out of its window's frame and went through the
# subnormal range).  On an H100 at B=256 (chip_smoke.py phase 7) the clean
# rows' gaps reach 0.24 of the limit on N(0, 1) logits at T=4000, and
# under 0.1 on peaked low-loss logits at T=500 and 4000.
_GAP_PER_STEP = 2.0 ** -24  # nats
_GAP_OF_LOSS = 2.0 ** -21  # of |loss|: 4 to 8 float32 ulps


def scan_gap_limit(loss, n_steps):
    """The largest gap in nats between the forward and the beta scan's
    losses that rounding explains, for scans of ``n_steps`` steps."""
    return _GAP_OF_LOSS * torch.abs(loss) + _GAP_PER_STEP * n_steps.to(loss.dtype)


def carry_loss(fwd_loss, beta0, beta0_e):
    """The loss of a beta scan's final carry (mantissa and exponent at lane
    0), +inf where the forward scan's ``fwd_loss`` is +inf and the carry's
    is finite (the forward flushed alone: the row's loss is +inf, its
    gradient zero).  NaN stays NaN.  The gradient's assembly and the
    softmax term's mask take it."""
    loss = -(torch.log(beta0) + beta0_e.to(torch.float32) * LN2)
    alone = torch.isposinf(fwd_loss) & torch.isfinite(loss)
    return torch.where(alone, torch.full_like(loss, float("inf")), loss)


def flush_signal(fwd_loss, loss, n_steps):
    """The guard's flush signal of a backward whose loss is ``loss``
    (:func:`carry_loss`) over ``n_steps`` steps: +inf also where it differs
    from the forward scan's ``fwd_loss`` by more than
    :func:`scan_gap_limit` (one scan lost mass that mattered).  Only the
    guard reads it: under ``guard_mode="pre"`` a row that only this flags,
    on a step whose forward flushed no row, keeps its fast gradient, as in
    the JAX package, which has no such flag."""
    both = torch.isfinite(fwd_loss) & torch.isfinite(loss)
    gap = torch.abs(fwd_loss - loss) > scan_gap_limit(loss, n_steps)
    return torch.where(both & gap, torch.full_like(loss, float("inf")), loss)


def beta_carry_loss(fwd_loss, beta0, beta0_e, n_steps):
    """The flush signal (:func:`flush_signal`) of a beta scan's final carry
    over ``n_steps`` steps."""
    return flush_signal(fwd_loss, carry_loss(fwd_loss, beta0, beta0_e), n_steps)


def beta_carry_scale(fwd_loss, ebi, beta0, beta0_e):
    """``(backward loss [B], act scale [B])`` from the mantissa and exponent
    of a beta scan's final carry at lane 0 (:func:`carry_loss`)."""
    loss = carry_loss(fwd_loss, beta0, beta0_e)
    # The acts were scaled by 2^-ebi; the posterior scale is
    # exp(loss + ebi ln2) = 2^(ebi - e) / m for the beta carry m * 2^e.
    # Taken from the carry, not through the float32 loss, whose rounding
    # (an ulp of a loss near 1e3 is 1.2e-4) would reach the gradient.
    scale = torch.where(torch.isfinite(loss),
                        torch.exp2(ebi - beta0_e.to(torch.float32)) / beta0, torch.exp2(ebi))
    return loss, scale


def gradient_from_beta_carry(ctx: CtcContext, sums, fwd_loss, ebi, beta0, beta0_e):
    """``(grad [B, T, V], backward loss [B])`` from the token sums of a beta
    scan's acts and its final carry at lane 0 (:func:`beta_carry_scale`)."""
    loss, scale = beta_carry_scale(fwd_loss, ebi, beta0, beta0_e)
    return grad_direct_assemble(ctx, sums, loss, scale), loss


# ---------------------------------------------------------------------------
# the streamed scheme's acts and assembly steps; kernel B12
# ---------------------------------------------------------------------------


def classic_streamed_acts(ctx: CtcContext, pack):
    """The acts step of the streamed scheme: ``(acts [B, Tp, L], lm,
    backward loss [B], act scale [B])`` from kernel B3 (a
    :class:`StreamPack`) or B13 (a :class:`HalfPack`); the loss is the beta
    carry's (:func:`carry_loss`)."""
    blank, dcu, lm, nb, rep, lens, lab_len, k_win = pack.inputs
    ebi = ebi_from_loss(pack.loss)
    if isinstance(pack, HalfPack):
        pc, f0, _f1, fe = classic_bwd_half(blank, dcu, lm, nb, rep, lens, lab_len, ebi,
                                           pack.a1, pack.saf, pack.a0w, k_win)
    else:
        pc, f0, _f1, fe = classic_bwd_streamed(blank, dcu, lm, nb, rep, lens, lab_len,
                                               ebi, pack.sa, pack.saf, k_win)
    return (pc, lm, *beta_carry_scale(pack.loss, ebi, f0[:, 0], fe[:, 0]))


def streamed_gradient(ctx: CtcContext, acts, lm, loss, scale):
    """The assembly step of the streamed scheme, unfused: ``(grad [B, T, V],
    backward loss)`` through the act scatter."""
    sums = act_scatter(ctx, acts[:, :ctx.logproba.shape[1]], lm)
    return grad_direct_assemble(ctx, sums, loss, scale), loss


def fused_epilogue_ok(ctx: CtcContext, pack) -> bool:
    """Whether the logits cotangent takes the fused epilogue (kernel B12):
    ``fused_epilogue`` on, a pack of the streamed scheme, and a B12 whose
    shared memory holds the label's lanes and the vocabulary."""
    if not (get_config().fused_epilogue and streamed(pack)):
        return False
    lpad = geometry(ctx)[1]
    return _build.fits(("fused_epilogue",), lpad, ctx.logproba.shape[2],
                       ctx.logproba.device)


def streamed_dlogits(ctx: CtcContext, d_loss, acts, lm, loss, scale):
    """The assembly step of the streamed scheme fused with the log-softmax
    cotangent (kernel B12): ``(d_logits [B, T, V], backward loss)``.  Rows
    whose backward loss is not finite are exactly 0, as in the JAX
    package's fused epilogue (the guard recomputes the flushed ones)."""
    num_t = ctx.logproba.shape[1]
    lens = torch.where(torch.isfinite(loss), ctx.logit_length.clamp(0, num_t),
                       torch.zeros_like(ctx.logit_length)).to(torch.int32)
    out = fused_dlogits(acts, lane_tokens(ctx, acts.shape[2]), lm, scale,
                        d_loss.to(torch.float32).contiguous(), lens,
                        ctx.logproba.contiguous(), ctx.blank_index)
    return out, loss


def fused_dlogits_plain(acts, labels, lm, scale, d_loss, lens, logproba, blank):
    """Plain version of ``fused_dlogits``."""
    batch, num_t, num_tokens = logproba.shape
    sums = token_sums(acts[:, :num_t], labels, lm, num_tokens)
    neg = neg_posterior(sums, scale, blank)
    out = d_loss[:, None, None] * (torch.exp(logproba) - neg)
    valid = torch.arange(num_t, device=logproba.device)[None, :] < lens[:, None]
    return torch.where(valid[:, :, None], out, torch.zeros_like(out))


def fused_dlogits(acts, labels, lm, scale, d_loss, lens, logproba, blank):
    """``d_logits [B, T, V]`` from the acts ``[B, Tp, L]`` of a streamed
    beta scan: per row ``d_loss * (exp(logproba) - neg)``, ``neg`` the
    :func:`neg_posterior` of the token sums (:func:`token_sums` of the
    lanes' tokens ``labels`` [B, L] int32 under the mask ``lm``) at the act
    scale ``scale`` [B]; exactly 0 at ``t >= lens`` [B] int32.  ``blank`` is
    the blank index (an int or a 0-d tensor).

    The op ``ctc_port::fused_dlogits``: CUDA tensors launch
    csrc/fused_epilogue.cu; CPU tensors run :func:`fused_dlogits_plain`."""
    check_device(acts, "fused_dlogits")
    return _fused_dlogits_op(acts, labels, lm, scale, d_loss, lens, logproba,
                             index_tensor(blank, acts.device))


def _fused_dlogits_plain_op(acts: Tensor, labels: Tensor, lm: Tensor, scale: Tensor,
                            d_loss: Tensor, lens: Tensor, logproba: Tensor,
                            blank: Tensor) -> Tensor:
    return fused_dlogits_plain(acts, labels, lm, scale, d_loss, lens, logproba, blank)


_fused_dlogits_op = kernel_op("fused_dlogits", _fused_dlogits_plain_op)


@_fused_dlogits_op.register_fake
def _fused_dlogits_fake(acts, labels, lm, scale, d_loss, lens, logproba, blank):
    return logproba.new_empty(logproba.shape, dtype=torch.float32)


@_fused_dlogits_op.register_kernel("cuda")
def _fused_dlogits_launch(acts, labels, lm, scale, d_loss, lens, logproba, blank):
    batch, num_t, num_tokens = logproba.shape
    _, tpad, lpad = acts.shape
    dev = acts.device
    f32 = torch.float32
    if num_t > tpad:
        raise ValueError(f"acts cover {tpad} steps, fewer than the {num_t} of logproba")
    if batch > 65535:
        raise ValueError(f"fused_dlogits takes at most 65535 samples, got {batch}")
    check_tensor(acts, (batch, tpad, lpad), f32, "acts", dev)
    check_tensor(labels, (batch, lpad), torch.int32, "labels", dev)
    check_tensor(lm, (batch, lpad), f32, "lm", dev)
    for name, t in (("scale", scale), ("d_loss", d_loss)):
        check_tensor(t, (batch,), f32, name, dev)
    check_tensor(lens, (batch,), torch.int32, "lens", dev)
    check_tensor(logproba, (batch, num_t, num_tokens), f32, "logproba", dev)
    check_aligned((("acts", acts),), "fused_dlogits")
    blank_t = blank.to(torch.int32).reshape(1)
    lib = _build.lib("fused_epilogue")
    _build.check_smem(lib.ctc_fused_epilogue_smem_bytes(lpad, num_tokens),
                      "fused_dlogits", dev)
    out = torch.empty((batch, num_t, num_tokens), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        err = lib.ctc_fused_dlogits(
            acts.data_ptr(), labels.data_ptr(), lm.data_ptr(), scale.data_ptr(),
            d_loss.data_ptr(), lens.data_ptr(), logproba.data_ptr(), blank_t.data_ptr(),
            batch, num_t, tpad, lpad, num_tokens, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "fused_dlogits")
    fused_dlogits.launches += 1
    return out


fused_dlogits.launches = 0
