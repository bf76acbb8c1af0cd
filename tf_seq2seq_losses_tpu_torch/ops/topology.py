"""The topologies: pure log-space path vs the CUDA kernel path, and the
saturation guard.

Counterpart of ``ClassicTopology`` and ``SimplifiedTopology`` in
``tf_seq2seq_losses_tpu/ops/topology.py``, as one :class:`Topology` that
each topology parametrises with its pure module, its block-float kernel
functions, its exact log-space functions and its feasibility rule.

The block-float kernels flush a lattice entry that falls 2^-126 below its
window's neighbourhood; a feasible row whose fast loss comes out +inf is
then recomputed exactly (``flushed = isposinf(fast_loss) & feasible``; NaN
inputs flow through, NaN is not +inf).  :func:`_guarded` takes the JAX
package's decisions, as Python branches on the flushed count, with no
imitation of the XLA control flow that served them there:

* ``guard_struct="while"`` (the default): every flushed row is repaired, in
  rounds of ``max(min(repair_bucket2, B), repair_bucket)`` rows through the
  exact path (the log-space kernels with ``log_fallback``, else the pure
  path), shrinking to ``repair_bucket`` rows and then to pure-path rounds
  where :func:`fallback_cap` does not admit them; with ``guard_tier1`` up
  to ``repair_bucket`` flushed rows go through the pure path instead.
  Clean rows keep their fast values bit for bit.
* ``guard_struct="cond"``: tier 1, up to ``repair_bucket`` flushed rows
  through the pure path; tier 2, up to ``repair_bucket2`` through the
  log-space kernels; beyond that the whole batch through the exact path,
  so clean rows get exact values too.  Where the whole batch's working set
  is over the cap, the guard warns and rows past the largest tier that
  fits keep +inf.  With ``repair_bucket=0`` (the whole batch fitting) any
  flushed row reroutes the whole batch, under either struct.
* nothing fitting the cap: the guard warns and returns the fast value.

A repair tier runs on its rows' own time axis (:func:`take_ctx`), where
the JAX package's runs on the batch's; rows never interact, so the values
are the same computation on fewer steps (the steps cut off are zeros),
and agree within the log-space repair's tolerance.  Pure-path repairs run
in float64 (``core.float64_context``), their results cast back; an exact
function on a context that the log-space kernels do not serve (a chunked
time axis, a label wider than they hold) falls back to the same float64
pure path (``ops/log_lattice.py``).

Finding the flushed rows is a ``nonzero()``, which waits for the device:
one host synchronisation per guarded call (and a few more per call that
repairs rows).  ``guard_mode="pre"`` spends the training forward's one on
the backward as well: a clean step's backward runs unguarded.

The device form (:func:`_guarded_device`, the "while" struct only) reads
no device value on the host, so that a CUDA graph can capture it: it runs
under capture (``ops/capture.py``), the host form everywhere else, and
:meth:`Topology._guard` is the one place that picks between them.  It follows the JAX package's ``w_cond`` and
``w_body``: ``ceil(B / rb)`` rounds of a static slice of the flushed-first
order, each gathered at the batch's full T, each written back only where
its rows flushed; under capture each round is a CUDA graph IF node on
``r * rb < n``, so a clean replay runs none of them.  Its values are the
host form's bit for bit on the kernels, whose rows never interact, except
on a chunked time axis: there a round at full T goes through the float64
pure path where the host form repairs a short row with the log-space
kernels on its own axis (within their 2e-4, and closer to float64).
``guard_struct="cond"`` and ``repair_bucket=0`` raise ``ValueError`` in
the device form, and so does a chunked time axis under capture (its
rounds' pure-path loop over T would take minutes to capture).
"""

from __future__ import annotations

import os
import warnings
from typing import NamedTuple, Optional, Union

import torch

from tf_seq2seq_losses_tpu_torch.ops import capture as _capture
from tf_seq2seq_losses_tpu_torch.ops import classic as _classic
from tf_seq2seq_losses_tpu_torch.ops import core as _core
from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice as _kernels
from tf_seq2seq_losses_tpu_torch.ops import cuda_simplified as _skernels
from tf_seq2seq_losses_tpu_torch.ops import log_lattice as _log
from tf_seq2seq_losses_tpu_torch.ops import simplified as _simplified
from tf_seq2seq_losses_tpu_torch.ops.core import CtcContext
from tf_seq2seq_losses_tpu_torch.utils.config import get_config


def kernels_enabled(ctx: CtcContext) -> bool:
    return get_config().kernels_enabled(ctx.logproba.device)


def _classic_feasible(ctx: CtcContext) -> torch.Tensor:
    """Per-sample feasibility by lengths: adjacent repeated labels each need
    an extra blank frame."""
    lab = ctx.label
    idx = torch.arange(lab.shape[1], device=lab.device)
    rep = (
        (lab == torch.roll(lab, 1, dims=1))
        & (idx[None, :] > 0)
        & (idx[None, :] < ctx.label_length[:, None])
    )
    repeats = rep.to(torch.int64).sum(dim=1)
    return ctx.logit_length >= ctx.label_length + repeats


def _simplified_feasible(ctx: CtcContext) -> torch.Tensor:
    return ctx.logit_length >= ctx.label_length


# the fields of a context with a time axis (dim 1)
_TIME_FIELDS = ("logproba", "raw_logproba", "logit_length_mask", "blank_lp")


def take_ctx(ctx: CtcContext, idx: torch.Tensor) -> CtcContext:
    """Gather a mini-batch of samples out of a context (repair rounds), its
    time axis cut to the longest ``logit_length`` among them (one step at
    least): a short row of a long batch is repaired on its own length,
    where the log-space kernels serve it."""
    sub = {name: val if name == "blank_index" else val.index_select(0, idx)
           for name, val in ctx._asdict().items()}
    num_t = int(sub["logit_length"].max().clamp(1, ctx.logproba.shape[1]))
    for name in _TIME_FIELDS:
        sub[name] = sub[name][:, :num_t]
    return CtcContext(**sub)


def _repair_rounds(ctx: CtcContext, rows: torch.Tensor, bucket: int):
    """``rows`` in rounds of at most ``bucket``, shortest first, the rows
    that fit one chunk apart from the longer ones: a round runs on its
    longest row's time axis (:func:`take_ctx`), and a short row is left to
    the log-space kernels, which serve one chunk."""
    lens = ctx.logit_length.index_select(0, rows)
    order = torch.argsort(lens, stable=True)
    rows = rows.index_select(0, order)
    short = int((lens <= _kernels.chunk_steps()).sum())  # host sync
    return [r for part in (rows[:short], rows[short:])
            for r in torch.split(part, bucket) if r.numel()]


def fallback_cap() -> int:
    """The largest working set, in bytes, that a repair tier of the guard
    may take: ``CTC_TPU_GUARD_FALLBACK_BYTES``, read at each call as the
    JAX package reads it, 4 GiB by default."""
    return int(os.environ.get("CTC_TPU_GUARD_FALLBACK_BYTES", 4 << 30))


def est_fallback_bytes(batch: int, num_t: int, lp1: int, lane_pad: bool = False) -> int:
    """The JAX package's estimate of a repair tier's working set, verbatim
    (``tf_seq2seq_losses_tpu/ops/topology.py`` ``_est_fallback_bytes``):
    eight float32 ``[batch, num_t + 1, width]`` tensors, ``width`` the
    ``lp1`` label lanes, rounded up to 128 (a TPU lane tile) for a tier of
    the log-space kernels (``lane_pad``).

    Held against :func:`fallback_cap`, it decides which tiers run and so
    which flushed rows keep +inf, which users see; it is kept as the JAX
    package computes it so that the port leaves the same rows at +inf.  It
    does not model this card's memory: the port's tiers run on their rows'
    own time axis with lanes padded to 32."""
    width = -(-lp1 // 128) * 128 if lane_pad else lp1
    return batch * (num_t + 1) * width * 4 * 8


_GUARD_DISABLED = (
    "ctc saturation guard disabled at this shape: even the {bucket}-sample "
    "repair branch's working set exceeds the {cap_mb} MB fallback cap "
    "(CTC_TPU_GUARD_FALLBACK_BYTES). Feasible-but-float32-saturated samples will "
    "return +inf loss / zero gradient on the fast path."
)
_WHOLE_BATCH_DISABLED = (
    "ctc saturation guard: whole-batch exact reroute disabled at this shape "
    "(working set over the {cap_mb} MB cap); up to {rows} flushed samples per "
    "batch are repaired exactly, any beyond that keep their +inf fast-path value."
)


def flushed_rows(loss_like: torch.Tensor, feasible: torch.Tensor) -> torch.Tensor:
    """Indices of the feasible rows whose fast loss is +inf, ascending (a
    host synchronisation)."""
    return torch.nonzero(torch.isposinf(loss_like) & feasible)[:, 0]


def _repair(fast_value, fn, ctx, rounds, aux):
    """``fast_value`` with the rows of each round replaced by ``fn`` of the
    round's gathered context (and rows of ``aux``); a ``[B, T, V]`` value is
    zero past the round's cut time axis."""
    out = fast_value.clone()
    for idx in rounds:
        sub = take_ctx(ctx, idx)
        mini = fn(sub) if aux is None else fn(sub, aux.index_select(0, idx))
        if out.dim() == 3:
            mini = torch.nn.functional.pad(mini, (0, 0, 0, out.shape[1] - mini.shape[1]))
        out[idx] = mini.to(out.dtype)
    return out


def _on_device() -> bool:
    """Whether the guard takes its device form: under a CUDA graph capture
    (the tests patch it to run the device form on the CPU)."""
    return _capture.capturing()


def _round_plan(fits, exact, pure_fn, batch, bucket, lane_pad):
    """``(function, rows)`` of the "while" struct's repair rounds: rounds
    of ``max(min(repair_bucket2, B), repair_bucket)`` rows through
    ``exact``, shrunk to ``repair_bucket`` rows, then to pure-path rounds,
    where the cap's ``fits`` does not admit them."""
    fn, size = exact, max(min(get_config().repair_bucket2, batch), bucket)
    if not fits(size, lane_pad):
        size = bucket
        if not fits(bucket, lane_pad):
            fn = pure_fn
    return fn, size


def _take_rows(ctx: CtcContext, idx: torch.Tensor) -> CtcContext:
    """The samples ``idx`` of a context at its full time axis (the device
    form's gather, the JAX package's ``_take_ctx``)."""
    return CtcContext(**{name: val if name == "blank_index" else val.index_select(0, idx)
                         for name, val in ctx._asdict().items()})


def _round(out, fn, ctx, idx, write, aux):
    """Rows ``idx`` of ``out`` replaced by ``fn`` of their gathered context
    where ``write`` [len(idx)] holds (in place)."""
    sub = _take_rows(ctx, idx)
    mini = fn(sub) if aux is None else fn(sub, aux.index_select(0, idx))
    keep = write.reshape(write.shape + (1,) * (out.dim() - 1))
    out.index_copy_(0, idx, torch.where(keep, mini.to(out.dtype), out.index_select(0, idx)))


def _guarded_device(fast_value, exact_fn, pure_fn, loss_like, feasible, ctx, aux=None,
                    gate=None):
    """The device form of :func:`_guarded` under ``guard_struct="while"``:
    ``(value, n)``, the same value and the number of flushed rows ``n`` (a
    0-d tensor), with no host read of a device value.

    The flushed-first order is a stable ``argsort(~flushed)``; round ``r``
    repairs the static slice ``order[r * rb:(r + 1) * rb]`` gathered at
    full T and writes back its flushed rows, as the JAX package's
    ``w_body``; ``rb``, the function and the cap's decisions are the host
    form's.  With ``guard_tier1``, where ``0 < n <= repair_bucket``, one
    round of ``repair_bucket`` rows goes through the pure path, and the
    rounds run where ``n > repair_bucket`` (the reference's ``t1`` and the
    ``n > thresh`` of ``w_cond``).  Each round is an IF node under capture
    (:func:`capture.if_node`) and its writes are masked by the same
    predicate, so an uncaptured call gives the replay's values.  ``gate``
    (a 0-d bool tensor) ands into every row's flush: ``guard_mode="pre"``
    passes the forward's count ``> 0``."""
    cfg = get_config()
    if cfg.guard_struct != "while":
        raise ValueError(
            'guard_struct="cond" cannot be captured in a CUDA graph: its tiers are '
            'host decisions on the flushed count; use guard_struct="while"')
    if _capture.capturing() and _kernels.chunk_plan(ctx)[0] > 1:
        raise ValueError(
            f"a time axis of {ctx.logproba.shape[1]} steps, longer than one chunk "
            f"(chunk_time={cfg.chunk_time}), cannot be captured in a CUDA graph: its "
            "guard's rounds repair through the float64 pure path, a Python loop over "
            "T whose capture takes minutes; run it eagerly")
    batch, num_t, _ = ctx.logproba.shape
    lp1 = ctx.label.shape[1]
    cap = fallback_cap()

    def fits(n, lane_pad=False):
        return est_fallback_bytes(n, num_t, lp1, lane_pad) <= cap

    has_exact = cfg.log_fallback
    fn = exact_fn if has_exact else pure_fn
    bucket = min(cfg.repair_bucket, batch)
    bucket_fits = bucket > 0 and fits(bucket)
    flushed = torch.isposinf(loss_like) & feasible
    if gate is not None:
        flushed = flushed & gate
    n = flushed.sum()
    if not (fits(batch, lane_pad=has_exact) or bucket_fits):
        warnings.warn(_GUARD_DISABLED.format(bucket=bucket, cap_mb=cap >> 20),
                      stacklevel=3)
        return fast_value, n
    if not bucket_fits:
        raise ValueError(
            "repair_bucket=0 cannot be captured in a CUDA graph: its guard reroutes "
            "the whole batch on a host decision; set repair_bucket > 0")
    fn, size = _round_plan(fits, fn, pure_fn, batch, bucket, has_exact)
    out = fast_value.clone()
    order = torch.argsort(~flushed, stable=True)
    run = n > 0
    if cfg.guard_tier1 and bucket < batch:
        tier1 = run & (n <= bucket)
        with _capture.if_node(tier1):
            idx = order[:bucket]
            _round(out, pure_fn, ctx, idx, flushed.index_select(0, idx) & tier1, aux)
        run = n > bucket
    for start in range(0, batch, size):
        pred = run & (n > start)
        with _capture.if_node(pred):
            idx = order[start:start + size]
            _round(out, fn, ctx, idx, flushed.index_select(0, idx) & pred, aux)
    return out, n


def _guarded(fast_value, exact_fn, pure_fn, loss_like, feasible, ctx, aux=None,
             rows=None):
    """``fast_value`` with flushed feasible rows recomputed, by the tiers of
    the module docstring.

    ``exact_fn`` runs the log-space kernels (with ``log_fallback``);
    ``pure_fn`` the pure path in float64, its result cast back.  Both take a
    context, plus its rows of ``aux`` when that is given, and serve a
    gathered round (:func:`take_ctx`) and the whole batch alike.  ``rows``:
    the flushed rows where the caller has found them already
    (:func:`flushed_rows`)."""
    cfg = get_config()
    if not cfg.guard:
        return fast_value
    batch, num_t, _ = ctx.logproba.shape
    lp1 = ctx.label.shape[1]
    cap = fallback_cap()

    def fits(n, lane_pad=False):
        return est_fallback_bytes(n, num_t, lp1, lane_pad) <= cap

    has_exact = cfg.log_fallback
    exact = exact_fn if has_exact else pure_fn
    full_fits = fits(batch, lane_pad=has_exact)
    bucket = min(cfg.repair_bucket, batch)
    bucket_fits = bucket > 0 and fits(bucket)
    if not (full_fits or bucket_fits):
        warnings.warn(_GUARD_DISABLED.format(bucket=bucket, cap_mb=cap >> 20),
                      stacklevel=2)
        return fast_value
    if cfg.guard_struct == "while" and bucket_fits:
        fn, size = _round_plan(fits, exact, pure_fn, batch, bucket, has_exact)
        rows = flushed_rows(loss_like, feasible) if rows is None else rows
        if rows.numel() == 0:
            return fast_value
        if cfg.guard_tier1 and bucket < batch and rows.numel() <= bucket:
            fn, size = pure_fn, bucket
        return _repair(fast_value, fn, ctx, _repair_rounds(ctx, rows, size), aux)

    bucket2 = min(cfg.repair_bucket2, batch)
    tier2 = has_exact and bucket2 > bucket and bucket_fits and fits(bucket2, True)
    if bucket_fits and not full_fits:
        warnings.warn(_WHOLE_BATCH_DISABLED.format(
            cap_mb=cap >> 20, rows=bucket2 if tier2 else bucket), stacklevel=2)
    rows = flushed_rows(loss_like, feasible) if rows is None else rows
    n = rows.numel()
    if n == 0:
        return fast_value
    if bucket_fits and n <= bucket:
        return _repair(fast_value, pure_fn, ctx, _repair_rounds(ctx, rows, bucket), aux)
    if tier2 and (n <= bucket2 or not full_fits):
        return _repair(fast_value, exact_fn, ctx,
                       _repair_rounds(ctx, rows[:bucket2], bucket2), aux)
    if not full_fits:
        return _repair(fast_value, pure_fn, ctx,
                       _repair_rounds(ctx, rows[:bucket], bucket), aux)
    # the whole batch, clean rows too (and the two-way guard of bucket 0)
    whole = exact(ctx) if aux is None else exact(ctx, aux)
    return whole.to(fast_value.dtype)


class GuardedPack(NamedTuple):
    """The training forward's pack (``inner``: the kernel path's, which
    carries the forward's raw fast loss as ``loss``) with the number of
    flushed feasible rows that the forward's guard found (None where it did
    not look; a 0-d tensor from the device form), which
    ``guard_mode="pre"`` branches on before the backward."""

    inner: object
    flushed: Optional[Union[int, torch.Tensor]]


def _unwrap_pack(pack):
    if isinstance(pack, GuardedPack):
        return pack.inner, pack.flushed
    return pack, None


def valid_softmax(logproba, logit_length, loss):
    """``softmax * valid``, ``valid = (t < logit_length) & isfinite(loss)``:
    the softmax term of the analytic log-softmax cotangent."""
    num_t = logproba.shape[1]
    mask = (
        torch.arange(num_t, device=logproba.device)[None, :] < logit_length[:, None]
    ) & torch.isfinite(loss)[:, None]
    return torch.exp(logproba) * mask[:, :, None]


def compose_dlogits(ctx: CtcContext, grad, loss, d_loss):
    """``d_loss * (grad + softmax * valid)``: the analytic log-softmax
    cotangent (:func:`valid_softmax`)."""
    return d_loss[:, None, None] * (
        grad + valid_softmax(ctx.logproba, ctx.logit_length, loss))


class Topology:
    """One CTC topology: its pure path, its kernel path and the guard that
    repairs the kernel path's flushed rows.

    ``pure`` is the pure log-space module (``alpha``, ``beta``, ``gamma``,
    ``combine``, ``loss``); ``loss_fast``, ``loss_and_pack``,
    ``gradient_with_loss`` and ``streamed_acts`` (the acts step of the
    streamed scheme, which the fused epilogue B12 assembles) are the
    block-float kernel path;
    ``loss_exact`` and ``loss_and_gradient_log_exact`` the exact log-space
    kernels that repair it; ``feasible`` gives the rows whose loss is
    finite by their lengths; ``kernels_hold(ctx, training)`` whether the
    kernel path's kernels hold the label's lanes (a label that they do not
    hold takes the pure path, as the JAX package computes any width).
    """

    def __init__(self, name, pure, feasible, loss_fast, loss_and_pack,
                 gradient_with_loss, streamed_acts, loss_exact,
                 loss_and_gradient_log_exact, kernels_hold):
        self.name = name
        self.alpha = pure.alpha
        self.beta = pure.beta
        self.gamma = pure.gamma
        self.combine = pure.combine
        self.loss = pure.loss
        self.feasible = feasible
        self._loss_fast = loss_fast
        self._loss_and_pack = loss_and_pack
        self._gradient_with_loss = gradient_with_loss
        self._streamed_acts = streamed_acts
        self._loss_exact = loss_exact
        self._loss_and_gradient_log_exact = loss_and_gradient_log_exact
        self._kernels_hold = kernels_hold

    def _kernel_path(self, ctx: CtcContext, training: bool) -> bool:
        return kernels_enabled(ctx) and self._kernels_hold(ctx, training)

    def pure_loss(self, c: CtcContext):
        return self.loss(c, self.alpha(c))

    def _pure_grad(self, c: CtcContext):
        return _core.gradient(self, c)

    def _pure_repair(self, c: CtcContext):
        """``(loss, gradient)`` of the pure path in float64, cast back: the
        guard's pure route."""
        c64 = _core.float64_context(c)
        alpha = self.alpha(c64)
        loss = self.loss(c64, alpha)
        grad = -torch.exp(_core.gradient_log(self, c64, loss, alpha))
        return loss.float(), grad.float()

    def _pure_repair_loss(self, c: CtcContext):
        return self.pure_loss(_core.float64_context(c)).float()

    def _exact_grad(self, c: CtcContext):
        return -torch.exp(self._loss_and_gradient_log_exact(c)[1])

    def _guard(self, fast_value, exact_fn, pure_fn, loss_like, ctx, aux=None,
               count=False, forward_flushed=None):
        """``(value, n)``: ``fast_value`` guarded by :func:`_guarded`, or by
        its device form (:func:`_guarded_device`) where :func:`_on_device`
        says so; the one place that picks the form.  ``n`` is the number of
        flushed feasible rows: a 0-d tensor from the device form, an int
        from the host form where ``count`` asks it to find the rows first
        (:func:`flushed_rows`), else None.  ``forward_flushed``: the
        training forward's count under ``guard_mode="pre"``; 0 skips the
        guard, a tensor gates the device form's rounds on its being
        positive."""
        cfg = get_config()
        on_device = cfg.guard and _on_device()
        gate = None
        if on_device and isinstance(forward_flushed, torch.Tensor):
            gate = forward_flushed > 0
        elif forward_flushed is not None and forward_flushed == 0:
            return fast_value, 0
        feasible = self.feasible(ctx)
        if on_device:
            return _guarded_device(fast_value, exact_fn, pure_fn, loss_like, feasible,
                                   ctx, aux, gate)
        rows = flushed_rows(loss_like, feasible) if count and cfg.guard else None
        value = _guarded(fast_value, exact_fn, pure_fn, loss_like, feasible, ctx, aux, rows)
        return value, None if rows is None else rows.numel()

    def _guarded_loss(self, ctx: CtcContext, fast, count=False):
        return self._guard(fast, self._loss_exact, self._pure_repair_loss, fast, ctx,
                           count=count)

    def loss_fast(self, ctx: CtcContext):
        """Forward-only loss: the forward kernel in mode final on the
        kernel path."""
        if not self._kernel_path(ctx, training=False):
            return self.pure_loss(ctx)
        return self._guarded_loss(ctx, self._loss_fast(ctx))[0]

    def loss_and_pack_fast(self, ctx: CtcContext):
        """Training forward: the guarded loss plus the pack that the
        backward reads, a :class:`GuardedPack` around the kernel path's
        (see ``cuda_lattice.classic_loss_and_pack``); the pack is None on
        the pure path."""
        if not self._kernel_path(ctx, training=True):
            return self.pure_loss(ctx), None
        fast, pack = self._loss_and_pack(ctx)
        if not get_config().guard:
            return fast, GuardedPack(pack, None)
        loss, n = self._guarded_loss(ctx, fast, count=True)
        return loss, GuardedPack(pack, n)

    def gradient_fast(self, ctx: CtcContext, pack=None):
        """Gradient w.r.t. log-probabilities; the backward kernel on the
        kernel path."""
        if not self._kernel_path(ctx, training=True):
            return self._pure_grad(ctx)
        fast, fast_loss = self._gradient_with_loss(ctx, None, _unwrap_pack(pack)[0])
        return self._guard(fast, self._exact_grad, lambda c: self._pure_repair(c)[1],
                           fast_loss, ctx)[0]

    def dlogits_fast(self, ctx: CtcContext, d_loss, pack=None):
        """Logits cotangent ``d_loss * (grad + softmax * valid)`` on the
        kernel path (the backward kernel), guarded at the d_logits level.
        With ``fused_epilogue`` and a pack of the streamed scheme, kernel
        B12 assembles it from the acts in one pass
        (``cuda_lattice.fused_epilogue_ok``); the rows the guard repairs
        are composed unfused either way.

        ``guard_mode="pre"`` (unfused only, as in the JAX package): where
        the forward's guard found no flushed row (:class:`GuardedPack`), the
        backward runs unguarded, with no host synchronisation; otherwise
        the guard runs as under ``"post"``, on the backward's flush signal,
        so the two give the same d_logits.  The port's backward also flags
        a row whose scans disagree (``cuda_lattice.beta_carry_loss``); under
        ``"pre"`` a clean forward trusts the forward's signal, as the JAX
        package's does, and such a row keeps zero d_logits."""

        def pure(c, dl):
            loss = self.pure_loss(c)
            return compose_dlogits(c, _core.gradient(self, c, loss), loss, dl)

        def pure_repair(c, dl):
            loss, grad = self._pure_repair(c)
            return compose_dlogits(c, grad, loss, dl)

        def exact(c, dl):
            loss, grad_log = self._loss_and_gradient_log_exact(c)
            return compose_dlogits(c, -torch.exp(grad_log), loss, dl)

        if not self._kernel_path(ctx, training=True):
            return pure(ctx, d_loss)
        pack, forward_flushed = _unwrap_pack(pack)
        if _kernels.fused_epilogue_ok(ctx, pack):
            fast, fast_loss = _kernels.streamed_dlogits(
                ctx, d_loss, *self._streamed_acts(ctx, pack))
            forward_flushed = None
        else:
            grad, fast_loss = self._gradient_with_loss(ctx, None, pack)
            fast = compose_dlogits(ctx, grad, fast_loss, d_loss)
            if get_config().guard_mode != "pre":
                forward_flushed = None
        return self._guard(fast, exact, pure_repair, fast_loss, ctx, aux=d_loss,
                           forward_flushed=forward_flushed)[0]


CLASSIC = Topology(
    "classic", _classic, _classic_feasible,
    loss_fast=_kernels.classic_loss_fast,
    loss_and_pack=_kernels.classic_loss_and_pack,
    gradient_with_loss=_kernels.classic_gradient_with_loss,
    streamed_acts=_kernels.classic_streamed_acts,
    loss_exact=_log.classic_loss_exact,
    loss_and_gradient_log_exact=_log.classic_loss_and_gradient_log_exact,
    kernels_hold=_kernels.classic_kernels_hold,
)
SIMPLIFIED = Topology(
    "simplified", _simplified, _simplified_feasible,
    loss_fast=_skernels.simplified_loss_fast,
    loss_and_pack=_skernels.simplified_loss_and_pack,
    gradient_with_loss=_skernels.simplified_gradient_with_loss,
    streamed_acts=_skernels.simplified_streamed_acts,
    loss_exact=_log.simplified_loss_exact,
    loss_and_gradient_log_exact=_log.simplified_loss_and_gradient_log_exact,
    kernels_hold=_skernels.simplified_kernels_hold,
)
TOPOLOGIES = {t.name: t for t in (CLASSIC, SIMPLIFIED)}
