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

The device form (:func:`_guarded_device`) reads no device value on the
host, so that a CUDA graph can capture it: it runs under capture
(``ops/capture.py``), the host form everywhere else, and
:meth:`Topology._guard` is the one place that picks between them.  Its
host decisions, on static shapes and the cap, are the host form's
(:func:`_tiers`); each decision on the flushed count ``n`` is an IF node on
a predicate of ``n``, whose body repairs a static slice of the
flushed-first order gathered at the batch's full T and writes back only
where the predicate holds, so a clean replay runs none of them.  Under
"while" these are the JAX package's ``w_cond`` and ``w_body``: ``ceil(B /
rb)`` rounds on ``r * rb < n``.  Under "cond" they are its ``lax.switch``:
one node a tier on mutually exclusive predicates, the whole batch's
writing every row; ``repair_bucket=0`` is one node on ``n > 0``.  Its
values are the host form's bit for bit on the kernels, whose rows never
interact, except on a chunked time axis: there a round at full T goes
through the float64 pure path where the host form repairs a short row
with the log-space kernels on its own axis (within their 2e-4, and closer
to float64).  On the card a pure-path round is a few launches (the float64
scan kernels of ``ops/pure_scan.py``), so a chunked time axis is captured
as any other.

Under ``torch.compile`` the guard takes the device form too: the "while"
struct's rounds are one ``while_loop`` (:func:`_round_loop`), each other
IF node a ``torch.cond`` whose branches return a new tensor (they may not
write their inputs).  The traced graph reads no device value on the host,
so one graph serves every flushed count.  The decisions on static shapes
and the cap (:func:`_tier_plan`) are a constant of the graph: the cap is
read, and its warnings given, when the graph is traced.  A float64
pure-path repair is one node (the op ``ctc_port::pure_repair``), so a
chunked time axis compiles.
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
    """Whether the guard takes its device form: under ``torch.compile``
    (asked first: a traced function reads no stream state) or a CUDA graph
    capture (the tests patch it to run the device form on the CPU)."""
    return torch.compiler.is_compiling() or _capture.capturing()


class _Tiers(NamedTuple):
    """The guard's decisions at a shape, on static shapes and the cap,
    which both forms take as the JAX package takes them: ``exact`` the
    function of the whole batch (``exact_fn`` with ``log_fallback``, else
    ``pure_fn``); ``bucket`` and ``bucket2`` the two tiers' rows, at most
    the batch; ``bucket_fits`` whether tier 1 fits the cap; ``tier2``
    whether tier 2 runs; ``full_fits`` whether the whole batch fits;
    ``round_fn`` and ``round_rows`` the function and rows of a "while"
    round: ``max(min(repair_bucket2, B), repair_bucket)`` rows through
    ``exact``, shrunk to ``repair_bucket`` rows, then to pure-path rounds,
    where the cap does not admit them."""

    exact: object
    bucket: int
    bucket_fits: bool
    bucket2: int
    tier2: bool
    full_fits: bool
    round_fn: object
    round_rows: int

    def rounds(self) -> bool:
        """Whether the "while" struct's rounds repair (``repair_bucket`` fitting;
        else the two-way guard of the whole batch, under either struct)."""
        return get_config().guard_struct == "while" and self.bucket_fits


@torch.compiler.assume_constant_result
def _tier_plan(batch: int, num_t: int, lp1: int, repair_bucket: int, repair_bucket2: int,
               log_fallback: bool, guard_struct: str):
    """``(bucket, bucket_fits, bucket2, tier2, full_fits, round_exact,
    round_rows)`` of :class:`_Tiers` (``round_exact``: a "while" round
    takes ``exact``), None where no tier fits the cap; warns where the cap
    disables the guard or the whole-batch reroute, whatever the flushed
    count, as the host form always has.

    A constant under ``torch.compile``: the cap is read, and the warnings
    given, when the graph is traced (as the JAX package reads and warns
    under ``jax.jit``), outside the traced code, which a warning would
    break."""
    cap = fallback_cap()

    def fits(n, lane_pad=False):
        return est_fallback_bytes(n, num_t, lp1, lane_pad) <= cap

    full_fits = fits(batch, lane_pad=log_fallback)
    bucket = min(repair_bucket, batch)
    bucket_fits = bucket > 0 and fits(bucket)
    if not (full_fits or bucket_fits):
        warnings.warn(_GUARD_DISABLED.format(bucket=bucket, cap_mb=cap >> 20),
                      stacklevel=4)
        return None
    bucket2 = min(repair_bucket2, batch)
    tier2 = log_fallback and bucket2 > bucket and bucket_fits and fits(bucket2, True)
    if bucket_fits and not full_fits and guard_struct != "while":
        warnings.warn(_WHOLE_BATCH_DISABLED.format(
            cap_mb=cap >> 20, rows=bucket2 if tier2 else bucket), stacklevel=4)
    round_exact, round_rows = True, max(bucket2, bucket)
    if not fits(round_rows, log_fallback):
        round_rows = bucket
        round_exact = fits(bucket, log_fallback)
    return bucket, bucket_fits, bucket2, tier2, full_fits, round_exact, round_rows


def _tiers(ctx: CtcContext, exact_fn, pure_fn) -> Optional[_Tiers]:
    """The :class:`_Tiers` at ``ctx``'s shape (:func:`_tier_plan`), None
    where no tier fits the cap."""
    cfg = get_config()
    batch, num_t, _ = ctx.logproba.shape
    plan = _tier_plan(batch, num_t, ctx.label.shape[1], cfg.repair_bucket,
                      cfg.repair_bucket2, cfg.log_fallback, cfg.guard_struct)
    if plan is None:
        return None
    bucket, bucket_fits, bucket2, tier2, full_fits, round_exact, round_rows = plan
    exact = exact_fn if cfg.log_fallback else pure_fn
    return _Tiers(exact, bucket, bucket_fits, bucket2, tier2, full_fits,
                  exact if round_exact else pure_fn, round_rows)


def _take_rows(ctx: CtcContext, idx: torch.Tensor) -> CtcContext:
    """The samples ``idx`` of a context at its full time axis (the device
    form's gather, the JAX package's ``_take_ctx``)."""
    return CtcContext(**{name: val if name == "blank_index" else val.index_select(0, idx)
                         for name, val in ctx._asdict().items()})


def _kept(out):
    return out.clone()


def _repaired_rows(o, fn, ctx, idx, write, aux):
    """Rows ``idx`` of ``o``, each replaced by ``fn`` of the gathered
    context (and rows of ``aux``) where ``write`` holds: a round's body."""
    sub = _take_rows(ctx, idx)
    mini = fn(sub) if aux is None else fn(sub, aux.index_select(0, idx))
    keep = write.reshape(write.shape + (1,) * (o.dim() - 1))
    return torch.where(keep, mini.to(o.dtype), o.index_select(0, idx))


def _round(out, pred, fn, ctx, idx, flushed, aux):
    """``out`` with rows ``idx`` replaced by ``fn`` of their gathered
    context where they flushed and ``pred`` (a 0-d bool tensor) holds.
    Under ``torch.compile`` a new tensor, from ``torch.cond`` on ``pred``
    (its branches may not write their inputs); else ``out`` written in
    place, under capture by an IF node on ``pred`` whose body is the
    round."""

    def rows(o):
        return _repaired_rows(o, fn, ctx, idx, flushed.index_select(0, idx) & pred, aux)

    if torch.compiler.is_compiling():
        return torch.cond(pred, lambda o: o.index_copy(0, idx, rows(o)), _kept, (out,))
    with _capture.if_node(pred):
        out.index_copy_(0, idx, rows(out))
    return out


def _while_device(out, t, pure_fn, ctx, aux, flushed, order, n):
    """The "while" struct's rounds (``repair_bucket`` fitting): ``ceil(B /
    rb)`` rounds of the static slices ``order[r * rb:(r + 1) * rb]``, each
    written where its rows flushed and ``r * rb < n``, as the JAX
    package's ``w_body`` and ``w_cond``; with ``guard_tier1``, where ``0 < n
    <= repair_bucket``, one round of ``repair_bucket`` rows through the
    pure path instead (the reference's ``t1``).  Under ``torch.compile``
    the rounds are one ``while_loop`` (:func:`_round_loop`): inductor lowers
    each ``torch.cond`` body on its own, and one body a guard compiles
    faster than one a round."""
    batch = out.shape[0]
    run = n > 0
    if get_config().guard_tier1 and t.bucket < batch:
        tier1 = run & (n <= t.bucket)
        out = _round(out, tier1, pure_fn, ctx, order[:t.bucket], flushed, aux)
        run = n > t.bucket
    size = t.round_rows
    if torch.compiler.is_compiling():
        return _round_loop(out, run, t.round_fn, ctx, aux, flushed, order, n, size)
    for start in range(0, batch, size):
        out = _round(out, run & (n > start), t.round_fn, ctx, order[start:start + size],
                     flushed, aux)
    return out


def _round_loop(out, run, fn, ctx, aux, flushed, order, n, size):
    """The "while" struct's rounds under ``torch.compile``: one
    ``while_loop`` (the JAX package's ``w_cond`` and ``w_body``), round
    ``r`` running while ``run`` and ``r * size < n``, on the ``size`` rows
    of ``order`` from ``min(r * size, B - size)``: a last round that would
    pass the batch's end takes the rows before it again, whose repairs give
    the same values."""
    from torch._higher_order_ops.while_loop import while_loop

    lanes = torch.arange(size, device=out.device)
    last = out.shape[0] - size

    def more(r, o):
        return run & (r * size < n)

    def one(r, o):
        idx = order.index_select(0, torch.clamp(r * size, max=last) + lanes)
        rows = _repaired_rows(o, fn, ctx, idx, flushed.index_select(0, idx), aux)
        return r + 1, o.index_copy(0, idx, rows)

    start = torch.zeros((), dtype=torch.int64, device=out.device)
    return while_loop(more, one, (start, out))[1]


def _cond_device(out, t, pure_fn, ctx, aux, flushed, order, n):
    """The "cond" struct's tiers, and the two-way guard of ``repair_bucket``
    0: one IF node a tier, on mutually exclusive predicates of ``n`` (the
    JAX package's ``lax.switch``): tier 1, ``0 < n <= bucket``, the first
    ``bucket`` rows of ``order`` through the pure path; tier 2, ``bucket <
    n`` and ``n <= bucket2`` (or the whole batch over the cap), the first
    ``bucket2`` through the exact path; over the cap without tier 2, ``n >
    bucket``, the first ``bucket`` through the pure path (rows past them
    keep +inf); the whole batch through ``t.exact``, every row written,
    where ``n`` exceeds the largest tier below it (``n > 0`` with no tier
    below: the two-way guard).  Under ``torch.compile`` each node is a
    ``torch.cond``."""
    batch = out.shape[0]
    top = 0
    if t.bucket_fits:
        out = _round(out, (n > 0) & (n <= t.bucket), pure_fn, ctx, order[:t.bucket],
                     flushed, aux)
        top = t.bucket
        over = n > t.bucket
        if t.tier2:
            if t.full_fits:
                over = over & (n <= t.bucket2)
            out = _round(out, over, t.exact, ctx, order[:t.bucket2], flushed, aux)
            top = t.bucket2
        elif not t.full_fits:
            out = _round(out, over, pure_fn, ctx, order[:t.bucket], flushed, aux)
    if t.full_fits and top < batch:
        whole = n > top

        def rerouted(o):
            value = t.exact(ctx) if aux is None else t.exact(ctx, aux)
            return torch.where(whole, value.to(o.dtype), o)

        if torch.compiler.is_compiling():
            return torch.cond(whole, rerouted, _kept, (out,))
        with _capture.if_node(whole):
            out.copy_(rerouted(out))
    return out


def _guarded_device(fast_value, exact_fn, pure_fn, loss_like, feasible, ctx, aux=None,
                    gate=None):
    """The device form of :func:`_guarded`: ``(value, n)``, the same value
    and the number of flushed rows ``n`` (a 0-d tensor), with no host read
    of a device value.

    The host decisions (:func:`_tiers`) are the host form's; the flushed
    count's are predicates on the device.  The flushed-first order is a
    stable ``argsort(~flushed)``, and each repair is a static slice of it
    gathered at full T: the "while" rounds (:func:`_while_device`) or the
    "cond" tiers (:func:`_cond_device`).  Each is an IF node under capture
    (:func:`capture.if_node`) and its writes are masked by the same
    predicate, so an uncaptured call gives the replay's values.  ``gate``
    (a 0-d bool tensor) ands into every row's flush: ``guard_mode="pre"``
    passes the forward's count ``> 0``."""
    flushed = torch.isposinf(loss_like) & feasible
    if gate is not None:
        flushed = flushed & gate
    n = flushed.sum()
    t = _tiers(ctx, exact_fn, pure_fn)
    if t is None:
        return fast_value, n
    order = torch.argsort(~flushed, stable=True)
    tiers = _while_device if t.rounds() else _cond_device
    return tiers(fast_value.clone(), t, pure_fn, ctx, aux, flushed, order, n), n


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
    t = _tiers(ctx, exact_fn, pure_fn)
    if t is None:
        return fast_value
    batch = ctx.logproba.shape[0]
    rows = flushed_rows(loss_like, feasible) if rows is None else rows
    n = rows.numel()
    if n == 0:
        return fast_value
    if t.rounds():
        fn, size = t.round_fn, t.round_rows
        if cfg.guard_tier1 and t.bucket < batch and n <= t.bucket:
            fn, size = pure_fn, t.bucket
        return _repair(fast_value, fn, ctx, _repair_rounds(ctx, rows, size), aux)
    if t.bucket_fits and n <= t.bucket:
        return _repair(fast_value, pure_fn, ctx, _repair_rounds(ctx, rows, t.bucket), aux)
    if t.tier2 and (n <= t.bucket2 or not t.full_fits):
        return _repair(fast_value, exact_fn, ctx,
                       _repair_rounds(ctx, rows[:t.bucket2], t.bucket2), aux)
    if not t.full_fits:
        return _repair(fast_value, pure_fn, ctx,
                       _repair_rounds(ctx, rows[:t.bucket], t.bucket), aux)
    # the whole batch, clean rows too (and the two-way guard of bucket 0)
    whole = t.exact(ctx) if aux is None else t.exact(ctx, aux)
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
        guard's pure route (the op ``ctc_port::pure_repair``)."""
        return tuple(_log.pure_repair(self.name, c, "grad"))

    def _pure_repair_loss(self, c: CtcContext):
        return _log.pure_repair(self.name, c, "loss")[0]

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

    def _backward(self, ctx: CtcContext, pack):
        """``(grad, loss, signal)`` of the kernel path's backward on the
        forward's ``pack`` (made here where there is none): the fast
        gradient and the backward's loss (``cuda_lattice.carry_loss``),
        which masks the gradient and the softmax term, and the guard's
        flush signal (``cuda_lattice.flush_signal``)."""
        if pack is None:
            pack = self._loss_and_pack(ctx)[1]
        grad, loss = self._gradient_with_loss(ctx, None, pack)
        if pack is None:  # an empty batch
            return grad, loss, loss
        return grad, loss, _kernels.flush_signal(pack.loss, loss, ctx.logit_length)

    def gradient_fast(self, ctx: CtcContext, pack=None):
        """Gradient w.r.t. log-probabilities; the backward kernel on the
        kernel path."""
        if not self._kernel_path(ctx, training=True):
            return self._pure_grad(ctx)
        fast, _, signal = self._backward(ctx, _unwrap_pack(pack)[0])
        return self._guard(fast, self._exact_grad, lambda c: self._pure_repair(c)[1],
                           signal, ctx)[0]

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
        a row whose scans disagree (``cuda_lattice.flush_signal``), which
        only the guard reads: under ``"post"`` and ``"grad"`` the row is
        repaired; under ``"pre"`` after a clean forward it keeps its fast
        gradient, the value of the JAX package's ``"pre"``, which has no
        such flag (repairing it would take the host read that ``"pre"``
        saves)."""

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
            fast, loss = _kernels.streamed_dlogits(
                ctx, d_loss, *self._streamed_acts(ctx, pack))
            signal = _kernels.flush_signal(pack.loss, loss, ctx.logit_length)
            forward_flushed = None
        else:
            grad, loss, signal = self._backward(ctx, pack)
            fast = compose_dlogits(ctx, grad, loss, d_loss)
            if get_config().guard_mode != "pre":
                forward_flushed = None
        return self._guard(fast, exact, pure_repair, signal, ctx, aux=d_loss,
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
