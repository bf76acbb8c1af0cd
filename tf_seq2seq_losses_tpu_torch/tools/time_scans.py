#!/usr/bin/env python3
"""Time the block-float scans of one checkout of the repository on one
NVIDIA card: the forward scans B1 (``classic_fwd``, modes final, resid,
bound and resid1) and B6 (``simplified_fwd``, modes final, resid and
bound), the residual-free beta scans B10 (``classic_bwd``) and B11
(``simplified_bwd``), and at the headline the streamed one-chunk beta scans
B3 (``classic_bwd_streamed``, over mode resid's residuals), B13
(``classic_bwd_half``, over mode resid1's) and B7
(``simplified_bwd_streamed``, over B6 mode resid's), the fused d_logits
epilogue B12 (``fused_dlogits``) at V=128 on the headline batch, over the
acts of the streamed classic scheme (``chip_smoke.fused_args``), and the
log-space scans, classic B4 (``classic_log_fwd``, modes final and resid)
and B5 (``classic_log_bwd``, over mode resid's residuals) and simplified
B8 (``simplified_log_fwd``, modes final and resid) and B9
(``simplified_log_bwd``, over mode resid's residual), at the headline and
on a repair round (:func:`repair_round`); and the float64 scans of the
guard's pure repair (``classic_alpha64``, ``classic_beta64``,
``simplified_alpha64``, ``simplified_beta64``, ``ops/pure_scan.py``) on
that round with the infeasible row 0 (:func:`pure_round`, bursts of 5) and
on a long-T row at full T (:func:`long_row`, single launches); and the
HVP's tangent scans (``classic_alpha_jvp64``, ``classic_beta_jvp64``,
``simplified_alpha_jvp64``, ``simplified_beta_jvp64``) on the HVP's rows
of the headline batch (:func:`hvp_case`, bursts of 5) and on the long-T
row (single launches).

    python3 tf_seq2seq_losses_tpu_torch/tools/time_scans.py --tree DIR \\
        [--tag NAME] [--variant TAG:LIBRARY=FILE.cu ...] [--steps]

``--tree`` names the root of a checkout (the repository itself, or an
older commit unpacked with ``git archive``): its package and its
``chip_smoke.py`` are imported, and its kernels built, so two commits are
compared on one card by running this script once for each, in turns.
Each ``--variant`` rebuilds one kernel library (``LIBRARY`` a key of
``_build._SOURCES``) from another source with the same C interface, and
times the scans again with it in place under ``TAG``: a way to time
modified copies of a kernel, such as one with a phase taken out.

Shapes: the headline (B=256, T=500, V=32, labels [256, 250], one chunk;
bursts of 20 launches) and one long-T chunk (chunk 1 of 8 at B=256,
T=4000, labels [256, 2000]: 504 steps, 2016 lanes, from the carry chunk 0
leaves; bursts of 5), and for B4, B5, B8 and B9 also a repair round (rows
2-5 of the headline batch, flushed at one frame, gathered by the guard's own
``topology.take_ctx`` on their own time axis; bursts of 20), each by CUDA
events, the median of 5 bursts, as ``chip_smoke.py`` times its kernels.
``--steps`` also times the training steps at the headline (median of 20):
classic streamed and half-stream, the classic step with those four rows
flushed (the guard repairs them through B4 and B5 at their full lengths),
simplified, the simplified step with the same rows flushed (B8 and B9),
and each topology's fused step at V=128; and the long-T
training step of each topology (median of 3; the
simplified one with the guard off, as its row 220 is otherwise repaired
through the pure path), each on the host clock and its device time by
``torch.profiler``, with a digest of the step's loss and d_logits, by
which two trees' steps are shown to give the same bits; and the HVP of each
topology on its rows and on the whole headline batch (:func:`hvp_steps`),
with a digest of its output.

Prints one JSON line: the tag, the card's name and power limit, the times
in ms, each case's bound (the least time the card could take for its work
on this run's data, ``chip_smoke.kernel_bounds``; B12's
``chip_smoke.fused_bound``), and a digest of the
outputs of the tree's own kernels at each shape (of what they write: mode
resid's residuals only at the steps and windows that a sample runs), by
which two trees' kernels are shown to give the same bits; and the steps of
the repair round's longest row, the chain its scans run.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

_FWD_MODES = {"classic": ("final", "resid", "bound", "resid1"),
              "simplified": ("final", "resid", "bound")}
# a repair round: rows 2-5 of the headline batch, flushed at frame 3 by a
# token at +1e2 (every other at -1e2)
ROUND_ROWS = (2, 3, 4, 5)
FLUSH_FRAME, FLUSH_SCALE = 3, 1e2


def build_variant(build, library: str, source: Path) -> Path:
    """Compile ``source`` as the library ``library`` with the package's own
    flags; returns the shared object's path."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(build._FLAGS).encode())
    out = build._BUILD_DIR / f"{library}-variant-{digest.hexdigest()[:16]}.so"
    if not out.exists():
        build._BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # the source may include the package's headers
        cmd = [build._nvcc(), *build._FLAGS, "-I", str(build._CSRC), "-o", str(out),
               str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}{proc.stderr}")
    return out


def scan_cases(smoke, torch, dev, max_t: int, chunk: int) -> dict:
    """``{case: (launch, mode, lens, window)}`` for every forward mode and
    the residual-free backward of each topology on chunk ``chunk`` of the
    inputs ``make_inputs`` gives at ``max_t`` (the headline generator; at
    T=4000 that of ``benchmarks/long_t.py``), each scan from the carry that
    the chunks before it leave; ``mode`` is None for a backward.  Where the
    time axis is one chunk, also B3 over mode resid's pack, B13 over mode
    resid1's and B7 over B6 mode resid's, each with the act normaliser of
    that forward's loss, and B12 (:func:`fused_case`; its window is
    None)."""
    from tf_seq2seq_losses_tpu_torch.ops import core
    from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice as cl
    from tf_seq2seq_losses_tpu_torch.ops import cuda_simplified as cs
    from tf_seq2seq_losses_tpu_torch.utils.numerics import logit_to_logproba

    labels, logits, label_length, logit_length = smoke.make_inputs(
        torch, 0, dev, max_t=max_t, infeasible=max_t == smoke.MAX_T)
    ctx = core.make_context(labels, logit_to_logproba(logits, 2), label_length,
                            logit_length, 0)
    n_chunks, chunk_t = cl.chunk_plan(ctx)
    out = {}
    for topology in ("classic", "simplified"):
        ops = smoke.rf_ops(ctx, topology)
        carry, carries = None, []
        for c in range(n_chunks):
            carries.append(carry)
            carry = ops.fwd(*ops.chunk(c, chunk_t), ops.k_win, "final",
                            **cl.init_kw(carry))
        ebi = cl.ebi_from_loss(ops.loss(carry))
        args = ops.chunk(chunk, chunk_t)
        init = cl.init_kw(carries[chunk])
        for mode in _FWD_MODES[topology]:
            out[f"{topology}_fwd[{mode}]"] = (
                lambda f=ops.fwd, a=args, k=ops.k_win, m=mode, kw=init: f(*a, k, m, **kw),
                mode, args[-1], ops.k_win)
        bounds = ops.fwd(*args, ops.k_win, "bound", **init)[:ops.states + 1]
        b_args = (*args, ops.lab_len, ebi, *bounds, ops.k_win, None)
        out[f"{topology}_bwd"] = (lambda f=ops.bwd, a=b_args: f(*a), None, args[-1],
                                  ops.k_win)
        if topology == "classic" and n_chunks == 1:
            sa, saf, *fin = ops.fwd(*args, ops.k_win, "resid")
            a1, saf1, a0w = ops.fwd(*args, ops.k_win, "resid1")[:3]
            s_args = (*args, ops.lab_len, cl.ebi_from_loss(ops.loss(fin)))
            out["classic_bwd_streamed"] = (
                lambda a=(*s_args, sa, saf, ops.k_win): cl.classic_bwd_streamed(*a),
                None, args[-1], ops.k_win)
            out["classic_bwd_half"] = (
                lambda a=(*s_args, a1, saf1, a0w, ops.k_win): cl.classic_bwd_half(*a),
                None, args[-1], ops.k_win)
        if topology == "simplified" and n_chunks == 1:
            sa, saf, *fin = ops.fwd(*args, ops.k_win, "resid")
            s_args = (*args, ops.lab_len, cl.ebi_from_loss(ops.loss(fin)), sa, saf,
                      ops.k_win)
            out["simplified_bwd_streamed"] = (
                lambda a=s_args: cs.simplified_bwd_streamed(*a), None, args[-1],
                ops.k_win)
    if n_chunks == 1:
        eargs = fused_case(smoke, torch, dev, max_t)
        out["fused_dlogits"] = (lambda a=eargs: (cl.fused_dlogits(*a),), None, eargs[5],
                                None)
        out.update(log_cases(torch, ctx))
        out.update(simplified_log_cases(torch, ctx))
    return out


def log_cases(torch, ctx) -> dict:
    """``{case: (launch, mode, lens, window)}`` of B4 in modes final and
    resid and B5 over mode resid's residuals, with the act normaliser of
    that forward's loss, on ``ctx`` (a time axis of one chunk); mode
    ``"log_resid"`` marks B4's residuals for :func:`written`."""
    from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice as cl
    from tf_seq2seq_losses_tpu_torch.ops import log_lattice as ll

    blank_l, dc_l, pt_l, _lm, nb, rep, lens, lab_len = ll._log_inputs(ctx)
    args = (blank_l, dc_l, pt_l, nb, rep, lens)
    sx, sa1, f0, f1 = ll.classic_log_fwd(*args, "resid")
    loss = ll._pick_log_loss(f0, f1, lab_len)
    b_args = (*args, lab_len, torch.where(torch.isfinite(loss), loss,
                                          torch.zeros_like(loss)), sx, sa1)
    k_win = cl.geometry(ctx)[2]
    return {
        "classic_log_fwd[final]": (lambda: ll.classic_log_fwd(*args, "final"), None,
                                   lens, k_win),
        "classic_log_fwd[resid]": (lambda: ll.classic_log_fwd(*args, "resid"),
                                   "log_resid", lens, k_win),
        "classic_log_bwd": (lambda: ll.classic_log_bwd(*b_args), None, lens, k_win),
    }


def simplified_log_cases(torch, ctx) -> dict:
    """``{case: (launch, mode, lens, window)}`` of B8 in modes final and
    resid and B9 over mode resid's residual, with the act normaliser of
    that forward's loss, on ``ctx`` (a time axis of one chunk); mode
    ``"slog_resid"`` marks B8's residual for :func:`written`."""
    from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice as cl
    from tf_seq2seq_losses_tpu_torch.ops import log_lattice as ll

    blank_l, dg_l, _lm, lens, lab_len = ll.simplified_log_inputs(ctx)
    args = (blank_l, dg_l, lens)
    sa, f = ll.simplified_log_fwd(*args, "resid")
    loss = ll._pick_single_log_loss(f, lab_len)
    b_args = (*args, lab_len, torch.where(torch.isfinite(loss), loss,
                                          torch.zeros_like(loss)), sa)
    k_win = cl.geometry(ctx)[2]
    return {
        "simplified_log_fwd[final]": (lambda: (ll.simplified_log_fwd(*args, "final"),),
                                      None, lens, k_win),
        "simplified_log_fwd[resid]": (lambda: ll.simplified_log_fwd(*args, "resid"),
                                      "slog_resid", lens, k_win),
        "simplified_log_bwd": (lambda: ll.simplified_log_bwd(*b_args), None, lens,
                               k_win),
    }


def flushed(labels, logits, rows=ROUND_ROWS):
    """``logits`` with ``rows`` flushed: at frame ``FLUSH_FRAME`` one token
    at +``FLUSH_SCALE`` and every other at -``FLUSH_SCALE``, the token one
    that no path can emit there (blank, and the row's first ``FLUSH_FRAME +
    2`` labels, are all that a path can have reached by then; every token
    is somewhere in a full-length label).  Every path pays about 2
    ``FLUSH_SCALE`` nats there, far below float32's normal range: the
    block-float scans flush the row, the log-space ones do not.  The
    lengths are kept."""
    logits = logits.clone()
    for row in rows:
        used = set(labels[row, :FLUSH_FRAME + 2].tolist()) | {0}
        token = min(set(range(logits.shape[2])) - used)
        logits[row, FLUSH_FRAME] = -FLUSH_SCALE
        logits[row, FLUSH_FRAME, token] = FLUSH_SCALE
    return logits


def repair_round(smoke, torch, dev, seed=0, rows=ROUND_ROWS):
    """The context of one repair round: rows ``ROUND_ROWS`` of the
    headline batch (``make_inputs`` at ``seed``), flushed (:func:`flushed`),
    gathered (with ``rows``, which may add others) by the guard's own
    ``topology.take_ctx``, which cuts the time axis to their longest
    ``logit_length``; their lengths are kept."""
    from tf_seq2seq_losses_tpu_torch.ops import core, topology
    from tf_seq2seq_losses_tpu_torch.utils.numerics import logit_to_logproba

    labels, logits, label_length, logit_length = smoke.make_inputs(torch, seed, dev)
    ctx = core.make_context(labels, logit_to_logproba(flushed(labels, logits), 2),
                            label_length, logit_length, 0)
    return topology.take_ctx(ctx, torch.tensor(rows, device=dev))


def pure_round(smoke, torch, dev, seed=0):
    """The repair round with the headline batch's infeasible row 0 beside
    rows ``ROUND_ROWS``: the float64 scans' round (their -inf entries: the
    lanes past each label, the flushed frame, row 0's lattice)."""
    return repair_round(smoke, torch, dev, seed, rows=(0,) + ROUND_ROWS)


def long_row(smoke, torch, dev, seed=0):
    """Rows 0 (infeasible) and 2 of the long-T batch at its full T=4000,
    gathered as the guard's device form gathers a round
    (``topology._take_rows``): a float64 scan's long-T case."""
    from tf_seq2seq_losses_tpu_torch.ops import core, topology
    from tf_seq2seq_losses_tpu_torch.utils.numerics import logit_to_logproba

    labels, logits, label_length, logit_length = smoke.make_inputs(
        torch, seed, dev, max_t=smoke.LONG_T)
    ctx = core.make_context(labels, logit_to_logproba(logits, 2), label_length,
                            logit_length, 0)
    return topology._take_rows(ctx, torch.tensor([0, 2], device=dev))


def pure64_cases(smoke, ctx) -> dict:
    """``{case: (launch, mode, lens, window)}`` of the four float64 scans
    (``ops/pure_scan.py``) on the float64 form of ``ctx``
    (``chip_smoke.pure64_args``)."""
    return {name: (lambda k=kern, a=args: (k(*a),), None, None, None)
            for name, (kern, _plain, args) in smoke.pure64_args(ctx).items()}


def pure64_bounds(smoke, ctx, shape: str) -> dict:
    """``{"case shape": ms}``: each float64 scan's bound on ``ctx``
    (``chip_smoke.pure64_bound``: bytes at the HBM rate or float64
    operations at the float64 rate)."""
    return {f"{name} {shape}": smoke.bound(*smoke.pure64_bound(name, args))[0]
            for name, (_k, _p, args) in smoke.pure64_args(ctx).items()}


def hvp_case(smoke, torch, dev, shape: str, seed=0):
    """``(context, vector)`` of a tangent scans' case: ``"hvp_rows"``, rows
    0 to ``chip_smoke.HVP_ROWS`` - 1 of the headline batch (rows 0 and 1
    infeasible), the rows of phase 8's and phase 15's HVP; or
    ``"hvp_long_t_row"``, the long-T row of :func:`long_row`; the vector
    N(0, 1) from a generator seeded ``seed``."""
    from tf_seq2seq_losses_tpu_torch.ops import core, topology
    from tf_seq2seq_losses_tpu_torch.utils.numerics import logit_to_logproba

    if shape == "hvp_rows":
        labels, logits, label_length, logit_length = smoke.make_inputs(torch, seed, dev)
        ctx = topology._take_rows(
            core.make_context(labels, logit_to_logproba(logits, 2), label_length,
                              logit_length, 0),
            torch.arange(smoke.HVP_ROWS, device=dev))
    else:
        ctx = long_row(smoke, torch, dev, seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return ctx, torch.randn(ctx.logproba.shape, generator=gen, device=dev)


def jvp64_cases(smoke, ctx, vector) -> dict:
    """``{case: (launch, mode, lens, window)}`` of the HVP's four tangent
    scans (``ops/pure_scan.py``) on the float64 form of ``ctx`` with the
    terms' tangents along ``vector`` (``chip_smoke.jvp64_args``)."""
    return {name: (lambda k=kern, a=args: k(*a), None, None, None)
            for name, (kern, _plain, args) in smoke.jvp64_args(ctx, vector).items()}


def jvp64_bounds(smoke, ctx, vector, shape: str) -> dict:
    """``{"case shape": ms}``: each tangent scan's bound on ``ctx``
    (``chip_smoke.jvp64_bound``)."""
    return {f"{name} {shape}": smoke.bound(*smoke.jvp64_bound(name, args))[0]
            for name, (_k, _p, args) in smoke.jvp64_args(ctx, vector).items()}


def hvp_steps(smoke, torch, dev) -> dict:
    """Host-clock and device time of ``ctc_loss_hessian_vector_product`` of
    each topology on rows 0 to ``chip_smoke.HVP_ROWS`` - 1 and on the whole
    headline batch (median of 20), with a digest of its output."""
    import tf_seq2seq_losses_tpu_torch as ctc
    from tf_seq2seq_losses_tpu_torch.utils.numerics import logit_to_logproba

    labels, logits, label_length, logit_length = smoke.make_inputs(torch, 0, dev)
    args = (labels, logit_to_logproba(logits, 2), label_length, logit_length)
    gen = torch.Generator(device=dev).manual_seed(0)
    vector = torch.randn(logits.shape, generator=gen, device=dev)
    out = {}
    for topology in ("classic", "simplified"):
        for part, rows in ((f"rows_0_{smoke.HVP_ROWS - 1}", slice(0, smoke.HVP_ROWS)),
                           ("whole_batch", slice(None))):
            def call(rows=rows, topology=topology):
                return ctc.ctc_loss_hessian_vector_product(
                    *(a[rows] for a in args), 0, vector[rows], topology)

            host = smoke.host_ms(torch, call)
            prof = smoke.profile_step(torch, dev, host, call)
            out[f"{topology}_hvp_{part}"] = {
                "host_ms": host, "device_ms": prof.get("device_ms_per_step"),
                "device_idle_share": prof.get("device_idle_share"),
                "digest": step_digest((call(),))}
    return out


def fused_case(smoke, torch, dev, max_t: int):
    """The ``fused_dlogits`` arguments at V = ``chip_smoke.SLICE_VOCAB`` on
    the batch ``make_inputs`` gives at ``max_t``: the acts of the streamed
    classic scheme (``chip_smoke.fused_args``)."""
    from tf_seq2seq_losses_tpu_torch.ops import core
    from tf_seq2seq_losses_tpu_torch.utils.numerics import logit_to_logproba

    labels, logits, label_length, logit_length = smoke.make_inputs(
        torch, 0, dev, max_t=max_t, vocab=smoke.SLICE_VOCAB)
    ctx = core.make_context(labels, logit_to_logproba(logits, 2), label_length,
                            logit_length, 0)
    return smoke.fused_args(ctx)[0]


def bound_ms(smoke, torch, dev, max_t: int, cases, label_length=None) -> dict:
    """``{case: ms}``: the least time the card could take for each case's
    work on the data ``scan_cases`` made at ``max_t``, or on a batch whose
    ``label_length`` is given (the repair round)
    (``chip_smoke.kernel_bounds``, B12's ``chip_smoke.fused_bound``: its
    bytes at the HBM rate or its operations at the float32 rate, whichever
    is longer)."""
    if label_length is None:
        label_length = smoke.make_inputs(torch, 0, dev, max_t=max_t,
                                         infeasible=max_t == smoke.MAX_T)[2]
    out = {}
    for name, (_launch, _mode, lens, k_win) in cases.items():
        if name == "fused_dlogits":
            v_ll = smoke.make_inputs(torch, 0, dev, max_t=max_t,
                                     vocab=smoke.SLICE_VOCAB)[2]
            work = smoke.fused_bound(lens, v_ll, max_t, smoke.SLICE_VOCAB)
        else:
            work = smoke.kernel_bounds(lens, label_length, k_win)[name]
        out[name] = smoke.bound(*work)[0]
    return out


def written(torch, outs, mode, lens, k_win) -> list:
    """A scan's outputs with what the kernel leaves unwritten set to 0: the
    residual steps and windows past each sample's length (modes resid and
    resid1: the residuals, the frames, then in resid1 ``a0w``; B4's mode
    resid, ``"log_resid"``: its two residual streams; B8's,
    ``"slog_resid"``: its one)."""
    outs = list(outs)
    if mode not in ("resid", "resid1", "log_resid", "slog_resid"):
        return outs
    steps = torch.arange(outs[0].shape[1], device=lens.device)
    run_t = steps[None, :] < lens[:, None]
    run_w = steps[None, ::k_win] < lens[:, None]

    def keep(x, ok):
        ok = ok.reshape(ok.shape + (1,) * (x.dim() - 2))
        return torch.where(ok, x, torch.zeros_like(x))

    masks = {"resid": (run_t, run_w), "resid1": (run_t, run_w, run_w),
             "log_resid": (run_t, run_t), "slog_resid": (run_t,)}[mode]
    for i, ok in enumerate(masks):
        outs[i] = keep(outs[i], ok)
    return outs


def digest(torch, case) -> str:
    """The first 16 hex digits of a SHA-256 of what ``case`` writes."""
    launch, mode, lens, k_win = case
    h = hashlib.sha256()
    for t in written(torch, launch(), mode, lens, k_win):
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def step_digest(outputs) -> str:
    """The first 16 hex digits of a SHA-256 of a step's outputs (its loss
    and d_logits)."""
    h = hashlib.sha256()
    for t in outputs:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def headline_steps(smoke, torch, dev) -> dict:
    """Host-clock and device time of the training steps at the headline:
    classic streamed (B2, B3) and half-stream (resid1, B13), classic with
    rows ``ROUND_ROWS`` flushed (:func:`flushed`; the guard repairs them in
    one round through B4 final, B4 resid and B5), simplified (B6 resid,
    B7), simplified with the same rows flushed (B8 final, B8 resid and
    B9), and each topology's fused step at V=128 (B12)."""
    from tf_seq2seq_losses_tpu_torch.utils.config import config_override

    labels, *inputs = smoke.make_inputs(torch, 0, dev)
    f_inputs = (flushed(labels, inputs[0]), *inputs[1:])
    v_labels, *v_inputs = smoke.make_inputs(torch, 0, dev, vocab=smoke.SLICE_VOCAB)
    v = smoke.SLICE_VOCAB
    cases = {  # name: (topology, labels, inputs, config)
        "classic_fwd_bwd_step": ("classic", labels, inputs, {}),
        "classic_fwd_bwd_step_half_stream": ("classic", labels, inputs,
                                             {"half_stream": True}),
        "classic_fwd_bwd_step_4_full_rows_repaired": ("classic", labels, f_inputs, {}),
        "simplified_fwd_bwd_step": ("simplified", labels, inputs, {}),
        "simplified_fwd_bwd_step_4_full_rows_repaired": ("simplified", labels, f_inputs,
                                                         {}),
        f"classic_fwd_bwd_step_v{v}_fused": ("classic", v_labels, v_inputs,
                                             {"fused_epilogue": True}),
        f"simplified_fwd_bwd_step_v{v}_fused": ("simplified", v_labels, v_inputs,
                                                {"fused_epilogue": True}),
    }
    out = {}
    for name, (topology, lab, args, cfg) in cases.items():
        step = smoke.make_step(torch, smoke.loss_function(topology), lab)
        with config_override(**cfg):
            host = smoke.host_ms(torch, lambda: step(*args))
            prof = smoke.profile_step(torch, dev, host, lambda: step(*args))
            digest_ = step_digest(step(*args))
        out[name] = {"host_ms": host, "device_ms": prof.get("device_ms_per_step"),
                     "device_idle_share": prof.get("device_idle_share"),
                     "digest": digest_}
    return out


def long_steps(smoke, torch, dev) -> dict:
    """Host-clock and device time of each topology's long-T training step."""
    from tf_seq2seq_losses_tpu_torch.utils.config import config_override

    labels, logits, label_length, logit_length = smoke.make_inputs(
        torch, 0, dev, max_t=smoke.LONG_T, infeasible=False)
    out = {}
    for topology in ("classic", "simplified"):
        step = smoke.make_step(torch, smoke.loss_function(topology), labels)
        with config_override(guard=topology == "classic"):
            host = smoke.host_ms(torch, lambda: step(logits, label_length, logit_length),
                                 runs=smoke.LONG_RUNS)
            prof = smoke.profile_step(torch, dev, host,
                                      lambda: step(logits, label_length, logit_length),
                                      steps=2)
            digest_ = step_digest(step(logits, label_length, logit_length))
        out[f"{topology}_fwd_bwd_step"] = {
            "host_ms": host, "device_ms": prof.get("device_ms_per_step"),
            "device_idle_share": prof.get("device_idle_share"), "digest": digest_}
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", type=Path, required=True)
    parser.add_argument("--tag", default=None)
    parser.add_argument("--variant", action="append", default=[],
                        help="TAG:LIBRARY=FILE.cu")
    parser.add_argument("--steps", action="store_true")
    args = parser.parse_args()
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        print("time_scans.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from tf_seq2seq_losses_tpu_torch.ops import _build

    dev = torch.device("cuda:0")
    libs = dict(_build.build_all())
    variants = {}
    for spec in args.variant:
        tag, _, rest = spec.partition(":")
        library, _, source = rest.partition("=")
        so = build_variant(_build, library, Path(source).resolve())
        variants.setdefault(tag, {})[library] = _build._bind(library, so)
    # shape: (T, the chunk timed, launches a burst)
    shapes = {"headline": (smoke.MAX_T, 0, 20), "long_t_chunk": (smoke.LONG_T, 1, 5)}
    cases = {shape: scan_cases(smoke, torch, dev, max_t, chunk)
             for shape, (max_t, chunk, _) in shapes.items()}
    bounds = {f"{name} {shape}": ms for shape, (max_t, _, _) in shapes.items()
              for name, ms in bound_ms(smoke, torch, dev, max_t, cases[shape]).items()}
    round_ctx = repair_round(smoke, torch, dev)
    cases["repair_round"] = {**log_cases(torch, round_ctx),
                             **simplified_log_cases(torch, round_ctx)}
    bounds.update({f"{name} repair_round": ms for name, ms in bound_ms(
        smoke, torch, dev, None, cases["repair_round"], round_ctx.label_length).items()})
    bursts = {shape: burst for shape, (_, _, burst) in shapes.items()}
    bursts["repair_round"] = 20
    # the float64 scans: the repair round with its infeasible row, and a
    # long-T row at full T
    for shape, ctx, burst in (("pure_round", pure_round(smoke, torch, dev), 5),
                              ("long_t_row", long_row(smoke, torch, dev), 1)):
        cases[shape] = pure64_cases(smoke, ctx)
        bounds.update(pure64_bounds(smoke, ctx, shape))
        bursts[shape] = burst
    # the HVP's tangent scans: its rows of the headline batch, and the
    # long-T row
    for shape, burst in (("hvp_rows", 5), ("hvp_long_t_row", 1)):
        ctx, vector = hvp_case(smoke, torch, dev, shape)
        cases[shape] = jvp64_cases(smoke, ctx, vector)
        bounds.update(jvp64_bounds(smoke, ctx, vector, shape))
        bursts[shape] = burst
    digests = {f"{name} {shape}": digest(torch, case)
               for shape in cases for name, case in cases[shape].items()}
    times = {}
    for tag, override in [(args.tag or tree.name, {}), *variants.items()]:
        _build._libs.clear()
        _build._libs.update({**libs, **override})
        times[tag] = {f"{name} {shape}": smoke.time_ms(torch, case[0], burst=bursts[shape])
                      for shape in cases for name, case in cases[shape].items()}
    _build._libs.clear()
    _build._libs.update(libs)
    out = {"tree": str(args.tag or tree.name), "card": smoke.card_line(),
           "ms": times, "bound_ms": bounds, "digest": digests,
           "repair_round_steps": int(round_ctx.logit_length.max())}
    if args.steps:
        out["headline_steps"] = headline_steps(smoke, torch, dev)
        out["long_t_steps"] = long_steps(smoke, torch, dev)
        out["hvp_steps"] = hvp_steps(smoke, torch, dev)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
