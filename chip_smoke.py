#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py [--seed 0]

Phases, one line each (phases 3 and 4 once per topology, classic then
simplified):

1. build the CUDA kernels of ``tf_seq2seq_losses_tpu_torch/csrc/``;
2. run every kernel (classic B1-B5, simplified B6-B9) on the card at the
   headline shape (B=256, T=500, V=32, labels [256, 250]), and at batch 8
   with labels [8, 600], windows 1 and 16, and blank index 3 with labels
   over {1, 2}, and hold it against its plain PyTorch version on the same
   inputs: losses rtol 1e-5; acts and scaled carries atol 1e-5; block-float
   residual mantissas rtol 1e-5 + atol 1e-6; log-space residuals rtol 1e-5
   + atol 1e-5; inf patterns equal throughout;
3. the main path, with TF32 allowed for float32 matrix products as
   training scripts on an H100 commonly set it: ``classic_ctc_loss`` (then
   ``simplified_ctc_loss``) forward plus ``.backward()``, then a
   forward-only call under ``torch.no_grad()``; finite loss on feasible
   rows, +inf loss and exactly zero d_logits on infeasible rows, loss
   (rtol 1e-5) and d_logits (atol 1e-5) equal to the same topology's pure
   path run on the card in float64 (the float32 pure path's own error is
   printed beside);
4. the saturation guard: four rows saturated at the logit scale 1e2 and
   1e10 flush and are repaired through the log-space kernels; rows at
   1e2 match the pure path (loss and d_logits atol 2e-4), rows at 1e10
   are finite and match the pure loss (rtol 1e-6), their d_logits are not
   compared (see ``saturate``); every clean row is bit for bit the clean
   batch's;
5. oracles: the README example, loss [5.4931, 2.4485] and grad[0, 0] =
   [1/3, -2/3, 1/3] (atol 1e-3), also from numpy arrays, whose result must
   lie on the card; the simplified loss of labels [[1, 2]] over three
   uniform frames of three tokens, ln 9 (three paths of 1/27; atol 1e-3);
6. timing with CUDA events (each kernel: median of 5 bursts of 20
   back-to-back launches; its plain version: median of 5 single calls;
   ``torch.nn.functional.ctc_loss``, the library yardstick of the classic
   loss: median of 20 single calls; no PyTorch call computes the
   simplified loss) and on the host clock (each topology's fwd+bwd step
   and forward-only call): each kernel, its plain version and its bound;
   then a ``torch.profiler`` breakdown of each step's device time by
   kernel.

The launch counts are set to 0 before each topology's phase 3 and read
after its phase 4: a kernel that its main path (training step, evaluation
call, guard repair) never launched fails the run.  The last lines are the
``kernels`` JSON, the card's name and power limit, and ``{"ok": true,
"device": ...}``.  Any failed check exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
BATCH, MAX_T, VOCAB = 256, 500, 32
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
RUNS = 20
PLAIN_RUNS = 5  # the plain versions take 0.1 to 0.2 s a launch at the headline


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def make_inputs(torch, seed: int, dev, batch=None, label_width=None):
    """Headline inputs: labels [B, T/2] in 1..V-1, N(0, 1) logits,
    label_length in [T/4, T/2), logit_length in [T/2, T); rows 0 and 1 are
    made infeasible (logit_length below label_length).  ``label_width``
    widens the label array (its extra columns are past every
    label_length)."""
    import numpy as np

    batch = batch or BATCH
    rng = np.random.RandomState(seed)
    labels = rng.randint(1, VOCAB, (batch, label_width or MAX_T // 2)).astype(np.int32)
    logits = rng.randn(batch, MAX_T, VOCAB).astype(np.float32)
    label_length = rng.randint(MAX_T // 4, MAX_T // 2, (batch,)).astype(np.int32)
    logit_length = rng.randint(MAX_T // 2, MAX_T, (batch,)).astype(np.int32)
    logit_length[:2] = label_length[:2] // 2
    return tuple(torch.as_tensor(a, device=dev) for a in (
        labels, logits, label_length, logit_length))


def saturate(torch, labels, logits, label_length, logit_length):
    """Rows 2..5: label_length 5, logit_length 12, and at frame 3 one token
    absent from the label (not blank) at +s, every other token at -s, with
    s = 1e2 for rows 2, 3 and 1e10 for rows 4, 5.  Every path pays ~2s
    there: the block-float forward flushes, the exact loss is finite.

    At s = 1e10 the loss is 2e10 plus about 12, and float32 holds it only
    to its ulp there, 2048.  Every float32 path, the pure one included,
    normalises the posteriors by that loss, so its d_logits keep no digits
    on these rows: they are held to finiteness, and the distance of the
    float32 pure path from float64 there is printed to show it."""
    logits = logits.clone()
    label_length = label_length.clone()
    logit_length = logit_length.clone()
    for row, scale in ((2, 1e2), (3, 1e2), (4, 1e10), (5, 1e10)):
        label_length[row] = 5
        logit_length[row] = 12
        used = set(labels[row, :5].tolist()) | {0}
        token = min(set(range(VOCAB)) - used)
        logits[row, 3] = -scale
        logits[row, 3, token] = scale
    return logits, label_length, logit_length


def close(a, b, rtol, atol) -> bool:
    import torch

    a = a.double()
    b = b.double()
    same_inf = torch.equal(torch.isinf(a), torch.isinf(b)) and torch.equal(
        a[torch.isinf(a)], b[torch.isinf(b)]
    )
    fin = torch.isfinite(a) & torch.isfinite(b)
    if not same_inf or not torch.equal(torch.isnan(a), torch.isnan(b)):
        return False
    return bool(torch.all(torch.abs(a[fin] - b[fin]) <= atol + rtol * torch.abs(b[fin])))


def agree(a, b, rtol, atol, what) -> None:
    """Fail unless ``a`` and ``b`` agree (equal inf/NaN patterns, then
    ``|a - b| <= atol + rtol |b|``); the message carries the largest error."""
    if not close(a, b, rtol, atol):
        raise CheckFailed(f"{what}: max abs err {max_err(a, b):.3g} "
                          f"(rtol {rtol}, atol {atol})")


def max_err(a, b) -> float:
    import torch

    a = a.double()
    b = b.double()
    fin = torch.isfinite(a) & torch.isfinite(b)
    if not bool(fin.any()):
        return 0.0
    return float(torch.max(torch.abs(a[fin] - b[fin])))


def time_ms(torch, fn, runs=5, burst=RUNS) -> float:
    """Device time per call of ``fn``, after one warm-up: the median over
    ``runs`` of CUDA events around ``burst`` calls issued back to back,
    divided by ``burst``.  Queued calls hide the host's time to issue one
    behind the previous kernel, so a slow host does not count as device
    time.  ``burst=1`` times single calls: for a function that waits for
    the host inside (the plain versions, ``F.ctc_loss``), queued calls
    would not overlap, and a mean over them would take in the host's
    outliers."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(burst):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / burst)
    return statistics.median(times)


def host_ms(torch, fn, runs=RUNS) -> float:
    """Median wall time of ``fn`` ending in a synchronize (step time)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def pure_float64(labels, logits, label_length, logit_length, topology="classic"):
    """The port's pure log-space path of ``topology`` evaluated in float64:
    the reference for the main path at T=500, where the float32 pure path's
    own rounding (about an ulp of a loss near 1e3 per step) reaches 1e-3."""
    import torch

    from tf_seq2seq_losses_tpu_torch.ops import core
    from tf_seq2seq_losses_tpu_torch.ops.topology import TOPOLOGIES, compose_dlogits
    from tf_seq2seq_losses_tpu_torch.utils.numerics import logit_to_logproba

    topo = TOPOLOGIES[topology]
    lp64 = logit_to_logproba(logits.double(), 2)
    c = core.make_context(labels, lp64, label_length, logit_length, 0)
    forced = torch.where(c.logit_length_mask[:, :, None], lp64, c.logproba.double())
    c = c._replace(logproba=forced, raw_logproba=lp64,
                   blank_lp=core.take_blank_logproba(forced, c.blank_index))
    loss = topo.loss(c, topo.alpha(c))
    grad = -torch.exp(core.gradient_log(topo, c, loss))
    ones = torch.ones_like(loss)
    return loss, compose_dlogits(c, grad, loss, ones)


def compare_kernels(ctx):
    """Run every classic kernel and its plain version on the same inputs and
    hold them together; returns ``(max abs errors, kernel arguments)``."""
    import torch

    from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice as cl
    from tf_seq2seq_losses_tpu_torch.ops import log_lattice as ll

    dev = ctx.logproba.device
    blank, dcu, lm, nb, rep, lens, lab_len, k_win = cl.kernel_inputs(ctx)
    batch, tpad, lpad = dcu.shape
    errs = {}

    def pick(f0, f1, fe):
        return cl.pick_loss(f0 + f1, fe, lab_len)

    f_k = cl.classic_fwd(blank, dcu, lm, nb, rep, lens, k_win, "final")
    f_p = cl.classic_fwd_plain(blank, dcu, lm, nb, rep, lens, k_win, "final")
    loss_k, loss_p = pick(*f_k), pick(*f_p)
    agree(loss_k, loss_p, 1e-5, 0.0, "classic_fwd[final] loss vs plain")
    errs["classic_fwd[final]"] = max_err(loss_k, loss_p)

    r_k = cl.classic_fwd(blank, dcu, lm, nb, rep, lens, k_win, "resid")
    r_p = cl.classic_fwd_plain(blank, dcu, lm, nb, rep, lens, k_win, "resid")
    rl_k, rl_p = pick(*r_k[2:]), pick(*r_p[2:])
    agree(rl_k, rl_p, 1e-5, 0.0, "classic_fwd[resid] loss vs plain")
    valid_t = (torch.arange(tpad, device=dev)[None, :] < lens[:, None])
    agree(r_k[0][valid_t], r_p[0][valid_t], 1e-5, 1e-6,
          "classic_fwd[resid] residual mantissas vs plain")
    errs["classic_fwd[resid]"] = max(max_err(rl_k, rl_p),
                                     max_err(r_k[0][valid_t], r_p[0][valid_t]))

    ebi = cl.ebi_from_loss(rl_k)
    b_args = (blank, dcu, lm, nb, rep, lens, lab_len, ebi, r_k[0], r_k[1], k_win)
    b_k = cl.classic_bwd_streamed(*b_args)
    b_p = cl.classic_bwd_streamed_plain(*b_args)

    def beta_loss(b):
        return -(torch.log(b[1][:, 0]) + b[3][:, 0].float() * cl.LN2)

    agree(beta_loss(b_k), beta_loss(b_p), 1e-5, 0.0,
          "classic_bwd_streamed beta carry vs plain")
    agree(b_k[0], b_p[0], 0.0, 1e-5, "classic_bwd_streamed pc vs plain")
    errs["classic_bwd_streamed"] = max(max_err(b_k[0], b_p[0]),
                                       max_err(beta_loss(b_k), beta_loss(b_p)))

    blank_l, dc_l, pt_l, _lm, nb_, rep_, _, _ = ll._log_inputs(ctx)
    lf_k = ll.classic_log_fwd(blank_l, dc_l, pt_l, nb_, rep_, lens, "final")
    lf_p = ll.classic_log_fwd_plain(blank_l, dc_l, pt_l, nb_, rep_, lens, "final")
    lfl_k, lfl_p = ll._pick_log_loss(*lf_k, lab_len), ll._pick_log_loss(*lf_p, lab_len)
    agree(lfl_k, lfl_p, 1e-5, 0.0, "classic_log_fwd[final] loss vs plain")
    errs["classic_log_fwd[final]"] = max_err(lfl_k, lfl_p)

    lr_k = ll.classic_log_fwd(blank_l, dc_l, pt_l, nb_, rep_, lens, "resid")
    lr_p = ll.classic_log_fwd_plain(blank_l, dc_l, pt_l, nb_, rep_, lens, "resid")
    lrl_k = ll._pick_log_loss(*lr_k[2:], lab_len)
    agree(lrl_k, ll._pick_log_loss(*lr_p[2:], lab_len), 1e-5, 0.0,
          "classic_log_fwd[resid] loss vs plain")
    for i, name in ((0, "x"), (1, "a1")):
        agree(lr_k[i][valid_t], lr_p[i][valid_t], 1e-5, 1e-5,
              f"classic_log_fwd[resid] residual {name} vs plain")
    errs["classic_log_fwd[resid]"] = max(
        max_err(lr_k[i][valid_t], lr_p[i][valid_t]) for i in (0, 1)
    )

    safe = torch.where(torch.isfinite(lrl_k), lrl_k, torch.zeros_like(lrl_k))
    lb_args = (blank_l, dc_l, pt_l, nb_, rep_, lens, lab_len, safe, lr_k[0], lr_k[1])
    lb_k = ll.classic_log_bwd(*lb_args)
    lb_p = ll.classic_log_bwd_plain(*lb_args)
    agree(lb_k[0], lb_p[0], 0.0, 1e-5, "classic_log_bwd pc vs plain")
    agree(lb_k[1][:, 0], lb_p[1][:, 0], 1e-5, 0.0, "classic_log_bwd beta0 vs plain")
    errs["classic_log_bwd"] = max(max_err(lb_k[0], lb_p[0]),
                                  max_err(lb_k[1][:, 0], lb_p[1][:, 0]))
    args = dict(fwd=(blank, dcu, lm, nb, rep, lens, k_win), bwd=b_args,
                log_fwd=(blank_l, dc_l, pt_l, nb_, rep_, lens), log_bwd=lb_args,
                lens=lens, k_win=k_win, shape=(batch, tpad, lpad))
    return errs, args


def compare_simplified_kernels(ctx):
    """The same for the simplified kernels (B6-B9), at the same tolerances:
    ``(max abs errors, kernel arguments)``."""
    import torch

    from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice as cl
    from tf_seq2seq_losses_tpu_torch.ops import cuda_simplified as cs
    from tf_seq2seq_losses_tpu_torch.ops import log_lattice as ll

    dev = ctx.logproba.device
    blank, dg, _lm, lens, lab_len, k_win = cs.simplified_kernel_inputs(ctx)
    tpad = dg.shape[1]
    valid_t = (torch.arange(tpad, device=dev)[None, :] < lens[:, None])
    errs = {}

    def pick(f, fe):
        return cl.pick_loss(f, fe, lab_len)

    loss_k = pick(*cs.simplified_fwd(blank, dg, lens, k_win, "final"))
    loss_p = pick(*cs.simplified_fwd_plain(blank, dg, lens, k_win, "final"))
    agree(loss_k, loss_p, 1e-5, 0.0, "simplified_fwd[final] loss vs plain")
    errs["simplified_fwd[final]"] = max_err(loss_k, loss_p)

    r_k = cs.simplified_fwd(blank, dg, lens, k_win, "resid")
    r_p = cs.simplified_fwd_plain(blank, dg, lens, k_win, "resid")
    rl_k, rl_p = pick(*r_k[2:]), pick(*r_p[2:])
    agree(rl_k, rl_p, 1e-5, 0.0, "simplified_fwd[resid] loss vs plain")
    agree(r_k[0][valid_t], r_p[0][valid_t], 1e-5, 1e-6,
          "simplified_fwd[resid] residual mantissas vs plain")
    errs["simplified_fwd[resid]"] = max(max_err(rl_k, rl_p),
                                        max_err(r_k[0][valid_t], r_p[0][valid_t]))

    ebi = cl.ebi_from_loss(rl_k)
    b_args = (blank, dg, lens, lab_len, ebi, r_k[0], r_k[1], k_win)
    b_k = cs.simplified_bwd_streamed(*b_args)
    b_p = cs.simplified_bwd_streamed_plain(*b_args)

    def beta_loss(b):
        return -(torch.log(b[1][:, 0]) + b[2][:, 0].float() * cl.LN2)

    agree(beta_loss(b_k), beta_loss(b_p), 1e-5, 0.0,
          "simplified_bwd_streamed beta carry vs plain")
    agree(b_k[0], b_p[0], 0.0, 1e-5, "simplified_bwd_streamed pd vs plain")
    errs["simplified_bwd_streamed"] = max(max_err(b_k[0], b_p[0]),
                                          max_err(beta_loss(b_k), beta_loss(b_p)))

    blank_l, dg_l, _lm, _, _ = ll.simplified_log_inputs(ctx)

    def log_pick(f):
        return ll._pick_single_log_loss(f, lab_len)

    lfl_k = log_pick(ll.simplified_log_fwd(blank_l, dg_l, lens, "final"))
    lfl_p = log_pick(ll.simplified_log_fwd_plain(blank_l, dg_l, lens, "final"))
    agree(lfl_k, lfl_p, 1e-5, 0.0, "simplified_log_fwd[final] loss vs plain")
    errs["simplified_log_fwd[final]"] = max_err(lfl_k, lfl_p)

    lr_k = ll.simplified_log_fwd(blank_l, dg_l, lens, "resid")
    lr_p = ll.simplified_log_fwd_plain(blank_l, dg_l, lens, "resid")
    lrl_k, lrl_p = log_pick(lr_k[1]), log_pick(lr_p[1])
    agree(lrl_k, lrl_p, 1e-5, 0.0, "simplified_log_fwd[resid] loss vs plain")
    agree(lr_k[0][valid_t], lr_p[0][valid_t], 1e-5, 1e-5,
          "simplified_log_fwd[resid] residual alpha vs plain")
    errs["simplified_log_fwd[resid]"] = max(max_err(lrl_k, lrl_p),
                                            max_err(lr_k[0][valid_t], lr_p[0][valid_t]))

    safe = torch.where(torch.isfinite(lrl_k), lrl_k, torch.zeros_like(lrl_k))
    lb_args = (blank_l, dg_l, lens, lab_len, safe, lr_k[0])
    lb_k = ll.simplified_log_bwd(*lb_args)
    lb_p = ll.simplified_log_bwd_plain(*lb_args)
    agree(lb_k[0], lb_p[0], 0.0, 1e-5, "simplified_log_bwd pd vs plain")
    agree(lb_k[1][:, 0], lb_p[1][:, 0], 1e-5, 0.0, "simplified_log_bwd beta0 vs plain")
    errs["simplified_log_bwd"] = max(max_err(lb_k[0], lb_p[0]),
                                     max_err(lb_k[1][:, 0], lb_p[1][:, 0]))
    args = dict(fwd=(blank, dg, lens, k_win), bwd=b_args,
                log_fwd=(blank_l, dg_l, lens), log_bwd=lb_args)
    return errs, args


def kernel_counters() -> dict:
    """``{path: {kernel name: (wrapper, mode or None)}}``: the launch counts
    that each main path must move."""
    from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice as cl
    from tf_seq2seq_losses_tpu_torch.ops import cuda_simplified as cs
    from tf_seq2seq_losses_tpu_torch.ops import log_lattice as ll

    return {
        "classic": {
            "classic_fwd[final]": (cl.classic_fwd, "final"),
            "classic_fwd[resid]": (cl.classic_fwd, "resid"),
            "classic_bwd_streamed": (cl.classic_bwd_streamed, None),
            "classic_log_fwd[final]": (ll.classic_log_fwd, "final"),
            "classic_log_fwd[resid]": (ll.classic_log_fwd, "resid"),
            "classic_log_bwd": (ll.classic_log_bwd, None),
        },
        "simplified": {
            "simplified_fwd[final]": (cs.simplified_fwd, "final"),
            "simplified_fwd[resid]": (cs.simplified_fwd, "resid"),
            "simplified_bwd_streamed": (cs.simplified_bwd_streamed, None),
            "simplified_log_fwd[final]": (ll.simplified_log_fwd, "final"),
            "simplified_log_fwd[resid]": (ll.simplified_log_fwd, "resid"),
            "simplified_log_bwd": (ll.simplified_log_bwd, None),
        },
    }


def reset_launches() -> None:
    for path in kernel_counters().values():
        for fn, _mode in path.values():
            fn.launches = 0
            if hasattr(fn, "mode_launches"):
                fn.mode_launches = {m: 0 for m in fn.mode_launches}


def read_launches(path: str) -> dict:
    return {name: fn.launches if mode is None else fn.mode_launches[mode]
            for name, (fn, mode) in kernel_counters()[path].items()}


def drive_main_path(torch, dev, topology, inputs, ctx, sync):
    """Phases 3 and 4 for one topology: its loss through the public API,
    training step and evaluation call, then the saturated batch through the
    guard.  The launch counts are set to 0 just before and read just after;
    returns the launches, the step function and the batches for timing."""
    import tf_seq2seq_losses_tpu_torch as ctc
    from tf_seq2seq_losses_tpu_torch.ops.topology import TOPOLOGIES
    from tf_seq2seq_losses_tpu_torch.utils.config import config_override

    loss_fn = {"classic": ctc.classic_ctc_loss,
               "simplified": ctc.simplified_ctc_loss}[topology]
    labels, logits, label_length, logit_length = inputs
    names = list(kernel_counters()[topology])
    fwd_final, fwd_resid, bwd, log_final, log_resid, log_bwd = names

    def train_step(x, ll_, gl_):
        x = x.detach().requires_grad_(True)
        loss = loss_fn(labels, x, ll_, gl_, 0)
        torch.where(torch.isfinite(loss), loss, torch.zeros_like(loss)).sum().backward()
        return loss.detach(), x.grad

    def launches_since(before):
        now = read_launches(topology)
        return {k: n - before[k] for k, n in now.items() if n > before[k]}

    # ---- 3. the main path --------------------------------------------------
    reset_launches()
    per_step = {}
    mark = read_launches(topology)
    loss, d_logits = train_step(logits, label_length, logit_length)
    per_step["training step"] = launches_since(mark)
    mark = read_launches(topology)
    with torch.no_grad():
        loss_eval = loss_fn(labels, logits, label_length, logit_length, 0)
    per_step["evaluation call"] = launches_since(mark)
    sync()
    feasible = TOPOLOGIES[topology].feasible(ctx)
    check(bool(torch.isfinite(loss[feasible]).all()), "finite loss on feasible rows")
    check(bool(torch.isposinf(loss[~feasible]).all()) and int((~feasible).sum()) >= 2,
          "+inf loss on infeasible rows")
    check(bool((d_logits[~feasible] == 0).all()), "zero d_logits on infeasible rows")
    check(torch.equal(loss, loss_eval), "forward-only loss equals the training loss")
    with config_override(use_kernels=False):
        loss_pure, d_pure = train_step(logits, label_length, logit_length)
    loss64, d64 = pure_float64(labels, logits, label_length, logit_length, topology)
    agree(loss, loss64, 1e-5, 0.0, f"{topology} loss vs the float64 pure path on the card")
    agree(d_logits, d64, 0.0, 1e-5,
          f"{topology} d_logits vs the float64 pure path on the card")
    launches = read_launches(topology)
    for name in (fwd_resid, fwd_final, bwd):
        check(launches[name] >= 1, f"{name} launched")
    log(f"phase 3 {topology} main path (TF32 on): ok, loss mean "
        f"{float(loss[feasible].mean()):.4f}; max abs err vs the float64 pure path: "
        f"kernel path loss {max_err(loss, loss64):.3g} d_logits "
        f"{max_err(d_logits, d64):.3g}, float32 pure path loss "
        f"{max_err(loss_pure, loss64):.3g} d_logits {max_err(d_pure, d64):.3g}")

    # ---- 4. the saturation guard ------------------------------------------
    s_logits, s_ll, s_gl = saturate(torch, labels, logits, label_length, logit_length)
    mark = read_launches(topology)
    s_loss, s_d = train_step(s_logits, s_ll, s_gl)
    per_step["step with 4 rows repaired"] = launches_since(mark)
    sync()
    for name in (log_final, log_resid, log_bwd):
        check(name in per_step["step with 4 rows repaired"], f"guard launched {name}")
    with config_override(use_kernels=False):
        p_loss, p_d = train_step(s_logits, s_ll, s_gl)
    rows = [2, 3]
    agree(s_loss[rows], p_loss[rows], 0.0, 2e-4,
          f"{topology} repaired loss vs pure (1e2 rows)")
    agree(s_d[rows], p_d[rows], 0.0, 2e-4,
          f"{topology} repaired d_logits vs pure (1e2 rows)")
    big = [4, 5]
    check(bool(torch.isfinite(s_loss[big]).all()), "finite loss at logits 1e10")
    check(bool(torch.isfinite(s_d[big]).all()), "finite d_logits at logits 1e10")
    agree(s_loss[big], p_loss[big], 1e-6, 0.0,
          f"{topology} repaired loss vs pure (1e10 rows)")
    _, s_d64 = pure_float64(labels, s_logits, s_ll, s_gl, topology)
    clean = torch.ones(len(loss), dtype=torch.bool, device=dev)
    clean[2:6] = False
    check(torch.equal(s_loss[clean], loss[clean]), "clean rows' loss bit for bit")
    check(torch.equal(s_d[clean], d_logits[clean]), "clean rows' d_logits bit for bit")
    launches = read_launches(topology)
    for name, n in launches.items():
        check(n >= 1, f"{name} launched on the {topology} main path")
    log(f"phase 4 {topology} guard: ok, repaired rows 2-5, losses "
        f"{[round(float(v), 4) for v in s_loss[2:6]]}, max abs err vs pure "
        f"loss {max_err(s_loss[rows], p_loss[rows]):.3g} "
        f"d_logits {max_err(s_d[rows], p_d[rows]):.3g}; rows 4-5 d_logits not "
        f"compared: float32 pure vs float64 {max_err(p_d[big], s_d64[big]):.3g} there; "
        f"launches per call {json.dumps(per_step)}")
    return dict(launches=launches, train_step=train_step, loss_fn=loss_fn,
                saturated=(s_logits, s_ll, s_gl))


def run(seed: int, dev) -> dict:
    import numpy as np
    import torch

    import tf_seq2seq_losses_tpu_torch as ctc
    from tf_seq2seq_losses_tpu_torch.ops import _build, core
    from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice as cl
    from tf_seq2seq_losses_tpu_torch.ops import cuda_simplified as cs
    from tf_seq2seq_losses_tpu_torch.ops import log_lattice as ll
    from tf_seq2seq_losses_tpu_torch.utils.config import config_override
    from tf_seq2seq_losses_tpu_torch.utils.numerics import logit_to_logproba

    card = card_line()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    # ---- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    log(f"phase 1 build: {time.perf_counter() - t0:.1f} s for "
        f"{len(_build._SOURCES)} libraries from tf_seq2seq_losses_tpu_torch/csrc")

    inputs = make_inputs(torch, seed, dev)
    labels, logits, label_length, logit_length = inputs

    # ---- 2. every kernel against its plain version ------------------------
    ctx = core.make_context(
        labels, logit_to_logproba(logits, 2), label_length, logit_length, 0
    )

    def compare_all(c):
        errs_c, args_c = compare_kernels(c)
        errs_s, args_s = compare_simplified_kernels(c)
        return {**errs_c, **errs_s}, args_c, args_s

    errs, kargs, sargs = compare_all(ctx)
    # other geometries at batch 8: two lanes per thread (labels [8, 600]),
    # windows 1 and 16, blank index 3 with labels over {1, 2} (many repeats)
    small = make_inputs(torch, seed + 1, dev, batch=8)
    extra = {}
    wide = make_inputs(torch, seed + 2, dev, batch=8, label_width=600)
    extra["labels [8, 600]"] = compare_all(
        core.make_context(wide[0], logit_to_logproba(wide[1], 2), *wide[2:], 0))[0]
    small_ctx = core.make_context(small[0], logit_to_logproba(small[1], 2), *small[2:], 0)
    for window in (1, 16):
        with config_override(window=window):
            extra[f"window {window}"] = compare_all(small_ctx)[0]
    rep_labels = 1 + small[0] % 2
    extra["blank 3, labels over {1, 2}"] = compare_all(core.make_context(
        rep_labels, logit_to_logproba(small[1], 2), *small[2:], 3))[0]
    sync()
    worst = {name: float(f"{max(e.values()):.3g}") for name, e in extra.items()}
    log("phase 2 kernel vs plain on the card: ok, max abs err at the headline "
        "shape " + json.dumps({k: float(f"{v:.3g}") for k, v in errs.items()})
        + "; worst over the kernels at batch 8: " + json.dumps(worst))

    # ---- 3 and 4. each main path, then the guard ---------------------------
    # TF32 on, as an H100 training script sets it: the act scatter must not
    # depend on it
    torch.set_float32_matmul_precision("high")
    paths = {name: drive_main_path(torch, dev, name, inputs, ctx, sync)
             for name in ("classic", "simplified")}
    launches = {**paths["classic"]["launches"], **paths["simplified"]["launches"]}

    # ---- 5. oracles ----------------------------------------------------------
    o_labels = torch.tensor([[1, 2, 2, 1], [1, 2, 1, 0]], device=dev)
    o_logits = torch.zeros((2, 5, 3), device=dev, requires_grad=True)
    o_loss = ctc.classic_ctc_loss(o_labels, o_logits, torch.tensor([4, 3], device=dev),
                                  torch.tensor([5, 4], device=dev), 0)
    o_loss.sum().backward()
    agree(o_loss.detach().cpu(), torch.tensor([5.4931, 2.4485]), 0.0, 1e-3,
          "README oracle loss")
    agree(o_logits.grad[0, 0].cpu(), torch.tensor([1 / 3, -2 / 3, 1 / 3]), 0.0, 1e-3,
          "README oracle grad")
    # the same example from numpy arrays: the values go to the card
    n_loss = ctc.classic_ctc_loss(np.array([[1, 2, 2, 1], [1, 2, 1, 0]]),
                                  np.zeros((2, 5, 3), np.float32), np.array([4, 3]),
                                  np.array([5, 4]), 0)
    check(n_loss.device == dev, f"numpy logits computed on {n_loss.device}, not {dev}")
    agree(n_loss.cpu(), o_loss.detach().cpu(), 0.0, 0.0, "README oracle from numpy")
    # simplified: three paths (_12, 1_2, 12_) of probability 1/27 each
    s_loss = ctc.simplified_ctc_loss(torch.tensor([[1, 2]], device=dev),
                                     torch.zeros((1, 3, 3), device=dev),
                                     torch.tensor([2], device=dev),
                                     torch.tensor([3], device=dev), 0)
    agree(s_loss.cpu(), torch.tensor([float(np.log(9.0))]), 0.0, 1e-3,
          "simplified oracle loss ln 9")
    log(f"phase 5 oracles: ok, README loss {[round(v, 4) for v in o_loss.tolist()]} "
        f"(also from numpy, on {n_loss.device}); simplified [[1, 2]] over 3 "
        f"frames {round(float(s_loss[0]), 4)} (ln 9 = 2.1972)")

    # ---- 6. timing -----------------------------------------------------------
    # Bytes and operations that this run's data needs, counted per sample:
    # len_b steps over the label_length_b + 1 lanes of its lattice (lanes
    # above it never reach the loss, mass only flows upward).  The kernels
    # read every padded lane of every step they run: the distance between
    # their time and this bound includes that.
    batch = kargs["shape"][0]
    lens, k_win = kargs["lens"].double(), kargs["k_win"]
    lanes_b = label_length.double() + 1
    steps = float(lens.sum())  # blank-row reads
    cells = float((lens * lanes_b).sum())  # one [T, L] stream
    wcells = float((torch.ceil(lens / k_win) * lanes_b).sum())  # frames
    lanes = float(lanes_b.sum())  # one [L] mask or carry
    fwd_final_b = 4 * (cells + steps + 3 * lanes + batch + 3 * lanes)
    fwd_resid_b = fwd_final_b + 4 * (2 * cells + wcells)
    bwd_b = 4 * (cells + steps + 3 * lanes + 3 * batch + 2 * cells + wcells
                 + cells + 3 * lanes)
    logf_final_b = 4 * (2 * cells + steps + 2 * lanes + batch + 2 * lanes)
    logf_resid_b = logf_final_b + 4 * 2 * cells
    logb_b = 4 * (2 * cells + steps + 2 * lanes + 3 * batch + 2 * cells
                  + cells + 2 * lanes)
    # simplified: one transition stream, one residual stream, no lane masks
    sfwd_final_b = 4 * (cells + steps + batch + 2 * lanes)
    sfwd_resid_b = sfwd_final_b + 4 * (cells + wcells)
    sbwd_b = 4 * (steps + 3 * cells + wcells + 3 * batch + 2 * lanes)
    slogf_final_b = 4 * (cells + steps + batch + lanes)
    slogf_resid_b = slogf_final_b + 4 * cells
    slogb_b = 4 * (steps + 3 * cells + 3 * batch + lanes)
    lib_lp = logit_to_logproba(logits, 2).transpose(0, 1).contiguous()
    lib_targets = labels.long()

    def library_fwd():
        torch.nn.functional.ctc_loss(
            lib_lp, lib_targets, logit_length.long(), label_length.long(),
            blank=0, reduction="none", zero_infinity=False,
        )

    with torch.no_grad():
        lib_fwd_ms = time_ms(torch, library_fwd, runs=RUNS, burst=1)
    fwd, bwd, logf, logb = (kargs[k] for k in ("fwd", "bwd", "log_fwd", "log_bwd"))
    sfwd, sbwd, slogf, slogb = (sargs[k] for k in ("fwd", "bwd", "log_fwd", "log_bwd"))
    pl = "tf_seq2seq_losses_tpu/ops/pallas_lattice.py"
    lg = "tf_seq2seq_losses_tpu/ops/log_lattice.py"
    table = {
        "classic_fwd[final]": (
            lambda: cl.classic_fwd(*fwd, "final"),
            lambda: cl.classic_fwd_plain(*fwd, "final"),
            fwd_final_b, 11 * cells, "csrc/classic_fwd.cu", f"{pl}:579", lib_fwd_ms),
        "classic_fwd[resid]": (
            lambda: cl.classic_fwd(*fwd, "resid"),
            lambda: cl.classic_fwd_plain(*fwd, "resid"),
            fwd_resid_b, 11 * cells, "csrc/classic_fwd.cu", f"{pl}:579", None),
        "classic_bwd_streamed": (
            lambda: cl.classic_bwd_streamed(*bwd),
            lambda: cl.classic_bwd_streamed_plain(*bwd),
            bwd_b, 24 * cells, "csrc/classic_bwd.cu", f"{pl}:1123", None),
        "classic_log_fwd[final]": (
            lambda: ll.classic_log_fwd(*logf, "final"),
            lambda: ll.classic_log_fwd_plain(*logf, "final"),
            logf_final_b, 16 * cells, "csrc/classic_log.cu", f"{lg}:152", lib_fwd_ms),
        "classic_log_fwd[resid]": (
            lambda: ll.classic_log_fwd(*logf, "resid"),
            lambda: ll.classic_log_fwd_plain(*logf, "resid"),
            logf_resid_b, 16 * cells, "csrc/classic_log.cu", f"{lg}:152", None),
        "classic_log_bwd": (
            lambda: ll.classic_log_bwd(*logb),
            lambda: ll.classic_log_bwd_plain(*logb),
            logb_b, 30 * cells, "csrc/classic_log.cu", f"{lg}:267", None),
        # no PyTorch call computes the simplified loss: library_ms is null
        "simplified_fwd[final]": (
            lambda: cs.simplified_fwd(*sfwd, "final"),
            lambda: cs.simplified_fwd_plain(*sfwd, "final"),
            sfwd_final_b, 4 * cells, "csrc/simplified_fwd.cu", f"{pl}:1720", None),
        "simplified_fwd[resid]": (
            lambda: cs.simplified_fwd(*sfwd, "resid"),
            lambda: cs.simplified_fwd_plain(*sfwd, "resid"),
            sfwd_resid_b, 4 * cells, "csrc/simplified_fwd.cu", f"{pl}:1720", None),
        "simplified_bwd_streamed": (
            lambda: cs.simplified_bwd_streamed(*sbwd),
            lambda: cs.simplified_bwd_streamed_plain(*sbwd),
            sbwd_b, 8 * cells, "csrc/simplified_bwd.cu", f"{pl}:2073", None),
        "simplified_log_fwd[final]": (
            lambda: ll.simplified_log_fwd(*slogf, "final"),
            lambda: ll.simplified_log_fwd_plain(*slogf, "final"),
            slogf_final_b, 8 * cells, "csrc/simplified_log.cu", f"{lg}:462", None),
        "simplified_log_fwd[resid]": (
            lambda: ll.simplified_log_fwd(*slogf, "resid"),
            lambda: ll.simplified_log_fwd_plain(*slogf, "resid"),
            slogf_resid_b, 8 * cells, "csrc/simplified_log.cu", f"{lg}:462", None),
        "simplified_log_bwd": (
            lambda: ll.simplified_log_bwd(*slogb),
            lambda: ll.simplified_log_bwd_plain(*slogb),
            slogb_b, 12 * cells, "csrc/simplified_log.cu", f"{lg}:575", None),
    }
    kernels = []
    for name, (kern, plain, nbytes, ops, src, replaces, lib_ms) in table.items():
        ms = time_ms(torch, kern)
        plain_ms = time_ms(torch, plain, runs=PLAIN_RUNS, burst=1)
        b_ms, b_by = bound(nbytes, ops)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "tf_seq2seq_losses_tpu_torch/" + src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        })

    steps_ms = {}
    for name, path in paths.items():
        step = path["train_step"]
        s_logits, s_ll, s_gl = path["saturated"]
        steps_ms[f"{name}_fwd_bwd_step"] = host_ms(
            torch, lambda: step(logits, label_length, logit_length))
        with config_override(guard=False):
            steps_ms[f"{name}_fwd_bwd_step_guard_off"] = host_ms(
                torch, lambda: step(logits, label_length, logit_length))
        steps_ms[f"{name}_fwd_bwd_step_4_rows_repaired"] = host_ms(
            torch, lambda: step(s_logits, s_ll, s_gl))
        with torch.no_grad():
            steps_ms[f"{name}_forward_only"] = host_ms(torch, lambda: path["loss_fn"](
                labels, logits, label_length, logit_length, 0))

    def library_step():
        x = lib_lp.detach().requires_grad_(True)
        torch.nn.functional.ctc_loss(
            x, lib_targets, logit_length.long(), label_length.long(),
            blank=0, reduction="none", zero_infinity=True,
        ).sum().backward()

    steps_ms["library_ctc_loss_fwd_bwd"] = host_ms(torch, library_step)
    steps_ms["library_ctc_loss_fwd"] = lib_fwd_ms
    log(f"phase 6 timing (ms, host clock, median of {RUNS}; F.ctc_loss forward by "
        f"CUDA events, median of {RUNS} calls; " + card + "): " + json.dumps(steps_ms))
    for name, path in paths.items():
        step = path["train_step"]
        log(f"phase 6 profile of the {name} fwd+bwd step: " + json.dumps(profile_step(
            torch, dev, steps_ms[f"{name}_fwd_bwd_step"],
            lambda: step(logits, label_length, logit_length))))
    return {"kernels": kernels, "card": card}


def profile_step(torch, dev, step_ms, step, steps=5) -> dict:
    """Device time per step by kernel (torch.profiler) and the device's idle
    share of the measured step time."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    step()
    with profile(activities=activities, acc_events=True) as prof:
        for _ in range(steps):
            step()
        if dev.type == "cuda":
            torch.cuda.synchronize()
    # kernel records only: an op's record repeats its kernels' device time
    rows = [(e.key, e.self_device_time_total / 1e3 / steps)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    busy = sum(ms for _, ms in rows)
    if not rows:
        return {"device_ms_per_step": "not measured: the profiler saw no device time"}
    return {
        "device_ms_per_step": busy,
        "device_idle_share": max(0.0, 1.0 - busy / step_ms) if step_ms else None,
        "top": [[name[:60], ms] for name, ms in rows[:10]],
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not (REPO / "tf_seq2seq_losses_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke.py: the package tf_seq2seq_losses_tpu_torch is not beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    try:
        result = run(args.seed, torch.device("cuda:0"))
    except CheckFailed as exc:
        print(f"chip_smoke.py: check failed: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": result["kernels"]}))
    print(result["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
