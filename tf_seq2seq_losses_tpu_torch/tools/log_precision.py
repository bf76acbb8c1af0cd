#!/usr/bin/env python3
"""How far the classic log-space repair scans (B4 mode resid, then B5) are
from float64, by the length of the row they repair.

    python3 tf_seq2seq_losses_tpu_torch/tools/log_precision.py [--seed 0] \\
        [--device cpu]

For each ``(T, label_length)`` of ``ROWS``: one row at V=32, labels uniform
over the non-blank tokens, N(0, 1) logits, ``logit_length`` T.  Its loss
and its gradient with respect to the log-probabilities go through the plain
versions of B4 mode resid and B5 (which the kernels match on the card:
``chip_smoke.py`` phase 2) and the guard's own assembly of the exact
gradient (``log_lattice._gradient_log_from_acts``), at any lane width and
time axis, and are held against the classic pure path in float64 on the
same float32 log-probabilities.  Prints one JSON line: each row's largest
absolute gradient error and relative loss error.

The carries are log-probabilities of the order of the loss (about 2 nats a
frame here); float32 rounds a carry near 1e4 to about 1e-3, so the error
grows with T.  The guard repairs a row this way only where its time axis is
one chunk and its label at most ``CLASSIC_LOG_LANES`` lanes wide; otherwise
it uses the pure path in float64.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROWS = ((495, 247), (3995, 1997))  # (T, label_length): the headline's longest, long T's
VOCAB = 32


def row_error(torch, seed: int, num_t: int, label_length: int, dev) -> dict:
    """Errors of the float32 log-space repair of one random row against the
    float64 pure path."""
    import numpy as np

    from tf_seq2seq_losses_tpu_torch.ops import core
    from tf_seq2seq_losses_tpu_torch.ops import log_lattice as ll
    from tf_seq2seq_losses_tpu_torch.ops.topology import TOPOLOGIES
    from tf_seq2seq_losses_tpu_torch.utils.numerics import logit_to_logproba

    rng = np.random.RandomState(seed)
    labels = torch.as_tensor(rng.randint(1, VOCAB, (1, label_length)).astype(np.int32),
                             device=dev)
    logits = torch.as_tensor(rng.randn(1, num_t, VOCAB).astype(np.float32), device=dev)
    lengths = (torch.tensor([label_length], device=dev), torch.tensor([num_t], device=dev))
    ctx = core.make_context(labels, logit_to_logproba(logits, 2), *lengths, 0)

    blank_l, dc_l, pt_l, lm, nb, rep, lens, lab_len = ll._log_inputs(ctx)
    sx, sa1, f0, f1 = ll.classic_log_fwd_plain(blank_l, dc_l, pt_l, nb, rep, lens,
                                               "resid")
    loss = ll._pick_log_loss(f0, f1, lab_len)
    pc = ll.classic_log_bwd_plain(blank_l, dc_l, pt_l, nb, rep, lens, lab_len,
                                  ll._safe_loss(loss), sx, sa1)[0]
    grad = -torch.exp(ll._gradient_log_from_acts(ctx, pc, lm, loss))

    c64 = core.float64_context(ctx)
    classic = TOPOLOGIES["classic"]
    loss64 = classic.loss(c64, classic.alpha(c64))
    grad64 = -torch.exp(core.gradient_log(classic, c64, loss64))
    return {"T": num_t, "label_length": label_length,
            "lanes": ll.geometry(ctx)[1], "loss64": float(loss64[0]),
            "grad_max_abs_err": float((grad.double() - grad64).abs().max()),
            "loss_rel_err": float(abs(loss.double()[0] - loss64[0]) / loss64[0])}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cpu")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch

    dev = torch.device(args.device)
    rows = [row_error(torch, args.seed, t, u, dev) for t, u in ROWS]
    print(json.dumps({"device": str(dev), "seed": args.seed, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
