#!/usr/bin/env python3
"""Time the fused epilogue B12 (``fused_dlogits``) at ``time_scans.py``'s
headline case (V=128) in one process while what the process holds on the
card changes: fresh; with ``time_scans.py``'s headline scan cases built;
also holding the HVP's tangent-scan cases of the long-T row (a tree
without them holds 1.3 GB instead, about their size); and after those are
freed.  Each time: CUDA events, median of 5 bursts of 20, three times.

    python3 tf_seq2seq_losses_tpu_torch/tools/time_fused_state.py --tree DIR \\
        [--tag NAME]

Run it for two trees in turns (parent, change, change, parent) in one call
on one card to tell a kernel whose time moved from a time that follows the
memory its process holds.  Prints one JSON line: the tag, the card's name
and power limit, the ms of each state, and the GB allocated at the end.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", type=Path, required=True)
    parser.add_argument("--tag", default=None)
    args = parser.parse_args()
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        print("time_fused_state.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from tf_seq2seq_losses_tpu_torch.ops import _build
    from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice as cl
    from tf_seq2seq_losses_tpu_torch.tools import time_scans as ts

    _build.build_all()
    dev = torch.device("cuda:0")
    eargs = ts.fused_case(smoke, torch, dev, smoke.MAX_T)

    def times():
        return [smoke.time_ms(torch, lambda: cl.fused_dlogits(*eargs)) for _ in range(3)]

    out = {"tree": args.tag or tree.name, "card": smoke.card_line(), "fresh": times()}
    cases = ts.scan_cases(smoke, torch, dev, smoke.MAX_T, 0)
    out["with_headline_cases"] = times()
    if hasattr(ts, "hvp_case"):
        ctx, vector = ts.hvp_case(smoke, torch, dev, "hvp_long_t_row")
        held = ts.jvp64_cases(smoke, ctx, vector)
        for case in held.values():
            ts.digest(torch, case)
    else:
        held = torch.ones(int(1.3e9) // 8, dtype=torch.float64, device=dev)
    out["holding_tangent_cases_or_1_3_gb"] = times()
    del held, cases
    torch.cuda.empty_cache()
    out["freed"] = times()
    out["allocated_gb"] = torch.cuda.memory_allocated() / 1e9
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
