#!/usr/bin/env python3
"""Compile the classic long-T training step with inductor on one NVIDIA card
and print where the compile's time goes.

    python3 tf_seq2seq_losses_tpu_torch/tools/compile_long_t.py

The step is ``chip_smoke.py``'s long-T step (``make_inputs(max_t=LONG_T,
infeasible=False)``: B=256, T=4000, labels [256, 2000], 8 chunks): the
classic loss and its finite sum under ``torch.compile(fullgraph=True,
dynamic=False)`` (inductor's default mode, its cache in a new temporary
directory), then ``.backward()``.  Prints one JSON line: the card's name
and power limit, the eager step's seconds, the compiled step's first call
(the compile included) and second call on the host clock, the peak device
memory, and the slowest of Dynamo's compile-time counters
(``torch._dynamo.utils.compilation_time_metrics``, seconds summed).  ``chip_smoke.py`` phase 13 runs
this step with ``backend="aot_eager"`` instead (``LONG_T_BACKEND``).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from pathlib import Path


def main() -> int:
    repo = Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(repo))
    import torch

    if not torch.cuda.is_available():
        print("compile_long_t.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from tf_seq2seq_losses_tpu_torch.ops import _build

    with tempfile.TemporaryDirectory() as cache:
        os.environ["TORCHINDUCTOR_CACHE_DIR"] = cache
        _build.build_all()
        torch.set_float32_matmul_precision("high")
        dev = torch.device("cuda:0")
        inputs = cs.make_inputs(torch, 0, dev, max_t=cs.LONG_T, infeasible=False)
        step = cs.loss_and_total(cs.loss_function("classic"), inputs[0])
        compiled = torch.compile(step, fullgraph=True, dynamic=False)
        seconds = {}
        for name, fn in (("eager", step), ("compiled_first", compiled),
                         ("compiled_second", compiled)):
            t0 = time.perf_counter()
            cs.run_step(fn, *inputs[1:])
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
        times = {name: sum(values) for name, values in
                 torch._dynamo.utils.compilation_time_metrics.items()}
        print(json.dumps({
            "card": cs.card_line(), "seconds": seconds,
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "slowest_compile_counters_s": dict(sorted(
                times.items(), key=lambda kv: -kv[1])[:12])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
