"""Tracing and timing helpers.

Counterpart of ``tf_seq2seq_losses_tpu/utils/profiling.py``:

* :func:`annotate` names the enclosed work in a ``torch.profiler`` trace
  (``record_function``) and, on a machine with a CUDA device, in an NVTX
  range, so a span shows up in both host and device timelines;
* :func:`trace_to` captures a ``torch.profiler`` trace of the enclosed
  block into a directory (a Chrome trace file);
* :func:`block_ms` is the wall clock of a thunk with a device synchronize
  before the clock starts and before it stops.  It times the host's view of
  a call; device time alone comes from CUDA events or a profile.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch


def _synchronize() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def annotate(name: str):
    """Name the enclosed work in profiler traces (and NVTX, with CUDA)."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Profile the enclosed block (host, and the device when there is one)
    and write a Chrome trace file into ``log_dir``; yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        _synchronize()
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def block_ms(fn: Callable[[], object], iters: int = 1) -> float:
    """Wall-clock milliseconds per call of ``fn`` after one warm-up call,
    with a device synchronize before the clock starts and stops."""
    fn()
    _synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _synchronize()
    return (time.perf_counter() - t0) / iters * 1e3
