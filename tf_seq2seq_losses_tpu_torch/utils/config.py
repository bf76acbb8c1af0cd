"""Kernel configuration of the PyTorch port.

Only the knobs that the port honours are fields here, at the JAX package's
defaults.  Knobs whose code path is not ported yet are accepted by
:func:`config_from_reference` at their default value only, and raise
``NotImplementedError`` naming their ROADMAP item otherwise.
"""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Knobs of the CTC kernel path (classic and simplified topologies).

    ``use_kernels``: None = auto (the CUDA kernels for CUDA tensors, the
    pure log-space path for CPU tensors); True forces the kernel path
    (on a CPU tensor it runs the kernels' plain PyTorch versions); False
    forces the pure path.
    ``window``: frozen-frame window length of the block-float scans; the
    set of rows that flush depends on it.
    ``chunk_time``: the longest chunk of the (window-padded) time axis that
    one kernel launch scans; a longer axis runs in equal chunks, each a
    whole number of windows, chaining the lattice carry from chunk to chunk.
    ``stream_residuals``: the training forward streams per-step alpha
    residuals ``[B, T, L]`` for the backward (single-chunk geometry only,
    and only where the streamed kernels' shared memory holds the label's
    lanes); otherwise the backward re-expands alpha from per-window
    boundary carries (the residual-free scheme).
    ``half_stream``: the classic topology's streamed one-chunk scheme
    keeps only the open-state mantissas ``a1`` per step, with the closed
    state ``a0`` at each window's first step; the backward rebuilds ``a0``
    with ``a0' = (a0 + a1) * blank``, as the forward computed it, so the
    gradient is the fully streamed one's bit for bit.  The simplified carry
    has one state and nothing to halve: it ignores this knob, as the
    residual-free and chunked schemes do.
    ``fused_epilogue``: on the streamed one-chunk scheme of either
    topology, the act scatter, the gradient assembly and the log-softmax
    cotangent run as one kernel that writes ``d_logits``.  The JAX gate's
    ``num_tokens % 128 == 0`` clause was a TPU lane rule; the CUDA kernel
    takes any vocabulary that its shared memory holds.
    ``guard``: recompute feasible rows whose fast loss flushed to +inf.
    ``repair_bucket2``: rows per exact repair round of the guard.
    ``log_fallback``: repair through the log-space kernels (else through
    the pure path).
    """

    use_kernels: Optional[bool] = None
    window: int = 8
    chunk_time: int = 512
    stream_residuals: bool = True
    half_stream: bool = False
    fused_epilogue: bool = False
    guard: bool = True
    repair_bucket2: int = 32
    log_fallback: bool = True

    def __post_init__(self):
        if self.use_kernels not in (None, True, False):
            raise ValueError(
                f"use_kernels must be None, True or False, got {self.use_kernels!r}"
            )
        for name in ("stream_residuals", "half_stream", "fused_epilogue", "guard",
                     "log_fallback"):
            if not isinstance(getattr(self, name), bool):
                raise ValueError(
                    f"{name} must be a bool, got {getattr(self, name)!r}"
                )
        for name, lo in (("window", 1), ("chunk_time", 1), ("repair_bucket2", 1)):
            val = getattr(self, name)
            if isinstance(val, bool) or not isinstance(val, int) or val < lo:
                raise ValueError(f"{name} must be an int >= {lo}, got {val!r}")

    def kernels_enabled(self, device: torch.device) -> bool:
        if self.use_kernels is not None:
            return self.use_kernels
        return device.type == "cuda"


# Knobs of the JAX KernelConfig whose code paths the port does not have yet:
# field -> (the default this port implements, ROADMAP item).
_UNPORTED = {
    "guard_struct": ("while", "A7 (cond-lattice guard structure)"),
}

# TPU-only geometry and lowering knobs, dropped by config_from_reference.
_DROPPED = (
    "use_pallas",
    "interpret",
    "unroll",
    "block_batch",
    "block_time",
    "vmem_budget_mb",
    "vmem_limit_mb",
    "sort_by_length",
    "fold_pt",
    "guard_tier1",
    "guard_mode",
    "repair_bucket",
)

_ENUMS = {"guard_struct": ("cond", "while"), "guard_mode": ("grad", "post", "pre")}


def _check_unported(fields: dict) -> None:
    for name, allowed in _ENUMS.items():
        if name in fields and fields[name] not in allowed:
            raise ValueError(
                f"unknown {name} {fields[name]!r}; expected one of {list(allowed)}"
            )
    for name, (default, item) in _UNPORTED.items():
        if name in fields and fields[name] != default:
            raise NotImplementedError(
                f"{name}={fields[name]!r} is not ported yet (ROADMAP {item}); "
                f"the port implements {name}={default!r}"
            )


def config_from_reference(fields: dict) -> KernelConfig:
    """The port's config for ``dataclasses.asdict()`` of a JAX ``KernelConfig``.

    The loss has no learned parameters; its behaviour is fixed by this
    config, so carrying it across is what reproduces the reference run.

    Mapped: ``window``, ``chunk_time``, ``stream_residuals``,
    ``half_stream``, ``fused_epilogue``, ``guard``, ``repair_bucket2`` and
    ``log_fallback``; ``use_pallas`` is dropped,
    since the port picks its path from the tensor's device (see
    ``KernelConfig.use_kernels``).

    Dropped (TPU geometry and lowering, same values either way):
    ``interpret``, ``unroll``, ``block_batch``, ``block_time``,
    ``vmem_budget_mb``, ``vmem_limit_mb``, ``sort_by_length``, ``fold_pt``
    (the CUDA kernels always take the folded transition stream),
    ``guard_tier1``, ``guard_mode`` and ``repair_bucket`` (the port's guard
    always repairs every flushed row in rounds of ``repair_bucket2``).

    Raises ``NotImplementedError`` for an unported knob off its default
    (``guard_struct="cond"``) and ``ValueError`` for an unknown field or
    enum value.
    """
    known = set(_UNPORTED) | set(_DROPPED) | {
        f.name for f in dataclasses.fields(KernelConfig) if f.name != "use_kernels"
    }
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"unknown KernelConfig fields {unknown}")
    _check_unported(fields)
    kw = {
        name: fields[name]
        for name in ("window", "chunk_time", "stream_residuals", "half_stream",
                     "fused_epilogue", "guard", "repair_bucket2", "log_fallback")
        if name in fields
    }
    return KernelConfig(**kw)


_CONFIG = KernelConfig()


def get_config() -> KernelConfig:
    return _CONFIG


@contextmanager
def config_override(**kwargs):
    """Temporarily override config fields (tests and measurements).

    Unported knobs of the JAX config may be named too: at their default
    they are accepted and ignored, otherwise they raise.
    """
    global _CONFIG
    _check_unported(kwargs)
    own = {k: v for k, v in kwargs.items() if k not in _UNPORTED}
    old = _CONFIG
    _CONFIG = dataclasses.replace(old, **own)
    try:
        yield _CONFIG
    finally:
        _CONFIG = old
