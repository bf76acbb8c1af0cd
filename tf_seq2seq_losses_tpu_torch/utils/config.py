"""Kernel configuration of the PyTorch port.

Every knob of the JAX package's ``KernelConfig`` whose behaviour the port
has is a field here, at the JAX package's default.  The TPU geometry and
lowering knobs (``_DROPPED``) have no counterpart on the card: they are
dropped by :func:`config_from_reference`, and :func:`config_override`
accepts and ignores them, so that code written for the JAX package's config
runs unchanged.

At import the defaults are read from the environment, as the JAX package
reads them (:func:`_env_default`): ``CTC_TPU_GUARD``,
``CTC_TPU_STREAM_RESIDUALS``, ``CTC_TPU_LOG_FALLBACK``,
``CTC_TPU_FUSED_EPILOGUE``, ``CTC_TPU_HALF_STREAM``, ``CTC_TPU_GUARD_MODE``,
``CTC_TPU_GUARD_STRUCT``, ``CTC_TPU_GUARD_TIER1``, ``CTC_TPU_WINDOW``,
``CTC_TPU_REPAIR_BUCKET``, ``CTC_TPU_REPAIR_BUCKET2`` and
``CTC_TPU_CHUNK_TIME``.  Ignored: the TPU-only ``CTC_TPU_PALLAS_INTERPRET``,
``CTC_TPU_UNROLL``, ``CTC_TPU_FOLD_PT``, ``CTC_TPU_SORT_BY_LENGTH``,
``CTC_TPU_BLOCK_BATCH``, ``CTC_TPU_BLOCK_TIME``, ``CTC_TPU_VMEM_BUDGET_MB``
and ``CTC_TPU_VMEM_LIMIT_MB``; and ``CTC_TPU_USE_PALLAS``, which does not
map to ``use_kernels``: it selects the TPU kernels, and the port picks its
path from the tensor's device, as :func:`config_from_reference` drops
``use_pallas`` (a JAX test setting of it would force the plain versions
onto every CPU tensor).  The saturation guard's fallback cap,
``CTC_TPU_GUARD_FALLBACK_BYTES``, is read at call time
(``ops/topology.py`` ``fallback_cap``), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
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
    ``repair_bucket``: up to this many flushed rows are repaired through
    the pure path (in float64) by ``guard_struct="cond"``, and by
    ``"while"`` with ``guard_tier1``; 0 disables that tier (the guard then
    reroutes the whole batch whenever a row flushed).
    ``repair_bucket2``: rows per exact repair round of the ``"while"``
    guard (at least ``repair_bucket``); under ``"cond"`` the most flushed
    rows that the log-space kernels repair as one gathered batch (tier 2;
    0 disables it) before the whole batch is rerouted.
    ``log_fallback``: repair through the log-space kernels (else through
    the pure path).
    ``guard_mode``: where the training step's guard sits.  ``"post"``
    guards the composed ``d_logits``; ``"pre"`` branches before the
    backward on the forward's flushed count (a clean step runs the
    unguarded backward); ``"grad"`` guards the gradient and composes the
    log-softmax cotangent after it.  They give the same ``d_logits``, but
    for a row that only the backward's scan-gap flag marks, which ``"pre"``
    after a clean forward leaves its fast gradient (``ops/topology.py``).
    ``guard_struct``: ``"while"`` repairs every flushed row in gathered
    rounds and keeps clean rows' fast values; ``"cond"`` is the JAX
    package's tiered lattice, whose tier 3 reroutes the whole batch, clean
    rows too, through the exact path.
    ``guard_tier1``: under ``"while"``, up to ``repair_bucket`` flushed rows
    go through the pure path instead of one log-space round.
    """

    use_kernels: Optional[bool] = None
    window: int = 8
    chunk_time: int = 512
    stream_residuals: bool = True
    half_stream: bool = False
    fused_epilogue: bool = False
    guard: bool = True
    repair_bucket: int = 16
    repair_bucket2: int = 32
    log_fallback: bool = True
    guard_mode: str = "post"
    guard_struct: str = "while"
    guard_tier1: bool = False

    def __post_init__(self):
        if self.use_kernels not in (None, True, False):
            raise ValueError(
                f"use_kernels must be None, True or False, got {self.use_kernels!r}"
            )
        for name in ("stream_residuals", "half_stream", "fused_epilogue", "guard",
                     "log_fallback", "guard_tier1"):
            if not isinstance(getattr(self, name), bool):
                raise ValueError(
                    f"{name} must be a bool, got {getattr(self, name)!r}"
                )
        for name, lo in (("window", 1), ("chunk_time", 1), ("repair_bucket", 0),
                         ("repair_bucket2", 0)):
            val = getattr(self, name)
            if isinstance(val, bool) or not isinstance(val, int) or val < lo:
                raise ValueError(f"{name} must be an int >= {lo}, got {val!r}")
        for name, allowed in _ENUMS.items():
            if getattr(self, name) not in allowed:
                raise ValueError(f"unknown {name} {getattr(self, name)!r}; "
                                 f"expected one of {list(allowed)}")

    def kernels_enabled(self, device: torch.device) -> bool:
        if self.use_kernels is not None:
            return self.use_kernels
        return device.type == "cuda"


_ENUMS = {"guard_mode": ("grad", "post", "pre"), "guard_struct": ("cond", "while")}

# TPU geometry and lowering knobs of the JAX KernelConfig: dropped by
# config_from_reference, accepted and ignored by config_override.
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
)

_FALSE = ("0", "false", "False")


def _env_default() -> KernelConfig:
    """The default config with the ``CTC_TPU_*`` variables of the fields
    that the port honours applied, each parsed as the JAX package's
    ``_env_default`` parses it: a value outside a variable's words leaves
    its field at the default."""
    env = os.environ.get
    kw = {}
    for field, name in (("guard", "CTC_TPU_GUARD"),
                        ("stream_residuals", "CTC_TPU_STREAM_RESIDUALS"),
                        ("log_fallback", "CTC_TPU_LOG_FALLBACK")):
        if env(name) in _FALSE:
            kw[field] = False
    for field, name in (("fused_epilogue", "CTC_TPU_FUSED_EPILOGUE"),
                        ("guard_tier1", "CTC_TPU_GUARD_TIER1")):
        if env(name) is not None:
            kw[field] = env(name) not in _FALSE
    if env("CTC_TPU_HALF_STREAM") in ("1", "true", "True"):
        kw["half_stream"] = True
    for field, name in (("guard_mode", "CTC_TPU_GUARD_MODE"),
                        ("guard_struct", "CTC_TPU_GUARD_STRUCT")):
        if env(name) in _ENUMS[field]:
            kw[field] = env(name)
    for field, name in (("window", "CTC_TPU_WINDOW"),
                        ("repair_bucket", "CTC_TPU_REPAIR_BUCKET"),
                        ("repair_bucket2", "CTC_TPU_REPAIR_BUCKET2"),
                        ("chunk_time", "CTC_TPU_CHUNK_TIME")):
        if env(name) is not None:
            kw[field] = int(env(name))
    return KernelConfig(**kw)


def config_from_reference(fields: dict) -> KernelConfig:
    """The port's config for ``dataclasses.asdict()`` of a JAX ``KernelConfig``.

    The loss has no learned parameters; its behaviour is fixed by this
    config, so carrying it across is what reproduces the reference run.

    Mapped: every field of the port but ``use_kernels``.  Dropped (TPU
    geometry and lowering, same values either way): ``use_pallas``, since
    the port picks its path from the tensor's device (see
    ``KernelConfig.use_kernels``), ``interpret``, ``unroll``,
    ``block_batch``, ``block_time``, ``vmem_budget_mb``, ``vmem_limit_mb``,
    ``sort_by_length`` and ``fold_pt`` (the CUDA kernels always take the
    folded transition stream).

    Raises ``ValueError`` for an unknown field or enum value.
    """
    mapped = {f.name for f in dataclasses.fields(KernelConfig)} - {"use_kernels"}
    unknown = sorted(set(fields) - mapped - set(_DROPPED))
    if unknown:
        raise ValueError(f"unknown KernelConfig fields {unknown}")
    return KernelConfig(**{k: v for k, v in fields.items() if k in mapped})


_CONFIG = _env_default()


def get_config() -> KernelConfig:
    return _CONFIG


@contextmanager
def config_override(**kwargs):
    """Temporarily override config fields (tests and measurements).

    The JAX config's TPU-only knobs (``_DROPPED``) may be named too; they
    are ignored.  Any other name that is not a field raises ``TypeError``.
    """
    global _CONFIG
    own = {k: v for k, v in kwargs.items() if k not in _DROPPED}
    old = _CONFIG
    _CONFIG = dataclasses.replace(old, **own)
    try:
        yield _CONFIG
    finally:
        _CONFIG = old
