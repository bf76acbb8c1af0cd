"""Build and load the CUDA kernels of ``csrc/``.

Each ``.cu`` source compiles with ``nvcc`` into its own shared library with
a plain C interface under ``build/torch_kernels/`` at the repository root,
keyed on a hash of the sources and flags, and is loaded with ``ctypes``.
All sources compile in parallel at first use.  No fast-math flag: the
log-space kernels need precise ``expf``/``log1pf``.  ``-fmad=false`` keeps
each multiply and add rounded on its own, as in the plain PyTorch
versions, so a kernel and its plain version round the same operations.

Each library's ``*_smem_bytes`` formula has a Python mirror in
:data:`SMEM_BYTES`, so that the host picks a scheme whose kernels hold a
label's lanes without a card (:func:`fits`); ``chip_smoke.py`` holds every
mirror against its library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_SOURCES = (
    "classic_fwd", "classic_bwd", "classic_bwd_half", "classic_bwd_rf", "classic_log",
    "simplified_fwd", "simplified_bwd", "simplified_bwd_rf", "simplified_log",
    "fused_epilogue", "graph_cond", "classic_pure64", "simplified_pure64", "viterbi",
    "walk", "beam_search",
)
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "classic_fwd": {
        "ctc_classic_fwd": [_P] * 9 + [_I] * 5 + [_P] * 10,
        "ctc_classic_fwd_smem_bytes": [_I, _I],
    },
    "classic_bwd": {
        "ctc_classic_bwd_streamed": [_P] * 10 + [_I] * 4 + [_P] * 5,
        "ctc_classic_bwd_smem_bytes": [_I, _I],
    },
    "classic_bwd_half": {
        "ctc_classic_bwd_half": [_P] * 11 + [_I] * 4 + [_P] * 5,
        "ctc_classic_bwd_half_smem_bytes": [_I, _I],
    },
    "classic_bwd_rf": {
        "ctc_classic_bwd_rf": [_P] * 14 + [_I] * 4 + [_P] * 6,
        "ctc_classic_bwd_rf_smem_bytes": [_I, _I],
    },
    "classic_log": {
        "ctc_classic_log_fwd": [_P] * 6 + [_I] * 4 + [_P] * 5,
        "ctc_classic_log_bwd": [_P] * 10 + [_I] * 3 + [_P] * 4,
        "ctc_classic_log_fwd_smem_bytes": [_I],
        "ctc_classic_log_bwd_smem_bytes": [_I],
    },
    "simplified_fwd": {
        "ctc_simplified_fwd": [_P] * 5 + [_I] * 5 + [_P] * 7,
        "ctc_simplified_fwd_smem_bytes": [_I, _I],
    },
    "simplified_bwd": {
        "ctc_simplified_bwd_streamed": [_P] * 7 + [_I] * 4 + [_P] * 4,
        "ctc_simplified_bwd_smem_bytes": [_I, _I],
    },
    "simplified_bwd_rf": {
        "ctc_simplified_bwd_rf": [_P] * 9 + [_I] * 4 + [_P] * 5,
        "ctc_simplified_bwd_rf_smem_bytes": [_I, _I],
    },
    "simplified_log": {
        "ctc_simplified_log_fwd": [_P] * 3 + [_I] * 4 + [_P] * 3,
        "ctc_simplified_log_bwd": [_P] * 6 + [_I] * 3 + [_P] * 3,
        "ctc_simplified_log_fwd_smem_bytes": [_I],
        "ctc_simplified_log_bwd_smem_bytes": [_I],
    },
    "fused_epilogue": {
        "ctc_fused_dlogits": [_P] * 8 + [_I] * 5 + [_P] * 2,
        "ctc_fused_epilogue_smem_bytes": [_I, _I],
    },
    "graph_cond": {
        "ctc_cond_load": [],
        "ctc_cond_begin": [_P] * 3,
        "ctc_cond_end": [_P, _P],
    },
    "classic_pure64": {
        "ctc_classic_alpha64": [_P] * 4 + [_I] * 4 + [_P] * 2,
        "ctc_classic_beta64": [_P] * 5 + [_I] * 4 + [_P] * 2,
        "ctc_classic_pure64_smem_bytes": [_I],
        "ctc_classic_alpha32": [_P] * 4 + [_I] * 4 + [_P] * 2,
        "ctc_classic_alpha32_smem_bytes": [_I],
        "ctc_classic_alpha_jvp64": [_P] * 8 + [_I] * 4 + [_P] * 3,
        "ctc_classic_beta_jvp64": [_P] * 9 + [_I] * 4 + [_P] * 3,
        "ctc_classic_jvp64_smem_bytes": [_I],
    },
    "simplified_pure64": {
        "ctc_simplified_alpha64": [_P] * 2 + [_I] * 4 + [_P] * 2,
        "ctc_simplified_beta64": [_P] * 3 + [_I] * 4 + [_P] * 2,
        "ctc_simplified_pure64_smem_bytes": [_I],
        "ctc_simplified_alpha32": [_P] * 2 + [_I] * 4 + [_P] * 2,
        "ctc_simplified_alpha32_smem_bytes": [_I],
        "ctc_simplified_alpha_jvp64": [_P] * 4 + [_I] * 4 + [_P] * 3,
        "ctc_simplified_beta_jvp64": [_P] * 5 + [_I] * 4 + [_P] * 3,
        "ctc_simplified_jvp64_smem_bytes": [_I],
    },
    "viterbi": {
        "ctc_classic_viterbi": [_P] * 7 + [_I] * 4 + [_P] * 5,
        "ctc_simplified_viterbi": [_P] * 5 + [_I] * 4 + [_P] * 5,
        "ctc_classic_viterbi_smem_bytes": [_I],
        "ctc_simplified_viterbi_smem_bytes": [_I],
        "ctc_classic_viterbi_grad": [_P] * 6 + [_I] * 4 + [_P] * 8,
        "ctc_simplified_viterbi_grad": [_P] * 4 + [_I] * 4 + [_P] * 6,
        "ctc_classic_viterbi_grad_smem_bytes": [_I],
        "ctc_simplified_viterbi_grad_smem_bytes": [_I],
    },
    "walk": {
        "ctc_classic_walk": [_P] * 9 + [_I] * 4 + [_P] * 3,
        "ctc_simplified_walk": [_P] * 7 + [_I] * 4 + [_P] * 3,
        "ctc_classic_walk_grad": [_P] * 8 + [_I] * 4 + [_P] * 6,
        "ctc_simplified_walk_grad": [_P] * 6 + [_I] * 4 + [_P] * 4,
    },
    "beam_search": {
        "ctc_beam_search": [_P] * 3 + [_I] * 7 + [_P] * 6,
        "ctc_beam_search_grad": [_P] * 4 + [_I] * 7 + [_P] * 4,
        "ctc_beam_search_smem_bytes": [_I, _I],
    },
}

_F = _N = 4  # bytes of a float and of an int
_BAR = 8  # bytes of an mbarrier
_LOG_RING = 8  # kLogRing and kSLogRing of the log-space kernels
_LOG_RUN = 8  # kLogRun and kSLogRun: steps whose blanks they stage at a time
_SPARE_ROWS = 2  # ring rows beyond one window of the staged scans


def _classic_bwd_bytes(half: bool):
    """The streamed beta scans' formula (B3, B13 with ``half``): a ring of
    k + spare slots, at least kBwdMinRing, each a step's transition row and
    its residual pair (B13: a1 only), and the double-buffered exchange a
    lane; B13 also the window's rebuilt a0 and the a0 that opens it; a
    blank row per window slot; an mbarrier per ring slot (B13: and a0's)."""
    parts = 2 if half else 3

    def smem_bytes(lp: int, k: int) -> int:
        ring = max(k + _SPARE_ROWS, 4)  # kBwdMinRing
        per_lane = ring * parts + 2 + (k + 1 if half else 0)
        return _F * (lp * per_lane + 2 * k) + _BAR * (ring + half)
    return smem_bytes


def _simplified_bwd_bytes(lp: int, k: int) -> int:
    """The streamed simplified beta scan's formula (B7): a ring of k + spare
    slots, at least kSBwdMinRing, each a step's transition row and residual
    row, and the double-buffered exchange a lane; a blank row per window
    slot; two mbarriers per ring slot (full, empty)."""
    ring = max(k + _SPARE_ROWS, 4)  # kSBwdMinRing
    return _F * (lp * (2 * ring + 2) + 2 * k) + _BAR * 2 * ring


def _fused_epilogue_bytes(lp: int, v: int) -> int:
    """The fused epilogue's formula (B12): each of its 8 warps' ring of act
    rows, two rows deep up to 2048 lanes and one beyond (epi_depth), an
    mbarrier per ring slot; the token lists: lanes[lp] and ends[v] ints,
    and one past the last listed lane."""
    slots = 8 * (2 if lp <= 2048 else 1)
    return _F * slots * lp + _BAR * slots + _N * (lp + v + 1)


def _log_bytes(rows: int):
    """The log-space scans' formula (classic B4 with ``rows`` 2, B5 with 4;
    simplified B8 with 1, B9 with 2):
    a ring of kLogRing slots, each ``rows`` staged rows of a step, and the
    double-buffered exchange a lane; a blank row per run slot; two
    mbarriers per ring slot (full, empty)."""
    def smem_bytes(lp: int, _) -> int:
        return _F * (lp * (rows * _LOG_RING + 2) + 2 * _LOG_RUN) + _BAR * 2 * _LOG_RING
    return smem_bytes


def _fwd_bytes(min_ring: int):
    """The forward scans' formula (B1 and B6): a ring of k + spare staged
    rows, at least ``min_ring`` (kFwdMinRing, kSFwdMinRing), and the
    double-buffered exchange a lane; a blank row per window slot; an
    mbarrier per ring row."""
    def smem_bytes(lp: int, k: int) -> int:
        ring = max(k + _SPARE_ROWS, min_ring)
        return _F * (lp * (ring + 2) + 2 * k) + _BAR * ring
    return smem_bytes


def _beam_search_bytes(vocab: int, k: int) -> int:
    """Beam search's row workspace (``BeamLayout``): the pool padded to a
    power of two P of at least 64, its sort keys and selection keys (8
    bytes each), the maxima's exchange (2 x 32 x 8), the sort's pool
    indices (4 bytes); each of the ``n = K (1 + V)`` candidates' pb and
    pnb; two states of seven words a beam and the selected positions (a
    word a beam); rounded up to 16 bytes."""
    n = k * (1 + vocab)
    pad = 64
    while pad < n:
        pad *= 2
    raw = 8 * 2 * pad + 8 * 64 + 4 * pad + 4 * 2 * n + 4 * 2 * 7 * k + 4 * k
    return (raw + 15) // 16 * 16


# Python mirrors of the libraries' ``ctc_<name>_smem_bytes(lpad, x)``: x is
# the window for the block-float kernels, the vocabulary size for the fused
# epilogue, and unused by the log-space kernels, the pure scans and Viterbi;
# beam search's are the vocabulary size and the beam width.
SMEM_BYTES = {
    "classic_fwd": _fwd_bytes(10),
    "classic_bwd": _classic_bwd_bytes(False),
    "classic_bwd_half": _classic_bwd_bytes(True),
    # a ring of k + spare staged rows, a blank row per window slot, an
    # mbarrier per ring row and one for the boundary rows
    "classic_bwd_rf": lambda lp, k: (_F * (lp * (k + _SPARE_ROWS + 9) + 2 * k)
                                     + _BAR * (k + _SPARE_ROWS + 1)),
    "classic_log_fwd": _log_bytes(2),
    "classic_log_bwd": _log_bytes(4),
    "simplified_fwd": _fwd_bytes(5),
    "simplified_bwd": _simplified_bwd_bytes,
    "simplified_bwd_rf": lambda lp, k: (_F * (lp * (k + _SPARE_ROWS + 6) + 2 * k)
                                        + _BAR * (k + _SPARE_ROWS + 1)),
    "simplified_log_fwd": _log_bytes(1),
    "simplified_log_bwd": _log_bytes(2),
    "fused_epilogue": _fused_epilogue_bytes,
    # the float64 pure scans' carries, double-buffered: two doubles a lane
    # for each state (the staged kernels; wider labels read the output)
    "classic_pure64": lambda lp, _: 2 * 2 * 8 * lp,
    "simplified_pure64": lambda lp, _: 2 * 8 * lp,
    # the HVP's tangent scans: the same carries, each a value and a tangent
    "classic_jvp64": lambda lp, _: 2 * 2 * 2 * 8 * lp,
    "simplified_jvp64": lambda lp, _: 2 * 2 * 8 * lp,
    # the same scans' forward in float32 (the sampler's alpha), and the
    # max-plus scans of forced alignment: two floats a lane for each state
    "classic_alpha32": lambda lp, _: 2 * 2 * _F * lp,
    "simplified_alpha32": lambda lp, _: 2 * _F * lp,
    "classic_viterbi": lambda lp, _: 2 * 2 * _F * lp,
    "simplified_viterbi": lambda lp, _: 2 * _F * lp,
    # their gradients: the same buffers hold the forward's carry, then the
    # adjoint
    "classic_viterbi_grad": lambda lp, _: 2 * 2 * _F * lp,
    "simplified_viterbi_grad": lambda lp, _: 2 * _F * lp,
    # beam search's pool, sort and beams (staged: in shared memory; else a
    # global scratch row of as many bytes)
    "beam_search": _beam_search_bytes,
}

# Shared memory one CTA may opt into on an H100 (227 KB): the limit that
# routes CPU tensors, so that their plain versions take the card's schemes.
SMEM_LIMIT = 232448

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("the CUDA toolkit (nvcc) was not found; set CUDA_HOME")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _digest() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for path in sorted(_CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _bind(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_size_t if fn.endswith("_smem_bytes") else ctypes.c_int
    return lib


def build_all() -> dict:
    """Compile (when not cached) and load every kernel library.

    Returns ``{source name: ctypes.CDLL}``.  Raises ``RuntimeError`` with
    the compiler's output when a build fails.
    """
    with _lock:
        if _libs:
            return _libs
        digest = _digest()
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        targets = {n: _BUILD_DIR / f"{n}-{digest}.so" for n in _SOURCES}
        procs = {}
        try:
            for name, out in targets.items():
                if out.exists():
                    continue
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
                procs[name] = (
                    subprocess.Popen(
                        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT
                    ),
                    tmp,
                )
            errors = []
            for name, (proc, tmp) in procs.items():
                out_text, _ = proc.communicate()
                if proc.returncode != 0:
                    errors.append(f"{name}.cu:\n{out_text.decode(errors='replace')}")
                else:
                    os.replace(tmp, targets[name])
            if errors:
                raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        finally:
            for proc, tmp in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                if tmp.exists():
                    tmp.unlink()
        for name, path in targets.items():
            _libs[name] = _bind(name, path)
        return _libs


def lib(name: str) -> ctypes.CDLL:
    return build_all()[name]


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: cudaError {err}")


def launch(library: str, fn: str, what: str, dev, *args) -> None:
    """Call ``library``'s entry point ``fn`` on ``dev`` with ``args`` (a
    tensor passes its data pointer, an int itself) and the device's current
    stream last; raise, naming ``what``, if it returns a CUDA error."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        err = getattr(lib(library), fn)(*ptrs, stream)
    check(err, what)


_optin: dict = {}  # CUDA device index -> the shared memory one CTA may opt into


@torch.compiler.assume_constant_result
def _card_smem_limit(device) -> int:
    """The shared memory one CTA may use on the CUDA ``device``, read once a
    device.  A constant under ``torch.compile``: the scheme it routes a call
    to is decided when the graph is traced, and the traced code reads no
    device property."""
    index = torch.cuda.current_device() if device.index is None else device.index
    if index not in _optin:
        props = torch.cuda.get_device_properties(index)
        _optin[index] = props.shared_memory_per_block_optin
    return _optin[index]


def smem_limit(device) -> int:
    """Shared memory one CTA may use: the card's for a CUDA device, else
    :data:`SMEM_LIMIT`."""
    if device.type == "cuda":
        return _card_smem_limit(device)
    return SMEM_LIMIT


def fits(kernels, lpad: int, x: int, device) -> bool:
    """Whether every kernel named in ``kernels`` (keys of
    :data:`SMEM_BYTES`) holds ``lpad`` lanes in one CTA's shared memory."""
    limit = smem_limit(device)
    return all(SMEM_BYTES[name](lpad, x) <= limit for name in kernels)


def check_smem(nbytes: int, what: str, device) -> None:
    """Raise a clear error when a kernel's shared memory exceeds the card's."""
    limit = smem_limit(device)
    if nbytes > limit:
        raise ValueError(
            f"{what}: the label is too long for one CTA per sample "
            f"({nbytes} bytes of shared memory needed, the card offers {limit}); "
            "shorten the labels"
        )
