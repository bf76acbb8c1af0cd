"""The pure path's recursions in float64 as CUDA kernels: the saturation
guard's float64 repair on the card.

No Pallas kernel stands behind these: the JAX package repairs such rows
through its pure path, a ``lax.scan`` that XLA compiles into one loop.  The
port's pure path is a Python loop over T (``ops/classic.py``,
``ops/simplified.py``) of about ten launches a step, which the op
``ctc_port::pure_repair`` (``ops/log_lattice.py``) ran for every repair that
the float32 log-space kernels do not serve: rows longer than one chunk,
labels wider than they hold, and the guard's pure tier.  On the card it now
takes its alpha and beta from these kernels:

* ``classic_alpha64`` and ``classic_beta64`` (csrc/classic_pure64.cu): the
  classic topology's recursions over the terms of ``classic.terms``,
  ``[B, T+1, Lp1, 2]``;
* ``simplified_alpha64`` and ``simplified_beta64``
  (csrc/simplified_pure64.cu): the simplified topology's over ``blank_lp``
  and ``expected_token_lp``, ``[B, T+1, Lp1]``.

Each is a custom op (``ctc_port::<name>``, ``cuda_lattice.kernel_op``):
CUDA tensors launch the kernel, CPU tensors run its plain version, which is
the pure module's own loop (``classic.alpha_scan`` and ``beta_scan``,
``simplified.alpha_scan`` and ``beta_scan``), so a kernel and the pure path
compute the same operations in the same order, and the kernels write its
bits.  A kernel keeps the previous step's carry in shared memory where the
label's lanes fit (``_build.SMEM_BYTES``), else reads it from the output
row it wrote: every label width is served.

The alpha kernels are templates on the scalar type.  In float32 they are
the ops ``ctc_port::classic_alpha32`` and ``ctc_port::simplified_alpha32``:
the forward that the alignment sampler walks back over (``ops/sample.py``),
the JAX package's float32 ``lax.scan`` (``ops/classic.py``,
``ops/simplified.py`` there), bit for bit the pure path's float32 loop.

The Hessian-vector product (``ops/hvp.py``) takes each lattice with its
tangent from four more kernels, the float64 scans' steps with a tangent
beside each value:

* ``classic_alpha_jvp64`` and ``classic_beta_jvp64``
  (csrc/classic_pure64.cu), whose plain versions are
  ``classic.alpha_scan_jvp`` and ``beta_scan_jvp``;
* ``simplified_alpha_jvp64`` and ``simplified_beta_jvp64``
  (csrc/simplified_pure64.cu), over ``simplified.alpha_scan_jvp`` and
  ``beta_scan_jvp``.

Each plain version is a loop over (value, tangent) pairs that gives the
bits of ``torch.func.jvp`` of the loop it extends; the kernels compute its
operations in its order.  Their ops fold ``vmap``'s groups into the batch
(``cuda_lattice.register_fold``), so the HVP runs under ``vmap`` with no
forward-mode AD through a loop.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from tf_seq2seq_losses_tpu_torch.ops import _build
from tf_seq2seq_losses_tpu_torch.ops import classic as classic_mod
from tf_seq2seq_losses_tpu_torch.ops import simplified as simplified_mod
from tf_seq2seq_losses_tpu_torch.ops.core import CtcContext, expected_token_lp
from tf_seq2seq_losses_tpu_torch.ops.cuda_lattice import (
    check_device,
    check_dtype,
    check_tensor,
    kernel_op,
    register_fold,
)


def _staged(kernels: str, lp1: int, device) -> int:
    """1 where the card gives a CTA the shared memory of the staged kernels
    ``kernels`` (a key of ``_build.SMEM_BYTES``) at ``lp1`` lanes, else 0
    (the carry read from the output)."""
    return int(_build.fits((kernels,), lp1, 0, device))


def _launch(library: str, fn: str, name: str, out, inputs, lengths=None,
            smem: str = None, tangents=None):
    """Launch ``library``'s entry point ``fn`` over ``inputs`` (``blank_lp``
    [B, T], then the [B, T, Lp1] terms, of ``out``'s type) and, for a
    tangent scan, their ``tangents`` in the same order, writing ``out`` (a
    tangent scan's is the pair of the lattice and its tangent); ``smem``
    names its shared-memory formula where it is not the library's."""
    outs = (out,) if tangents is None else tuple(out)
    batch, num_t, lp1 = inputs[-1].shape
    dev, dtype = outs[0].device, outs[0].dtype
    for group in (inputs,) if tangents is None else (inputs, tangents):
        check_tensor(group[0], (batch, num_t), dtype, "blank_lp", dev)
        for i, t in enumerate(group[1:]):
            check_tensor(t, (batch, num_t, lp1), dtype, f"term {i}", dev)
    args = tuple(inputs) + tuple(tangents or ())
    if lengths is not None:
        check_tensor(lengths, (batch,), torch.int64, "label_length", dev)
        args += (lengths,)
    _build.launch(library, fn, name, dev, *args, batch, num_t, lp1,
                  _staged(smem or library, lp1, dev), *outs)
    return out


def _classic_shape(diag_closed: Tensor):
    batch, num_t, lp1 = diag_closed.shape
    return batch, num_t + 1, lp1, 2


def _simplified_shape(diag_lp: Tensor):
    batch, num_t, lp1 = diag_lp.shape
    return batch, num_t + 1, lp1


# ---------------------------------------------------------------------------
# classic: alpha and beta over classic.terms
# ---------------------------------------------------------------------------


def classic_alpha64(blank_lp, prev_tok_masked, diag_closed, diag_open) -> Tensor:
    """Forward lattice log-probabilities [B, T+1, Lp1, 2] of the classic
    pure path, in float64, from its terms (``classic.terms``).

    The op ``ctc_port::classic_alpha64``: CUDA tensors launch
    csrc/classic_pure64.cu; CPU tensors run ``classic.alpha_scan``."""
    args = (blank_lp, prev_tok_masked, diag_closed, diag_open)
    check_device(diag_closed, "classic_alpha64")
    check_dtype(zip(("blank_lp", "prev_tok_masked", "diag_closed", "diag_open"), args),
                torch.float64, "classic_alpha64")
    return _classic_alpha64_op(*(t.contiguous() for t in args))


def _classic_alpha_plain(blank_lp: Tensor, prev_tok_masked: Tensor,
                           diag_closed: Tensor, diag_open: Tensor) -> Tensor:
    return classic_mod.alpha_scan(blank_lp, prev_tok_masked, diag_closed, diag_open)


_classic_alpha64_op = kernel_op("classic_alpha64", _classic_alpha_plain)


@_classic_alpha64_op.register_fake
def _classic_alpha_fake(blank_lp, prev_tok_masked, diag_closed, diag_open):
    return diag_closed.new_empty(_classic_shape(diag_closed))


@_classic_alpha64_op.register_kernel("cuda")
def _classic_alpha64_launch(blank_lp, prev_tok_masked, diag_closed, diag_open):
    out = diag_closed.new_empty(_classic_shape(diag_closed))
    _launch("classic_pure64", "ctc_classic_alpha64", "classic_alpha64", out,
            (blank_lp, prev_tok_masked, diag_closed, diag_open))
    classic_alpha64.launches += 1
    return out


classic_alpha64.launches = 0


def classic_beta64(blank_lp, prev_tok_masked, diag_closed, diag_open,
                   label_length) -> Tensor:
    """Backward lattice log-probabilities [B, T+1, Lp1, 2] of the classic
    pure path, in float64, from its terms and ``label_length`` [B] int64.

    The op ``ctc_port::classic_beta64``: CUDA tensors launch
    csrc/classic_pure64.cu; CPU tensors run ``classic.beta_scan``."""
    args = (blank_lp, prev_tok_masked, diag_closed, diag_open)
    check_device(diag_closed, "classic_beta64")
    check_dtype(zip(("blank_lp", "prev_tok_masked", "diag_closed", "diag_open"), args),
                torch.float64, "classic_beta64")
    return _classic_beta64_op(*(t.contiguous() for t in args),
                              label_length.contiguous())


def _classic_beta64_plain(blank_lp: Tensor, prev_tok_masked: Tensor,
                          diag_closed: Tensor, diag_open: Tensor,
                          label_length: Tensor) -> Tensor:
    return classic_mod.beta_scan(blank_lp, prev_tok_masked, diag_closed, diag_open,
                                 label_length)


_classic_beta64_op = kernel_op("classic_beta64", _classic_beta64_plain)


@_classic_beta64_op.register_fake
def _classic_beta64_fake(blank_lp, prev_tok_masked, diag_closed, diag_open,
                         label_length):
    return diag_closed.new_empty(_classic_shape(diag_closed))


@_classic_beta64_op.register_kernel("cuda")
def _classic_beta64_launch(blank_lp, prev_tok_masked, diag_closed, diag_open,
                           label_length):
    out = diag_closed.new_empty(_classic_shape(diag_closed))
    _launch("classic_pure64", "ctc_classic_beta64", "classic_beta64", out,
            (blank_lp, prev_tok_masked, diag_closed, diag_open), label_length)
    classic_beta64.launches += 1
    return out


classic_beta64.launches = 0


# ---------------------------------------------------------------------------
# simplified: alpha and beta over blank_lp and expected_token_lp
# ---------------------------------------------------------------------------


def simplified_alpha64(blank_lp, diag_lp) -> Tensor:
    """Forward lattice log-probabilities [B, T+1, Lp1] of the simplified
    pure path, in float64, from ``blank_lp`` [B, T] and ``diag_lp`` [B, T,
    Lp1] (``core.expected_token_lp``).

    The op ``ctc_port::simplified_alpha64``: CUDA tensors launch
    csrc/simplified_pure64.cu; CPU tensors run ``simplified.alpha_scan``."""
    check_device(diag_lp, "simplified_alpha64")
    check_dtype((("blank_lp", blank_lp), ("diag_lp", diag_lp)), torch.float64,
                "simplified_alpha64")
    return _simplified_alpha64_op(blank_lp.contiguous(), diag_lp.contiguous())


def _simplified_alpha_plain(blank_lp: Tensor, diag_lp: Tensor) -> Tensor:
    return simplified_mod.alpha_scan(blank_lp, diag_lp)


_simplified_alpha64_op = kernel_op("simplified_alpha64", _simplified_alpha_plain)


@_simplified_alpha64_op.register_fake
def _simplified_alpha_fake(blank_lp, diag_lp):
    return diag_lp.new_empty(_simplified_shape(diag_lp))


@_simplified_alpha64_op.register_kernel("cuda")
def _simplified_alpha64_launch(blank_lp, diag_lp):
    out = diag_lp.new_empty(_simplified_shape(diag_lp))
    _launch("simplified_pure64", "ctc_simplified_alpha64", "simplified_alpha64", out,
            (blank_lp, diag_lp))
    simplified_alpha64.launches += 1
    return out


simplified_alpha64.launches = 0


def simplified_beta64(blank_lp, diag_lp, label_length) -> Tensor:
    """Backward lattice log-probabilities [B, T+1, Lp1] of the simplified
    pure path, in float64, from ``blank_lp``, ``diag_lp`` and
    ``label_length`` [B] int64.

    The op ``ctc_port::simplified_beta64``: CUDA tensors launch
    csrc/simplified_pure64.cu; CPU tensors run ``simplified.beta_scan``."""
    check_device(diag_lp, "simplified_beta64")
    check_dtype((("blank_lp", blank_lp), ("diag_lp", diag_lp)), torch.float64,
                "simplified_beta64")
    return _simplified_beta64_op(blank_lp.contiguous(), diag_lp.contiguous(),
                                 label_length.contiguous())


def _simplified_beta64_plain(blank_lp: Tensor, diag_lp: Tensor,
                             label_length: Tensor) -> Tensor:
    return simplified_mod.beta_scan(blank_lp, diag_lp, label_length)


_simplified_beta64_op = kernel_op("simplified_beta64", _simplified_beta64_plain)


@_simplified_beta64_op.register_fake
def _simplified_beta64_fake(blank_lp, diag_lp, label_length):
    return diag_lp.new_empty(_simplified_shape(diag_lp))


@_simplified_beta64_op.register_kernel("cuda")
def _simplified_beta64_launch(blank_lp, diag_lp, label_length):
    out = diag_lp.new_empty(_simplified_shape(diag_lp))
    _launch("simplified_pure64", "ctc_simplified_beta64", "simplified_beta64", out,
            (blank_lp, diag_lp), label_length)
    simplified_beta64.launches += 1
    return out


simplified_beta64.launches = 0


# ---------------------------------------------------------------------------
# the forwards in float32: the alignment sampler's alpha
# ---------------------------------------------------------------------------


def classic_alpha32(blank_lp, prev_tok_masked, diag_closed, diag_open) -> Tensor:
    """Forward lattice log-probabilities [B, T+1, Lp1, 2] of the classic
    pure path in float32, from its terms (``classic.terms``): the lattice
    that the alignment sampler walks back over (``ops/sample.py``).

    The op ``ctc_port::classic_alpha32``: CUDA tensors launch the float32
    instantiation of ``classic_alpha64``'s kernel (csrc/classic_pure64.cu);
    CPU tensors run ``classic.alpha_scan``.  ``vmap`` folds the groups into
    the batch."""
    args = (blank_lp, prev_tok_masked, diag_closed, diag_open)
    check_device(diag_closed, "classic_alpha32")
    check_dtype(zip(("blank_lp", "prev_tok_masked", "diag_closed", "diag_open"), args),
                torch.float32, "classic_alpha32")
    return _classic_alpha32_op(*(t.contiguous() for t in args))


_classic_alpha32_op = kernel_op("classic_alpha32", _classic_alpha_plain)
_classic_alpha32_op.register_fake(_classic_alpha_fake)
register_fold(_classic_alpha32_op, (0, 0, 0, 0), (0,))


@_classic_alpha32_op.register_kernel("cuda")
def _classic_alpha32_launch(blank_lp, prev_tok_masked, diag_closed, diag_open):
    out = diag_closed.new_empty(_classic_shape(diag_closed))
    _launch("classic_pure64", "ctc_classic_alpha32", "classic_alpha32", out,
            (blank_lp, prev_tok_masked, diag_closed, diag_open), smem="classic_alpha32")
    classic_alpha32.launches += 1
    return out


classic_alpha32.launches = 0


def simplified_alpha32(blank_lp, diag_lp) -> Tensor:
    """Forward lattice log-probabilities [B, T+1, Lp1] of the simplified
    pure path in float32, from ``blank_lp`` [B, T] and ``diag_lp`` [B, T,
    Lp1]: the sampler's lattice.

    The op ``ctc_port::simplified_alpha32``: CUDA tensors launch the float32
    instantiation of ``simplified_alpha64``'s kernel
    (csrc/simplified_pure64.cu); CPU tensors run ``simplified.alpha_scan``."""
    check_device(diag_lp, "simplified_alpha32")
    check_dtype((("blank_lp", blank_lp), ("diag_lp", diag_lp)), torch.float32,
                "simplified_alpha32")
    return _simplified_alpha32_op(blank_lp.contiguous(), diag_lp.contiguous())


_simplified_alpha32_op = kernel_op("simplified_alpha32", _simplified_alpha_plain)
_simplified_alpha32_op.register_fake(_simplified_alpha_fake)
register_fold(_simplified_alpha32_op, (0, 0), (0,))


@_simplified_alpha32_op.register_kernel("cuda")
def _simplified_alpha32_launch(blank_lp, diag_lp):
    out = diag_lp.new_empty(_simplified_shape(diag_lp))
    _launch("simplified_pure64", "ctc_simplified_alpha32", "simplified_alpha32", out,
            (blank_lp, diag_lp), smem="simplified_alpha32")
    simplified_alpha32.launches += 1
    return out


simplified_alpha32.launches = 0


# ---------------------------------------------------------------------------
# the tangent scans of the HVP: each lattice and its tangent
# ---------------------------------------------------------------------------

_CLASSIC_TERMS = ("blank_lp", "prev_tok_masked", "diag_closed", "diag_open")
_SIMPLIFIED_TERMS = ("blank_lp", "diag_lp")


def _check_jvp(what: str, names, values, tangents) -> None:
    check_device(values[-1], what)
    check_dtype(zip(names + tuple(f"t_{n}" for n in names), values + tangents),
                torch.float64, what)


def classic_alpha_jvp64(blank_lp, prev_tok_masked, diag_closed, diag_open, t_blank_lp,
                        t_prev_tok_masked, t_diag_closed,
                        t_diag_open) -> Tuple[Tensor, Tensor]:
    """``(alpha, tangent)``, each [B, T+1, Lp1, 2] in float64: the classic
    forward lattice of the terms (``classic.terms``) and its tangent for
    the terms' tangents ``t_*``, the values and tangents that
    ``torch.func.jvp`` of ``classic.alpha_scan`` gives.

    The op ``ctc_port::classic_alpha_jvp64``: CUDA tensors launch
    csrc/classic_pure64.cu; CPU tensors run ``classic.alpha_scan_jvp``.
    ``vmap`` folds the groups into the batch."""
    values = (blank_lp, prev_tok_masked, diag_closed, diag_open)
    tangents = (t_blank_lp, t_prev_tok_masked, t_diag_closed, t_diag_open)
    _check_jvp("classic_alpha_jvp64", _CLASSIC_TERMS, values, tangents)
    return _classic_alpha_jvp64_op(*(t.contiguous() for t in values + tangents))


def _classic_alpha_jvp_plain(blank_lp: Tensor, prev_tok_masked: Tensor,
                             diag_closed: Tensor, diag_open: Tensor, t_blank_lp: Tensor,
                             t_prev_tok_masked: Tensor, t_diag_closed: Tensor,
                             t_diag_open: Tensor) -> Tuple[Tensor, Tensor]:
    return classic_mod.alpha_scan_jvp(blank_lp, prev_tok_masked, diag_closed, diag_open,
                                      t_blank_lp, t_prev_tok_masked, t_diag_closed,
                                      t_diag_open)


_classic_alpha_jvp64_op = kernel_op("classic_alpha_jvp64", _classic_alpha_jvp_plain)
register_fold(_classic_alpha_jvp64_op, (0,) * 8, (0, 0))


@_classic_alpha_jvp64_op.register_fake
def _classic_alpha_jvp_fake(blank_lp, prev_tok_masked, diag_closed, *_):
    shape = _classic_shape(diag_closed)
    return diag_closed.new_empty(shape), diag_closed.new_empty(shape)


@_classic_alpha_jvp64_op.register_kernel("cuda")
def _classic_alpha_jvp64_launch(*args):
    out = _classic_alpha_jvp_fake(*args)
    _launch("classic_pure64", "ctc_classic_alpha_jvp64", "classic_alpha_jvp64", out,
            args[:4], smem="classic_jvp64", tangents=args[4:])
    classic_alpha_jvp64.launches += 1
    return out


classic_alpha_jvp64.launches = 0


def classic_beta_jvp64(blank_lp, prev_tok_masked, diag_closed, diag_open, t_blank_lp,
                       t_prev_tok_masked, t_diag_closed, t_diag_open,
                       label_length) -> Tuple[Tensor, Tensor]:
    """``(beta, tangent)``, each [B, T+1, Lp1, 2] in float64: the classic
    backward lattice from the one-hot at ``label_length`` [B] int64 and its
    tangent, as :func:`classic_alpha_jvp64`.

    The op ``ctc_port::classic_beta_jvp64``: CUDA tensors launch
    csrc/classic_pure64.cu; CPU tensors run ``classic.beta_scan_jvp``."""
    values = (blank_lp, prev_tok_masked, diag_closed, diag_open)
    tangents = (t_blank_lp, t_prev_tok_masked, t_diag_closed, t_diag_open)
    _check_jvp("classic_beta_jvp64", _CLASSIC_TERMS, values, tangents)
    return _classic_beta_jvp64_op(*(t.contiguous() for t in values + tangents),
                                  label_length.contiguous())


def _classic_beta_jvp_plain(blank_lp: Tensor, prev_tok_masked: Tensor,
                            diag_closed: Tensor, diag_open: Tensor, t_blank_lp: Tensor,
                            t_prev_tok_masked: Tensor, t_diag_closed: Tensor,
                            t_diag_open: Tensor,
                            label_length: Tensor) -> Tuple[Tensor, Tensor]:
    return classic_mod.beta_scan_jvp(blank_lp, prev_tok_masked, diag_closed, diag_open,
                                     t_blank_lp, t_prev_tok_masked, t_diag_closed,
                                     t_diag_open, label_length)


_classic_beta_jvp64_op = kernel_op("classic_beta_jvp64", _classic_beta_jvp_plain)
register_fold(_classic_beta_jvp64_op, (0,) * 9, (0, 0))
_classic_beta_jvp64_op.register_fake(_classic_alpha_jvp_fake)


@_classic_beta_jvp64_op.register_kernel("cuda")
def _classic_beta_jvp64_launch(*args):
    out = _classic_alpha_jvp_fake(*args)
    _launch("classic_pure64", "ctc_classic_beta_jvp64", "classic_beta_jvp64", out,
            args[:4], args[8], smem="classic_jvp64", tangents=args[4:8])
    classic_beta_jvp64.launches += 1
    return out


classic_beta_jvp64.launches = 0


def simplified_alpha_jvp64(blank_lp, diag_lp, t_blank_lp, t_diag_lp) -> Tuple[Tensor, Tensor]:
    """``(alpha, tangent)``, each [B, T+1, Lp1] in float64: the simplified
    forward lattice of ``blank_lp`` [B, T] and ``diag_lp`` [B, T, Lp1]
    (``core.expected_token_lp``) and its tangent for ``t_blank_lp`` and
    ``t_diag_lp``, the values and tangents that ``torch.func.jvp`` of
    ``simplified.alpha_scan`` gives.

    The op ``ctc_port::simplified_alpha_jvp64``: CUDA tensors launch
    csrc/simplified_pure64.cu; CPU tensors run
    ``simplified.alpha_scan_jvp``.  ``vmap`` folds the groups into the
    batch."""
    values, tangents = (blank_lp, diag_lp), (t_blank_lp, t_diag_lp)
    _check_jvp("simplified_alpha_jvp64", _SIMPLIFIED_TERMS, values, tangents)
    return _simplified_alpha_jvp64_op(*(t.contiguous() for t in values + tangents))


def _simplified_alpha_jvp_plain(blank_lp: Tensor, diag_lp: Tensor, t_blank_lp: Tensor,
                                t_diag_lp: Tensor) -> Tuple[Tensor, Tensor]:
    return simplified_mod.alpha_scan_jvp(blank_lp, diag_lp, t_blank_lp, t_diag_lp)


_simplified_alpha_jvp64_op = kernel_op("simplified_alpha_jvp64",
                                       _simplified_alpha_jvp_plain)
register_fold(_simplified_alpha_jvp64_op, (0,) * 4, (0, 0))


@_simplified_alpha_jvp64_op.register_fake
def _simplified_alpha_jvp_fake(blank_lp, diag_lp, *_):
    shape = _simplified_shape(diag_lp)
    return diag_lp.new_empty(shape), diag_lp.new_empty(shape)


@_simplified_alpha_jvp64_op.register_kernel("cuda")
def _simplified_alpha_jvp64_launch(*args):
    out = _simplified_alpha_jvp_fake(*args)
    _launch("simplified_pure64", "ctc_simplified_alpha_jvp64", "simplified_alpha_jvp64",
            out, args[:2], smem="simplified_jvp64", tangents=args[2:])
    simplified_alpha_jvp64.launches += 1
    return out


simplified_alpha_jvp64.launches = 0


def simplified_beta_jvp64(blank_lp, diag_lp, t_blank_lp, t_diag_lp,
                          label_length) -> Tuple[Tensor, Tensor]:
    """``(beta, tangent)``, each [B, T+1, Lp1] in float64: the simplified
    backward lattice from the one-hot at ``label_length`` and its tangent,
    as :func:`simplified_alpha_jvp64`.

    The op ``ctc_port::simplified_beta_jvp64``: CUDA tensors launch
    csrc/simplified_pure64.cu; CPU tensors run ``simplified.beta_scan_jvp``."""
    values, tangents = (blank_lp, diag_lp), (t_blank_lp, t_diag_lp)
    _check_jvp("simplified_beta_jvp64", _SIMPLIFIED_TERMS, values, tangents)
    return _simplified_beta_jvp64_op(*(t.contiguous() for t in values + tangents),
                                     label_length.contiguous())


def _simplified_beta_jvp_plain(blank_lp: Tensor, diag_lp: Tensor, t_blank_lp: Tensor,
                               t_diag_lp: Tensor,
                               label_length: Tensor) -> Tuple[Tensor, Tensor]:
    return simplified_mod.beta_scan_jvp(blank_lp, diag_lp, t_blank_lp, t_diag_lp,
                                        label_length)


_simplified_beta_jvp64_op = kernel_op("simplified_beta_jvp64", _simplified_beta_jvp_plain)
register_fold(_simplified_beta_jvp64_op, (0,) * 5, (0, 0))
_simplified_beta_jvp64_op.register_fake(_simplified_alpha_jvp_fake)


@_simplified_beta_jvp64_op.register_kernel("cuda")
def _simplified_beta_jvp64_launch(*args):
    out = _simplified_alpha_jvp_fake(*args)
    _launch("simplified_pure64", "ctc_simplified_beta_jvp64", "simplified_beta_jvp64",
            out, args[:2], args[4], smem="simplified_jvp64", tangents=args[2:4])
    simplified_beta_jvp64.launches += 1
    return out


simplified_beta_jvp64.launches = 0


# ---------------------------------------------------------------------------
# a context's alpha and beta
# ---------------------------------------------------------------------------


def scan_terms(topology: str, ctx: CtcContext) -> tuple:
    """The terms that ``topology``'s scans take on ``ctx``: the four of
    ``classic.terms``, or the simplified topology's ``blank_lp`` and
    ``expected_token_lp``."""
    if topology == "classic":
        t = classic_mod.terms(ctx)
        return t.blank_lp, t.prev_tok_masked, t.diag_closed, t.diag_open
    return ctx.blank_lp, expected_token_lp(ctx)


def classic_scans(ctx: CtcContext, with_beta: bool = True):
    """``(alpha, beta or None)`` of the classic pure path on a float64
    context, through the kernels' ops (one ``classic.terms`` for both)."""
    args = scan_terms("classic", ctx)
    alpha = classic_alpha64(*args)
    return alpha, classic_beta64(*args, ctx.label_length) if with_beta else None


def simplified_scans(ctx: CtcContext, with_beta: bool = True):
    """``(alpha, beta or None)`` of the simplified pure path on a float64
    context, through the kernels' ops."""
    args = scan_terms("simplified", ctx)
    alpha = simplified_alpha64(*args)
    return alpha, simplified_beta64(*args, ctx.label_length) if with_beta else None


SCANS = {"classic": classic_scans, "simplified": simplified_scans}
