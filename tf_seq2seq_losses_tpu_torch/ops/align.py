"""Viterbi forced alignment over the CTC lattices, in PyTorch.

Counterpart of ``tf_seq2seq_losses_tpu/ops/align.py``: the alpha
recursions of the losses with ``max`` in place of ``logsumexp``, integer
argmax pointers kept per step, then a backtrack from the terminal state.

The scan over T is the custom op ``ctc_port::classic_viterbi`` (or
``ctc_port::simplified_viterbi``) over the lattice's terms
(``cuda_lattice.kernel_op``): CUDA tensors launch csrc/viterbi.cu, which
runs the forward and the backtrack in one launch; CPU tensors run its
plain version, a Python loop over T on the ``[B, Lp1(, 2)]`` carry, as the
pure loss path.  Each op has a fake, so ``torch.compile`` keeps it opaque
in its graph, and a ``vmap`` rule that folds the groups into the batch
(``cuda_lattice.register_fold``).  The terms and the masking around the op
are plain torch.  ``path_logproba`` is differentiable: where a gradient is
asked, the op's backward runs its plain version again and pulls the
gradient back through it (``cuda_lattice.plain_grad``; the kernel has no
backward), the loop's own gradient.

The pointers come from *strict* comparisons, as in the JAX package: the
lattices are full of ``-inf`` ties, and a ``>=`` would pick another of the
equally scored (impossible) predecessors and change the alignment.  They
are stored as int8, ``[T, B, Lp1]`` per state (the kernel: one byte a lane
and step).

Conventions (those of the loss modules):

* classic: being in ``(l, open)`` after frame ``t`` means frame ``t``
  emitted (or repeated) ``label[l-1]``; ``closed`` means blank.  The
  emission depends only on the state.
* simplified: the edge determines the emission (horizontal = blank,
  diagonal into ``l`` = ``label[l-1]``), so the backtrack reads the stored
  pointer.
* frames at ``t >= logit_length`` and infeasible samples emit blank; an
  infeasible sample's ``path_logproba`` is ``-inf``.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from tf_seq2seq_losses_tpu_torch.ops import _build
from tf_seq2seq_losses_tpu_torch.ops.classic import terms as classic_terms
from tf_seq2seq_losses_tpu_torch.ops.core import CtcContext, expected_token_lp
from tf_seq2seq_losses_tpu_torch.ops.cuda_lattice import (
    check_device,
    check_dtype,
    check_tensor,
    kernel_op,
    plain_grad,
    register_fold,
)

NEG_INF = float("-inf")


def _final_state(v_last: Tensor, label_length: Tensor) -> Tensor:
    """The terminal lattice value at ``l = label_length``."""
    rng = torch.arange(v_last.shape[0], device=v_last.device)
    return v_last[rng, label_length]


def _initial(batch: int, lp1: int, states: Tuple[int, ...], device) -> Tensor:
    init = torch.full((batch, lp1) + states, NEG_INF, device=device)
    init[(slice(None), 0) + (0,) * len(states)] = 0.0
    return init


def _check_label(label: Tensor, label_length: Tensor, blank: Tensor, batch: int,
                 lp1: int, dev) -> None:
    check_tensor(label, (batch, lp1), torch.int64, "label", dev)
    check_tensor(label_length, (batch,), torch.int64, "label_length", dev)
    check_tensor(blank, (), torch.int64, "blank", dev)


def _launch(fn: str, name: str, args, batch: int, num_t: int, lp1: int,
            smem: str, carry_floats: int, dev):
    """Launch viterbi.cu's entry point ``fn`` over the pointers of ``args``:
    ``(path_lp [B], alignment [B, T] int32)``."""
    staged = _build.fits((smem,), lp1, 0, dev)
    gcarry = torch.empty(0 if staged else batch * carry_floats * lp1, device=dev)
    ptr = torch.empty((batch, num_t, lp1), dtype=torch.uint8, device=dev)
    path_lp = torch.empty((batch,), device=dev)
    alignment = torch.empty((batch, num_t), dtype=torch.int32, device=dev)
    _build.launch("viterbi", fn, name, dev, *args, batch, num_t, lp1, int(staged),
                  gcarry, ptr, path_lp, alignment)
    return path_lp, alignment


def _viterbi_fake(diag: Tensor):
    batch, num_t, _ = diag.shape
    return (diag.new_empty((batch,)),
            diag.new_empty((batch, num_t), dtype=torch.int32))


# ---------------------------------------------------------------------------
# classic
# ---------------------------------------------------------------------------


def classic_viterbi_scan(blank_lp, prev_tok_masked, diag_closed, diag_open, label,
                         label_length, blank) -> Tuple[Tensor, Tensor]:
    """``(path_logproba [B], alignment [B, T] int32)`` of the classic lattice
    over its terms (``classic.terms``: ``blank_lp`` [B, T], the others [B, T,
    Lp1], float32), the cleaned ``label`` [B, Lp1], ``label_length`` [B] and
    ``blank`` [] (int64), before the masking of :func:`_mask_alignment`.

    The op ``ctc_port::classic_viterbi``: CUDA tensors launch
    csrc/viterbi.cu; CPU tensors run :func:`classic_viterbi_plain`."""
    args = (blank_lp, prev_tok_masked, diag_closed, diag_open)
    check_device(diag_closed, "classic_viterbi")
    check_dtype(zip(("blank_lp", "prev_tok_masked", "diag_closed", "diag_open"), args),
                torch.float32, "classic_viterbi")
    return _classic_viterbi(*(t.contiguous() for t in args), label.contiguous(),
                            label_length.contiguous(), blank)


def classic_viterbi_plain(blank_lp: Tensor, prev_tok_masked: Tensor,
                          diag_closed: Tensor, diag_open: Tensor, label: Tensor,
                          label_length: Tensor, blank: Tensor) -> Tuple[Tensor, Tensor]:
    """The plain version of the kernel ``classic_viterbi``: the max-plus
    loop over T, then the backtrack's loop."""
    batch, num_t, lp1 = diag_closed.shape
    device = diag_closed.device
    carry = _initial(batch, lp1, (2,), device)
    ptr_closed = torch.empty((num_t, batch, lp1), dtype=torch.int8, device=device)
    ptr_open = torch.empty((num_t, batch, lp1), dtype=torch.int8, device=device)
    for k in range(num_t):
        v_closed, v_open = carry[..., 0], carry[..., 1]
        # into (l, closed): blank from (l, closed) or (l, open)
        new_closed = torch.maximum(v_closed, v_open) + blank_lp[:, k, None]
        ptr_closed[k] = v_open > v_closed
        # into (l, open): horizontal repeat from (l, open), or diagonal from
        # (l-1, closed/open).  The roll's wrap is safe: position Lp1-1 is
        # -inf past label_length (as in the alpha recursion)
        horiz = v_open + prev_tok_masked[:, k]
        diag_c = v_closed + diag_closed[:, k]
        diag_o = v_open + diag_open[:, k]
        diag_best = torch.roll(torch.maximum(diag_c, diag_o), shifts=1, dims=1)
        diag_from_open = torch.roll((diag_o > diag_c).to(torch.int8), shifts=1, dims=1)
        ptr_open[k] = torch.where(diag_best > horiz, 1 + diag_from_open,
                                  torch.zeros_like(diag_from_open))
        carry = torch.stack([new_closed, torch.maximum(horiz, diag_best)], dim=-1)

    vf = _final_state(carry, label_length)  # [B, 2]
    cur_s = torch.argmax(vf, dim=1)  # the first maximum, as jnp.argmax
    path_lp = torch.amax(vf, dim=1)

    rng = torch.arange(batch, device=device)
    cur_l = label_length
    emits = torch.empty((batch, num_t), dtype=torch.int64, device=device)
    for k in range(num_t - 1, -1, -1):
        is_open = cur_s == 1
        emits[:, k] = torch.where(is_open, label[rng, torch.clamp(cur_l - 1, min=0)],
                                  blank)
        pc_here = ptr_closed[k][rng, cur_l].to(torch.int64)
        po_here = ptr_open[k][rng, cur_l].to(torch.int64)
        prev_s = torch.where(is_open, torch.where(po_here == 0, 1, po_here - 1), pc_here)
        prev_l = torch.where(is_open & (po_here > 0), cur_l - 1, cur_l)
        cur_l, cur_s = torch.clamp(prev_l, min=0), prev_s
    return path_lp, emits.to(torch.int32)


_classic_viterbi_op = kernel_op("classic_viterbi", classic_viterbi_plain)
register_fold(_classic_viterbi_op, (0, 0, 0, 0, 0, 0, None), (0, 0))
_classic_viterbi = plain_grad("classic_viterbi", classic_viterbi_plain, (0, 1, 2, 3), (0,))


@_classic_viterbi_op.register_fake
def _classic_viterbi_fake(blank_lp, prev_tok_masked, diag_closed, diag_open, label,
                          label_length, blank):
    return _viterbi_fake(diag_closed)


@_classic_viterbi_op.register_kernel("cuda")
def _classic_viterbi_launch(blank_lp, prev_tok_masked, diag_closed, diag_open, label,
                            label_length, blank):
    batch, num_t, lp1 = diag_closed.shape
    dev = diag_closed.device
    check_tensor(blank_lp, (batch, num_t), torch.float32, "blank_lp", dev)
    for name, t in (("prev_tok_masked", prev_tok_masked), ("diag_closed", diag_closed),
                    ("diag_open", diag_open)):
        check_tensor(t, (batch, num_t, lp1), torch.float32, name, dev)
    _check_label(label, label_length, blank, batch, lp1, dev)
    out = _launch("ctc_classic_viterbi", "classic_viterbi",
                  (blank_lp, prev_tok_masked, diag_closed, diag_open, label,
                   label_length, blank), batch, num_t, lp1, "classic_viterbi", 4, dev)
    classic_viterbi_scan.launches += 1
    return out


classic_viterbi_scan.launches = 0


def classic_viterbi(ctx: CtcContext) -> Tuple[Tensor, Tensor]:
    """``(path_logproba [B], alignment [B, T] int32)`` through the classic
    lattice."""
    t = classic_terms(ctx)
    path_lp, emits = classic_viterbi_scan(t.blank_lp, t.prev_tok_masked, t.diag_closed,
                                          t.diag_open, ctx.label, ctx.label_length,
                                          ctx.blank_index)
    return _mask_alignment(ctx, path_lp, emits)


# ---------------------------------------------------------------------------
# simplified
# ---------------------------------------------------------------------------


def simplified_viterbi_scan(blank_lp, diag_lp, label, label_length,
                            blank) -> Tuple[Tensor, Tensor]:
    """``(path_logproba [B], alignment [B, T] int32)`` of the simplified
    lattice over ``blank_lp`` [B, T] and ``diag_lp`` [B, T, Lp1]
    (``core.expected_token_lp``), before the masking.

    The op ``ctc_port::simplified_viterbi``: CUDA tensors launch
    csrc/viterbi.cu; CPU tensors run :func:`simplified_viterbi_plain`."""
    check_device(diag_lp, "simplified_viterbi")
    check_dtype((("blank_lp", blank_lp), ("diag_lp", diag_lp)), torch.float32,
                "simplified_viterbi")
    return _simplified_viterbi(blank_lp.contiguous(), diag_lp.contiguous(),
                               label.contiguous(), label_length.contiguous(), blank)


def simplified_viterbi_plain(blank_lp: Tensor, diag_lp: Tensor, label: Tensor,
                             label_length: Tensor, blank: Tensor) -> Tuple[Tensor, Tensor]:
    """The plain version of the kernel ``simplified_viterbi``."""
    batch, num_t, lp1 = diag_lp.shape
    device = diag_lp.device
    carry = _initial(batch, lp1, (), device)
    ptrs = torch.empty((num_t, batch, lp1), dtype=torch.int8, device=device)
    for k in range(num_t):
        horiz = carry + blank_lp[:, k, None]
        diag = torch.roll(carry + diag_lp[:, k], shifts=1, dims=1)
        ptrs[k] = diag > horiz  # 1: diagonal, an emitted token
        carry = torch.maximum(horiz, diag)

    path_lp = _final_state(carry, label_length)
    rng = torch.arange(batch, device=device)
    cur_l = label_length
    emits = torch.empty((batch, num_t), dtype=torch.int64, device=device)
    for k in range(num_t - 1, -1, -1):
        took_diag = ptrs[k][rng, cur_l] == 1
        emits[:, k] = torch.where(took_diag, label[rng, torch.clamp(cur_l - 1, min=0)],
                                  blank)
        cur_l = torch.clamp(torch.where(took_diag, cur_l - 1, cur_l), min=0)
    return path_lp, emits.to(torch.int32)


_simplified_viterbi_op = kernel_op("simplified_viterbi", simplified_viterbi_plain)
register_fold(_simplified_viterbi_op, (0, 0, 0, 0, None), (0, 0))
_simplified_viterbi = plain_grad("simplified_viterbi", simplified_viterbi_plain, (0, 1),
                                 (0,))


@_simplified_viterbi_op.register_fake
def _simplified_viterbi_fake(blank_lp, diag_lp, label, label_length, blank):
    return _viterbi_fake(diag_lp)


@_simplified_viterbi_op.register_kernel("cuda")
def _simplified_viterbi_launch(blank_lp, diag_lp, label, label_length, blank):
    batch, num_t, lp1 = diag_lp.shape
    dev = diag_lp.device
    check_tensor(blank_lp, (batch, num_t), torch.float32, "blank_lp", dev)
    check_tensor(diag_lp, (batch, num_t, lp1), torch.float32, "diag_lp", dev)
    _check_label(label, label_length, blank, batch, lp1, dev)
    out = _launch("ctc_simplified_viterbi", "simplified_viterbi",
                  (blank_lp, diag_lp, label, label_length, blank), batch, num_t, lp1,
                  "simplified_viterbi", 2, dev)
    simplified_viterbi_scan.launches += 1
    return out


simplified_viterbi_scan.launches = 0


def simplified_viterbi(ctx: CtcContext) -> Tuple[Tensor, Tensor]:
    """``(path_logproba [B], alignment [B, T] int32)`` through the
    simplified lattice (blank removal without collapse)."""
    path_lp, emits = simplified_viterbi_scan(ctx.blank_lp, expected_token_lp(ctx),
                                             ctx.label, ctx.label_length,
                                             ctx.blank_index)
    return _mask_alignment(ctx, path_lp, emits)


def _mask_alignment(ctx: CtcContext, path_lp: Tensor, alignment: Tensor):
    """Blank out frames past logit_length and whole infeasible samples."""
    feasible = torch.isfinite(path_lp)
    alignment = torch.where(ctx.logit_length_mask & feasible[:, None], alignment,
                            ctx.blank_index)
    return path_lp, alignment.to(torch.int32)


VITERBI = {"classic": classic_viterbi, "simplified": simplified_viterbi}
