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
asked, the op's backward is ``ctc_port::classic_viterbi_grad`` (or
``ctc_port::simplified_viterbi_grad``, ``cuda_lattice.op_with_grad``),
whose CUDA implementation runs the forward again in one launch, keeping
each ``maximum``'s comparison, then the reverse max-plus adjoint sweep;
its plain version does the same out of place.  That is the gradient that
autograd takes through the loop, ties included: each ``torch.maximum``
gives half its gradient to each of two equal arguments (also ``-inf``
against ``-inf``), ``torch.amax`` over the two terminal states splits it
evenly between equal maxima, and ``blank_lp``'s gradient sums the lanes in
:func:`lane_sum`'s order.

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
    op_with_grad,
    plain_grad,
    register_fold,
)

NEG_INF = float("-inf")


def _final_state(v_last: Tensor, label_length: Tensor) -> Tensor:
    """The terminal lattice value at ``l = label_length``."""
    rng = torch.arange(v_last.shape[0], device=v_last.device)
    return v_last[rng, label_length]


def _initial(batch: int, lp1: int, device) -> Tensor:
    """The carry entering step 0 (of the closed state, classic): 0 at lane
    0, else ``-inf``."""
    lane = torch.arange(lp1, device=device)
    return torch.where(lane == 0, 0.0, NEG_INF).expand(batch, lp1)


def _stack_steps(steps, reverse: bool = False) -> Tensor:
    """The tensors of each step of a loop over T stacked at axis 1, in time
    order (``reverse``: the loop ran from the last step down)."""
    return torch.stack(steps[::-1] if reverse else steps, dim=1)


def maximum_code(a: Tensor, b: Tensor) -> Tensor:
    """How ``torch.maximum(a, b)`` routes its gradient, as int8: 0 all to
    ``a`` (the larger), 1 all to ``b``, 2 half to each (a tie, ``-inf``
    against ``-inf`` too), 3 all to each (a NaN: no comparison holds)."""
    code = torch.where(a > b, 0, torch.where(a < b, 1, torch.where(a == b, 2, 3)))
    return code.to(torch.int8)


def first_share(code: Tensor, g: Tensor) -> Tensor:
    """The gradient ``g`` of ``torch.maximum(a, b)`` that ``a`` takes, by
    :func:`maximum_code` (derivatives.yaml: ``where(a == b, g / 2,
    g).masked_fill_(a < b, 0)``)."""
    return torch.where(code == 1, 0.0, torch.where(code == 2, g / 2, g))


def second_share(code: Tensor, g: Tensor) -> Tensor:
    """The gradient ``g`` of ``torch.maximum(a, b)`` that ``b`` takes."""
    return torch.where(code == 0, 0.0, torch.where(code == 2, g / 2, g))


def lane_sum(x: Tensor) -> Tensor:
    """``x`` summed over its last axis in a fixed order: four partial sums
    from zero, lane ``l`` into partial ``l % 4`` up to the last whole group
    of four, the lanes after it into partial 0, then ``((p0 + p1) + p2) +
    p3``.  That is the order of ``torch.sum``'s scalar path on the CPU,
    which autograd's sum over the lanes takes below 8 lanes (wider rows
    vectorise there); the kernels keep it at every width, so that a tie's
    halves, which a random cotangent can make round, add up alike."""
    lanes = x.shape[-1]
    whole = lanes - lanes % 4
    parts = torch.zeros(x.shape[:-1] + (4,), dtype=x.dtype, device=x.device)
    for group in x[..., :whole].unflatten(-1, (-1, 4)).unbind(-2):
        parts = parts + group
    first = parts[..., 0]
    for lane in x[..., whole:].unbind(-1):
        first = first + lane
    return ((first + parts[..., 1]) + parts[..., 2]) + parts[..., 3]


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


def _launch_grad(fn: str, name: str, args, batch: int, num_t: int, lp1: int,
                 carry_floats: int, n_terms: int, dev):
    """Launch viterbi.cu's gradient entry point ``fn`` over the pointers of
    ``args``: ``(d blank_lp [B, T], then the n_terms [B, T, Lp1])``.  The
    scratch: the forward's codes, a byte a lane and step, and the adjoints
    that ``blank_lp``'s lane sums read, ``[B, Lp1, T]``."""
    staged = _build.fits((name,), lp1, 0, dev)
    gcarry = torch.empty(0 if staged else batch * carry_floats * lp1, device=dev)
    codes = torch.empty((batch, num_t, lp1), dtype=torch.uint8, device=dev)
    adj = torch.empty((batch, lp1, num_t), device=dev)
    outs = [torch.empty((batch, num_t), device=dev)]
    outs += [torch.empty((batch, num_t, lp1), device=dev) for _ in range(n_terms)]
    _build.launch("viterbi", fn, name, dev, *args, batch, num_t, lp1, int(staged), gcarry,
                  codes, adj, *outs)
    return tuple(outs)


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
    csrc/viterbi.cu; CPU tensors run :func:`classic_viterbi_plain`.  Its
    backward is :func:`classic_viterbi_grad`."""
    args = (blank_lp, prev_tok_masked, diag_closed, diag_open)
    check_device(diag_closed, "classic_viterbi")
    check_dtype(zip(("blank_lp", "prev_tok_masked", "diag_closed", "diag_open"), args),
                torch.float32, "classic_viterbi")
    return _classic_viterbi(*(t.contiguous() for t in args), label.contiguous(),
                            label_length.contiguous(), blank)


def _classic_step(v_closed, v_open, blank_k, pm_k, dc_k, do_k):
    """One step of the classic max-plus forward from the carry ``(v_closed,
    v_open)`` [B, Lp1]: ``(closed', open', horiz, diag_c, diag_o, best)``.

    Into ``(l, closed)``: a blank from ``(l, closed)`` or ``(l, open)``.
    Into ``(l, open)``: the horizontal repeat from ``(l, open)``, or the
    diagonal from ``(l-1, closed/open)``.  The roll's wrap is safe: position
    Lp1-1 is -inf past label_length (as in the alpha recursion)."""
    new_closed = torch.maximum(v_closed, v_open) + blank_k[:, None]
    horiz = v_open + pm_k
    diag_c = v_closed + dc_k
    diag_o = v_open + do_k
    best = torch.roll(torch.maximum(diag_c, diag_o), shifts=1, dims=1)
    return new_closed, torch.maximum(horiz, best), horiz, diag_c, diag_o, best


def _classic_final(v_closed, v_open, label_length):
    """The terminal values ``(closed, open)`` [B] at ``l = label_length``."""
    return _final_state(v_closed, label_length), _final_state(v_open, label_length)


def classic_viterbi_plain(blank_lp: Tensor, prev_tok_masked: Tensor,
                          diag_closed: Tensor, diag_open: Tensor, label: Tensor,
                          label_length: Tensor, blank: Tensor) -> Tuple[Tensor, Tensor]:
    """The plain version of the kernel ``classic_viterbi``: the max-plus
    loop over T, then the backtrack's loop."""
    batch, num_t, lp1 = diag_closed.shape
    device = diag_closed.device
    v_closed = _initial(batch, lp1, device)
    v_open = torch.full((batch, lp1), NEG_INF, device=device)
    ptr_closed, ptr_open = [], []
    for k in range(num_t):
        ptr_closed.append((v_open > v_closed).to(torch.int8))
        v_closed, v_open, horiz, diag_c, diag_o, best = _classic_step(
            v_closed, v_open, blank_lp[:, k], prev_tok_masked[:, k], diag_closed[:, k],
            diag_open[:, k])
        diag_from_open = torch.roll((diag_o > diag_c).to(torch.int8), shifts=1, dims=1)
        ptr_open.append(torch.where(best > horiz, 1 + diag_from_open,
                                    torch.zeros_like(diag_from_open)))

    vf = torch.stack(_classic_final(v_closed, v_open, label_length), dim=1)  # [B, 2]
    cur_s = torch.argmax(vf, dim=1)  # the first maximum, as jnp.argmax
    path_lp = torch.amax(vf, dim=1)

    rng = torch.arange(batch, device=device)
    cur_l = label_length
    emits = []
    for k in range(num_t - 1, -1, -1):
        is_open = cur_s == 1
        emits.append(torch.where(is_open, label[rng, torch.clamp(cur_l - 1, min=0)],
                                 blank))
        pc_here = ptr_closed[k][rng, cur_l].to(torch.int64)
        po_here = ptr_open[k][rng, cur_l].to(torch.int64)
        prev_s = torch.where(is_open, torch.where(po_here == 0, 1, po_here - 1), pc_here)
        prev_l = torch.where(is_open & (po_here > 0), cur_l - 1, cur_l)
        cur_l, cur_s = torch.clamp(prev_l, min=0), prev_s
    return path_lp, _alignment(emits, batch, device)


def _alignment(emits, batch: int, device) -> Tensor:
    """The backtrack's emissions, last frame first, as ``[B, T]`` int32."""
    if not emits:
        return torch.empty((batch, 0), dtype=torch.int32, device=device)
    return _stack_steps(emits, reverse=True).to(torch.int32)


_classic_viterbi_op = kernel_op("classic_viterbi", classic_viterbi_plain)
register_fold(_classic_viterbi_op, (0, 0, 0, 0, 0, 0, None), (0, 0))


@_classic_viterbi_op.register_fake
def _classic_viterbi_fake(blank_lp, prev_tok_masked, diag_closed, diag_open, label,
                          label_length, blank):
    return _viterbi_fake(diag_closed)


@_classic_viterbi_op.register_kernel("cuda")
def _classic_viterbi_launch(blank_lp, prev_tok_masked, diag_closed, diag_open, label,
                            label_length, blank):
    batch, num_t, lp1, dev = _check_classic(blank_lp, prev_tok_masked, diag_closed,
                                            diag_open, label, label_length, blank)
    out = _launch("ctc_classic_viterbi", "classic_viterbi",
                  (blank_lp, prev_tok_masked, diag_closed, diag_open, label,
                   label_length, blank), batch, num_t, lp1, "classic_viterbi", 4, dev)
    classic_viterbi_scan.launches += 1
    return out


classic_viterbi_scan.launches = 0


def _check_classic(blank_lp, prev_tok_masked, diag_closed, diag_open, label,
                   label_length, blank):
    batch, num_t, lp1 = diag_closed.shape
    dev = diag_closed.device
    check_tensor(blank_lp, (batch, num_t), torch.float32, "blank_lp", dev)
    for name, t in (("prev_tok_masked", prev_tok_masked), ("diag_closed", diag_closed),
                    ("diag_open", diag_open)):
        check_tensor(t, (batch, num_t, lp1), torch.float32, name, dev)
    _check_label(label, label_length, blank, batch, lp1, dev)
    return batch, num_t, lp1, dev


def classic_viterbi_grad(blank_lp, prev_tok_masked, diag_closed, diag_open, label,
                         label_length, blank,
                         grad) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The gradients of ``path_logproba`` (:func:`classic_viterbi_scan`'s
    first output) under the cotangent ``grad`` [B], in its four float terms:
    ``(d blank_lp [B, T], d prev_tok_masked, d diag_closed, d diag_open [B,
    T, Lp1])``, the gradient autograd takes through
    :func:`classic_viterbi_plain`.

    The op ``ctc_port::classic_viterbi_grad``: CUDA tensors launch
    csrc/viterbi.cu; CPU tensors run :func:`classic_viterbi_grad_plain`."""
    check_device(diag_closed, "classic_viterbi_grad")
    args = (blank_lp, prev_tok_masked, diag_closed, diag_open, grad)
    check_dtype(zip(("blank_lp", "prev_tok_masked", "diag_closed", "diag_open", "grad"),
                    args), torch.float32, "classic_viterbi_grad")
    return _classic_viterbi_grad(*(t.contiguous() for t in args[:4]),
                                    label.contiguous(), label_length.contiguous(), blank,
                                    grad.contiguous())


def classic_viterbi_grad_plain(blank_lp: Tensor, prev_tok_masked: Tensor,
                               diag_closed: Tensor, diag_open: Tensor, label: Tensor,
                               label_length: Tensor, blank: Tensor,
                               grad: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The plain version of the kernel ``classic_viterbi_grad``, out of
    place: the forward loop again, keeping the codes of its three maxima
    (:func:`maximum_code`), then the adjoint sweep from the last step down.
    The terminal ``amax`` gives ``grad / n`` to each of its ``n`` equal
    states; at each step a maximum routes its output's adjoint by its code,
    the roll's adjoint rolls back one lane (lane 0's to lane Lp1-1), and a
    carry's adjoint sums what its uses return, ``open`` as
    ``(diagonal + horizontal) + closed'``, autograd's order.  ``blank_lp``'s
    gradient at step k is :func:`lane_sum` of the adjoint of ``closed'``."""
    batch, num_t, lp1 = diag_closed.shape
    device = diag_closed.device
    v_closed = _initial(batch, lp1, device)
    v_open = torch.full((batch, lp1), NEG_INF, device=device)
    codes = []
    for k in range(num_t):
        code_closed = maximum_code(v_closed, v_open)
        v_closed, v_open, horiz, diag_c, diag_o, best = _classic_step(
            v_closed, v_open, blank_lp[:, k], prev_tok_masked[:, k], diag_closed[:, k],
            diag_open[:, k])
        code_diag = torch.roll(maximum_code(diag_c, diag_o), shifts=1, dims=1)
        codes.append((code_closed, code_diag, maximum_code(horiz, best)))

    vc, vo = _classic_final(v_closed, v_open, label_length)
    top = torch.amax(torch.stack([vc, vo], dim=1), dim=1)
    on_closed, on_open = vc == top, vo == top
    share = grad / (on_closed.to(torch.int64) + on_open.to(torch.int64))
    at_end = _at_lane(label_length, lp1)
    adj_closed = torch.where(at_end, (share * on_closed)[:, None], 0.0)
    adj_open = torch.where(at_end, (share * on_open)[:, None], 0.0)
    d_pm, d_dc, d_do, d_closed = [], [], [], []
    for k in range(num_t - 1, -1, -1):
        code_closed, code_diag, code_open = codes[k]
        d_closed.append(adj_closed)
        d_horiz = first_share(code_open, adj_open)
        # the diagonal's adjoint back through the roll: lane l's from lane l+1
        d_best = torch.roll(second_share(code_open, adj_open), shifts=-1, dims=1)
        code_diag = torch.roll(code_diag, shifts=-1, dims=1)
        d_diag_c, d_diag_o = first_share(code_diag, d_best), second_share(code_diag, d_best)
        d_pm.append(d_horiz)
        d_dc.append(d_diag_c)
        d_do.append(d_diag_o)
        m_closed, m_open = (first_share(code_closed, adj_closed),
                            second_share(code_closed, adj_closed))
        adj_closed, adj_open = d_diag_c + m_closed, (d_diag_o + d_horiz) + m_open
    if not num_t:
        empty = diag_closed.new_zeros((batch, 0, lp1))
        return blank_lp.new_zeros((batch, 0)), empty, empty.clone(), empty.clone()
    return (lane_sum(_stack_steps(d_closed, reverse=True)),
            _stack_steps(d_pm, reverse=True), _stack_steps(d_dc, reverse=True),
            _stack_steps(d_do, reverse=True))


def _at_lane(label_length: Tensor, lp1: int) -> Tensor:
    """``[B, Lp1]``: true at lane ``label_length`` of each row."""
    return torch.arange(lp1, device=label_length.device) == label_length[:, None]


_classic_viterbi_grad_op = kernel_op("classic_viterbi_grad", classic_viterbi_grad_plain)
register_fold(_classic_viterbi_grad_op, (0, 0, 0, 0, 0, 0, None, 0), (0, 0, 0, 0))
_classic_viterbi_grad = plain_grad(
    "classic_viterbi_grad", classic_viterbi_grad_plain, (0, 1, 2, 3, 7), (0, 1, 2, 3))
_classic_viterbi = op_with_grad(
    "classic_viterbi", (0, 1, 2, 3),
    lambda args, grads: classic_viterbi_grad(*args, grads[0]))


@_classic_viterbi_grad_op.register_fake
def _classic_viterbi_grad_fake(blank_lp, prev_tok_masked, diag_closed, diag_open, label,
                               label_length, blank, grad):
    return (torch.empty_like(blank_lp), torch.empty_like(prev_tok_masked),
            torch.empty_like(diag_closed), torch.empty_like(diag_open))


@_classic_viterbi_grad_op.register_kernel("cuda")
def _classic_viterbi_grad_launch(blank_lp, prev_tok_masked, diag_closed, diag_open,
                                 label, label_length, blank, grad):
    batch, num_t, lp1, dev = _check_classic(blank_lp, prev_tok_masked, diag_closed,
                                            diag_open, label, label_length, blank)
    check_tensor(grad, (batch,), torch.float32, "grad", dev)
    out = _launch_grad("ctc_classic_viterbi_grad", "classic_viterbi_grad",
                       (blank_lp, prev_tok_masked, diag_closed, diag_open, label_length,
                        grad), batch, num_t, lp1, 4, 3, dev)
    classic_viterbi_grad.launches += 1
    return out


classic_viterbi_grad.launches = 0


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
    csrc/viterbi.cu; CPU tensors run :func:`simplified_viterbi_plain`.  Its
    backward is :func:`simplified_viterbi_grad`."""
    check_device(diag_lp, "simplified_viterbi")
    check_dtype((("blank_lp", blank_lp), ("diag_lp", diag_lp)), torch.float32,
                "simplified_viterbi")
    return _simplified_viterbi(blank_lp.contiguous(), diag_lp.contiguous(),
                               label.contiguous(), label_length.contiguous(), blank)


def _simplified_step(carry, blank_k, dg_k):
    """One step of the simplified max-plus forward: ``(carry', horiz,
    diag)``, the horizontal a blank, the diagonal into ``l`` an emitted
    ``label[l-1]``."""
    horiz = carry + blank_k[:, None]
    diag = torch.roll(carry + dg_k, shifts=1, dims=1)
    return torch.maximum(horiz, diag), horiz, diag


def simplified_viterbi_plain(blank_lp: Tensor, diag_lp: Tensor, label: Tensor,
                             label_length: Tensor, blank: Tensor) -> Tuple[Tensor, Tensor]:
    """The plain version of the kernel ``simplified_viterbi``."""
    batch, num_t, lp1 = diag_lp.shape
    device = diag_lp.device
    carry = _initial(batch, lp1, device)
    ptrs = []
    for k in range(num_t):
        carry, horiz, diag = _simplified_step(carry, blank_lp[:, k], diag_lp[:, k])
        ptrs.append(diag > horiz)  # 1: diagonal, an emitted token

    path_lp = _final_state(carry, label_length)
    rng = torch.arange(batch, device=device)
    cur_l = label_length
    emits = []
    for k in range(num_t - 1, -1, -1):
        took_diag = ptrs[k][rng, cur_l]
        emits.append(torch.where(took_diag, label[rng, torch.clamp(cur_l - 1, min=0)],
                                 blank))
        cur_l = torch.clamp(torch.where(took_diag, cur_l - 1, cur_l), min=0)
    return path_lp, _alignment(emits, batch, device)


_simplified_viterbi_op = kernel_op("simplified_viterbi", simplified_viterbi_plain)
register_fold(_simplified_viterbi_op, (0, 0, 0, 0, None), (0, 0))


@_simplified_viterbi_op.register_fake
def _simplified_viterbi_fake(blank_lp, diag_lp, label, label_length, blank):
    return _viterbi_fake(diag_lp)


@_simplified_viterbi_op.register_kernel("cuda")
def _simplified_viterbi_launch(blank_lp, diag_lp, label, label_length, blank):
    batch, num_t, lp1, dev = _check_simplified(blank_lp, diag_lp, label, label_length,
                                               blank)
    out = _launch("ctc_simplified_viterbi", "simplified_viterbi",
                  (blank_lp, diag_lp, label, label_length, blank), batch, num_t, lp1,
                  "simplified_viterbi", 2, dev)
    simplified_viterbi_scan.launches += 1
    return out


simplified_viterbi_scan.launches = 0


def _check_simplified(blank_lp, diag_lp, label, label_length, blank):
    batch, num_t, lp1 = diag_lp.shape
    dev = diag_lp.device
    check_tensor(blank_lp, (batch, num_t), torch.float32, "blank_lp", dev)
    check_tensor(diag_lp, (batch, num_t, lp1), torch.float32, "diag_lp", dev)
    _check_label(label, label_length, blank, batch, lp1, dev)
    return batch, num_t, lp1, dev


def simplified_viterbi_grad(blank_lp, diag_lp, label, label_length, blank,
                            grad) -> Tuple[Tensor, Tensor]:
    """The gradients of ``path_logproba`` under the cotangent ``grad`` [B]:
    ``(d blank_lp [B, T], d diag_lp [B, T, Lp1])``, the gradient autograd
    takes through :func:`simplified_viterbi_plain`.

    The op ``ctc_port::simplified_viterbi_grad``: CUDA tensors launch
    csrc/viterbi.cu; CPU tensors run :func:`simplified_viterbi_grad_plain`."""
    check_device(diag_lp, "simplified_viterbi_grad")
    check_dtype((("blank_lp", blank_lp), ("diag_lp", diag_lp), ("grad", grad)),
                torch.float32, "simplified_viterbi_grad")
    return _simplified_viterbi_grad(blank_lp.contiguous(), diag_lp.contiguous(),
                                       label.contiguous(), label_length.contiguous(),
                                       blank, grad.contiguous())


def simplified_viterbi_grad_plain(blank_lp: Tensor, diag_lp: Tensor, label: Tensor,
                                  label_length: Tensor, blank: Tensor,
                                  grad: Tensor) -> Tuple[Tensor, Tensor]:
    """The plain version of the kernel ``simplified_viterbi_grad``, out of
    place: the forward loop again, keeping each step's maximum code, then
    the adjoint sweep from ``grad`` at the terminal lane down.  A carry's
    adjoint is its horizontal share plus the diagonal's share of the lane
    above (the roll back); ``blank_lp``'s gradient at step k is
    :func:`lane_sum` of the horizontal shares."""
    batch, num_t, lp1 = diag_lp.shape
    carry = _initial(batch, lp1, diag_lp.device)
    codes = []
    for k in range(num_t):
        carry, horiz, diag = _simplified_step(carry, blank_lp[:, k], diag_lp[:, k])
        codes.append(maximum_code(horiz, diag))

    adj = torch.where(_at_lane(label_length, lp1), grad[:, None], 0.0)
    d_horiz, d_dg = [], []
    for k in range(num_t - 1, -1, -1):
        d_h = first_share(codes[k], adj)
        d_d = torch.roll(second_share(codes[k], adj), shifts=-1, dims=1)
        d_horiz.append(d_h)
        d_dg.append(d_d)
        adj = d_h + d_d
    if not num_t:
        return blank_lp.new_zeros((batch, 0)), diag_lp.new_zeros((batch, 0, lp1))
    return (lane_sum(_stack_steps(d_horiz, reverse=True)),
            _stack_steps(d_dg, reverse=True))


_simplified_viterbi_grad_op = kernel_op("simplified_viterbi_grad",
                                        simplified_viterbi_grad_plain)
register_fold(_simplified_viterbi_grad_op, (0, 0, 0, 0, None, 0), (0, 0))
_simplified_viterbi_grad = plain_grad(
    "simplified_viterbi_grad", simplified_viterbi_grad_plain, (0, 1, 5), (0, 1))
_simplified_viterbi = op_with_grad(
    "simplified_viterbi", (0, 1),
    lambda args, grads: simplified_viterbi_grad(*args, grads[0]))


@_simplified_viterbi_grad_op.register_fake
def _simplified_viterbi_grad_fake(blank_lp, diag_lp, label, label_length, blank, grad):
    return torch.empty_like(blank_lp), torch.empty_like(diag_lp)


@_simplified_viterbi_grad_op.register_kernel("cuda")
def _simplified_viterbi_grad_launch(blank_lp, diag_lp, label, label_length, blank, grad):
    batch, num_t, lp1, dev = _check_simplified(blank_lp, diag_lp, label, label_length,
                                               blank)
    check_tensor(grad, (batch,), torch.float32, "grad", dev)
    out = _launch_grad("ctc_simplified_viterbi_grad", "simplified_viterbi_grad",
                       (blank_lp, diag_lp, label_length, grad), batch, num_t, lp1, 2, 1,
                       dev)
    simplified_viterbi_grad.launches += 1
    return out


simplified_viterbi_grad.launches = 0


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
