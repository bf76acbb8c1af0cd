"""Numerically stable log-space primitives (PyTorch).

Counterparts of ``tf_seq2seq_losses_tpu/utils/numerics.py`` with the same
semantics, including the -inf contract: an all-(-inf) slice reduces to
exactly -inf and every derivative through it is zero, never NaN.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Union

import numpy as np
import torch

inf = np.float32(np.inf)


def logit_to_logproba(logit: torch.Tensor, dim: int) -> torch.Tensor:
    """Stable log-softmax: ``x - logsumexp(x, dim)``."""
    return logit - torch.logsumexp(logit, dim=dim, keepdim=True)


def apply_logarithmic_mask(tensor: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Keep entries where ``mask`` is True, force exactly -inf elsewhere."""
    return torch.where(mask, tensor, torch.full_like(tensor, -np.inf))


def logsumexp(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise ``log(exp(x) + exp(y))``, safe for same-signed infinite ties.

    ``-inf, -inf`` gives exactly -inf and ``+inf, +inf`` exactly +inf, both
    with zero derivative (the double-where form keeps the untaken branch
    finite, so no NaN leaks into the gradient).
    """
    x, y = torch.broadcast_tensors(x, y)
    neg_tie = torch.isneginf(x) & torch.isneginf(y)
    pos_tie = torch.isposinf(x) & torch.isposinf(y)
    special = neg_tie | pos_tie
    mx = torch.maximum(x, y)
    mn = torch.minimum(x, y)
    zero = torch.zeros_like(mx)
    diff = torch.where(special, zero, mn) - torch.where(special, zero, mx)
    mx_safe = torch.where(special, zero, mx)
    out = mx_safe + torch.log1p(torch.exp(diff))
    return torch.where(
        neg_tie,
        torch.full_like(out, -np.inf),
        torch.where(pos_tie, torch.full_like(out, np.inf), out),
    )


def logsumexp_jvp(x, y, tx, ty):
    """``(logsumexp(x, y), its tangent)`` for tangents ``tx``, ``ty``: the
    value of :func:`logsumexp` and the tangent that forward-mode AD
    (``torch.func.jvp``) gives it, operation for operation, so both round
    alike.  ``torch.maximum`` and ``torch.minimum`` take ``ty + w * (tx -
    ty)`` with ``w`` 1/2 at a tie, else 1 or 0 (``derivatives.yaml``);
    ``exp`` takes ``t * result``, ``log1p`` ``t / (x + 1)``; a tie of
    infinities gives a zero tangent."""
    x, y, tx, ty = torch.broadcast_tensors(x, y, tx, ty)
    neg_tie = torch.isneginf(x) & torch.isneginf(y)
    special = neg_tie | (torch.isposinf(x) & torch.isposinf(y))
    zero = torch.zeros_like(x)
    tie = x == y
    d = tx - ty
    t_mx = ty + torch.where(tie, 0.5, (x > y).to(x.dtype)) * d
    t_mn = ty + torch.where(tie, 0.5, (x < y).to(x.dtype)) * d
    mx = torch.where(special, zero, torch.maximum(x, y))
    diff = torch.where(special, zero, torch.minimum(x, y)) - mx
    e = torch.exp(diff)
    t_e = (torch.where(special, zero, t_mn) - torch.where(special, zero, t_mx)) * e
    out = mx + torch.log1p(e)
    t_out = torch.where(special, zero, t_mx) + t_e / (e + 1)
    value = torch.where(neg_tie, -np.inf, torch.where(special, np.inf, out))
    return value, torch.where(special, zero, t_out)


def reduce_logsumexp(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Axis logsumexp; all-(-inf) slices give exactly -inf, zero derivative."""
    m = torch.amax(x, dim=dim, keepdim=True).detach()
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    s = torch.sum(torch.exp(x - m_safe), dim=dim)
    empty = s == 0.0
    safe_log = torch.log(torch.where(empty, torch.ones_like(s), s))
    return m_safe.squeeze(dim) + torch.where(
        empty, torch.full_like(safe_log, -np.inf), safe_log
    )


def subexp(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Stable ``exp(x) - exp(y)``."""
    return torch.where(
        x > y,
        -torch.exp(x) * torch.expm1(y - x),
        torch.where(x < y, torch.exp(y) * torch.expm1(x - y), torch.zeros_like(x)),
    )


def unsorted_segment_logsumexp(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Segment logsumexp over the leading axis; empty segments give -inf."""
    ids = segment_ids.long()
    shape = (num_segments,) + tuple(data.shape[1:])
    idx = ids.view(-1, *([1] * (data.ndim - 1))).expand_as(data)
    data_max = torch.full(shape, -np.inf, dtype=data.dtype, device=data.device)
    data_max = data_max.scatter_reduce(0, idx, data.detach(), "amax")
    data_max_safe = torch.where(
        torch.isfinite(data_max), data_max, torch.zeros_like(data_max)
    )
    normed = data - data_max_safe.index_select(0, ids)
    sums = torch.zeros(shape, dtype=data.dtype, device=data.device)
    sums = sums.index_add(0, ids, torch.exp(normed))
    empty = sums == 0.0
    safe_log = torch.log(torch.where(empty, torch.ones_like(sums), sums))
    return data_max_safe + torch.where(
        empty, torch.full_like(safe_log, -np.inf), safe_log
    )


def unfold(
    init_tensor: torch.Tensor,
    iterfunc: Callable[[torch.Tensor, int], torch.Tensor],
    num_iters: int,
    d_i: int,
) -> torch.Tensor:
    """Iterate ``iterfunc`` and stack all ``num_iters + 1`` slices.

    ``d_i == +1``: ``[init, f(init, 0), f(f(init, 0), 1), ...]``.
    ``d_i == -1``: the iteration runs ``i = num_iters-1 .. 0`` and index
    ``i`` holds the value after consuming steps ``i .. num_iters-1``.
    """
    if d_i not in (-1, 1):
        raise ValueError("d_i must be +1 or -1")
    out = [init_tensor]
    carry = init_tensor
    order = range(num_iters) if d_i == 1 else range(num_iters - 1, -1, -1)
    for i in order:
        carry = iterfunc(carry, i)
        out.append(carry)
    if d_i == -1:
        out = out[::-1]
    return torch.stack(out, dim=0)


def pad_until(
    tensor: torch.Tensor,
    desired_size: int,
    axis: int,
    pad_value: Union[int, float, bool] = 0,
) -> torch.Tensor:
    """Right-pad ``axis`` to ``desired_size`` with ``pad_value``."""
    rank = tensor.ndim
    if axis >= rank:
        raise ValueError(f"axis {axis} out of range for rank {rank}")
    current = tensor.shape[axis]
    if desired_size < current:
        raise ValueError(
            f"desired_size {desired_size} smaller than current {current}"
        )
    shape = list(tensor.shape)
    shape[axis] = desired_size - current
    pad = torch.full(shape, pad_value, dtype=tensor.dtype, device=tensor.device)
    return torch.cat([tensor, pad], dim=axis)


def insert_zeros(tensor: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Insert a zero before each masked element of each row of ``tensor``
    ``[B, L]``; the output is ``[B, L + the most insertions of a row]``.

    The width depends on the data.  The JAX package raises under ``jit``,
    whose shapes are static; PyTorch runs the call eagerly, so the port
    reads the width on the host (one synchronisation for a CUDA tensor) and
    has no error to raise.  The call cannot be captured into a CUDA graph,
    which admits no synchronisation.
    """
    batch_size, length = tensor.shape
    delta = torch.cumsum(mask.to(torch.int64), dim=1)
    max_num_insertions = int(delta[:, -1].max()) if batch_size and length else 0
    cols = torch.arange(length, device=tensor.device)[None, :] + delta
    out = torch.zeros((batch_size, length + max_num_insertions), dtype=tensor.dtype,
                      device=tensor.device)
    return out.scatter(1, cols, tensor)


def reduce_max_with_default(input_tensor: torch.Tensor, default) -> torch.Tensor:
    """``max`` over all elements, ``default`` for an empty tensor."""
    if input_tensor.numel() == 0:
        return torch.as_tensor(default, dtype=input_tensor.dtype,
                               device=input_tensor.device)
    return torch.max(input_tensor)


def expand_many_dims(x: torch.Tensor, axes: List[int]) -> torch.Tensor:
    """Insert several singleton dimensions, in order."""
    for axis in axes:
        x = torch.unsqueeze(x, axis)
    return x


def smart_transpose(a: torch.Tensor, perm: List[int]) -> torch.Tensor:
    """``permute`` by a partial permutation (trailing axes unchanged)."""
    if len(perm) > a.ndim:
        raise ValueError(f"Tensor of rank {a.ndim} cannot be transposed by {perm}")
    return a.permute(*perm, *range(len(perm), a.ndim))


def smart_reshape(tensor: torch.Tensor, shape: List[Optional[int]]) -> torch.Tensor:
    """``reshape`` by a partial spec, ``None`` keeping that dimension; the
    rank is kept."""
    if len(shape) > tensor.ndim:
        raise ValueError(
            f"Tensor of rank {tensor.ndim} cannot be reshaped to {shape}"
        )
    spec = list(shape) + [None] * (tensor.ndim - len(shape))
    return tensor.reshape([tensor.shape[i] if dim is None else dim
                           for i, dim in enumerate(spec)])
