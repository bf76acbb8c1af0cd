"""Rank mesh, batch sharding and the batch-sharded CTC loss.

Counterpart of ``tf_seq2seq_losses_tpu/parallel/sharding.py``.  The only
parallel axis a CTC loss has is the batch:

* :func:`make_mesh` lays the run's ranks out on a named grid,
  ``('data',)`` or ``('data', 'model')``, row-major as a JAX mesh lays out
  its devices, with one process group per line of each axis;
* :func:`shard_batch` gives a rank its data group's rows of a global batch;
* :func:`sharded_ctc_loss` computes those rows' losses, with no
  communication at all;
* :func:`sharded_mean_ctc_loss` adds the one collective a training
  objective needs, a sum of the ranks' local sums.

Where the JAX package writes one program over global arrays, each rank
here runs on its own rows and the collectives are explicit.  The autograd
functions below are the conjugate pairs of that style: an all-reduce whose
backward is the identity (each rank's term enters the sum once), its
transpose, and an all-gather whose backward keeps the rank's own slice.
They are in the ``setup_context`` form with a ``vmap`` rule each, so the
losses are differentiable under ``torch.func`` too, as the JAX package's
are under ``jax.grad``.  Where the JAX package returns ``jax.jit(mapped)``,
the losses here are graphed callables on CUDA (:func:`_graphed`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch._C import _functorch

from tf_seq2seq_losses_tpu_torch import api
from tf_seq2seq_losses_tpu_torch.ops import core
from tf_seq2seq_losses_tpu_torch.utils.config import get_config


class Mesh:
    """A grid of the run's ranks with named axes.

    ``shape`` maps each axis name to its size, ``coords`` to this rank's
    index along it; ``device`` is the device this rank computes on.
    :meth:`group` is the process group of this rank's line along an axis,
    or ``None`` without a process group (one process, where every
    collective is the identity)."""

    def __init__(self, axis_shapes: Sequence[int], axis_names: Sequence[str], device):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in axis_shapes)))
        self.device = torch.device(device)
        rank = dist.get_rank() if dist.is_initialized() else 0
        self.coords = dict(zip(self.axis_names,
                               (int(i) for i in np.unravel_index(rank, axis_shapes))))
        self._groups = {}
        if dist.is_initialized():
            grid = np.arange(int(np.prod(axis_shapes))).reshape(tuple(axis_shapes))
            for i, name in enumerate(self.axis_names):
                lines = np.moveaxis(grid, i, -1).reshape(-1, grid.shape[i]).tolist()
                self._groups[name] = dist.new_subgroups_by_enumeration(lines)[0]

    def group(self, axis: str):
        return self._groups.get(axis)


def _rank_device() -> torch.device:
    """The device of this rank: the CPU under gloo, else its CUDA card."""
    if dist.is_initialized() and dist.get_backend() == "gloo":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def make_mesh(
    axis_shapes: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("data",),
    device=None,
) -> Mesh:
    """A mesh over the run's ranks, one device each; without a process
    group, a mesh of one rank.  Defaults to a 1-D ``('data',)`` mesh over
    all ranks.  ``device`` is this rank's device (default: the CPU under
    gloo, else the current CUDA device).  Every rank must call it, in the
    same order as the other ranks (it creates process groups)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if axis_shapes is None:
        axis_shapes = (world,)
    needed = int(np.prod(axis_shapes))
    if needed != world:
        raise ValueError(f"mesh {tuple(axis_shapes)} needs {needed} ranks, the run "
                         f"has {world}")
    if len(axis_shapes) != len(axis_names):
        raise ValueError(f"{len(axis_names)} axis names for mesh {tuple(axis_shapes)}")
    return Mesh(axis_shapes, axis_names, _rank_device() if device is None else device)


def tree_map(fn, tree):
    """``fn`` over the leaves of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, tree, data_axis: str = "data"):
    """This rank's rows of a global batch-major batch (a pytree of arrays),
    on its device: the ``data_axis`` index's share of the batch."""
    size, index = mesh.shape[data_axis], mesh.coords[data_axis]

    def place(x):
        x = torch.as_tensor(x)
        if x.shape[0] % size:
            raise ValueError(f"batch {x.shape[0]} does not divide over {size} "
                             f"'{data_axis}' groups")
        rows = x.shape[0] // size
        return x[index * rows:(index + 1) * rows].to(mesh.device)

    return tree_map(place, tree)


class _SumOverGroup(torch.autograd.Function):
    """All-reduce (sum) forward, identity backward."""

    @staticmethod
    def forward(x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        return grad, None

    @staticmethod
    def vmap(info, in_dims, x, group):
        # elementwise over the ranks: the mapped dimension stays where it is
        return _SumOverGroup.apply(x, group), in_dims[0]


class _CopyToGroup(torch.autograd.Function):
    """Identity forward, all-reduce (sum) backward."""

    @staticmethod
    def forward(x, group):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return _SumOverGroup.apply(grad.contiguous(), ctx.group), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _CopyToGroup.apply(x, group), in_dims[0]


class _GatherLastDim(torch.autograd.Function):
    """All-gather along the last axis forward; backward keeps this rank's
    slice of the cotangent."""

    @staticmethod
    def forward(x, group):
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, group = inputs
        ctx.index = dist.get_rank(group)
        ctx.width = x.shape[-1]

    @staticmethod
    def backward(ctx, grad):
        start = ctx.index * ctx.width
        return grad[..., start:start + ctx.width].contiguous(), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        # a mapped last axis would interleave the groups' slices: move the
        # mapped dimension to the front, where the gather keeps it apart
        if in_dims[0] is None:
            return _GatherLastDim.apply(x, group), None
        return _GatherLastDim.apply(x.movedim(in_dims[0], 0), group), 0


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``, replicated; its
    backward passes the cotangent through unchanged, since each rank's
    ``x`` enters the sum once.  (``torch.distributed.nn``'s all-reduce
    sums the cotangent as well: a replicated objective backpropagated on
    every rank would then give each rank ``world_size`` times its
    gradient.)"""
    return x if group is None else _SumOverGroup.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` unchanged; its cotangent is summed over ``group`` (where a
    replicated activation enters a column-parallel product)."""
    return x if group is None else _CopyToGroup.apply(x, group)


def gather_last_dim(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` of ``group`` concatenated along the last axis."""
    return x if group is None else _GatherLastDim.apply(x, group)


class _Slot:
    """One capture of a graphed loss: its graphed callable
    (``torch.cuda.make_graphed_callables``), whose forward and backward
    replay into the same static tensors, the number of forwards it has
    replayed and whether the backward of the last one is still to come."""

    def __init__(self, graphed):
        self.graphed = graphed
        self.forwards = 0
        self.pending = False


class _Hold:
    """A slot's forward, held while its backward may still come: the
    slot's static tensors are this forward's until :meth:`release`, which
    the backward calls, or the death of the autograd graph that holds it."""

    def __init__(self, slot: _Slot):
        self.slot = slot
        slot.forwards += 1
        slot.pending = True
        self.forward = slot.forwards

    def current(self) -> bool:
        return self.slot.forwards == self.forward

    def release(self) -> None:
        if self.current():
            self.slot.pending = False

    __del__ = release


class _Release(torch.autograd.Function):
    """Identity on the logits that enter a graphed loss.  Its backward
    comes after the graph's: it hands on a copy of the graph's static
    gradient, so that a later replay cannot change it, and frees the
    slot."""

    @staticmethod
    def forward(logits, hold):
        return logits.view_as(logits)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.hold = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        if not ctx.hold.current():
            raise RuntimeError(
                "backward through a graphed loss whose graph has replayed a later "
                "forward since (retain_graph=True): its saved tensors are gone")
        ctx.hold.release()
        return grad.clone(), None


def _eager(logits: torch.Tensor) -> bool:
    """Whether a graphed loss runs eagerly: on CPU logits (the caller's
    choice of device), and inside a ``torch.func`` transform, since a
    graphed callable's Function has no ``setup_context`` form."""
    return logits.device.type != "cuda" or _functorch.peek_interpreter_stack() is not None


def _graphed(loss_fn):
    """``loss_fn(labels, logits, label_length, logit_length)`` captured on
    CUDA, the counterpart of the JAX package's ``jax.jit(mapped)``.

    Per key (the inputs' shapes and dtypes, whether the call records
    autograd, ``get_config()``), ``torch.cuda.make_graphed_callables``
    captures the forward and, where the call records autograd, the
    backward, so the result stays differentiable.  A call copies its
    inputs into the capture's static tensors and replays it, and returns a
    copy of its loss; the gradient that reaches the logits is a copy too.
    A forward's saved tensors stay in its capture (a :class:`_Slot`) until
    its backward has run or its autograd graph is gone: a forward that
    finds every slot of its key held captures another, so forwards taken
    before one backward (gradient accumulation) each keep their own.  A
    slot is captured once and replayed, so keeping the graphs of many
    forwards alive keeps as many slots.  Where :func:`_eager` says so, and
    in ``call.eager``, ``loss_fn`` runs eagerly."""
    slots = {}

    def call(labels, logits, label_length, logit_length):
        logits = core.values_tensor(logits)
        if _eager(logits):
            return loss_fn(labels, logits, label_length, logit_length)
        args = [torch.as_tensor(labels, device=logits.device), logits,
                torch.as_tensor(label_length, device=logits.device),
                torch.as_tensor(logit_length, device=logits.device)]
        grad = torch.is_grad_enabled() and logits.requires_grad
        key = (tuple((a.shape, a.dtype) for a in args), grad, get_config())
        free = [s for s in slots.setdefault(key, []) if not s.pending]
        if free:
            slot = free[0]
        else:
            sample = [a.detach().clone() for a in args]
            sample[1].requires_grad_(grad)
            slot = _Slot(torch.cuda.make_graphed_callables(loss_fn, tuple(sample)))
            slots[key].append(slot)
        args[1] = _Release.apply(logits, _Hold(slot)) if grad else logits.detach()
        return slot.graphed(*args).clone()

    call.eager = loss_fn
    return call


def sharded_ctc_loss(
    mesh: Mesh,
    topology: str = "classic",
    blank_index: int = 0,
    data_axis: str = "data",
):
    """Per-sample CTC losses of this rank's rows (:func:`shard_batch`).

    Returns ``(labels, logits, label_length, logit_length) -> loss``; no
    communication, differentiable as the loss is; on CUDA a graphed
    callable (:func:`_graphed`)."""

    def loss_fn(labels, logits, label_length, logit_length):
        return api.ctc_loss(labels, logits, label_length, logit_length, blank_index,
                            topology)

    return _graphed(loss_fn)


def sharded_mean_ctc_loss(
    mesh: Mesh,
    topology: str = "classic",
    blank_index: int = 0,
    data_axis: str = "data",
):
    """Global mean CTC loss: the ranks' local sums and counts summed over
    the ``data_axis`` group.

    Returns ``(labels, logits, label_length, logit_length) -> scalar``,
    replicated on every rank of the group and differentiable, also under
    ``torch.func.grad``: each rank's ``d_logits`` are its rows of the
    single-device gradient; on CUDA a graphed callable (:func:`_graphed`).
    Every row counts; an infinite loss makes the mean infinite."""
    group = mesh.group(data_axis)

    def loss_fn(labels, logits, label_length, logit_length):
        loss = api.ctc_loss(labels, logits, label_length, logit_length, blank_index,
                            topology)
        total = sum_over(loss.sum(), group)
        count = sum_over(torch.full((), float(loss.shape[0]), device=loss.device), group)
        return total / count

    return _graphed(loss_fn)
