"""Data-parallel (+ optional tensor-parallel) CTC training step.

Counterpart of ``tf_seq2seq_losses_tpu/parallel/train.py``: utterance
batches shard over ``'data'``; the encoder's MLP and head optionally shard
over ``'model'``; gradients sum over the data group.  Where XLA inserts
the collectives of the reference's sharding annotations, this module calls
them itself (``sharding.sum_over``, ``copy_to``, ``gather_last_dim``).

Tensor parallelism follows the reference's ``_param_spec`` as coded: the
up projections are column-parallel (``up.w``, ``up.b`` shard the 4H
outputs), the down projections row-parallel (``down.w`` shards the 4H
inputs; the partial sums are all-reduced in float32 before the replicated
``down.b`` is added), and the head shards the vocabulary (``head.w``,
``head.b``); the logits are gathered over the vocabulary before the loss.
Every other parameter is replicated and gets the same gradient on every
rank of a model group.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from tf_seq2seq_losses_tpu_torch import api
from tf_seq2seq_losses_tpu_torch.models import encoder as enc
from tf_seq2seq_losses_tpu_torch.parallel import sharding

# parameter-name suffix -> the dimension that the model axis shards
_MODEL_DIMS = {"up.w": 1, "up.b": 0, "down.w": 0, "head.w": 1, "head.b": 0}


class TrainState(NamedTuple):
    params: enc.Encoder  # this rank's shard of the encoder
    opt_state: torch.optim.Optimizer


def _param_dim(name: str, mesh: sharding.Mesh, model_axis: Optional[str]):
    if model_axis is None or model_axis not in mesh.axis_names:
        return None
    for suffix, dim in _MODEL_DIMS.items():
        if name.endswith(suffix):
            return dim
    return None


def param_shardings(params: enc.Encoder, mesh: sharding.Mesh,
                    model_axis: Optional[str] = "model") -> Dict[str, Optional[int]]:
    """For each parameter name of ``params``, the dimension that
    ``model_axis`` shards, or ``None`` (replicated)."""
    return {name: _param_dim(name, mesh, model_axis)
            for name, _ in params.named_parameters()}


# the products' weights, whose data-group sum runs inside the backward
_PRODUCT_WEIGHTS = ("up.w", "down.w", "head.w")


class _ShardedEncoder(enc.Encoder):
    """One rank's shard of an encoder: the model group's slice of the
    sharded parameters (all of them without a model axis).

    The cotangent of each product's bfloat16 weight is summed over the data
    group (``_shared_weight``), and that of a column-parallel product's
    bfloat16 activation over the model group (``_enter_columns``), before
    the cast's backward rounds it to bfloat16: XLA sums the partial
    products of the reference's sharded step in float32 first, too."""

    def __init__(self, full: enc.Encoder, mesh: sharding.Mesh, data_axis: str,
                 model_axis: Optional[str]):
        tp = model_axis is not None and model_axis in mesh.axis_names
        size, index = ((mesh.shape[model_axis], mesh.coords[model_axis]) if tp
                       else (1, 0))
        num_features = full.stem.w.shape[1]
        hidden, vocab = full.head.w.shape
        for what, width in (("4 * hidden", 4 * hidden), ("vocab", vocab)):
            if width % size:
                raise ValueError(f"{what} = {width} does not divide over the "
                                 f"'{model_axis}' axis of size {size}")
        super().__init__(num_features, hidden, vocab, len(full.blocks),
                         device=mesh.device, inner=4 * hidden // size,
                         head_width=vocab // size)
        self.model_group = mesh.group(model_axis) if tp else None
        self.data_group = mesh.group(data_axis)
        state = {}
        for name, value in full.state_dict().items():
            dim = _param_dim(name, mesh, model_axis)
            if dim is not None:
                width = value.shape[dim] // size
                value = value.narrow(dim, index * width, width)
            state[name] = value
        self.load_state_dict(state)

    def _enter_columns(self, xq):
        return sharding.copy_to(xq, self.model_group)

    def _shared_weight(self, wq):
        return sharding.copy_to(wq, self.data_group)

    def _reduce_rows(self, y):
        return sharding.sum_over(y, self.model_group)

    def _gather_vocab(self, logits):
        return sharding.gather_last_dim(logits, self.model_group)


def make_train_step(
    mesh: sharding.Mesh,
    learning_rate: float = 1e-3,
    topology: str = "classic",
    blank_index: int = 0,
    data_axis: str = "data",
    model_axis: Optional[str] = "model",
    optimizer=None,
):
    """Build ``init_state``, ``shard_batch`` and ``train_step``.

    ``init_state(params)`` takes a whole encoder (on any device) and
    returns this rank's :class:`TrainState`: its shard on the mesh's
    device and the optimizer over it, ``optimizer(parameters)`` (default
    ``torch.optim.Adam`` at ``learning_rate``, whose other defaults are
    optax's: b1 0.9, b2 0.999, eps 1e-8).  ``shard_batch(batch)`` gives
    this rank's rows of a global batch.  ``train_step(state, batch) ->
    (state, loss)`` updates the state in place, where ``batch`` is a dict
    with ``features [B, T, F]``, ``feature_length [B]``, ``labels [B, L]``
    and ``label_length [B]``, this rank's rows.

    The objective is the mean of the finite losses of the global batch
    (an infeasible sample's loss is +inf and its gradient 0): each rank
    differentiates its finite sum over the global finite count, and the
    gradients are summed over the data group.  ``loss`` is that mean,
    replicated.
    """
    make_opt = optimizer or (lambda p: torch.optim.Adam(p, lr=learning_rate))
    data_group = mesh.group(data_axis)

    def init_state(params: enc.Encoder) -> TrainState:
        local = _ShardedEncoder(params, mesh, data_axis, model_axis)
        return TrainState(local, make_opt(local.parameters()))

    def shard_batch(batch):
        return sharding.shard_batch(mesh, batch, data_axis)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, torch.Tensor]:
        model, opt = state
        logits = model(batch["features"])
        losses = api.ctc_loss(batch["labels"], logits, batch["label_length"],
                              enc.subsampled_length(batch["feature_length"]),
                              blank_index, topology)
        finite = torch.isfinite(losses)
        local_sum = torch.where(finite, losses, torch.zeros_like(losses)).sum()
        # the global finite sum and count, before the backward needs the count
        total, count = sharding.sum_over(
            torch.stack([local_sum.detach(), finite.sum().to(torch.float32)]),
            data_group)
        denom = torch.clamp(count, min=1.0)
        opt.zero_grad(set_to_none=True)
        (local_sum / denom).backward()
        if data_group is not None:
            grads = [p.grad for name, p in model.named_parameters()
                     if not name.endswith(_PRODUCT_WEIGHTS)]
            flat = _flatten_dense_tensors(grads)
            dist.all_reduce(flat, group=data_group)
            for g, summed in zip(grads, _unflatten_dense_tensors(flat, grads)):
                g.copy_(summed)
        opt.step()
        return state, total / denom

    return init_state, shard_batch, train_step
