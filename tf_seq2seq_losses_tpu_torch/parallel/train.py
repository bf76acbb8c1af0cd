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

Where the reference returns ``jax.jit(train_step)``, the step here is
captured as a CUDA graph on a CUDA mesh (:func:`capture_step`) and
replayed; its eager body is :func:`train_step_eager`.
"""

from __future__ import annotations

import weakref
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from tf_seq2seq_losses_tpu_torch import api
from tf_seq2seq_losses_tpu_torch.models import encoder as enc
from tf_seq2seq_losses_tpu_torch.parallel import sharding
from tf_seq2seq_losses_tpu_torch.utils.config import get_config

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


def train_step_eager(state: TrainState, batch, topology: str = "classic",
                     blank_index: int = 0, data_group=None
                     ) -> Tuple[TrainState, torch.Tensor]:
    """One eager training step of ``state`` on ``batch`` (this rank's rows):
    the body of :func:`make_train_step`'s ``train_step``, which a CUDA
    mesh captures as a graph.  ``data_group``: the process group over which
    the gradients sum (None: one rank).  Updates the state in place and
    returns it with the replicated mean loss."""
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


class _Captured(NamedTuple):
    """One captured step: its graph, static batch and static loss, and the
    host state that the graph fixed (:func:`_fixed`)."""

    graph: torch.cuda.CUDAGraph
    batch: dict
    loss: torch.Tensor
    fixed: tuple


def _fixed(state: TrainState) -> tuple:
    """What a capture fixes of a state on the host: the model's and the
    optimizer's parameter tensors (their addresses are in the graph) and
    each parameter group's hyperparameters, those of ``opt.defaults`` (a
    Python ``lr`` is a constant of the graph; a tensor's value is read at
    each replay)."""
    model, opt = state
    groups = tuple(tuple((k, g.get(k)) for k in sorted(opt.defaults))
                   for g in opt.param_groups)
    params = tuple(model.parameters()) + tuple(p for g in opt.param_groups
                                               for p in g["params"])
    return params, groups


def _same(a, b) -> bool:
    """``a`` and ``b`` of :func:`_fixed` agree: the same tensors, equal
    other values."""
    if torch.is_tensor(a) or torch.is_tensor(b):
        return a is b
    if isinstance(a, (tuple, list)) and isinstance(b, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def _check_capturable(opt) -> None:
    if opt.defaults.get("capturable") is False:
        raise ValueError(
            f"{type(opt).__name__}(capturable=False) cannot be captured in a CUDA graph: "
            "its step reads the step count on the host; construct it with "
            "capturable=True")


def _snapshot(opt):
    """The optimizer's state tensors by parameter, copied."""
    return {p: {k: v.clone() if torch.is_tensor(v) else v for k, v in st.items()}
            for p, st in opt.state.items()}


def _restore(model, opt, params, state):
    """Undo a warm-up step in place: the parameters ``params`` and the
    optimizer state ``state`` (:func:`_snapshot`) as they were; state that
    the warm-up created is set to zero, as Adam's starts."""
    with torch.no_grad():
        for p, v in zip(model.parameters(), params):
            p.copy_(v)
        for p, st in opt.state.items():
            old = state.get(p, {})
            for k, v in st.items():
                if torch.is_tensor(v):
                    v.copy_(old[k]) if k in old else v.zero_()
                elif k in old:
                    st[k] = old[k]


def capture_step(step, state: TrainState, batch) -> _Captured:
    """Capture ``step(state, batch)`` (which returns ``(state, loss)``) as
    a CUDA graph on the current device.

    A warm-up call on a side stream first builds the kernels and the NCCL
    communicators and creates the optimizer state; it is then undone
    (:func:`_restore`), so the first replay is the state's next step.
    Every tensor of ``batch`` gets a static copy, which each call of the
    captured step refills (:func:`replay`)."""
    model, opt = state
    _check_capturable(opt)
    static = {k: v.clone() for k, v in batch.items()}
    params = [p.detach().clone() for p in model.parameters()]
    saved = _snapshot(opt)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(state, static)
    torch.cuda.current_stream().wait_stream(side)
    _restore(model, opt, params, saved)
    opt.zero_grad(set_to_none=True)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _, loss = step(state, static)
    return _Captured(graph, static, loss, _fixed(state))


def replay(captured: _Captured, state: TrainState, batch) -> torch.Tensor:
    """Copy ``batch`` into the captured step's static inputs, replay it and
    return a copy of its loss.  Raises ``ValueError`` where ``state`` has
    changed what the capture fixed (:func:`_fixed`)."""
    if not _same(_fixed(state), captured.fixed):
        raise ValueError(
            "the optimizer's hyperparameters or the parameters changed after the step "
            "was captured, and a replay would use the old ones, as jax.jit fixes its "
            "constants: give lr as a tensor and update it in place, or build a new "
            "train_step")
    for name, value in batch.items():
        captured.batch[name].copy_(value)
    captured.graph.replay()
    return captured.loss.clone()


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
    optax's: b1 0.9, b2 0.999, eps 1e-8; on a CUDA mesh with
    ``capturable=True``).  ``shard_batch(batch)`` gives this rank's rows
    of a global batch.  ``train_step(state, batch) -> (state, loss)``
    updates the state in place, where ``batch`` is a dict with ``features
    [B, T, F]``, ``feature_length [B]``, ``labels [B, L]`` and
    ``label_length [B]``, this rank's rows.

    The objective is the mean of the finite losses of the global batch
    (an infeasible sample's loss is +inf and its gradient 0): each rank
    differentiates its finite sum over the global finite count, and the
    gradients are summed over the data group.  ``loss`` is that mean,
    replicated.

    On a CUDA mesh ``train_step`` is the counterpart of the JAX package's
    ``jax.jit(train_step)``: the step (:func:`train_step_eager`: forward,
    backward, the data group's all-reduces and the optimizer step) is
    captured as one CUDA graph per state and key (the batch's shapes and
    dtypes and the kernel config, ``get_config()``; topology and blank are
    fixed here) by :func:`capture_step`, and each call replays it.  The
    capture fixes the parameters and the optimizer's hyperparameters: a
    replay after a change to them (a scheduler's Python ``lr``, a replaced
    parameter) raises ``ValueError``; a tensor ``lr`` updated in place is
    read at each replay.  The
    saturation guard runs inside the graph (its device form,
    ``ops/topology.py``).  A user ``optimizer`` must be capturable (Adam
    and its kin with ``capturable=True``), else the capture raises
    ``ValueError``.  On a CPU mesh the step runs eagerly.
    """
    cuda = mesh.device.type == "cuda"
    make_opt = optimizer or (lambda p: torch.optim.Adam(p, lr=learning_rate,
                                                        capturable=cuda))
    data_group = mesh.group(data_axis)
    graphs = weakref.WeakKeyDictionary()  # model -> optimizer -> {key: _Captured}

    def init_state(params: enc.Encoder) -> TrainState:
        local = _ShardedEncoder(params, mesh, data_axis, model_axis)
        return TrainState(local, make_opt(local.parameters()))

    def shard_batch(batch):
        return sharding.shard_batch(mesh, batch, data_axis)

    def eager(state: TrainState, batch) -> Tuple[TrainState, torch.Tensor]:
        return train_step_eager(state, batch, topology, blank_index, data_group)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, torch.Tensor]:
        if not cuda:
            return eager(state, batch)
        model, opt = state
        key = (get_config(),
               tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(batch.items())))
        by_key = graphs.setdefault(model, weakref.WeakKeyDictionary()).setdefault(opt, {})
        if key not in by_key:
            by_key[key] = capture_step(eager, state, batch)
        return state, replay(by_key[key], state, batch)

    return init_state, shard_batch, train_step
