"""Distributed layer of the port: rank mesh, sharded losses, the DP x TP
training step, multi-process initialisation."""

from tf_seq2seq_losses_tpu_torch.parallel.distributed import (
    global_mesh,
    host_local_batch_to_global,
    init_distributed,
    is_primary,
)
from tf_seq2seq_losses_tpu_torch.parallel.sharding import (
    make_mesh,
    shard_batch,
    sharded_ctc_loss,
    sharded_mean_ctc_loss,
)
from tf_seq2seq_losses_tpu_torch.parallel.train import (
    TrainState,
    make_train_step,
    param_shardings,
    train_step_eager,
)

__all__ = [
    "init_distributed",
    "is_primary",
    "global_mesh",
    "host_local_batch_to_global",
    "make_mesh",
    "shard_batch",
    "sharded_ctc_loss",
    "sharded_mean_ctc_loss",
    "TrainState",
    "make_train_step",
    "param_shardings",
    "train_step_eager",
]
