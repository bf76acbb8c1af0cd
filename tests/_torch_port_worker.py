"""One rank of a multi-rank run of the port's parallel layer on gloo (see
test_torch_port_parallel.py).

    python tests/_torch_port_worker.py CASE INIT_URL WORLD RANK IN.pt OUT_DIR

Joins a gloo group at ``INIT_URL`` (a ``file://`` rendezvous) with a
60 s timeout, runs ``CASE`` on the inputs that the test saved to
``IN.pt``, and saves this rank's results to ``OUT_DIR/rank{RANK}.pt``.
Imports PyTorch and the port only.
"""

import datetime
import sys

import torch
import torch.distributed as dist

from tf_seq2seq_losses_tpu_torch.models import encoder as enc
from tf_seq2seq_losses_tpu_torch.parallel import (
    init_distributed,
    make_mesh,
    make_train_step,
    shard_batch,
    sharded_ctc_loss,
    sharded_mean_ctc_loss,
    sharding,
)

CPU = torch.device("cpu")


def _encoder(spec):
    model = enc.Encoder(*spec["dims"], device=CPU)
    model.load_state_dict(spec["state"])
    return model


def _train(spec, mesh, model_axis):
    init_state, shard, train_step = make_train_step(
        mesh, model_axis=model_axis,
        optimizer=lambda p: torch.optim.SGD(p, lr=spec["lr"]))
    state = init_state(_encoder(spec))
    local = shard(spec["batch"])
    losses = [train_step(state, local)[1] for _ in range(spec["steps"])]
    return {"losses": torch.stack(losses),
            "params": {k: v.clone() for k, v in state.params.state_dict().items()}}


def data_parallel(spec, world):
    """sharded_ctc_loss, sharded_mean_ctc_loss and its d_logits on a
    ('data',) mesh, then ``steps`` DP training steps."""
    mesh = make_mesh((world,), ("data",), device=CPU)
    labels, logits, label_length, logit_length = shard_batch(mesh, spec["loss_inputs"])
    logits = logits.clone().requires_grad_(True)
    rows = sharded_ctc_loss(mesh)(labels, logits, label_length, logit_length)
    mean = sharded_mean_ctc_loss(mesh)(labels, logits, label_length, logit_length)
    mean.backward()
    return {"rows": rows.detach(), "mean": mean.detach(), "d_logits": logits.grad,
            **_train(spec, mesh, None)}


def func(spec, world):
    """The sharded losses and collectives under ``torch.func`` on a
    ('data',) mesh: ``grad_and_value`` of ``sharded_mean_ctc_loss``;
    ``vmap`` of ``sharded_ctc_loss``, of ``sharded_mean_ctc_loss`` and of
    its ``grad`` over the groups of ``spec["groups"]``, and the same calls
    group by group; ``vmap`` of ``gather_last_dim`` (mapped at dims 0 and
    1) and of ``grad`` through ``copy_to``, and their loops."""
    mesh = make_mesh((world,), ("data",), device=CPU)
    group = mesh.group("data")
    args = shard_batch(mesh, spec["loss_inputs"])
    mean_fn = sharded_mean_ctc_loss(mesh)
    rows_fn = sharded_ctc_loss(mesh)
    d_logits, mean = torch.func.grad_and_value(mean_fn, argnums=1)(*args)
    groups = [shard_batch(mesh, g) for g in spec["groups"]]
    stacked = [torch.stack([g[i] for g in groups]) for i in range(4)]
    grad_fn = torch.func.grad(mean_fn, argnums=1)
    out = {"mean": mean, "d_logits": d_logits}
    for name, fn in (("rows", rows_fn), ("means", mean_fn), ("grads", grad_fn)):
        out[name] = torch.func.vmap(fn)(*stacked)
        out[name + "_loop"] = torch.stack([fn(*g) for g in groups])
    x = torch.randn(len(groups), 3, 4, generator=torch.Generator().manual_seed(
        dist.get_rank()))
    gather = lambda v: sharding.gather_last_dim(v, group)  # noqa: E731
    out["gathered"] = torch.func.vmap(gather)(x)
    out["gathered_dim1"] = torch.func.vmap(gather, in_dims=1)(x.transpose(0, 1))
    out["gathered_loop"] = torch.stack([gather(v) for v in x])
    weight = torch.linspace(-1.0, 1.0, 4)
    copy_grad = torch.func.grad(
        lambda v: (sharding.copy_to(v, group) * weight).sum())
    out["copy_grads"] = torch.func.vmap(copy_grad)(x)
    out["copy_grads_loop"] = torch.stack([copy_grad(v) for v in x])
    return out


def dp_tp(spec, world):
    """``steps`` training steps on the (world/2, 2) ('data', 'model') mesh."""
    mesh = make_mesh((world // 2, 2), ("data", "model"), device=CPU)
    return _train(spec, mesh, "model")


def main():
    case, url, world, rank, in_path, out_dir = sys.argv[1:]
    world, rank = int(world), int(rank)
    init_distributed(url, world, rank, device=CPU,
                     timeout=datetime.timedelta(seconds=60))
    spec = torch.load(in_path)
    out = {"data_parallel": data_parallel, "dp_tp": dp_tp, "func": func}[case](spec, world)
    torch.save(out, f"{out_dir}/rank{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
