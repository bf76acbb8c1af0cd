"""Entry points: the flagship forward at a small shape, and a multi-rank dry
run of the training step.

Counterpart of the JAX repo's ``__graft_entry__.py``.

    python -m tf_seq2seq_losses_tpu_torch.entry [--cpu] [--ranks 4]

runs :func:`entry`'s forward (on the card unless ``--cpu``), then
:func:`dryrun_multichip`.
"""

from __future__ import annotations

import argparse
import datetime
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

_REPO = str(Path(__file__).resolve().parents[1])


def entry(device=None):
    """The flagship forward, encoder -> classic CTC loss, at a small shape.

    Returns ``(fn, example_args)``: ``fn(*example_args)`` is the loss
    ``[2]``; ``device`` defaults to CUDA."""
    from tf_seq2seq_losses_tpu_torch import classic_ctc_loss
    from tf_seq2seq_losses_tpu_torch.models import encoder as enc

    batch, num_t, feat, vocab = 2, 16, 8, 6
    params = enc.init_encoder(torch.Generator().manual_seed(0), num_features=feat,
                              hidden=32, vocab=vocab, num_layers=2, device=device)
    dev = params.head.w.device
    features = torch.as_tensor(
        np.random.RandomState(0).randn(batch, num_t, feat).astype(np.float32),
        device=dev)
    feature_length = torch.tensor([num_t, num_t - 4], device=dev)
    labels = torch.tensor([[1, 2, 3, 0], [2, 4, 0, 0]], device=dev)
    label_length = torch.tensor([3, 2], device=dev)

    def fn(params, features, feature_length, labels, label_length):
        logits = enc.apply_encoder(params, features)
        logit_length = enc.subsampled_length(feature_length)
        return classic_ctc_loss(labels, logits, label_length, logit_length, 0)

    return fn, (params, features, feature_length, labels, label_length)


def dryrun_multichip(n_devices: int, timeout: float = 300.0) -> None:
    """One DP x TP training step over ``n_devices`` ranks, then the
    data-parallel mean loss on the pure path and on the kernel path.

    PyTorch has no virtual devices: this spawns ``n_devices`` processes
    that join a gloo group on the CPU (a ``file://`` rendezvous in a
    temporary directory).  Each runs :func:`_dryrun_rank`: a step of
    ``make_train_step`` on the ``(n/2, 2)`` ``('data', 'model')`` mesh (or
    ``(n, 1)`` for odd ``n``), then ``sharded_mean_ctc_loss`` on a
    ``('data',)`` mesh, first on the pure path, then under
    ``config_override(use_kernels=True)``, where CPU tensors run the
    kernels' plain versions; the two agree to 1e-4 and the gradient is
    finite.  Raises ``RuntimeError`` with a failed rank's output."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_REPO, env.get("PYTHONPATH")) if p)
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{tmp}/rendezvous"
        procs = [subprocess.Popen(
            [sys.executable, "-m", "tf_seq2seq_losses_tpu_torch.entry", "--rank",
             str(rank), "--ranks", str(n_devices), "--init", init],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
            for rank in range(n_devices)]
        deadline = time.monotonic() + timeout
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(
                    timeout=max(deadline - time.monotonic(), 1.0))[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"dryrun rank {rank} failed:\n{out[-3000:]}")


def _dryrun_rank(init_method: str, n_devices: int, rank: int) -> None:
    import torch.distributed as dist

    from tf_seq2seq_losses_tpu_torch.models import encoder as enc
    from tf_seq2seq_losses_tpu_torch.parallel import (
        init_distributed,
        make_mesh,
        make_train_step,
        shard_batch,
        sharded_mean_ctc_loss,
    )
    from tf_seq2seq_losses_tpu_torch.utils.config import config_override

    cpu = torch.device("cpu")
    init_distributed(init_method, n_devices, rank, device=cpu,
                     timeout=datetime.timedelta(seconds=60))
    try:
        model_dim = 2 if n_devices % 2 == 0 else 1
        data_dim = n_devices // model_dim
        mesh = make_mesh((data_dim, model_dim), ("data", "model"), device=cpu)
        batch, num_t, feat, vocab = 2 * data_dim, 16, 8, 6
        params = enc.init_encoder(torch.Generator().manual_seed(0), num_features=feat,
                                  hidden=8 * model_dim, vocab=vocab, num_layers=2,
                                  device=cpu)
        rng = np.random.RandomState(0)
        batch_data = {
            "features": rng.randn(batch, num_t, feat).astype(np.float32),
            "feature_length": np.full((batch,), num_t, np.int32),
            "labels": rng.randint(1, vocab, (batch, 4)).astype(np.int32),
            "label_length": np.full((batch,), 3, np.int32),
        }
        init_state, shard, train_step = make_train_step(mesh, learning_rate=1e-2)
        _, loss = train_step(init_state(params), shard(batch_data))
        if not bool(torch.isfinite(loss)):
            raise RuntimeError(f"multichip dryrun loss not finite: {loss}")

        dp_mesh = make_mesh((n_devices,), ("data",), device=cpu)
        rows = 2 * n_devices
        labels = rng.randint(1, 5, (rows, 3)).astype(np.int32)
        local = shard_batch(dp_mesh, (labels, np.zeros((rows, 6, 5), np.float32),
                                      np.full((rows,), 3), np.full((rows,), 6)))
        mean_loss = sharded_mean_ctc_loss(dp_mesh)(*local)
        with config_override(use_kernels=True):
            logits = local[1].clone().requires_grad_(True)
            kernel_loss = sharded_mean_ctc_loss(dp_mesh)(local[0], logits, *local[2:])
            kernel_loss.backward()
        if not bool(torch.isfinite(kernel_loss)):
            raise RuntimeError("kernel-path dryrun loss not finite")
        if abs(float(kernel_loss) - float(mean_loss)) >= 1e-4:
            raise RuntimeError(f"kernel path disagrees with pure path: "
                               f"{float(kernel_loss)} vs {float(mean_loss)}")
        if not bool(torch.isfinite(logits.grad).all()):
            raise RuntimeError("kernel-path dryrun gradient not finite")
    finally:
        dist.destroy_process_group()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--init", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.rank is not None:
        _dryrun_rank(args.init, args.ranks, args.rank)
        return 0
    fn, fn_args = entry("cpu" if args.cpu else None)
    print("entry loss:", fn(*fn_args).tolist())
    dryrun_multichip(args.ranks)
    print(f"dryrun_multichip({args.ranks}) OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
