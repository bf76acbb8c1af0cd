"""Multi-process initialisation and host-local batch plumbing.

Counterpart of ``tf_seq2seq_losses_tpu/parallel/distributed.py``.  One
process per card (or per CPU rank), wired into one process group by
:func:`init_distributed`; a mesh over the whole world (:func:`global_mesh`)
then names the groups that the collectives of ``sharding.py`` and
``train.py`` run over.  NCCL carries them between cards, gloo between CPU
processes.

A single-process run is the degenerate case: with nothing configured,
:func:`init_distributed` is a no-op returning ``False``, and every helper
below collapses to its local meaning.
"""

from __future__ import annotations

import datetime
import os
import warnings
from typing import Optional

import torch
import torch.distributed as dist

from tf_seq2seq_losses_tpu_torch.parallel import sharding


def _launcher_env() -> bool:
    """Whether a launcher (torchrun) configured a multi-process run."""
    return (int(os.environ.get("WORLD_SIZE", "1")) > 1
            and "RANK" in os.environ and "MASTER_ADDR" in os.environ)


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    timeout: Optional[datetime.timedelta] = None,
) -> bool:
    """Join this process to the run's process group when one is configured.

    Returns ``True`` iff the run is multi-process (after initialisation).

    ``device`` (default CUDA) picks the backend: NCCL for CUDA, gloo for
    the CPU; with CUDA, the process takes the card ``LOCAL_RANK`` (else its
    rank modulo the cards) and NCCL starts at once, so a failure shows here.

    Configuration sources, in order:

    * the explicit arguments (``coordinator_address``: a ``tcp://`` or
      ``file://`` URL, or ``host:port``);
    * a launcher's environment (torchrun's ``WORLD_SIZE`` > 1, ``RANK``,
      ``MASTER_ADDR``);
    * ``CTC_TPU_COORDINATOR``, ``CTC_TPU_NUM_PROCESSES`` and
      ``CTC_TPU_PROCESS_ID``.

    With no configuration this is a no-op.  A configured run (arguments or
    ``CTC_TPU_*``) whose initialisation fails re-raises: running it
    single-process would corrupt a real job.  Only a launcher-detected one
    warns and goes on single-process.
    """
    device = torch.device("cuda" if device is None else device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if dist.is_initialized():
        return dist.get_world_size() > 1
    auto = coordinator_address is None and _launcher_env()
    if coordinator_address is None and not auto:
        coordinator_address = os.environ.get("CTC_TPU_COORDINATOR")
        if coordinator_address is None:
            return False  # single-process run: nothing to initialise
    if auto:
        kwargs = {"init_method": "env://"}
        rank = int(os.environ["RANK"])
    else:
        if num_processes is None and os.environ.get("CTC_TPU_NUM_PROCESSES"):
            num_processes = int(os.environ["CTC_TPU_NUM_PROCESSES"])
        if process_id is None and os.environ.get("CTC_TPU_PROCESS_ID"):
            process_id = int(os.environ["CTC_TPU_PROCESS_ID"])
        if num_processes is None or process_id is None:
            raise ValueError("a configured run needs num_processes and process_id")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        kwargs = {"init_method": url, "world_size": num_processes, "rank": process_id}
        rank = process_id
    if timeout is not None:
        kwargs["timeout"] = timeout
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    try:
        dist.init_process_group(backend, **kwargs)
    except (RuntimeError, ValueError) as e:
        if not auto:
            raise
        warnings.warn(
            f"init_distributed(): init_process_group failed ({e}); continuing "
            "single-process.",
            stacklevel=2,
        )
        return False
    return dist.get_world_size() > 1


def is_primary() -> bool:
    """True on the process that should own logging and checkpoint IO: rank
    0, or the only process when there is no process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def global_mesh(axis_names=("data",), axis_shapes=None, device=None) -> sharding.Mesh:
    """Mesh over every rank of the run (call after :func:`init_distributed`);
    ``device`` as :func:`sharding.make_mesh` takes it."""
    return sharding.make_mesh(axis_shapes, axis_names, device)


def host_local_batch_to_global(mesh: sharding.Mesh, tree, data_axis: str = "data"):
    """The batch of this process's rank, from the rows it loaded.

    As in the JAX package, each process passes only its data group's
    samples (``global_batch / data_size`` of them, batch-major; processes
    that share a ``data_axis`` coordinate pass the same rows), and the
    global batch is their concatenation over the data groups.  Under data
    parallelism each rank computes on exactly those rows, so no array is
    assembled: they are placed on the rank's device, as they are."""
    return sharding.tree_map(
        lambda x: torch.as_tensor(x, device=mesh.device), tree)
