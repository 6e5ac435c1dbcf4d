"""The process group of the learner's ranks, and the counts they share.

Counterpart of ``pydreamer_tpu/parallel/multihost.py:31-85``. JAX runs one
process per host, and that process drives every device of the host. The port
runs one process (rank) per device, as PyTorch does, so a host holds several
ranks:

  * ``maybe_initialize_distributed()`` initializes ``torch.distributed`` from
    torch's standard environment (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, as ``torchrun`` sets them), in
    place of JAX's ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
    ``JAX_PROCESS_ID``. Ranks on one host may meet through a file instead of
    a TCP port: ``PYDREAMER_DIST_INIT_FILE`` names a new file that every rank
    can reach (torch's ``file://`` rendezvous). That needs no free port, so no
    other process can take the address between its choice and its use; the
    port's launcher does so on one node. It initializes at
    ``WORLD_SIZE=1`` too, so the distributed path runs on a single card. On the
    card the backend is ``cpu:gloo,cuda:nccl``: host tensors (the replay
    counts, the stop decisions) go through gloo and the gradients through NCCL;
    on the CPU it is gloo;
  * metrics, checkpoints and evals are the main process's (``is_main_process``);
  * ``local_batch_size`` divides the global batch by the *data ranks*: one
    rank holds one device's share;
  * JAX's ``host_batch_to_global`` has no counterpart. It assembles a global
    array from each host's slice; here each rank keeps its local
    ``(T, B_local, ...)`` slice, and that slice is its shard.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from ..tools import logger

__all__ = ["maybe_initialize_distributed", "INIT_FILE_ENV", "is_main_process", "rank",
           "world_size", "local_rank", "local_world_size", "local_batch_size", "global_sum",
           "global_any", "COLLECTIVE_TIMEOUT"]

# Ranks wait at their next collective while rank 0 alone writes a checkpoint
# or runs the eval protocol: the timeout must outlast an eval at full width.
COLLECTIVE_TIMEOUT = timedelta(minutes=30)

# Names a file for the ranks' rendezvous in place of MASTER_ADDR / MASTER_PORT.
INIT_FILE_ENV = "PYDREAMER_DIST_INIT_FILE"


def maybe_initialize_distributed(device_type: str = "cuda") -> bool:
    """Initialize the process group when the environment names one, and say
    whether a group is active.

    A group that exists already is kept (JAX's ``already`` check,
    multihost.py:44), so a caller may start one itself. ``device_type`` is
    where the learner runs: ``"cuda"`` binds the rank to ``cuda:LOCAL_RANK``
    and uses NCCL for device tensors; ``"cpu"`` uses gloo alone.
    """
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    if device_type == "cuda":
        torch.cuda.set_device(local_rank())
        backend = "cpu:gloo,cuda:nccl"
    else:
        backend = "gloo"
    init_file = os.environ.get(INIT_FILE_ENV)
    dist.init_process_group(backend=backend,
                            init_method=f"file://{init_file}" if init_file else "env://",
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]), timeout=COLLECTIVE_TIMEOUT)
    logger.info("Distributed: rank %d/%d (local rank %d), backend %s", rank(), world_size(),
                local_rank(), backend)
    return True


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    """The rank's index on its host (``LOCAL_RANK``; the rank on one host)."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def local_world_size() -> int:
    """Ranks on this host (``LOCAL_WORLD_SIZE``; every rank on one host)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world_size()))


def is_main_process() -> bool:
    return rank() == 0


def local_batch_size(global_batch: int, n_data: Optional[int] = None) -> int:
    """The rank's share of the batch: ``global_batch / n_data`` (every rank a
    data rank when ``n_data`` is None); the batch must divide evenly."""
    n = world_size() if n_data is None else n_data
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} data ranks")
    return global_batch // n


def global_sum(x) -> int:
    """Sum of a host count over every rank (JAX trainer.py:78-84), through
    gloo on a host tensor. A collective: every rank calls it at the same point."""
    if not dist.is_initialized():
        return int(x)
    t = torch.tensor([int(x)], dtype=torch.int64)
    dist.all_reduce(t)
    return int(t.item())


def global_any(flag: bool) -> bool:
    """Whether any rank's ``flag`` is set (an all-reduce MAX), so that a
    decision one rank makes is taken by all. A collective."""
    if not dist.is_initialized():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())
