"""Multi-process bootstrap: one process per GPU under ``torchrun``.

    torchrun --nproc_per_node=8 -m omgsr_tpu_torch.cli.infer_omgsr_f --shard tp ...

``initialize`` forms the default process group from torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``)
or from explicit arguments: NCCL for CUDA devices, gloo for the CPU. Every
group gets a finite timeout, so a rank that dies ends the others' collectives
in an error instead of a hang. The collectives of the sharded paths go
through the small wrappers below, which take the group they run on.
"""

from __future__ import annotations

import datetime
import logging
import os

import torch
import torch.distributed as dist

logger = logging.getLogger("omgsr_tpu_torch.distributed")

DEFAULT_TIMEOUT_S = 600.0


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *, device="cuda", backend: str | None = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Form the default process group once; later calls return at once.

    ``coordinator_address`` is ``host:port`` of rank 0's TCP store (default:
    ``MASTER_ADDR:MASTER_PORT``), ``num_processes`` the world size (default
    ``WORLD_SIZE``), ``process_id`` this rank (default ``RANK``). One process
    that names no coordinator is a no-op: nothing is formed and the caller
    runs unsharded. On a CUDA device the process takes ``cuda:LOCAL_RANK``
    (default: the rank) before the group forms. ``backend`` overrides the
    choice (NCCL for CUDA, gloo for the CPU). Returns whether a group exists."""
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    world = int(num_processes if num_processes is not None else env.get("WORLD_SIZE", 1))
    if coordinator_address is None and world == 1:
        return False
    if coordinator_address is None:
        raise ValueError(f"a world of {world} processes needs a coordinator address (host:port)")
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)) if device.index is None else device.index)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    logger.info("torch.distributed initialized: rank %d of %d over %s", rank, world, backend)
    return True


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def local_device(device="cuda") -> torch.device:
    """``device`` with this process's card: a bare "cuda" becomes the
    current device that ``initialize`` set."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return device


def shutdown():
    if dist.is_initialized():
        dist.destroy_process_group()


# ----------------------------------------------------------------------------
# collectives on a group (a tensor on the group's device: CUDA for NCCL)
# ----------------------------------------------------------------------------


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """In place, and returned: the elementwise sum or max over the group."""
    dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op], group=group)
    return t


def all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``t`` (equal shapes), in rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return parts


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order."""
    return torch.cat(all_gather(t, group), dim=dim)
