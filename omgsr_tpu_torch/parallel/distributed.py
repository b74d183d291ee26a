"""Multi-process bootstrap: one process per GPU under ``torchrun``.

    torchrun --nproc_per_node=8 -m omgsr_tpu_torch.cli.infer_omgsr_f --shard tp ...
    torchrun --nproc_per_node=8 -m omgsr_tpu_torch.cli.train_omgsr_s --config cfg.yml "mesh_shape={data: 8}"

``initialize`` forms the default process group from torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``)
or from explicit arguments: NCCL for CUDA devices, gloo for the CPU. Every
group gets a finite timeout, so a rank that dies ends the others' collectives
in an error instead of a hang. The collectives of the sharded paths go
through the small wrappers below, which take the group they run on; those of
a data-parallel train step (``broadcast_tree`` of the initial state,
``all_reduce_mean_tree`` of the gradients and metrics) are written here by
hand, since the trainers take their gradients with ``torch.autograd.grad``
over trees of tensors that no ``DistributedDataParallel`` module sees.
"""

from __future__ import annotations

import datetime
import logging
import os

import torch
import torch.distributed as dist

from omgsr_tpu_torch.utils.tree import flatten_dict, unflatten_dict

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


def barrier(group=None):
    """Every rank of ``group`` (default: the world) waits for the others;
    a no-op without a process group."""
    if dist.is_initialized():
        dist.barrier(group=group)


def broadcast_object(obj, src: int = 0, group=None):
    """``obj`` of rank ``src`` (a picklable value) on every rank of the group."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def _flat_views(buf: torch.Tensor, leaves: list[torch.Tensor]) -> list[torch.Tensor]:
    """``buf`` cut into one view per leaf, of the leaf's shape."""
    return [part.view(t.shape) for part, t in zip(buf.split([t.numel() for t in leaves]), leaves)]


def broadcast_tree(tree, src: int = 0, group=None):
    """In place: every tensor of ``tree`` takes the values of rank ``src`` of
    ``group`` (default: the world), one
    broadcast per dtype of one flat buffer. Non-tensor leaves (step counters)
    are left as they are: every rank counts them alike. Returns ``tree``."""
    by_dtype: dict = {}
    for t in flatten_dict(tree).values():  # the same order on every rank that built the tree alike
        if isinstance(t, torch.Tensor):
            by_dtype.setdefault(t.dtype, []).append(t.detach())
    with torch.no_grad():
        for dtype, ts in by_dtype.items():
            flat = torch.empty(sum(t.numel() for t in ts), dtype=dtype, device=ts[0].device)
            views = _flat_views(flat, ts)
            torch._foreach_copy_(views, ts)
            dist.broadcast(flat, group=group, group_src=src)
            torch._foreach_copy_(ts, views)
    return tree


def all_reduce_mean_tree(tree, group):
    """A new tree of the same structure: the mean of every leaf over the
    group. One all-reduce of one flat f32 buffer, divided by the group size,
    each leaf cast back to its dtype and strides (a bf16 gradient is rounded
    once, after the sum; on one rank the mean is the leaf, bit for bit). The
    copies in and out are one multi-tensor launch each: a LoRA tree has
    hundreds of leaves."""
    flat = flatten_dict(tree)
    leaves = [v.detach() for v in flat.values()]
    with torch.no_grad():
        buf = torch.empty(sum(t.numel() for t in leaves), dtype=torch.float32, device=leaves[0].device)
        views = _flat_views(buf, leaves)
        torch._foreach_copy_(views, leaves)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        buf /= dist.get_world_size(group)
        # in each leaf's own strides (a conv gradient is channels-last): a norm over the mean then
        # sums in the order it sums over the leaf
        means = [torch.empty_like(t) for t in leaves]
        torch._foreach_copy_(means, views)
    return unflatten_dict(dict(zip(flat, means)))
