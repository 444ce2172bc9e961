"""Data parallelism over torch.distributed (port of `echoflow.parallel.mesh`).

echoflow's parallelism is a 1-D `data` mesh: the batch is sharded over the
devices, the state is replicated, and XLA inserts the gradient all-reduce.
The port runs one process per device instead (`torchrun`, or
`parallel/launch.run_ranks`): each rank holds a replica of the state and
takes its contiguous shard of every global batch, which is the layout
`PartitionSpec("data")` gives. `train/loop.fit_on_mesh` does the rest
(DistributedDataParallel, global BatchNorm, the batch-coupled loss terms).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def data_devices(num_devices: int | None = None, devices=None) -> list[torch.device]:
    """The devices of a data-parallel run (echoflow's `data_mesh`): `devices`
    as torch devices, or every local card (the first `num_devices`), or on a
    machine without a card `num_devices` times the CPU (default once). A
    CUDA device that is not there raises."""
    if devices is None:
        if torch.cuda.is_available():
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
            if num_devices is not None:
                if num_devices > len(devices):
                    raise RuntimeError(f"data_devices: {num_devices} devices asked, "
                                       f"{len(devices)} cards present")
                devices = devices[:num_devices]
        else:
            devices = ["cpu"] * (num_devices or 1)
    out = [torch.device(d) for d in devices]
    for dev in out:
        if dev.type == "cuda":
            index = 0 if dev.index is None else dev.index
            if not torch.cuda.is_available() or index >= torch.cuda.device_count():
                raise RuntimeError(f"data_devices: no CUDA device {dev}")
        elif dev.type != "cpu":
            raise ValueError(f"data_devices: cpu or cuda devices, got {dev}")
    return out


def init_distributed(init_method: str | None = None, world_size: int | None = None,
                     rank: int | None = None, backend: str | None = None) -> bool:
    """Join the default process group (echoflow's multi-host init). Under an
    existing group this does nothing; without `init_method` it reads
    torchrun's environment (`env://` when RANK and WORLD_SIZE are set) and
    in a single process does nothing. The backend is NCCL where there is a
    card and gloo on the CPU. Returns whether a group is up; a failed
    initialization raises."""
    if dist.is_initialized():
        return True
    if init_method is None:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            return False
        init_method = "env://"
    if init_method != "env://" and (world_size is None or rank is None):
        raise ValueError("init_distributed: world_size and rank go with an init_method")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    sizes = {} if init_method == "env://" else {"world_size": world_size, "rank": rank}
    dist.init_process_group(backend, init_method=init_method, **sizes)
    return True


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        out = tensor.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(tensor: torch.Tensor, group) -> torch.Tensor:
    """The sum of `tensor` over the ranks of `group`, with autograd: its
    backward sums the ranks' upstream gradients, so each rank gets the
    gradient of the sum of every rank's objective. Neither direction waits
    for the device."""
    return _AllReduceSum.apply(tensor, group)


def host_shard_indices(total: int, process_index: int | None = None,
                       process_count: int | None = None) -> range:
    """Contiguous per-rank slice of a dataset of `total` items: rank i gets
    items [i*chunk, min((i+1)*chunk, total)), chunk = ceil(total / count).
    The rank and count default to the default group's (0 and 1 without
    one)."""
    up = dist.is_initialized()
    pi = (dist.get_rank() if up else 0) if process_index is None else process_index
    pc = (dist.get_world_size() if up else 1) if process_count is None else process_count
    chunk = -(-total // pc)
    return range(pi * chunk, min((pi + 1) * chunk, total))


def shard_batch(batch: dict, rank: int, world: int) -> dict:
    """Rank `rank`'s rows of every array in `batch` (leading axis the batch
    B): rows [rank*B/W, (rank+1)*B/W), the `P("data")` layout. B must be a
    multiple of W, as jax requires of an even sharding."""
    out = {}
    for key, value in batch.items():
        n = value.shape[0]
        if n % world:
            raise ValueError(f"shard_batch: {key} has {n} rows, not a multiple of "
                             f"{world} ranks")
        per = n // world
        out[key] = value[rank * per:(rank + 1) * per]
    return out
