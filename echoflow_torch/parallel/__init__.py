"""Data parallelism over torch.distributed (port of `echoflow.parallel`)."""

from echoflow_torch.parallel.mesh import (  # noqa: F401
    all_reduce_sum,
    data_devices,
    host_shard_indices,
    init_distributed,
    shard_batch,
)
