"""Host-to-device copies that do not wait for the device.

A pageable `tensor.to("cuda")` (or `torch.tensor(..., device="cuda")`)
waits for all work queued on the device before it copies, so one such copy
inside a forward or a train step stalls the host until the card is idle.
`upload` copies from pinned memory with `non_blocking=True` instead: the
copy is queued on the current stream behind the work already there, and the
pinned buffer is kept until the copy has run by PyTorch's host allocator.
"""

from __future__ import annotations

import functools

import torch

from echoflow_torch.utils.profiling import count


def upload(host: torch.Tensor, device) -> torch.Tensor:
    """`host` (a CPU tensor) on `device`; on CUDA without a synchronizing
    copy. A CPU device returns `host` itself."""
    device = torch.device(device)
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


def device_constant(maxsize: int):
    """`functools.lru_cache(maxsize)` for a function that makes a constant on
    a device, counting `device.constants` at each miss: a graph's capture
    refuses one (`utils/graphs`), whose copy would replay a host buffer."""
    def cached(fn):
        def made(*args):
            count("device.constants")
            return fn(*args)
        return functools.lru_cache(maxsize)(functools.wraps(fn)(made))
    return cached
