"""Profiling / timing harness (port of `echoflow.utils.profiling`).

The reference's only instrumentation is wall-clock `tic/toc` prints. Here:
a step timer that waits for the device work of a step's result, a
throughput helper for the frames/sec north star, and a wrapper around
`torch.profiler` that writes a Chrome trace. Where echoflow calls
`jax.block_until_ready`, these wait on each CUDA device that holds a tensor
of the result (a CPU result is complete when it is returned).
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from dataclasses import dataclass, field


def _devices_of(result) -> set:
    """The CUDA devices of the tensors in a nested result."""
    import torch

    if isinstance(result, torch.Tensor):
        return {result.device} if result.device.type == "cuda" else set()
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (list, tuple)):
        return set().union(*(_devices_of(r) for r in result))
    return set()


def block_until_ready(result):
    """Wait until the device work that produces `result` (a tensor or a
    nested dict/list/tuple of them) is done; returns `result`."""
    import torch

    for device in _devices_of(result):
        torch.cuda.synchronize(device)
    return result


@dataclass
class StepTimer:
    """Collects step wall times; `summary()` gives mean/p50/p95 excluding
    warmup steps (the first calls build kernels and pick cuDNN algorithms)."""

    warmup: int = 1
    times: list = field(default_factory=list)

    @contextlib.contextmanager
    def step(self, result_to_block=None):
        t0 = time.perf_counter()
        yield
        if result_to_block is not None:
            block_until_ready(result_to_block)
        self.times.append(time.perf_counter() - t0)

    def summary(self) -> dict:
        import numpy as np

        steady = self.times[self.warmup:] or self.times
        arr = np.asarray(steady)
        return {
            "steps": len(self.times),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
        }


def measure_throughput(fn, args, items_per_call: int, iters: int = 10,
                       label: str = "throughput") -> dict:
    """Time `fn(*args)` with full synchronization; returns items/sec.
    `fn` returns tensors (waited on after the warm-up call and after the
    timed calls)."""
    block_until_ready(fn(*args))   # warm-up
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    block_until_ready(out)
    dt = (time.perf_counter() - t0) / iters
    result = {"label": label, "sec_per_call": dt,
              "items_per_sec": items_per_call / dt}
    print(json.dumps(result))
    return result


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """torch.profiler trace of the block (host, and the card where there is
    one), written as a Chrome trace to `log_dir`/trace.json (default: a
    directory under the system's temporary directory). Yields `log_dir`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "echoflow_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
