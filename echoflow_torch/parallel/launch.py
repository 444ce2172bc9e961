"""Run a function on W ranks of a fresh process group, one spawned process
each (the in-program counterpart of `torchrun`).

The ranks meet at a `file://` store in a new temporary directory, so two
launches on one machine never collide on a port. `fn` must be a
module-level function of an importable module (a spawned child re-imports
it): `fn(rank, world, *args)` runs after the default group is up and its
result, picklable, comes back to the caller. A rank that raises, or a
launch that outlives `timeout`, fails the launch; every process is gone
when `run_ranks` returns or raises.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import tempfile
import time
import traceback
from datetime import timedelta


def _rank_main(fn, rank, world, backend, init_method, threads, results, args):
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(threads)
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(backend, init_method=init_method, world_size=world,
                                rank=rank, timeout=timedelta(seconds=300))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:   # reported to the parent, which fails the launch
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, *args, backend: str = "gloo", timeout: float = 600.0,
              threads: int = 2) -> list:
    """[fn(0, world, *args), ..., fn(world - 1, world, *args)], each run in
    its own spawned process of a `backend` group (gloo on the CPU; NCCL with
    rank r on `cuda:r`), with `threads` intra-op threads a rank."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, rank, world, backend, init, threads, results, args))
                 for rank in range(world)]
        for p in procs:
            p.start()
        out: dict = {}
        deadline = time.monotonic() + timeout
        finished = False
        try:
            while len(out) < world:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"run_ranks: {world - len(out)} of {world} ranks of "
                                       f"{fn.__name__} did not finish in {timeout:.0f} s")
                try:
                    rank, ok, payload = results.get(timeout=min(remaining, 1.0))
                except queue_mod.Empty:
                    dead = [i for i, p in enumerate(procs) if p.exitcode not in (None, 0)
                            and i not in out]
                    if dead:
                        raise RuntimeError(f"run_ranks: rank(s) {dead} of {fn.__name__} "
                                           "exited without a result") from None
                    continue
                if not ok:
                    raise RuntimeError(f"run_ranks: rank {rank} of {fn.__name__} "
                                       f"failed:\n{payload}")
                out[rank] = payload
            finished = True
        finally:
            # After a failure the other ranks may wait in a collective: end them.
            for p in procs:
                if finished:
                    p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                p.join()
    return [out[r] for r in range(world)]
