"""Data-parallel train traffic: the port's CLAS-FV train step as
`train.loop.fit_on_mesh` runs it, one process a card (`ranks` NCCL ranks
through `parallel/launch.run_ranks`; gloo ranks on the CPU), each rank on
its contiguous shard of every global batch of `batch` samples
(`parallel.shard_batch`): `loop.data_parallel`'s state (rank 0's weights
broadcast, global BatchNorm, the gradients in one flat buffer averaged by
one all-reduce after the backward) and `compiled_steps`' CUDA graphs of
`make_train_step()`.

Traffic parameters: `drivers/train.py`'s, `batch` the global batch, and
`ranks`. The ranks run their steps in lockstep: before each step of the
window rank 0 tells every rank, over a gloo group of its own, whether one
more step runs (rank 0 runs the window by its clock, or the traced
session under the profiler; the other ranks follow it untraced).

End-to-end: train_step_ms (rank 0's window wall, ended at a device
synchronize, over its steps), peak_reserved_gib (the largest over the
ranks), setup_s (to rank 0's window). Checked on rank 0, after the window
and with the program's state freed, against the reference's steps on the
whole global batch on one device (`reference/steps.r2plus1d_forward`,
`drivers/train_ref.py`): the step data parallelism claims to be. The
readers read rank 0's trace and program spans, which rank 0 hands back.
"""

from __future__ import annotations

import gc
import math
import time
from collections import deque

import torch
from torch.profiler import record_function

from portbench import flops, peaks
from portbench.drivers import train_ref
from portbench.drivers.train import _cycle, _norms, make_batches, make_state_of_port
from portbench.harness import Outcome, print_setup
from portbench.reference.steps import r2plus1d_forward
from portbench.trace import traced
from portbench.weights import make_state

# A launch's ranks must finish in this many seconds (set-up, window,
# reference), or the run fails.
RANK_TIMEOUT_S = 1800


def rank_run(rank, world, cell):
    """One rank's run (module docstring); rank 0's result carries the
    readings, the others' their memory peak."""
    import torch.distributed as dist

    from echoflow_torch.parallel.mesh import shard_batch
    from echoflow_torch.train.loop import compiled_steps, data_parallel, prefetch_to_device

    device = torch.device("cuda", rank) if cell.device == "cuda" else torch.device("cpu")
    t = cell.traffic
    marks = [("ranks up", time.perf_counter())]
    batches = make_batches(cell)
    marks.append(("batches", time.perf_counter()))
    checked = batches[:t["check_steps"]]
    state = data_parallel(make_state_of_port(cell, device))
    step, _ = compiled_steps(state)
    lockstep = dist.new_group(backend="gloo")
    marks.append(("state, the CUDA context and the groups", time.perf_counter()))
    feed = prefetch_to_device((shard_batch(b, rank, world) for b in _cycle(batches)), device)
    params = dict(state.model.named_parameters())
    start = {k: v.detach().clone() for k, v in params.items()}
    losses, first = [], None
    for i in range(t["check_steps"]):
        state, m = step(state, next(feed))
        losses.append(m["loss"])
        if i == 0:   # Adam's first moment after one step is (1 - beta1) x the gradient
            opt = state.optimizer
            moments = {k: opt.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                       for k, p in params.items()}
            first = _norms({k: m / (1 - opt.defaults["betas"][0]) for k, m in moments.items()})
    change = _norms({k: params[k].detach() - start[k] for k in params})
    port_losses = torch.stack(losses).cpu().tolist()
    del start
    if device.type == "cuda":
        torch.cuda.synchronize()
    marks.append(("checked steps (warm-up, capture, replay)", time.perf_counter()))
    setup_s = time.perf_counter() - cell.t0

    window_losses, inflight, sessions = [], deque(), []
    go = torch.zeros(1, dtype=torch.int32)

    def more(flag: bool) -> bool:
        """Rank 0's `flag`, on every rank."""
        go.fill_(int(flag))
        dist.broadcast(go, src=0, group=lockstep)
        return bool(go.item())

    def one_step():
        nonlocal state
        with record_function("portbench.step"):
            state, m = step(state, next(feed))
        window_losses.append(m["loss"])
        if device.type == "cuda":
            inflight.append(torch.cuda.Event())
            inflight[-1].record()
            if len(inflight) > t["in_flight"]:
                with record_function("portbench.wait"):
                    inflight.popleft().synchronize()

    def session():
        sessions.append(len(window_losses))
        for _ in range(t["trace_steps"]):
            more(True)
            one_step()

    trace = snap = None
    t0 = time.perf_counter()
    if rank != 0:
        while more(False):
            one_step()
    elif cell.trace:
        trace, _ = traced(session)
        more(False)
    else:
        deadline = t0 + cell.seconds
        while more(time.perf_counter() < deadline):
            one_step()
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_reserved(device) if device.type == "cuda" else 0
    if rank == 0 and trace is not None:
        from portbench import spans

        ctx = {"trace": trace}
        snap = spans.program(ctx)
    finite = [math.isfinite(v) for v in torch.stack(window_losses).cpu().tolist()]
    steps = len(window_losses)
    del step, state, feed, params, inflight
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if rank != 0:
        return {"peak": peak}
    ref = train_ref.reference(cell, checked, device, r2plus1d_forward, make_state)
    return {"peak": peak, "marks": marks, "setup_s": setup_s, "wall": wall, "steps": steps,
            "failed": finite.count(False), "trace": trace, "program_spans": snap,
            "traced_steps": steps - (sessions[-1] if sessions else 0),
            "checks": train_ref.compare(ref, port_losses, first, change)}


def run(cell):
    t = cell.traffic
    if cell.control:
        checked = make_batches(cell)[:t["check_steps"]]
        checks = train_ref.control(cell, checked, torch.device(cell.device), r2plus1d_forward,
                                   make_state)
        return Outcome(len(checked), 0, {}, checks)
    from echoflow_torch.parallel.launch import run_ranks
    from portbench.drivers import train_dp   # by a name the ranks' processes import

    results = run_ranks(train_dp.rank_run, t["ranks"], cell,
                        backend="nccl" if cell.device == "cuda" else "gloo",
                        timeout=RANK_TIMEOUT_S)
    lead = results[0]
    print_setup(cell.t0, lead["marks"])
    peak = max(r["peak"] for r in results)
    metrics = {"setup_s": lead["setup_s"], "peak_reserved_gib": peak / 2**30,
               "train_step_ms": lead["wall"] / lead["steps"] * 1e3}
    cfg, trace = cell.config, lead["trace"]
    context = {"trace": trace, "config": cfg, "traffic": t, "steps": lead["traced_steps"],
               "step_flops": flops.clip_flops(cfg, train=True) * t["batch"] // t["ranks"],
               "peak_flops": peaks.MODEL_PEAK[cfg["precision"]["train_compute"]],
               "window_s": trace.wall_s if trace is not None else lead["wall"]}
    if trace is not None:
        context["program_spans"] = lead["program_spans"]
    return Outcome(lead["steps"], lead["failed"], metrics, lead["checks"], peak, context, trace)
