"""Train traffic over CLAS-FV with the ir-CSN-152 backbone: the port's
fused train step as `fit` runs it on the card (`train.loop.compiled_steps`:
CUDA graphs of `make_train_step()`), one step after another on host
batches of synthetic samples cycled through `prefetch_to_device`.

Everything is `drivers/train.py`'s (its traffic parameters, set-up, window,
end-to-end metrics and checked numbers) but the network: the port's
`models/csn.CSNMotionSegNet` at the configuration's stages, on the seed's
weights of `portbench/weights_csn.py`, held against the plain
`reference/csn.forward` (`drivers/train_ref.py`); and the step's model
FLOPs, `portbench/flops_csn.py`'s. The context also carries the depthwise
convs' least bytes a step (`depthwise_bytes`).

Set-up also runs the same step for the traffic's `warm_seconds` after the
checked steps: the graph's first replays of a process run slower on the
card (104.5 against 101.4 ms a replay on an H100 for the first 10-15 s of
each of five processes, with the SM and memory clocks constant), and the
window measures the step as it runs after that.

A program without `models/csn.py` stops at once with an ImportError.
"""

from __future__ import annotations

import gc
import math
import time
from collections import deque

import torch
from torch.profiler import record_function

from portbench import flops_csn, peaks
from portbench.drivers import train_ref
from portbench.drivers.train import DTYPES, _cycle, _norms, make_batches
from portbench.harness import Outcome, print_setup
from portbench.reference import csn
from portbench.trace import traced
from portbench.weights_csn import make_state


def make_state_of_port(cell, device):
    """The port's train state on the seed's weights, as `create_train_state`
    makes it (the model in train mode, Adam, the LR schedule, TF32 off)."""
    from echoflow_torch.models.csn import CSNMotionSegNet
    from echoflow_torch.train.loop import TrainConfig, TrainState, lr_schedule, make_optimizer

    cfg = cell.config
    dtype = DTYPES[cfg["precision"]["train_compute"]]
    train_cfg = TrainConfig(lr=cell.traffic["lr"], compute_dtype=dtype, backbone="ir_csn_152")
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    stages = tuple(zip(cfg["stage_blocks"], cfg["stage_mid_widths"], cfg["stage_strides"]))
    model = CSNMotionSegNet(stages=stages, stem_width=cfg["stem_width"]).to(device)
    model.load_state_dict(make_state(cfg, cell.seed, device))
    model.train()
    if dtype != torch.float32:
        model.compute_dtype = dtype
    return TrainState(model=model, optimizer=make_optimizer(train_cfg, model.parameters()),
                      schedule=lr_schedule(train_cfg),
                      generator=torch.Generator(device=device).manual_seed(cell.seed + 1))


def run(cell):
    from echoflow_torch.models import csn as _port_csn  # noqa: F401  (fails at once without it)
    from echoflow_torch.train.loop import compiled_steps, prefetch_to_device

    device = torch.device(cell.device)
    t = cell.traffic
    marks = [("imports", time.perf_counter())]
    batches = make_batches(cell)
    marks.append(("batches", time.perf_counter()))
    checked = batches[:t["check_steps"]]
    if cell.control:
        checks = train_ref.control(cell, checked, device, csn.forward, make_state)
        return Outcome(len(checked), 0, {}, checks)

    state = make_state_of_port(cell, device)
    step, _ = compiled_steps(state)
    marks.append(("state and the CUDA context", time.perf_counter()))
    feed = prefetch_to_device(_cycle(batches), device)
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
    warm_until = time.perf_counter() + t.get("warm_seconds", 0)
    while time.perf_counter() < warm_until:
        state, _ = step(state, next(feed))
    if device.type == "cuda":
        torch.cuda.synchronize()
    marks.append(("warm steps", time.perf_counter()))
    setup_s = time.perf_counter() - cell.t0
    print_setup(cell.t0, marks)

    window_losses, inflight, sessions = [], deque(), []

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
            one_step()

    trace = None
    t0 = time.perf_counter()
    if cell.trace:
        trace, _ = traced(session)
    else:
        deadline = t0 + cell.seconds
        while time.perf_counter() < deadline:
            one_step()
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_reserved(device) if device.type == "cuda" else 0
    finite = [math.isfinite(v) for v in torch.stack(window_losses).cpu().tolist()]
    steps = len(window_losses)
    del step, state, feed, params, inflight
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    metrics = {"setup_s": setup_s, "peak_reserved_gib": peak / 2**30,
               "train_step_ms": wall / steps * 1e3}
    ref = train_ref.reference(cell, checked, device, csn.forward, make_state)
    checks = train_ref.compare(ref, port_losses, first, change)
    cfg = cell.config
    traced_steps = steps - (sessions[-1] if sessions else 0)
    context = {"trace": trace, "config": cfg, "traffic": t, "steps": traced_steps,
               "step_flops": flops_csn.clip_flops(cfg, train=True) * t["batch"],
               "peak_flops": peaks.MODEL_PEAK[cfg["precision"]["train_compute"]],
               "depthwise_bytes": flops_csn.depthwise_bytes(cfg, t["batch"]),
               "window_s": trace.wall_s if trace is not None else wall}
    return Outcome(steps, finite.count(False), metrics, checks, peak, context, trace)
