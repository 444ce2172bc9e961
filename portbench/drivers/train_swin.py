"""Train traffic over CLAS-FV with the Video Swin-B backbone: the port's
fused train step as `fit` runs it on the card (`train.loop.compiled_steps`:
CUDA graphs of `make_train_step()`), one step after another on host
batches of synthetic samples cycled through `prefetch_to_device`.

Everything is `drivers/train.py`'s and `drivers/train_ircsn.py`'s (the
traffic's parameters, set-up, window, end-to-end metrics and checked
numbers) but the network: the port's `models/swin3d.SwinMotionSegNet` at
the configuration's widths, depths, heads, window and stochastic depth,
on the seed's weights of `portbench/weights_swin.py`, held against the
plain `reference/swin3d.forward` (`drivers/train_ref.py`); and the step's
model FLOPs, `portbench/flops_swin.py`'s. The context also carries the
attention core's least FLOPs and bytes a step (`attention_flops`,
`attention_bytes`). With the traffic's `warm_seconds`, set-up also runs
the same step that long after the checked steps.

A program without `models/swin3d.py` stops at once with an ImportError.
"""

from __future__ import annotations

import gc
import math
import time
from collections import deque

import torch
from torch.profiler import record_function

from portbench import flops_swin, peaks
from portbench.drivers import train_ref
from portbench.drivers.train import DTYPES, _cycle, _norms, make_batches
from portbench.harness import Outcome, print_setup
from portbench.reference import swin3d
from portbench.trace import traced
from portbench.weights_swin import make_state


def make_state_of_port(cell, device):
    """The port's train state on the seed's weights, as `create_train_state`
    makes it (the model in train mode drawing from the state's generator,
    Adam, the LR schedule, TF32 off)."""
    from echoflow_torch.models.swin3d import SwinMotionSegNet
    from echoflow_torch.train.loop import TrainConfig, TrainState, lr_schedule, make_optimizer

    cfg = cell.config
    dtype = DTYPES[cfg["precision"]["train_compute"]]
    train_cfg = TrainConfig(lr=cell.traffic["lr"], compute_dtype=dtype, backbone="swin3d_b")
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    model = SwinMotionSegNet(embed_dim=cfg["embed_dim"], depths=tuple(cfg["depths"]),
                             heads=tuple(cfg["num_heads"]), window=tuple(cfg["window_size"]),
                             drop_path_rate=cfg["drop_path_rate"]).to(device)
    model.load_state_dict(make_state(cfg, cell.seed, device))
    model.train()
    if dtype != torch.float32:
        model.compute_dtype = dtype
    model.generator = torch.Generator(device=device).manual_seed(cell.seed + 1)
    return TrainState(model=model, optimizer=make_optimizer(train_cfg, model.parameters()),
                      schedule=lr_schedule(train_cfg), generator=model.generator)


def run(cell):
    from echoflow_torch.models import swin3d as _port_swin  # noqa: F401  (fails at once without it)
    from echoflow_torch.train.loop import compiled_steps, prefetch_to_device

    device = torch.device(cell.device)
    t = cell.traffic
    marks = [("imports", time.perf_counter())]
    batches = make_batches(cell)
    marks.append(("batches", time.perf_counter()))
    checked = batches[:t["check_steps"]]
    if cell.control:
        checks = train_ref.control(cell, checked, device, swin3d.forward, make_state)
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
    ref = train_ref.reference(cell, checked, device, swin3d.forward, make_state)
    checks = train_ref.compare(ref, port_losses, first, change)
    cfg = cell.config
    traced_steps = steps - (sessions[-1] if sessions else 0)
    context = {"trace": trace, "config": cfg, "traffic": t, "steps": traced_steps,
               "step_flops": flops_swin.clip_flops(cfg, train=True) * t["batch"],
               "peak_flops": peaks.MODEL_PEAK[cfg["precision"]["train_compute"]],
               "attention_flops": flops_swin.attention_flops(cfg, t["batch"]),
               "attention_bytes": flops_swin.attention_bytes(cfg, t["batch"]),
               "window_s": trace.wall_s if trace is not None else wall}
    return Outcome(steps, finite.count(False), metrics, checks, peak, context, trace)
