"""Train traffic: the port's CLAS-FV train step, as `fit` runs it on the
card (`train.loop.compiled_steps`: CUDA graphs of `make_train_step()`,
the fused OTA loss), one step after another on host batches of synthetic
samples cycled through `prefetch_to_device`.

Traffic parameters (portbench/traffic/<mix>.json): `batch`, `batches` (the
distinct host batches made from the seed, cycled), `lr`, `in_flight` (the
steps the host may run ahead of the card), `check_steps` (the steps the
reference follows) and `trace_steps` (the steps a traced run profiles).

Set-up builds the train state from the seed's weights, makes the graphed
step and drives it through its first `check_steps` steps, which run as
every step does: the first eagerly (the graph's warm-up), the second
captured and replayed, the third replayed. The window then runs the same
step on the same state. End-to-end: train_step_ms (the window's wall,
ended at a device synchronize, over its steps), peak_reserved_gib,
setup_s. Checked against the reference's steps from the same weights on
the same batches: each step's loss (`loss_gap`, the largest relative
gap; `loss_gap_first`, the first step's), the norm of each leaf's first gradient as Adam holds it after step
one (`grad_gap`), and the norm of each leaf's change after the checked
steps (`change_gap`), each leaf's gap over the larger of the reference's
norm of that leaf and of the median leaf (the worst leaf's, and
`grad_gap_median`, `change_gap_median` the median leaf's). The cell's
limits file names the numbers that are compared. Leaves whose first gradient in
the reference is under a thousandth of the median leaf's (nought but for
rounding: biases before a BatchNorm, the unused fc) are left out of the
change.
"""

from __future__ import annotations

import gc
import math
import sys
import time
from collections import deque

import numpy as np
import torch
from torch.profiler import record_function

from portbench import flops, peaks
from portbench.harness import Outcome, print_setup
from portbench.reference.model import Precision
from portbench.reference.train import total_loss, train_steps
from portbench.synthetic import training_batch, training_sample
from portbench.trace import traced
from portbench.weights import make_state

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ZERO_LEAF = 1e-3     # of the median leaf's first gradient: nought but for rounding


def make_batches(cell):
    """`batches` host batches of `batch` distinct samples each."""
    t, cfg = cell.traffic, cell.config
    rng = np.random.default_rng([2, cell.seed % 2**63])
    seeds = rng.choice(2**31, size=t["batches"] * t["batch"], replace=False)
    samples = [training_sample(cfg["clip_length"], cfg["height"], cfg["width"], seed=int(s))
               for s in seeds]
    return [training_batch(samples[i:i + t["batch"]])
            for i in range(0, len(samples), t["batch"])]


def _cycle(batches):
    while True:
        yield from batches


def make_state_of_port(cell, device):
    """The port's train state on the seed's weights, as `create_train_state`
    makes it (the model in train mode, Adam, the LR schedule, TF32 off)."""
    from echoflow_torch.models.r2plus1d import R2Plus1DMotionSegNet
    from echoflow_torch.train.loop import TrainConfig, TrainState, lr_schedule, make_optimizer

    dtype = DTYPES[cell.config["precision"]["train_compute"]]
    cfg = TrainConfig(lr=cell.traffic["lr"], compute_dtype=dtype)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    model = R2Plus1DMotionSegNet().to(device)
    model.load_state_dict(make_state(cell.config, cell.seed, device))
    model.train()
    if dtype != torch.float32:
        model.compute_dtype = dtype
    return TrainState(model=model, optimizer=make_optimizer(cfg, model.parameters()),
                      schedule=lr_schedule(cfg),
                      generator=torch.Generator(device=device).manual_seed(cell.seed + 1))


def _norms(tensors: dict) -> dict:
    keys = list(tensors)
    values = torch.stack([tensors[k].detach().float().norm() for k in keys]).cpu().tolist()
    return dict(zip(keys, values))


def run(cell):
    device = torch.device(cell.device)
    t = cell.traffic
    marks = [("imports", time.perf_counter())]
    batches = make_batches(cell)
    marks.append(("batches", time.perf_counter()))
    checked = batches[:t["check_steps"]]
    if cell.control:
        return control(cell, checked, device)
    from echoflow_torch.train.loop import compiled_steps, prefetch_to_device

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
    checks = compare(cell, checked, device, port_losses, first, change)
    cfg = cell.config
    traced_steps = steps - (sessions[-1] if sessions else 0)
    context = {"trace": trace, "config": cfg, "traffic": t, "steps": traced_steps,
               "step_flops": flops.clip_flops(cfg, train=True) * t["batch"],
               "peak_flops": peaks.MODEL_PEAK[cfg["precision"]["train_compute"]],
               "window_s": trace.wall_s if trace is not None else wall}
    return Outcome(steps, finite.count(False), metrics, checks, peak, context, trace)


def half_batch_loss(video, seg, motion, batch):
    """The loss over the first half of the batch alone (a planted fault)."""
    n = video.shape[0] // 2
    return total_loss(video[:n], seg[:n], motion[:n], {k: v[:n] for k, v in batch.items()})


def reference(cell, checked, device, precision="fp32", loss_fn=total_loss):
    """(losses, first gradients' norms, changes' norms) of the reference's
    steps from the seed's weights."""
    state = make_state(cell.config, cell.seed, device)
    prec = Precision(precision)
    with prec.flags():
        losses, first, after = train_steps(state, cell.config, checked, lr=cell.traffic["lr"],
                                           precision=prec, loss_fn=loss_fn)
    change = _norms({k: after[k] - state[k] for k in after})
    return losses, _norms(first), change


def _gaps(got: dict, want: dict, keys) -> dict:
    """Each leaf's gap of norms over the larger of the reference's norm of
    that leaf and of the median leaf."""
    median = float(np.median([want[k] for k in keys]))
    return {k: abs(got[k] - want[k]) / max(want[k], median, 1e-30) for k in keys}


def compare(cell, checked, device, losses, first, change):
    """The numbers compared: `loss_gap` (the largest over the checked
    steps), `grad_gap`, `change_gap` (the worst leaf's), and beside them
    the first step's loss gap and the median leaf's gaps."""
    ref_losses, ref_first, ref_change = reference(cell, checked, device)
    keys = list(ref_first)
    median = float(np.median([ref_first[k] for k in keys]))
    moving = [k for k in keys if ref_first[k] >= ZERO_LEAF * median]
    loss = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    grad, moved = _gaps(first, ref_first, keys), _gaps(change, ref_change, moving)
    for name, gaps in (("grad_gap", grad), ("change_gap", moved)):
        worst = sorted(gaps, key=lambda k: -gaps[k])[:3]
        print(f"{name}: worst leaves " + ", ".join(f"{k} {gaps[k]:.3e}" for k in worst),
              file=sys.stderr)
    print(f"loss gap by step {loss}; left out of the change: {sorted(set(keys) - set(moving))}",
          file=sys.stderr)
    return {"loss_gap": float(np.max(loss)), "loss_gap_first": loss[0],
            "grad_gap": float(np.max(list(grad.values()))),
            "grad_gap_median": float(np.median(list(grad.values()))),
            "change_gap": float(np.max(list(moved.values()))),
            "change_gap_median": float(np.median(list(moved.values())))}


def control(cell, checked, device):
    """The reference in the program's place, through the same check: in the
    configuration's lower precision, or with its loss over half of each
    batch."""
    if cell.control == "half_batch":
        losses, first, change = reference(cell, checked, device, loss_fn=half_batch_loss)
    else:
        losses, first, change = reference(cell, checked, device,
                                          cell.config["precision"]["control"])
    return Outcome(len(checked), 0, {}, compare(cell, checked, device, losses, first, change))
