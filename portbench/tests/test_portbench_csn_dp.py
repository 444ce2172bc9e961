"""The two train cells that run another network or more than one process:
`ircsn152-fp32-train` (CLAS-FV over ir-CSN-152, `drivers/train_ircsn.py`)
and `fp32-train-dp4` (data parallelism, `drivers/train_dp.py`), run on the
CPU at a tiny size as `tiny.run_tiny` runs the others; the CSN reference's
shapes and counts; the new readers."""

from __future__ import annotations

import contextlib
import io
import json
import math
import time

import pytest
import torch

from portbench import flops_csn, harness
from portbench.harness import ROOT, Outcome, load_cell, per_layer, run
from portbench.reference import csn
from portbench.trace import Trace

TRAIN_CFG = {"clip_length": 8, "height": 32, "width": 32}
OVERRIDES = {
    # The published widths cut to 1, 2, 1, 1 blocks of middle width 4, 8, 8, 8.
    "ircsn152-fp32-train": {"traffic": {"batch": 2, "batches": 3, "warm_seconds": 0.2},
                            "config": {**TRAIN_CFG, "stage_mid_widths": [4, 8, 8, 8],
                                       "stage_blocks": [1, 2, 1, 1]}},
    # Two gloo ranks, one sample each.
    "fp32-train-dp4": {"traffic": {"ranks": 2, "batch": 2, "batches": 3}, "config": TRAIN_CFG},
}


def run_small(workload, seed=2**31 + 7, extra=()):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run(["--workload", workload, "--seed", str(seed), "--seconds", "0.5", *extra],
                 time.perf_counter(), device="cpu", overrides=OVERRIDES[workload])
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


@pytest.mark.parametrize("workload", list(OVERRIDES))
def test_a_small_run_is_correct_and_prints_the_contracts_line(workload):
    rc, line, err = run_small(workload)
    assert rc == 0, err
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0, err
    assert set(line["metrics"]) == {"train_step_ms", "peak_reserved_gib", "setup_s"}
    assert set(line["checks"]) == set(load_cell(workload)[4]["limits"])
    assert {"grad_gap", "change_gap"} <= set(line["checks"])
    assert line["device"]["count"] == (4 if workload == "fp32-train-dp4" else 1)


def test_the_csn_reference_describes_the_published_network():
    """The reference's state dict at the published widths: the port's
    keys and shapes, 29,958,294 parameters; the forward's 37.24 GFLOP of
    backbone convs a clip (0.63 of them depthwise); 50 depthwise convs."""
    from echoflow_torch.models.r2plus1d import motion_seg_net

    _, _, cfg, _, _ = load_cell("ircsn152-fp32-train")
    shapes = csn.state_shapes(cfg)
    with torch.device("meta"):
        port = motion_seg_net("ir_csn_152").state_dict()
    assert {k: tuple(v.shape) for k, v in port.items()} == shapes
    assert sum(math.prod(s) for k, s in shapes.items()
               if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))) \
        == cfg["assumed"]["parameters"] == 29_958_294
    layers, taps = csn.conv_layers(cfg)
    assert taps == [(32, 56, 56), (32, 28, 28), (16, 14, 14), (8, 7, 7), (4, 4, 4)]
    depthwise = [layer for layer in layers if layer[6] > 1]
    assert len(depthwise) == 50
    backbone = sum(flops_csn._flops(layer) for layer in layers if layer[0].startswith("ir_csn"))
    assert round(backbone / 1e9, 2) == 37.24
    assert round(sum(flops_csn._flops(layer) for layer in depthwise) / 1e9, 2) == 0.63
    assert flops_csn.clip_flops(cfg, train=True) < 3 * flops_csn.clip_flops(cfg) + 3e9
    # Forward, input and weight gradient of each: x, w, y three times, fp32.
    want = sum(12 * (4 * layer[2] * math.prod(size) + 4 * layer[1] * math.prod(layer[7])
                     + layer[1] * 27)
               for layer, size in zip(depthwise, _depthwise_inputs(layers)))
    assert flops_csn.depthwise_bytes(cfg, 4) == want


def _depthwise_inputs(layers):
    """The input size of each depthwise conv: its block's first conv's output."""
    sizes, prev = [], None
    for key, _, _, _, _, _, groups, out in layers:
        if groups > 1:
            sizes.append(prev)
        if not key.endswith(".downsample.0"):
            prev = out
    return sizes


# Each step's loss, Adam and host path, in every train cell's context.
STEP_SPANS = [("train.ota_and_chains", 1e6, 3e6), ("train.optimizer", 4e6, 5e6)]
HOST_SPANS = [{"name": "graph.replay", "id": 1, "parent": None, "thread": 1, "start_ns": 0,
               "end_ns": 4e6}]


def _ctx(cell, steps, device_spans, **extra):
    bench, work, config, traffic, _ = load_cell(cell)
    trace = Trace([("k", 0.0, 1000.0)], [], (0.0, 2000.0), 0.002)
    device_spans = device_spans + STEP_SPANS
    snap = {"host": HOST_SPANS, "device": [{"name": n, "id": 1, "device": 0, "start_ns": s,
                                    "end_ns": e} for n, s, e in device_spans],
            "counters": {}, "dropped": 0}
    return bench, work, {"trace": trace, "config": config, "traffic": traffic, "steps": steps,
                         "program_spans": snap, "step_flops": 1e9, "peak_flops": 67e12,
                         "window_s": 0.002, **extra}


def test_the_new_readers_read_the_programs_spans():
    """`depthwise_span_ms_per_step.csn` and `depthwise_roofline_pct.csn`
    from `conv.depthwise`'s device time, `allreduce_span_ms_per_step.dp4`
    from `dp.all_reduce`'s; each cell's line holds its own and the
    existing quantities under its part names, the loss's, Adam's and the
    host path's among them."""
    bench, work, ctx = _ctx("ircsn152-fp32-train", 2,
                            [("conv.depthwise", 0, 3_000_000), ("conv.depthwise", 5e6, 6e6),
                             ("train.backward", 0, 8e6)], depthwise_bytes=3.35e9)
    got = per_layer(bench, work, Outcome(2, 0, {}, {}, context=ctx))
    assert got["depthwise_span_ms_per_step.csn"]["value"] == pytest.approx(2.0)
    # 3.35e9 bytes a step at 3.35 TB/s is 1 ms, over 2 ms a step.
    assert got["depthwise_roofline_pct.csn"]["value"] == pytest.approx(50.0)
    assert got["backward_span_ms_per_step.train.csn"]["value"] == pytest.approx(4.0)
    assert {"device_idle_pct.train.csn", "mfu.train.csn"} <= set(got)
    assert got["loss_span_ms_per_step.train.csn"]["value"] == pytest.approx(1.0)
    assert got["optimizer_span_ms_per_step.train.csn"]["value"] == pytest.approx(0.5)
    assert got["step_host_ms.train.csn"]["value"] == pytest.approx(2.0)
    assert "allreduce_span_ms_per_step.dp4" not in got
    bench, work, ctx = _ctx("fp32-train-dp4", 3, [("dp.all_reduce", 0, 6e6),
                                                  ("train.backward", 0, 9e6)])
    got = per_layer(bench, work, Outcome(3, 0, {}, {}, context=ctx))
    assert got["allreduce_span_ms_per_step.dp4"]["value"] == pytest.approx(2.0)
    assert got["backward_span_ms_per_step.train.dp4"]["value"] == pytest.approx(3.0)
    assert {"device_idle_pct.train.dp4", "mfu.train.dp4"} <= set(got)
    assert got["loss_span_ms_per_step.train.dp4"]["value"] == pytest.approx(2 / 3)
    assert got["optimizer_span_ms_per_step.train.dp4"]["value"] == pytest.approx(1 / 3)
    assert got["step_host_ms.train.dp4"]["value"] == pytest.approx(4 / 3)
    assert not any(name.endswith(".csn") for name in got)


@pytest.mark.parametrize("reader", ["depthwise_span_ms_per_step", "depthwise_roofline_pct",
                                    "allreduce_span_ms_per_step"])
def test_the_new_readers_are_silent_without_the_span(reader):
    """A program without the span (the parent of the change that adds it)
    leaves the metric out of the line; nothing raises."""
    _, _, ctx = _ctx("ircsn152-fp32-train", 2, [("train.backward", 0, 8e6)],
                     depthwise_bytes=1e9)
    mod = harness.load_module(ROOT / "portbench" / "metrics" / f"{reader}.py", "reader")
    assert mod.read(ctx) is None
    ctx["program_spans"] = None
    assert mod.read(ctx) is None
