"""The cells of Video Swin-B and of the archive over every length:
`swin3db-fp32-train` (CLAS-FV over Video Swin-B, `drivers/train_swin.py`)
and `fp32-archive-anylen` run on the CPU at a tiny size as `tiny.run_tiny`
runs the others; the Swin reference's shapes and counts; the new readers."""

from __future__ import annotations

import contextlib
import io
import json
import math
import time

import pytest
import torch

from portbench import flops_swin, harness
from portbench.harness import ROOT, Outcome, load_cell, per_layer, run
from portbench.reference import swin3d
from portbench.trace import Trace

# The published widths cut to width 8, 2 blocks a stage of 1, 2, 2, 4 heads
# and windows of (2, 3, 3) (tokens 4 x 8^2, 4^2, 2^2, 1^2).
SWIN = {"traffic": {"batch": 2, "batches": 3, "warm_seconds": 0.2},
        "config": {"clip_length": 8, "height": 32, "width": 32, "embed_dim": 8,
                   "depths": [2, 2, 2, 2], "num_heads": [1, 2, 2, 4], "window_size": [2, 3, 3]}}
ANYLEN = {"traffic": {"lengths": [40, 41, 47, 48], "videos_per_length": 1, "height": 32,
                      "width": 32, "base_radius": [5.0, 7.0], "amplitude": [1.5, 3.0],
                      "num_clips": 2, "check_videos": 2, "trace_videos": 4},
          "config": {"height": 32, "width": 32}}
OVERRIDES = {"swin3db-fp32-train": SWIN, "fp32-archive-anylen": ANYLEN}


def run_small(workload, seed=2**31 + 9, extra=(), overrides=None):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run(["--workload", workload, "--seed", str(seed), "--seconds", "0.5", *extra],
                 time.perf_counter(), device="cpu",
                 overrides=overrides or OVERRIDES[workload])
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


@pytest.mark.parametrize("workload", list(OVERRIDES))
def test_a_small_run_is_correct_and_prints_the_contracts_line(workload):
    rc, line, err = run_small(workload)
    assert rc == 0, err
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0, err
    # archive-anylen's frames_per_s spreads past its half-bound (PERF.md section 2): not reported
    want = ({"train_step_ms", "peak_reserved_gib", "setup_s"} if "train" in workload
            else {"video_p95_ms", "peak_reserved_gib", "setup_s"})
    assert set(line["metrics"]) == want
    assert set(line["checks"]) == set(load_cell(workload)[4]["limits"])
    assert line["device"]["count"] == 1


def test_the_swin_controls_move_the_checks():
    """The TF32 control (10-bit operands in every conv, Linear and
    attention product) and half the batch, each through the same check:
    the TF32 control reads above the sound run, half the batch fails."""
    _, sound, _ = run_small("swin3db-fp32-train")
    _, tf32, _ = run_small("swin3db-fp32-train", extra=["--control", "precision"])
    _, half, _ = run_small("swin3db-fp32-train", extra=["--control", "half_batch"])
    for name in ("grad_gap", "change_gap"):
        assert tf32["checks"][name]["value"] > 10 * sound["checks"][name]["value"]
    assert half["correct"] is False and tf32["metrics"] == {}


def test_the_swin_reference_describes_the_published_network():
    """The reference's state dict at the published widths: the port's keys
    and shapes, 88,184,926 parameters; a clip's forward 147.57 GFLOP, of
    it 9.575 GMAC in attention; a train step of 4 clips 1.772 TFLOP; the
    attention core a step 229.8 GFLOP over 2.42 GB, bound by its FLOPs."""
    from echoflow_torch.models.r2plus1d import motion_seg_net

    _, _, cfg, _, _ = load_cell("swin3db-fp32-train")
    shapes = swin3d.state_shapes(cfg)
    with torch.device("meta"):
        port = motion_seg_net("swin3d_b").state_dict()
    assert {k: tuple(v.shape) for k, v in port.items()} == shapes
    assert sum(math.prod(s) for k, s in shapes.items()
               if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))) \
        == cfg["assumed"]["parameters"] == 88_184_926
    assert cfg["drop_path_rate"] == 0.0 and cfg["published_drop_path_rate"] == 0.3
    stages = flops_swin._stages(cfg)
    assert [s[0] for s in stages] == [(16, 28, 28), (16, 14, 14), (16, 7, 7), (16, 4, 4)]
    assert [s[4] for s in stages] == [(392, 32), (392, 8), (392, 2), (128, 2)]
    assert round(flops_swin.clip_flops(cfg) / 1e9, 2) == 147.57
    assert round(flops_swin._attention_forward(cfg) / 2e9, 3) == 9.575
    assert round(flops_swin.clip_flops(cfg, train=True) * 4 / 1e12, 3) == 1.772
    assert round(flops_swin.attention_flops(cfg, 4) / 1e9, 1) == 229.8
    assert round(flops_swin.attention_bytes(cfg, 4) / 1e9, 2) == 2.42
    assert flops_swin.attention_flops(cfg, 4) / 67e12 > flops_swin.attention_bytes(cfg, 4) / 3.35e12


def test_the_seeded_weights_follow_the_published_init():
    """`weights_swin.make_state` at the published widths: the same weights
    for the same seed; Linear weights and tables with std 0.02, LayerNorms
    the identity, the patch conv within +-1/sqrt(96), comb1 within
    +-1/sqrt(2048), the Kinetics head 0."""
    from portbench.weights_swin import make_state

    _, _, cfg, _, _ = load_cell("swin3db-fp32-train")
    a, b = (make_state(cfg, 2**31 + 3, "cpu") for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    key = "swin3d_model.layers.2.blocks.17"
    assert abs(float(a[f"{key}.mlp.fc2.weight"].std()) - 0.02) < 1e-3
    assert abs(float(a[f"{key}.attn.relative_position_bias_table"].std()) - 0.02) < 1e-3
    assert torch.equal(a[f"{key}.norm2.weight"], torch.ones(512))
    assert float(a[f"{key}.attn.qkv.bias"].abs().max()) == 0
    assert float(a["swin3d_model.patch_embed.proj.bias"].abs().max()) <= 96 ** -0.5
    assert float(a["comb_1_layer.weight"].abs().max()) <= 2048 ** -0.5
    assert float(a["swin3d_model.fc.weight"].abs().max()) == 0


STEP_SPANS = [("train.ota_and_chains", 1e6, 3e6), ("train.optimizer", 4e6, 5e6)]


def _ctx(steps, device_spans, **extra):
    bench, work, config, traffic, _ = load_cell("swin3db-fp32-train")
    trace = Trace([("k", 0.0, 1000.0)], [], (0.0, 2000.0), 0.002)
    snap = {"host": [{"name": "graph.replay", "id": 1, "parent": None, "thread": 1,
                      "start_ns": 0, "end_ns": 4e6}],
            "device": [{"name": n, "id": 1, "device": 0, "start_ns": s, "end_ns": e}
                       for n, s, e in device_spans + STEP_SPANS],
            "counters": {}, "dropped": 0}
    return bench, work, {"trace": trace, "config": config, "traffic": traffic, "steps": steps,
                         "program_spans": snap, "step_flops": 1e9, "peak_flops": 67e12,
                         "window_s": 0.002, **extra}


def test_the_new_readers_read_the_programs_spans():
    """`attention_span_ms_per_step.swin` and `attention_roofline_pct.swin`
    from `swin.attention`'s device time, `window_span_ms_per_step.swin`
    from `swin.windows`'; the cell's line holds them and the existing
    quantities under their `.swin` names."""
    bench, work, ctx = _ctx(2, [("swin.attention", 0, 3e6), ("swin.attention", 5e6, 6e6),
                                ("swin.windows", 0, 1e6), ("train.backward", 0, 8e6)],
                            attention_flops=67e9, attention_bytes=1e6)
    got = per_layer(bench, work, Outcome(2, 0, {}, {}, context=ctx))
    assert got["attention_span_ms_per_step.swin"]["value"] == pytest.approx(2.0)
    assert got["window_span_ms_per_step.swin"]["value"] == pytest.approx(0.5)
    # 67 GFLOP a step at 67 TFLOP/s is 1 ms, over 2 ms a step.
    assert got["attention_roofline_pct.swin"]["value"] == pytest.approx(50.0)
    assert got["backward_span_ms_per_step.train.swin"]["value"] == pytest.approx(4.0)
    assert got["loss_span_ms_per_step.train.swin"]["value"] == pytest.approx(1.0)
    assert {"device_idle_pct.train.swin", "mfu.train.swin", "step_host_ms.train.swin",
            "optimizer_span_ms_per_step.train.swin"} <= set(got)
    assert not any(name.endswith((".csn", ".dp4")) for name in got)


@pytest.mark.parametrize("reader", ["attention_span_ms_per_step", "window_span_ms_per_step",
                                    "attention_roofline_pct"])
def test_the_new_readers_are_silent_without_the_span(reader):
    """A program without the span (the parent of the change that adds it)
    leaves the metric out of the line; nothing raises."""
    _, _, ctx = _ctx(2, [("train.backward", 0, 8e6)], attention_flops=1e9,
                     attention_bytes=1e6)
    mod = harness.load_module(ROOT / "portbench" / "metrics" / f"{reader}.py", "reader")
    assert mod.read(ctx) is None
    ctx["program_spans"] = None
    assert mod.read(ctx) is None


def test_the_anylen_mix_is_the_archive_over_every_length():
    """`archive-anylen` is `archive` but for one video of each length from
    112 to 304 frames (193 lengths, more than the engine's 64 operand
    slots), handed over in one fixed order."""
    _, _, _, anylen, _ = load_cell("fp32-archive-anylen")
    _, _, _, archive, _ = load_cell("fp32-archive")
    assert anylen["lengths"] == list(range(112, 305)) and anylen["videos_per_length"] == 1
    assert anylen["driver"] == "stream_fixed_order" and archive["driver"] == "stream"
    same = {k for k in archive
            if k not in ("name", "about", "lengths", "videos_per_length", "driver")}
    assert {k: anylen[k] for k in same} == {k: archive[k] for k in same}
    from echoflow_torch.infer.pipeline import VideoSegmenter

    assert len(anylen["lengths"]) > VideoSegmenter.operand_cache_size


def test_the_fixed_order_is_the_same_for_every_seed():
    """`drivers/stream_fixed_order`: the stream's order of the pool is the
    one permutation for every seed and every pass, while the
    seed still draws the videos and the checked ones."""
    from portbench.drivers import stream, stream_fixed_order

    traffic = {**load_cell("fp32-archive-anylen")[3], **ANYLEN["traffic"]}
    orders, videos = [], []
    for seed in (5, 2**31 + 11):
        pool, rng = stream.make_pool(traffic, seed)
        fixed = stream_fixed_order._FixedOrder(rng)
        orders += [fixed.permutation(len(pool)).tolist() for _ in range(2)]
        videos.append(pool[0][1])
    assert all(o == orders[0] for o in orders) and sorted(orders[0]) == list(range(4))
    assert not (videos[0] == videos[1]).all()
