#!/usr/bin/env python3
"""Smoke run of echoflow_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits nonzero):

  1. device: require CUDA; print the card's name and power limit;
  2. build: compile every kernel in echoflow_torch/csrc/ with nvcc (one
     process per source, all started together) into echoflow_torch/_build/;
  3. kernels vs plain: the decoder-tail kernel (K1) against its plain
     PyTorch version on the same CUDA tensors at the main path's shapes
     (30 clips x 32 frames, sources 56/28/14/7 squared, 112x112 output),
     with and without motion; kernel and plain times (CUDA events,
     median), the kernel's bound on this card (CUDA cores, 3xTF32 tensor
     cores, memory) and its share of that bound and of the earlier
     all-fp32 CUDA-core bound;
  4. main path: a full-width R(2+1)D-18 MotionNet (seeded init, seg head
     x50 with a centred bias) in `VideoSegmenter(dtype=float32)`;
     `segment_videos` over 3 synthetic 176-frame 112x112 uint8 videos,
     5 shifts, step 1, SIMPLE fusion, then per-beat EF. The kernel's
     launch count is zeroed just before and read just after. The masks are
     held against the same engine with decoder="model" on the card, and one
     short video against the CPU engine (plain decoder, fp32);
  5. warp kernels vs plain: K2 (forward), K3 (image gradient) and K4
     (coordinate gradient) against their plain PyTorch versions at the
     training path's shapes: one fused chain step's label warp
     (8, 4, 112, 112) and video warp (8, 3, 112, 112), and the unfused OTA
     batch (124, 3, 112, 112), each under a rough and a smooth motion
     field; then K2's pair launch of the chain step (label and video at
     the same coordinates, cases "chain" and "chain_smooth") beside the
     two single launches on the same inputs; device time of kernel, plain
     version and `F.grid_sample` (a yardstick the port never calls); K3
     held to the same bits over 10 launches, and whether it is bitwise the
     plain version under torch's deterministic algorithms;
  6. training at full width: `create_train_state(device="cuda")`, fp32,
     TF32 off, 3 steps of `make_train_step(fused_ota=True)` at batch
     4 x 3 x 32 x 112 x 112 on synthetic samples, then one eval step, with
     the warp launch counts zeroed just before and read just after each and
     held against the counts the code implies; the calls in one more fused
     step that wait for the device (torch's sync debug mode), which must be
     none; then one small step on the card and on the CPU from
     the same state (loss, all gradients, and each leaf's gradient by its
     relative L2 error);
  7. clips and propagation at full width: `ClipForward` (fp32, 8 clips a
     chunk, with the motion head) on the 16 clips around one ED frame of
     a 176-frame video, K1's launch count zeroed just before and held at
     ceil(16 / 8) = 2; labels and motion (motion head x10, a few pixels
     between frames) against the module's forward on the card and the CPU
     port on 2 clips, and the probabilities on the same model with its
     seg head divided by 50 (x50 logits move a probability 50 times as
     far); then
     `deform_forback` (nearest), `deform_forback(mode="bilinear")` and
     `deform_images_forback` on their motion, K2's launches held at 0,
     2 x 31 and 1 + 31, each rollout bitwise the same call on the plain
     warp; times of each call, K1 a launch against its bound with motion,
     K2 a launch against its byte bound;
  8. the CLI: `motion_segment_torch.main` on a written 96-frame AVI (or,
     without cv2, its `run` body on the frames), 5 shifts, `-c all` (less
     the GIF without matplotlib or PIL), the smoke weights as an echoflow
     `.pkl`: artifact names, masks, finite EFs, wall time;
  9. data parallelism: (a) in a one-rank NCCL group, phase 6's full-width
     fused step (seed-0 state, its first batch) through `data_parallel`
     (the gradient all-reduce, global BatchNorm and the coupled
     smoothness): its loss against the plain step on the same card (1e-5),
     K2/K3/K4 launches held at 31/30/62, and in the third step the calls
     that wait for the device (none) and the collectives of a step; the
     gradients at phase 6's bars on phase 6's (2, 3, 8, 32, 32) step, with
     and without data parallelism; (b) `VideoSegmenter(devices=["cuda:0", "cuda:0"])`, fp32, on
     phase 4's three videos against phase 4's masks (1e-4 of the pixels),
     K1's launches held at the chunk plan's; (c) `dryrun_multigpu(1,
     "nccl")`, echoflow's six multichip cases on a spawned rank;
 10. CAMUS: (a) `ota_loss` and `sgs_ots_loss` at batch 4, 10 frames, 4
     classes, a 1-channel source, 112x112, motion of a few pixels: values
     (1e-5) and input gradients (5e-3 relative L2) against the same calls
     on the plain warp, launches held at the counts the code implies; (b)
     `train_camus_torch.main --synthetic --epochs 2` on the card against
     the CPU from the same seed, with and without `--acnn` (losses within
     1e-3 relative), wall seconds;
 11. precision and remat: (a) 3 full-width fused steps (phase 6's batches,
     seed-0 state) of each of fp32, fp32 with remat, bf16
     (`TrainConfig.compute_dtype`) and bf16 with remat: K2/K3/K4 launches
     zeroed just before and held at 31/30/62 a step, the median unprofiled
     step time, the peak allocated memory after a reset, and one more step
     under sync debug mode "error" (no wait); (b) one full-width step with
     and without remat from the same state and batch: phase 6's bars, the
     running statistics within 1e-6 and `num_batches_tracked` at 1; (c)
     the bf16 step at phase 6's (2, 3, 8, 32, 32) shape, residual branches
     damped, on the card and on the CPU, each from the CPU's float64 step:
     the card's gradients and each leaf at most 2x as far as the CPU's,
     the gradients at most 0.5 and the loss 1e-2 from float64, the stem's
     statistics within 5e-4 of the CPU's; (d) phase 9a's one-rank NCCL group with the remat step:
     the collectives of a step, no wait; (e) the native host normalizer
     (`csrc/preprocess.cc`, built with the host compiler) bitwise the numpy
     path on phase 4's videos, host times of both;
 12. graphed steps (`train/graph.py`, what `fit` runs on the card): for each
     of fp32, fp32 with remat, bf16, bf16 with remat and the ed-or-es-only
     recipe, 4 steps from phase 6's seed-0 state and batches, twice
     eagerly and once graphed (a warm-up, a capture with its replay, two
     replays), the LR dropping at update 2: the warm-up and a replay at
     phase 6's bars (bf16: 1e-2 and 3e-2) against the eager step from the
     same state and batch; after 4 steps the parameters and running
     statistics at most 2x as far from the eager runs' (their median) as
     the eager runs are apart, or 1e-6 of the moves (the runs repeat),
     `num_batches_tracked` equal, the LR of each update the schedule's;
     launches zeroed just before each step and held at the recipe's, K1's
     held at 0; K1-K4 by kernel name in a profiled replay; no wait in a
     replay (sync mode "error"); the graphed eval step against the eager
     one; eager and graphed step times, the capture, a replay's device
     busy time and idle share, peak memory.
     12f: `train_clasfv_torch.main` for 2 epochs of 3 steps, one train and
     one eval graph a run.
 13. graphs of the paths echoflow compiles that ran op by op before
     (phase 12's graphs dropped first): (a) in a one-rank NCCL group, the
     data-parallel fused step in fp32, bf16 (residuals damped) and fp32
     with remat, and the data-parallel eval step: eager (the first call,
     then the median of 5) and graphed (warm-up, capture, median of 5
     replays); a replay against the eager step of a twin from the same
     state and batch at phase 12's bars; the collectives called in the
     capture equal to the eager step's; K1-K4 by name in a profiled
     replay 0/31/60/62 (eval 0/33/0/0), device busy and idle
     share; no wait in a replay; memory reserved with the graphs; then
     `fit_on_mesh` on the graphed steps of `compiled_steps` (as
     `train_clasfv_torch.py` under torchrun runs them) against the same
     run eager, and `parallel/dryrun.dp_train_steps` on its graphs; (b)
     phase 7's rollouts through their graphs, a replay bitwise the eager
     rollout, its launches by all four counters (K2 62 or 32, K1, K3, K4
     0) and by name among the nodes of the graph it ran, eager and graphed
     ms; (c) `train_camus_torch.main --synthetic --epochs 2`
     through its graphs against the same run eager, with and without
     `--acnn`: losses within 1e-3, graphs and replays, no warp launch.
     Phase 7 runs the eager rollouts (`fn.__wrapped__`).
 14. repeatable training and the last paths echoflow compiles: (a) two
     eager fp32 runs of phase 12's recipe as the trainer runs them (each
     convolution's backward on its repeatable route, `ops/conv.py`),
     under the plain warp with torch's deterministic algorithms, under
     those with the port's K3, and with only cuDNN's deterministic
     algorithms: bitwise or their distance, all but the second held
     bitwise; phase 12's eager fp32 and fp32-remat runs held bitwise,
     its graphed runs against them; two eager runs of the one-rank NCCL
     data-parallel step and of the CAMUS trainer (with and without
     `--acnn`; its graphed runs of phases 10b and 13c too) held bitwise;
     a fresh process's run of the recipe held to the same SHA-256 of its
     moves; the ops torch names nondeterministic in a step; two eager
     bf16 runs held bitwise; the cost line: phase 12's graphed fp32 step
     on the parent's route (every conv the plain functional conv on
     cuDNN's defaults), the repeatable route and the global
     `cudnn.deterministic` switch in turns, the route's cost held below
     the switch's, and the graphed bf16 step on both routes; K3's us a
     launch in an eager step; (b) the engine through its graphs (the default on one
     card) against its eager body (`_run.__wrapped__`) on phase 4's three
     videos, fp32 and bf16: masks bitwise, K1's launches by counter (3)
     and by name, in bf16 no NCHW<->NHWC transpose of cuDNN in the
     profiled pass (its backbone is channels-last-3d,
     `fold_bn.channels_last`), no wait in a replayed dispatch, frames/s
     of each, a profiled pass's busy time and idle share, captures, memory reserved;
     then a seeded stream of 12 videos of 100-300 frames: keys, warm-ups,
     captures, replays, wall time against eager; (c) `ClipForward`'s
     graphs on phase 7's 16 clips against its eager forward: bitwise, K1
     at 2, ms of each. Phases 4, 7 and 8 run the graphed engine and
     `ClipForward` (their defaults; the CLI's one video is a warm-up).

Prints the nvidia-smi line, then one JSON line {"kernels": [...]}, and as
the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import functools
import gc
import hashlib
import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from echoflow_torch.data.synthetic import make_beating_video
from echoflow_torch.infer.ef import compute_ef_using_putative_clips
from echoflow_torch.infer.pipeline import VideoSegmenter
from echoflow_torch.models.r2plus1d import create_model
from echoflow_torch.ops import _build
from echoflow_torch.ops.conv import deterministic_cudnn
from echoflow_torch.ops import warp_kernel as wk
from echoflow_torch.ops.decoder_heads import decoder_heads, reference_decoder_heads
from echoflow_torch.ops.normalize import zeroone_normalizer
from echoflow_torch.ops.warp import offset_coords
from echoflow_torch.train.loop import (TrainConfig, create_train_state, make_eval_step,
                                       make_train_step, prefetch_to_device)
from echoflow_torch.utils.profiling import counters
from train_clasfv_torch import synthetic_batches

# Peak rates of an H100 SXM (NVIDIA data sheet): fp32 outside the tensor
# cores, dense TF32 on the tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12
# fp32 on both sides (comb2 as 3xTF32 on the tensor cores: ~fp32 accuracy);
# summation order and the dropped lo*lo term differ.
K1_TOL = 1e-4
K1_WEIGHTS = dict(b1=(64,), w2=(64, 64), b2=(64,), ws=(64, 2), bs=(2,), wm=(64, 4), bm=(4,))
MASK_TOL = 1e-4        # argmax near-ties between two fp32 decoders
# K2 and K4 do the plain versions' elementwise arithmetic in the same order
# with no contracted multiply-adds. K2 is held bitwise; K4's bound allows a
# last-bit difference (it is bitwise too). K3's bound is per element
# (`image_grad_tolerance`): it sums in the plain version's order of corners
# and sources, with each corner's sources summed apart; K3 is held bitwise
# to itself.
K4_TOL = 1e-6          # relative to 1 + |plain|
K3_REPEATS = 10        # K3 launches on the same inputs held bitwise equal (phase 5)
# Card vs CPU, one fused train step at (2, 3, 8, 32, 32): fp32 rounding on
# both sides, cuDNN's and the CPU's conv algorithms, K3's order of sums.
# Measured on an H100 (with the float4-atomic K3): loss 6.7e-7, all
# gradients 1.6e-3, worst leaf 2.3e-3. A planted fault in the CPU port,
# the label warps' image gradient (K3)
# dropped, moves all gradients by 1.0e-2 and the worst leaf by 0.61; K4
# without its border zeroing moves them by 0.14 and 8.9.
LOSS_TOL = 1e-5        # relative loss difference
GRAD_TOL = 5e-3        # relative L2 error of all gradients together
LEAF_TOL = 1e-2        # relative L2 error of each leaf's gradient
ZERO_LEAF = 1e-4       # below this share of the largest leaf's norm: 0 in exact arithmetic
# Phase 9a at full width, the DP step (global BatchNorm) against the plain
# step (cuDNN's BatchNorm), both fp32 on the card: two roundings of a step
# that is itself ~1% from float64 at full width (1.04e-2 at (2, 3, 16, 64,
# 64) on the CPU). Measured on an H100: all gradients 1.03e-2, worst leaf
# 1.26e-2, the same in two calls. A BatchNorm gradient through autograd of
# the fp32 formula was 25x further from float64 at phase 6's shape.
DP_FULL_GRAD_TOL = 3e-2
DP_FULL_LEAF_TOL = 4e-2
# The warp shapes of the training path at batch 4, 32 frames, 112x112.
WARP_SHAPES = (("label", (8, 4, 112, 112)),   # fused chain step, labels (2N, 4)
               ("video", (8, 3, 112, 112)),   # fused chain step, video (2N, 3)
               ("ota", (124, 3, 112, 112)))   # unfused OTA batch, N (T-1) frames


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of `fn` over `reps` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def k1_inputs():
    """Phase 3's seeded K1 inputs: 30 clips x 32 frames, sources 56/28/14/7
    squared, 64 channels, and the decoder weights."""
    g = torch.Generator(device="cuda").manual_seed(0)
    projs = [torch.randn(30, 32, s, s, 64, device="cuda", generator=g) * 0.2
             for s in (56, 28, 14, 7)]
    w = {k: torch.randn(*s, device="cuda", generator=g) * 0.3 for k, s in K1_WEIGHTS.items()}
    return projs, w


def k1_bound(projs, with_motion, out_hw=(112, 112)):
    """The least time of the decoder tail on these inputs, on the pipes the
    kernel uses: per output pixel, on the CUDA cores 8 FLOP per source
    channel for the bilinear sum, 2 per channel for +b1/ReLU and 2*64*2 for
    the seg head (+ 2*64*4 for the motion head); on the tensor cores the
    2*64*64 FLOP of comb2 three times (3xTF32, the least-cost route to fp32
    accuracy on this card); each input read once, each output written once.
    The bound is the largest of the three times; `bounds` holds each, and
    `fp32_cuda_cores_ms` the earlier bound: all the FLOP at the fp32
    CUDA-core rate. Every one is computed from the inputs, none measured."""
    bsz, t = projs[0].shape[:2]
    pixels = bsz * t * out_hw[0] * out_hw[1]
    c = projs[0].shape[-1]
    core_flops = pixels * (8 * c * len(projs) + 2 * c + 2 * c * 2
                           + (2 * c * 4 if with_motion else 0))
    comb2_flops = pixels * 2 * c * c
    nbytes = sum(p.numel() * 4 for p in projs) + (c + c * c + c + c * 2 + 2) * 4
    nbytes += pixels * (2 + (4 if with_motion else 0)) * 4
    times = {"operations": max(core_flops / PEAK_FP32_FLOPS, 3 * comb2_flops / PEAK_TF32_FLOPS),
             "bytes": nbytes / PEAK_HBM_BYTES}
    bound_by = max(times, key=times.get)
    bounds = dict(cuda_cores_ms=core_flops / PEAK_FP32_FLOPS * 1e3,
                  tensor_cores_ms=3 * comb2_flops / PEAK_TF32_FLOPS * 1e3,
                  memory_ms=times["bytes"] * 1e3,
                  fp32_cuda_cores_ms=(core_flops + comb2_flops) / PEAK_FP32_FLOPS * 1e3)
    return dict(bound_ms=times[bound_by] * 1e3, bound_by=bound_by, bounds=bounds,
                flops=core_flops + comb2_flops, nbytes=nbytes)


DEVICE_MS_SESSIONS = 6


def device_ms(fn, reps: int = 20, match: str | None = None):
    """Device time per call of `fn` from torch.profiler: the summed duration
    of the device kernels (and memsets/copies) it launches, not the device
    mirrors of the `echoflow_torch.*` ranges around them, over `reps`
    back-to-back calls after one warm-up; with `match`, also the time of
    the kernels whose name contains it. A session that records no device
    event (it happens on the card's sandbox, once three sessions in a row)
    is repeated, up to DEVICE_MS_SESSIONS sessions, a second apart.
    Returns (total_ms, matched_ms)."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(DEVICE_MS_SESSIONS):
        if attempt:
            time.sleep(1.0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = matched = 0.0
        for evt in prof.events():
            # A record_function range has a device-side mirror spanning the
            # kernels inside it: counted, it would count them twice.
            if evt.device_type == torch.autograd.DeviceType.CPU or \
                    evt.name.startswith("echoflow_torch."):
                continue
            total += evt.device_time_total
            if match is not None and match in evt.name:
                matched += evt.device_time_total
        if total > 0.0:
            return total / reps / 1e3, matched / reps / 1e3
    raise RuntimeError(f"torch.profiler recorded no device time in {DEVICE_MS_SESSIONS} "
                       "sessions")


def _grid(px, py, h, w):
    """Unclamped pixel coordinates -> the normalized grid of grid_sample
    (align_corners=False): px = ((gx + 1) W - 1) / 2."""
    return torch.stack([(2.0 * px + 1.0) / w - 1.0, (2.0 * py + 1.0) / h - 1.0], dim=-1)


def warp_inputs(shape, g, motion="rough"):
    """Image, output gradient and the coordinates of a motion field.
    "rough": tanh-bounded per-pixel noise as the model emits it (about 8 px
    standard deviation; about 1% of the coordinates leave the image, so
    the border clamp and the zeroed coordinate gradient run). "smooth": a
    7x7 field x 0.05 upsampled bilinearly, about 3 px, the scale of wall
    motion between consecutive frames."""
    n, c, h, w = shape
    image = torch.rand(shape, device="cuda", generator=g)
    grad = torch.randn(shape, device="cuda", generator=g)
    if motion == "rough":
        field = torch.tanh(0.15 * torch.randn((n, 2, h, w), device="cuda", generator=g))
    else:
        field = F.interpolate(0.05 * torch.randn((n, 2, 7, 7), device="cuda", generator=g),
                              size=(h, w), mode="bilinear", align_corners=False)
    px, py = offset_coords(field)
    return image, grad, px.contiguous(), py.contiguous()


def phase_warp():
    """K2, K3, K4 against their plain versions at the training shapes, on
    the rough field (keys "label", "video", "ota") and the smooth one
    ("label_smooth", ...)."""
    g = torch.Generator(device="cuda").manual_seed(1)
    out = {"warp_forward": {}, "warp_image_grad": {}, "warp_coord_grad": {}}
    cases = [(label, shape, "rough") for label, shape in WARP_SHAPES]
    cases += [(f"{label}_smooth", shape, "smooth") for label, shape in WARP_SHAPES]
    for label, shape, motion in cases:
        image, grad, px, py = warp_inputs(shape, g, motion)
        n, c, h, w = shape
        img_b, pix_b = image.numel() * 4, px.numel() * 4
        grid = _grid(px, py, h, w)

        # K2
        got, want = wk.warp_forward(image, px, py), wk.reference_warp_forward(image, px, py)
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"K2 {shape}: not bitwise the plain version, max abs err {err}")
        lib_err = float((F.grid_sample(image, grid, mode="bilinear", padding_mode="border",
                                       align_corners=False) - want).abs().max())
        call, ms = device_ms(lambda: wk.warp_forward(image, px, py),
                             match="warp_forward_kernel")
        plain, _ = device_ms(lambda: wk.reference_warp_forward(image, px, py), reps=5)
        lib, _ = device_ms(lambda: F.grid_sample(image, grid, mode="bilinear",
                                                 padding_mode="border", align_corners=False))
        out["warp_forward"][label] = dict(
            shape=list(shape), max_abs_err=err, bitwise=bool(torch.equal(got, want)), ms=ms,
            call_ms=call, plain_ms=plain, library_ms=lib, library_abs_diff=lib_err,
            bound_ms=(2 * img_b + 2 * pix_b) / PEAK_HBM_BYTES * 1e3, bound_by="bytes")

        # K3: K3_REPEATS launches on the same inputs, bitwise equal, within
        # the per-element bound of the plain version; and whether it is
        # bitwise the plain version under torch's deterministic algorithms
        # (its `index_add_`s through a sort).
        tol = wk.image_grad_tolerance(grad, px, py)
        runs = [wk.warp_image_grad(grad, px, py) for _ in range(K3_REPEATS)]
        got1 = runs[0]
        want = wk.reference_warp_image_grad(grad, px, py)
        with torch_deterministic():
            want_det = wk.reference_warp_image_grad(grad, px, py)
        err = float((got1 - want).abs().max())
        run_diff = max(float((r - got1).abs().max()) for r in runs[1:])
        same_bits = all(torch.equal(r.view(torch.int32), got1.view(torch.int32)) for r in runs)
        if not (bool(((got1 - want).abs() <= tol).all()) and same_bits):
            raise AssertionError(f"K3 {shape}: max abs err {err} (the per-element bound), "
                                 f"the same bits in {K3_REPEATS} launches {same_bits}")
        call, ms = device_ms(lambda: wk.warp_image_grad(grad, px, py),
                             match="warp_image_grad_kernel")
        plain, _ = device_ms(lambda: wk.reference_warp_image_grad(grad, px, py), reps=5)
        lib, _ = device_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
            grad, image, grid, 0, 1, False, [True, False]))
        out["warp_image_grad"][label] = dict(
            shape=list(shape), max_abs_err=err, run_to_run_abs_diff=run_diff,
            bitwise_deterministic_plain=bool(torch.equal(got1, want_det)),
            deterministic_plain_abs_diff=float((got1 - want_det).abs().max()),
            max_tolerance=float(tol.max()), ms=ms, call_ms=call, plain_ms=plain,
            library_ms=lib, bound_ms=(2 * img_b + 2 * pix_b) / PEAK_HBM_BYTES * 1e3,
            bound_by="bytes")

        # K4
        got, want = wk.warp_coord_grad(image, grad, px, py), \
            wk.reference_warp_coord_grad(image, grad, px, py)
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        if not all(bool(((a - b).abs() <= K4_TOL * (1 + b.abs())).all())
                   for a, b in zip(got, want)):
            raise AssertionError(f"K4 {shape}: max abs err {err} vs plain")
        call, ms = device_ms(lambda: wk.warp_coord_grad(image, grad, px, py),
                             match="warp_coord_grad_kernel")
        plain, _ = device_ms(lambda: wk.reference_warp_coord_grad(image, grad, px, py),
                             reps=5)
        lib, _ = device_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
            grad, image, grid, 0, 1, False, [False, True]))
        out["warp_coord_grad"][label] = dict(
            shape=list(shape), max_abs_err=err,
            bitwise=all(bool(torch.equal(a, b)) for a, b in zip(got, want)), ms=ms,
            call_ms=call, plain_ms=plain, library_ms=lib,
            bound_ms=(2 * img_b + 4 * pix_b) / PEAK_HBM_BYTES * 1e3, bound_by="bytes")
        for name in out:
            r = out[name][label]
            r["motion"] = motion
            log(f"{name} {label} {tuple(shape)} {motion}: max_abs_err "
                f"{r['max_abs_err']:.3e}, kernel {r['ms'] * 1e3:.2f} us (call "
                f"{r['call_ms'] * 1e3:.2f} us), plain {r['plain_ms'] * 1e3:.1f} us, "
                f"grid_sample {r['library_ms'] * 1e3:.1f} us, "
                f"bound {r['bound_ms'] * 1e3:.2f} us"
                + (f", run-to-run {r['run_to_run_abs_diff']:.3e} over {K3_REPEATS} launches, "
                   f"bitwise the plain version under deterministic algorithms "
                   f"{r['bitwise_deterministic_plain']} (max abs diff "
                   f"{r['deterministic_plain_abs_diff']:.3e})"
                   if "run_to_run_abs_diff" in r else ""))
        del image, grad, px, py, grid, got, want, got1, runs, want_det, tol
    for motion in ("rough", "smooth"):
        label = "chain" if motion == "rough" else "chain_smooth"
        r = out["warp_forward"][label] = phase_warp_chain(g, motion)
        log(f"warp_forward {label} {r['shape']} {motion}: pair launch bitwise "
            f"{r['bitwise']}, kernel {r['ms'] * 1e3:.2f} us (call {r['call_ms'] * 1e3:.2f} us), "
            f"two single launches {r['singles_ms'] * 1e3:.2f} us, plain "
            f"{r['plain_ms'] * 1e3:.1f} us, grid_sample {r['library_ms'] * 1e3:.1f} us, "
            f"bound {r['bound_ms'] * 1e3:.2f} us")
    torch.cuda.empty_cache()
    return out


def phase_warp_chain(g, motion):
    """K2's pair launch at a fused chain step's shapes: the label stack
    (8, 4, 112, 112) and the video stack (8, 3, 112, 112) sampled at the
    same coordinates, each output held bitwise against the plain version;
    the two single launches on the same inputs beside it. `F.grid_sample`
    computes the same function in one call on the two stacks concatenated
    along the channels."""
    (_, label_shape), (_, video_shape) = WARP_SHAPES[:2]
    label, _, px, py = warp_inputs(label_shape, g, motion)
    video = torch.rand(video_shape, device="cuda", generator=g)
    n, _, h, w = label_shape
    outs = wk.warp_forward_pair(label, video, px, py)
    wants = wk.reference_warp_forward(label, px, py), wk.reference_warp_forward(video, px, py)
    err = max(float((a - b).abs().max()) for a, b in zip(outs, wants))
    if not all(torch.equal(a, b) for a, b in zip(outs, wants)):
        raise AssertionError(f"K2 pair {label_shape} + {video_shape}: not bitwise the plain "
                             f"version, max abs err {err}")
    call, ms = device_ms(lambda: wk.warp_forward_pair(label, video, px, py),
                         match="warp_forward_kernel")
    _, singles = device_ms(lambda: (wk.warp_forward(label, px, py), wk.warp_forward(video, px, py)),
                           match="warp_forward_kernel")
    plain, _ = device_ms(lambda: (wk.reference_warp_forward(label, px, py),
                                  wk.reference_warp_forward(video, px, py)), reps=5)
    both, grid = torch.cat([label, video], dim=1), _grid(px, py, h, w)
    lib, _ = device_ms(lambda: F.grid_sample(both, grid, mode="bilinear", padding_mode="border",
                                             align_corners=False))
    nbytes = 2 * (label.numel() + video.numel()) * 4 + 2 * px.numel() * 4
    return dict(shape=[list(label_shape), list(video_shape)], motion=motion, max_abs_err=err,
                bitwise=True, ms=ms, call_ms=call, singles_ms=singles, plain_ms=plain,
                library_ms=lib, bound_ms=nbytes / PEAK_HBM_BYTES * 1e3, bound_by="bytes")


def count_syncs(fn):
    """Run fn with torch's sync debug mode set to "warn": returns (fn's
    result, the calls in it that waited for the device, counted by the
    file:line of the Python frame that made each)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")   # before the capture: it warns that it is a prototype
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            result = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sites = collections.Counter(f"{w.filename}:{w.lineno}" for w in caught
                                if "synchronizing" in str(w.message))
    return result, sites


# Each kernel's count (`<kernel>.launches` of `utils/profiling.counters`)
# when `_zero_launches` last zeroed it; a plain version counts nothing.
_ZEROED: dict = {}


def _zero_launches(*kernels):
    for kernel in kernels:
        _ZEROED[kernel] = counters().get(f"{kernel}.launches", 0)


def _launched(kernel: str) -> int:
    """The launches of a kernel wrapper since `_zero_launches` zeroed it."""
    return counters().get(f"{kernel}.launches", 0) - _ZEROED.get(kernel, 0)


def _launch_counts():
    """(K2, K3, K4) launches since `_zero_launch_counts`."""
    return tuple(_launched(k) for k in ("warp_forward", "warp_image_grad", "warp_coord_grad"))


def _zero_launch_counts():
    _zero_launches("warp_forward", "warp_image_grad", "warp_coord_grad")


def _step_grads(device, batch, dtype=torch.float32):
    """Loss and per-parameter gradients (float64, CPU) of one fused train
    step from the seed-3 state at the batch's size, on `device`: float64
    casts the model and its outputs, bf16 sets `TrainConfig.compute_dtype`."""
    n, _, t, h, _ = batch["video"].shape
    cfg = TrainConfig(clip_length=t, image_size=(h, h), batch_size=n,
                      compute_dtype=torch.bfloat16 if dtype == torch.bfloat16 else torch.float32)
    state = create_train_state(3, cfg, device=device)
    b = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    if dtype == torch.float64:
        state.model.double().output_dtype = torch.float64
        b["video"] = b["video"].double()
    state, m = make_train_step(fused_ota=True)(state, b)
    grads = {k: p.grad.detach().double().cpu() for k, p in state.model.named_parameters()}
    return float(m["loss"]), grads


def phase_train():
    """Full-width fused train steps with launch counts, an eval step, and
    a small step on the card against the same step on the CPU."""
    cfg = TrainConfig()
    t = cfg.clip_length
    host = list(synthetic_batches(cfg.batch_size, t, cfg.image_size[0], 4, seed=0))
    state = create_train_state(0, cfg, device="cuda")
    n_params = sum(p.numel() for p in state.model.parameters())
    batches = list(prefetch_to_device(iter(host), "cuda"))
    train_step, eval_step = make_train_step(fused_ota=True), make_eval_step()
    torch.cuda.synchronize()

    _zero_launch_counts()
    step_ms, metrics = [], []
    for batch in batches[:3]:
        t0 = time.perf_counter()
        state, m = train_step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    train_counts = _launch_counts()
    # Per fused step: one pair launch (K2) for the label and the video warp
    # and their two coordinate gradients (K4) in each of the T-1 chain
    # steps; K3 for the label warps only, and not at chain step 0, whose
    # labels are constants.
    want_train = (3 * (t - 1), 3 * (t - 2), 3 * 2 * (t - 1))
    _zero_launch_counts()
    ev = {k: float(v) for k, v in eval_step(state, batches[3]).items()}
    eval_counts = _launch_counts()
    want_eval = (2 + (t - 1), 0, 0)   # OTA's two batched warps + T-1 chain warps
    log(f"train: {n_params} params, batch {tuple(batches[0]['video'].shape)}, fp32 "
        f"(TF32 off), step ms {[round(x, 1) for x in step_ms]} (information only)")
    for i, m in enumerate(metrics):
        log(f"  step {i}: " + " ".join(f"{k}={v:.5f}" for k, v in m.items()))
    log(f"  eval: " + " ".join(f"{k}={v:.5f}" for k, v in ev.items()))
    log(f"  launches (K2, K3, K4): train {train_counts}, implied {want_train}; "
        f"eval {eval_counts}, implied {want_eval}")
    if train_counts != want_train or eval_counts != want_eval:
        raise AssertionError("warp launch counts differ from the counts the code implies")
    if not all(np.isfinite(v) for m in metrics + [ev] for v in m.values()):
        raise AssertionError(f"non-finite training metrics {metrics} {ev}")
    if not all(bool(torch.isfinite(p).all()) for p in state.model.parameters()):
        raise AssertionError("non-finite parameters after 3 steps")
    _, syncs = count_syncs(lambda: train_step(state, batches[3]))
    log(f"  calls that wait for the device in one more fused step: {sum(syncs.values())} "
        f"(want 0) {dict(syncs)}")
    if syncs:
        raise AssertionError(f"the fused train step waits for the device: {dict(syncs)}")
    del state, batches
    torch.cuda.empty_cache()

    small = next(synthetic_batches(2, 8, 32, 1, seed=11))
    loss_c, grads_c = _step_grads("cuda", small)
    loss_h, grads_h = _step_grads("cpu", small)
    loss_rel = abs(loss_c - loss_h) / abs(loss_h)
    flat_c = torch.cat([g.reshape(-1) for g in grads_c.values()])
    flat_h = torch.cat([g.reshape(-1) for g in grads_h.values()])
    grad_rel = float((flat_c - flat_h).norm() / flat_h.norm())
    top = max(float(g.norm()) for g in grads_h.values())
    live = {k: g for k, g in grads_h.items() if float(g.norm()) > ZERO_LEAF * top}
    leaf_rel = max(float((grads_c[k] - g).norm() / g.norm()) for k, g in live.items())
    zero_leaf = max((float(g.norm()) / top for k, g in grads_c.items() if k not in live),
                    default=0.0)
    log(f"card vs CPU, one fused step at (2, 3, 8, 32, 32): loss {loss_c:.6f} vs "
        f"{loss_h:.6f} (rel {loss_rel:.2e}, limit {LOSS_TOL:.0e}), gradients rel L2 "
        f"{grad_rel:.2e} (limit {GRAD_TOL:.0e}), worst of {len(live)} leaves rel L2 "
        f"{leaf_rel:.2e} (limit {LEAF_TOL:.0e}), largest of {len(grads_c) - len(live)} "
        f"zero leaves on the card {zero_leaf:.2e} of the top (limit {ZERO_LEAF:.0e})")
    if not (loss_rel <= LOSS_TOL and grad_rel <= GRAD_TOL and leaf_rel <= LEAF_TOL
            and zero_leaf <= ZERO_LEAF):
        raise AssertionError("card and CPU train steps disagree")
    names = ("warp_forward", "warp_image_grad", "warp_coord_grad")
    return {"launches": dict(zip(names, train_counts)),
            "eval_launches": dict(zip(names, eval_counts)), "step_ms": step_ms,
            "syncs_per_step": sum(syncs.values())}


def phase_k1():
    torch.backends.cuda.matmul.allow_tf32 = False
    projs, w = k1_inputs()
    result = {}
    for with_motion in (False, True):
        got = decoder_heads(projs, **w, out_hw=(112, 112), with_motion=with_motion)
        torch.cuda.synchronize()
        want = reference_decoder_heads(projs, **w, out_hw=(112, 112), with_motion=with_motion)
        err, excess = 0.0, 0.0
        for a, b in zip(got, want):
            if b is None:
                continue
            diff = (a - b).abs()
            err = max(err, float(diff.max()))
            excess = max(excess, float((diff - K1_TOL * (1 + b.abs())).max()))
        del got, want
        if not excess <= 0.0:
            raise AssertionError(f"K1 (with_motion={with_motion}) disagrees with its plain "
                                 f"version: max abs err {err}")
        ms = cuda_ms(lambda: decoder_heads(projs, **w, out_hw=(112, 112),
                                           with_motion=with_motion), reps=10)
        plain_ms = cuda_ms(lambda: reference_decoder_heads(
            projs, **w, out_hw=(112, 112), with_motion=with_motion), reps=3, warmup=1)
        b = k1_bound(projs, with_motion)
        bb = b["bounds"]
        result[with_motion] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **b)
        log(f"K1 with_motion={with_motion}: max_abs_err {err:.3e}, kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms; bound {b['bound_ms']:.3f} ms by {b['bound_by']} "
            f"(CUDA cores {bb['cuda_cores_ms']:.3f}, tensor cores 3xTF32 "
            f"{bb['tensor_cores_ms']:.3f}, memory {bb['memory_ms']:.3f} ms), "
            f"{b['bound_ms'] / ms:.1%} of it; fp32 CUDA-core bound "
            f"{bb['fp32_cuda_cores_ms']:.3f} ms, {bb['fp32_cuda_cores_ms'] / ms:.1%} "
            f"of it; {b['flops'] / ms / 1e9:.1f} TFLOP/s of useful work "
            f"({b['flops'] / 1e9:.1f} GFLOP, {b['nbytes'] / 1e9:.3f} GB)")
    del projs
    torch.cuda.empty_cache()
    return result


def smoke_weights(seed=0):
    """Seeded full-width MotionNet state dict; seg head x50 so the argmax
    is decided by the network and not by fp noise, bias centred on a sample
    clip's median logit margin so the masks are not all one class."""
    model = create_model(seed=seed)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    state["segmentation_head.weight"] = state["segmentation_head.weight"] * 50.0
    model.load_state_dict(state)
    clip = make_beating_video(num_frames=32, seed=99).video
    x = torch.from_numpy(zeroone_normalizer(clip))[None].cuda()
    with torch.no_grad():
        seg, _ = model.cuda()(x)
    med = float((seg[0, 1] - seg[0, 0]).median())
    state["segmentation_head.bias"] = state["segmentation_head.bias"] + torch.tensor(
        [med / 2, -med / 2])
    return state


def main_path_videos():
    """Phase 4's three synthetic 176-frame 112x112 uint8 videos."""
    return [make_beating_video(num_frames=176, period=p, seed=s).video.astype(np.uint8)
            for s, p in ((1, 38.0), (2, 44.0), (3, 50.0))]


def phase_main_path():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    state = smoke_weights()
    engine = VideoSegmenter(state, dtype=torch.float32)
    videos = main_path_videos()
    engine.segment_video(videos[0], num_clips=5, step=1, fuse_method="simple")  # warm-up
    torch.cuda.synchronize()

    _zero_launches("decoder_heads")
    t0 = time.perf_counter()
    masks = list(engine.segment_videos(videos, num_clips=5, step=1, fuse_method="simple"))
    seconds = time.perf_counter() - t0
    launches = _launched("decoder_heads")
    if launches < 1:
        raise AssertionError("the main path never launched the decoder-tail kernel")

    efs = [compute_ef_using_putative_clips(m) for m in masks]
    for m in masks:
        if m.shape != (176, 112, 112) or m.dtype != np.uint8 or m.max() > 1:
            raise AssertionError(f"bad mask {m.shape} {m.dtype} max {m.max()}")
    if not all(np.isfinite(e) for ef in efs for e in ef):
        raise AssertionError(f"non-finite EF {efs}")
    fg = float(np.mean([m.mean() for m in masks]))
    log(f"main path: {len(videos)} videos x 176 frames in {seconds:.3f} s "
        f"({len(videos) * 176 / seconds:.1f} frames/s on {torch.cuda.get_device_name(0)}, "
        f"fp32, information only); "
        f"K1 launches {launches}; foreground {fg:.3f}; EF per video {efs}")

    model_engine = VideoSegmenter(state, dtype=torch.float32, decoder="model")
    ref = list(model_engine.segment_videos(videos, num_clips=5, step=1, fuse_method="simple"))
    mismatch = max(float((a != b).mean()) for a, b in zip(masks, ref))
    log(f"kernel decoder vs model decoder on the card: mismatch {mismatch:.2e}")
    if mismatch > MASK_TOL:
        raise AssertionError(f"mask mismatch {mismatch} > {MASK_TOL}")
    del model_engine, ref

    short = make_beating_video(num_frames=40, seed=5).video.astype(np.uint8)
    cpu = VideoSegmenter(state, device="cpu").segment_video(short, num_clips=2, step=1)
    gpu = engine.segment_video(short, num_clips=2, step=1)
    cpu_mismatch = float((cpu != gpu).mean())
    log(f"card vs CPU engine, 40-frame video: mismatch {cpu_mismatch:.2e}")
    if cpu_mismatch > MASK_TOL:
        raise AssertionError(f"card/CPU mask mismatch {cpu_mismatch} > {MASK_TOL}")

    auto = VideoSegmenter(state)   # the default: bf16 backbone on CUDA
    bf16 = auto.segment_video(videos[0], num_clips=5, step=1, fuse_method="simple")
    log(f"default dtype {auto.dtype}: mask shape {bf16.shape}, "
        f"mismatch vs fp32 {float((bf16 != masks[0]).mean()):.2e} (information only)")
    return launches, {"state": state, "videos": videos, "masks": masks}

CLIP_TOL = 1e-4        # probabilities and motion: folded (K1) vs the module's forward, fp32
SEG_GAIN = 50.0        # smoke_weights' seg head gain
MOTION_GAIN = 10.0     # phase 7's motion head gain
CLIP_STARTS = 16       # clips of phase 7, the starts covering one ED frame
CLIP_CHUNK = 8


@contextlib.contextmanager
def plain_warp():
    """Inside the block the warp (forward, image and coordinate gradients)
    runs its plain PyTorch versions on CUDA tensors too (the reference of
    the propagation and of the CAMUS losses on the card)."""
    kernels = wk.warp_forward, wk.warp_forward_pair, wk.warp_image_grad, wk.warp_coord_grad
    wk.warp_forward, wk.warp_image_grad, wk.warp_coord_grad = (
        wk.reference_warp_forward, wk.reference_warp_image_grad, wk.reference_warp_coord_grad)
    wk.warp_forward_pair = lambda a, b, px, py: (wk.reference_warp_forward(a, px, py),   # noqa: E731
                                                 wk.reference_warp_forward(b, px, py))
    try:
        yield
    finally:
        wk.warp_forward, wk.warp_forward_pair, wk.warp_image_grad, wk.warp_coord_grad = kernels


def with_plain_warp(fn):
    def run():
        with plain_warp():
            return fn()
    return run


def k2_bytes(n, c, h, w):
    """K2's least traffic: the image read and the output written once, px
    and py read once."""
    return 2 * n * c * h * w * 4 + 2 * n * h * w * 4


def clip_workload():
    """Phase 7's inputs: the smoke weights with the motion head x10 (a few
    pixels between frames; the init's is ~0.1 px), a 176-frame synthetic
    video in [0, 1], its second ED frame and the first 16 clip starts that
    cover it."""
    from echoflow_torch.infer.ef import start_points_covering_frame

    state = smoke_weights()
    state["motion_head.weight"] = state["motion_head.weight"] * MOTION_GAIN
    beat = make_beating_video(num_frames=176, period=44.0, seed=4)
    video = zeroone_normalizer(beat.video.copy())
    ed = int(beat.ed_frames[1])
    return state, video, ed, start_points_covering_frame(ed, video.shape[1])[:CLIP_STARTS]


def rollout_inputs(labels, motion, clips, ed, starts):
    """The rollouts' inputs on the card from the clip outputs: each clip's
    one-hot label at the ED frame and at its last frame, its motion, and
    its frames."""
    dev = torch.device("cuda")
    lab = torch.from_numpy(labels).to(dev).long()
    rows = torch.arange(len(starts), device=dev)
    ed_in_clip = torch.from_numpy(ed - starts).to(dev)
    one_hot = lambda m: torch.stack([1 - m, m], dim=1).float()   # noqa: E731
    return (one_hot(lab[rows, ed_in_clip]), one_hot(lab[:, -1]),
            torch.from_numpy(motion).to(dev), torch.from_numpy(clips).to(dev))


def phase_clips():
    """Phase 7: `ClipForward` with the motion head at full width on the 16
    clips around one ED frame of a 176-frame video, against the module's
    forward on the card and the CPU port; then the rollouts of
    `infer/propagate.py` on their motion, each against the same call on the
    plain warp."""
    from echoflow_torch.infer import propagate
    from echoflow_torch.infer.clips import ClipForward

    # The eager rollouts (phase 13b holds their graphs against them).
    deform_forback = propagate.deform_forback.__wrapped__
    deform_images_forback = propagate.deform_images_forback.__wrapped__
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    state, video, ed, starts = clip_workload()
    clip_fwd = ClipForward(state, dtype=torch.float32, forward_chunk=CLIP_CHUNK)
    clip_fwd.segment_start_points(video, starts[:CLIP_CHUNK])   # warm-up
    torch.cuda.synchronize()

    _zero_launches("decoder_heads")
    t0 = time.perf_counter()
    labels, probs, motion = clip_fwd.segment_start_points(video, starts)
    clip_seconds = time.perf_counter() - t0
    launches = _launched("decoder_heads")
    want_launches = -(-len(starts) // CLIP_CHUNK)
    n = len(starts)
    log(f"clips: {n} clips around ED frame {ed} (starts {starts[0]}..{starts[-1]}), "
        f"K1 launches {launches}, implied {want_launches}; ClipForward "
        f"{clip_seconds * 1e3:.1f} ms (host clock, to numpy)")
    if launches != want_launches:
        raise AssertionError("ClipForward's K1 launches differ from ceil(clips / chunk)")
    if labels.shape != (n, 32, 112, 112) or motion.shape != (n, 4, 32, 112, 112) \
            or not (np.isfinite(probs).all() and np.isfinite(motion).all()):
        raise AssertionError(f"bad clip outputs {labels.shape} {probs.shape} {motion.shape}")

    # The labels and motion of the smoke model are held against the
    # module's forward on the card (16 clips) and the CPU port (2 clips).
    # Its probabilities are not: its seg head is x50, so its logits are 50
    # times larger than the init's and fp32 rounding moves a probability
    # 50 times as far (2.55e-4 on the card). They are held on the same
    # model with the seg head's weight and bias divided by 50 (logits / 50,
    # the init's scale, for which the 1e-4 bar is meant).
    clips = np.stack([video[:, s:s + 32] for s in starts])
    unit = dict(state)
    for key in ("segmentation_head.weight", "segmentation_head.bias"):
        unit[key] = state[key] / SEG_GAIN
    unit_probs = ClipForward(unit, forward_chunk=CLIP_CHUNK, with_motion=False)(clips)[0]
    refs = (("module forward on the card", slice(None),
             ClipForward(state, forward_chunk=CLIP_CHUNK, fold_bn=False)
             .segment_start_points(video, starts),
             ClipForward(unit, forward_chunk=CLIP_CHUNK, fold_bn=False, with_motion=False)),
            ("CPU port, 2 clips", slice(0, 2),
             ClipForward(state, device="cpu", forward_chunk=CLIP_CHUNK)
             .segment_start_points(video, starts[:2]),
             ClipForward(unit, device="cpu", forward_chunk=CLIP_CHUNK, with_motion=False)))
    for name, sl, (r_labels, r_probs, r_motion), unit_ref in refs:
        mismatch = float((labels[sl] != r_labels).mean())
        m_err = float(np.abs(motion[sl] - r_motion).max())
        p50_err = float(np.abs(probs[sl] - r_probs).max())
        p_err = float(np.abs(unit_probs[sl] - unit_ref(clips[sl])[0]).max())
        log(f"  clips vs {name}: labels mismatch {mismatch:.2e} (limit {MASK_TOL:.0e}), "
            f"motion {m_err:.2e}, probabilities of the seg head / {SEG_GAIN:.0f} {p_err:.2e} (limit "
            f"{CLIP_TOL:.0e}); probabilities at x{SEG_GAIN:.0f} {p50_err:.2e} (information)")
        if mismatch > MASK_TOL or p_err > CLIP_TOL or m_err > CLIP_TOL:
            raise AssertionError(f"ClipForward disagrees with the {name}")
    del refs, unit_probs
    ms_call, k1_ms = device_ms(lambda: clip_fwd(clips), reps=3, match="decoder_heads_kernel")
    meta = [torch.empty(CLIP_CHUNK, 32, r, r, 64, device="meta") for r in (56, 28, 14, 7)]
    k1_b = k1_bound(meta, with_motion=True)
    k1_per_launch = k1_ms / want_launches
    log(f"  K1 with motion on the clip path: {k1_per_launch:.3f} ms a launch of "
        f"{CLIP_CHUNK} clips, bound {k1_b['bound_ms']:.3f} ms by {k1_b['bound_by']} "
        f"(fp32 CUDA-core bound {k1_b['bounds']['fp32_cuda_cores_ms']:.3f}); device time "
        f"of a ClipForward call {ms_call:.2f} ms")

    label_ed, label_es, mot, images = rollout_inputs(labels, motion, clips, ed, starts)
    calls = {
        "deform_forback": (lambda: deform_forback(label_ed, label_es, mot), 0),
        "deform_forback_bilinear": (lambda: deform_forback(label_ed, label_es, mot,
                                                           mode="bilinear"), 2 * 31),
        "deform_images_forback": (lambda: deform_images_forback(images, mot), 1 + 31),
    }
    t = mot.shape[2]
    k2_bound = {"deform_forback": 0.0,
                "deform_forback_bilinear": 2 * (t - 1) * k2_bytes(n, 2, 112, 112),
                "deform_images_forback": (k2_bytes((t - 1) * n, 3, 112, 112)
                                          + (t - 1) * k2_bytes(n, 3, 112, 112))}
    rollouts = {}
    for name, (fn, want) in calls.items():
        _zero_launches("warp_forward")
        got = fn()
        count = _launched("warp_forward")
        with plain_warp():
            ref = fn()
        bitwise = all(torch.equal(a, b) for a, b in zip(got, ref))
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        ms = cuda_ms(fn, reps=5, warmup=1)
        _, k2_ms = device_ms(fn, reps=3, match="warp_forward_kernel")
        plain_ms = cuda_ms(with_plain_warp(fn), reps=3, warmup=1)
        bound = k2_bound[name] / PEAK_HBM_BYTES * 1e3
        rollouts[name] = dict(launches=count, implied=want, bitwise=bitwise, max_abs_err=err,
                              ms=ms, k2_ms=k2_ms, plain_ms=plain_ms, k2_bound_ms=bound,
                              shape=[list(got[0].shape), list(got[1].shape)])
        log(f"  {name}: K2 launches {count}, implied {want}; bitwise the plain warp {bitwise} "
            f"(max abs err {err:.1e}); call {ms:.3f} ms, K2 {k2_ms:.4f} ms "
            f"({k2_ms * 1e3 / max(count, 1):.2f} us a launch; byte bound {bound:.4f} ms), "
            f"plain warp {plain_ms:.3f} ms; out {rollouts[name]['shape']}")
        if count != want or not bitwise:
            raise AssertionError(f"{name}: K2 launches {count} (want {want}), bitwise {bitwise}")
        del got, ref
    torch.cuda.empty_cache()
    bilinear = [r for r in rollouts.values() if r["implied"]]
    k2_launches = sum(r["implied"] for r in bilinear)   # = the counts, checked above
    return {"clip_launches": launches, "clip_seconds": clip_seconds,
            "k1_ms_per_launch": k1_per_launch, "k1_bound_ms": k1_b["bound_ms"],
            "k1_bound_by": k1_b["bound_by"], "k2_launches": k2_launches,
            "k2_ms_per_launch": sum(r["k2_ms"] for r in bilinear) / k2_launches,
            "k2_bound_ms_per_launch": sum(r["k2_bound_ms"] for r in bilinear) / k2_launches,
            "rollouts": rollouts, "rollout_inputs": (label_ed, label_es, mot, images)}


def write_echoflow_pkl(path, state):
    """`state` (the port's state dict) as an echoflow training checkpoint
    (the pickled numpy tree `motion_segment.py` reads), written without
    jax."""
    import pickle

    from echoflow_torch.models.convert import variables_from_state_dict

    variables = variables_from_state_dict(state)
    payload = {"state": {"step": 0, "params": variables["params"],
                         "batch_stats": variables["batch_stats"], "opt_state": None,
                         "rng": None}, "extra": {}}
    with open(path, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)


def phase_cli():
    """Phase 8: the CLI, `motion_segment_torch.py`, on the card with the
    smoke weights as an echoflow `.pkl`: `main` on a written 96-frame AVI
    where cv2 is present, else its `run` body on the RGB frames of the same
    synthetic video. Artifacts that need a missing host package are
    skipped, and said so."""
    import importlib.util
    import os
    import pickle
    import tempfile

    import motion_segment_torch as cli
    from echoflow_torch.data.synthetic import write_synthetic_avi

    have = {m: importlib.util.find_spec(m) is not None
            for m in ("cv2", "matplotlib", "PIL", "pandas")}
    gif = have["matplotlib"] and have["PIL"]
    content = "all" if gif else "binary,binary_video"
    skipped = [] if gif else ["echo_annotated.gif (needs matplotlib and PIL)"]
    if not have["cv2"]:
        skipped.append("the AVI write and decode (needs cv2): run() on the frames instead")
    log(f"cli: host packages {have}; skipped: {skipped or 'nothing'}")
    with tempfile.TemporaryDirectory() as tmp:
        pkl, avi, out = (os.path.join(tmp, f) for f in ("smoke.pkl", "echo.avi", "out"))
        write_echoflow_pkl(pkl, smoke_weights())
        argv = ["-p", avi, "-m", pkl, "-f", "5", "-s", "1", "-c", content, "-o", out]
        t0 = time.perf_counter()
        if have["cv2"]:
            write_synthetic_avi(avi, num_frames=96, period=24.0, seed=3)
            t0 = time.perf_counter()
            segs, efs, pairs = cli.main(argv)
        else:
            frames = make_beating_video(num_frames=96, period=24.0, seed=3).video
            segs, efs, pairs = cli.run(zeroone_normalizer(frames.astype(np.uint8)),
                                       cli.parse_args(argv))
        seconds = time.perf_counter() - t0
        files = sorted(os.listdir(out))
        want = {"echo_whole_video_segmentation.pkl"}
        want |= {f"echo_ED_Frame_{ed}_segmentation.pkl" for ed, _ in pairs}
        want |= {f"echo_ES_Frame_{es}_segmentation.pkl" for _, es in pairs}
        if gif:
            want.add("echo_annotated.gif")
        with open(os.path.join(out, "echo_whole_video_segmentation.pkl"), "rb") as f:
            whole = pickle.load(f)
    log(f"  CLI {'main' if have['cv2'] else 'run'}: {seconds:.2f} s wall (weights, engine, "
        f"5 shifts, EF, artifacts); masks {segs.shape} {segs.dtype}, foreground "
        f"{float(segs.mean()):.3f}; pairs {pairs}; EF {efs}; artifacts {files}")
    if set(files) != want:
        raise AssertionError(f"CLI artifacts {files}, want {sorted(want)}")
    if segs.shape != (96, 112, 112) or segs.dtype != np.uint8 or segs.max() > 1 \
            or not np.array_equal(whole, segs):
        raise AssertionError(f"bad CLI masks {segs.shape} {segs.dtype}")
    if not all(np.isfinite(e) for e in efs):
        raise AssertionError(f"non-finite EF {efs}")
    return {"seconds": seconds, "used": "main" if have["cv2"] else "run", "skipped": skipped,
            "host_packages": have, "pairs": len(pairs), "efs": efs}


def _grad_dict(model):
    return {k: p.grad.detach().double().cpu() for k, p in model.named_parameters()}


def _compare_steps(loss_a, grads_a, loss_b, grads_b):
    """Phase 6's measures of two steps' agreement: loss relative, all
    gradients and each live leaf by relative L2, the largest zero leaf."""
    flat_a = torch.cat([g.reshape(-1) for g in grads_a.values()])
    flat_b = torch.cat([g.reshape(-1) for g in grads_b.values()])
    top = max(float(g.norm()) for g in grads_b.values())
    live = {k: g for k, g in grads_b.items() if float(g.norm()) > ZERO_LEAF * top}
    return dict(loss_rel=abs(loss_a - loss_b) / abs(loss_b),
                grad_rel=float((flat_a - flat_b).norm() / flat_b.norm()),
                leaf_rel=max(float((grads_a[k] - g).norm() / g.norm()) for k, g in live.items()),
                zero_leaf=max((float(g.norm()) / top for k, g in grads_a.items()
                               if k not in live), default=0.0))


def _spread(runs):
    """The largest relative L2 distance of the gradients of repeated runs
    of one step from its first run."""
    return max(_compare_steps(*runs[0], *r)["grad_rel"] for r in runs[1:])


def _dp_step_grads(batch):
    """Phase 6's `_step_grads` (seed-3 state, one fused step) through
    `data_parallel` in the group that is up."""
    from echoflow_torch.train.loop import data_parallel

    n, _, t, h, _ = batch["video"].shape
    state = data_parallel(create_train_state(3, TrainConfig(clip_length=t, image_size=(h, h),
                                                            batch_size=n), device="cuda"))
    state, m = make_train_step(fused_ota=True)(
        state, {k: torch.as_tensor(v).to("cuda") for k, v in batch.items()})
    return float(m["loss"]), _grad_dict(state.model)


def phase_dp_train():
    """Phase 9a: one-rank NCCL group. The full-width fused step (phase 6's
    seed-0 state and first batch) through `data_parallel` (the gradient
    all-reduce, global BatchNorm and the coupled smoothness): its loss and
    gradients against the plain step's, its launches, and in the third step
    the calls that wait for the device and the collectives of a step. The
    full-width gradients are held at bars set from readings
    (`DP_FULL_GRAD_TOL`); phase 6's (2, 3, 8, 32, 32) step on the card,
    without and with data parallelism, at phase 6's bars. Each step is also run twice to
    read the run-to-run spread (0 where every sum runs in a fixed order)
    that the bars must leave room for."""
    import torch.distributed as dist

    from echoflow_torch.train.loop import data_parallel

    cfg = TrainConfig()
    host = list(synthetic_batches(cfg.batch_size, cfg.clip_length, cfg.image_size[0], 3,
                                  seed=0))
    batches = list(prefetch_to_device(iter(host), "cuda"))
    step = make_train_step(fused_ota=True)
    plain_runs = []
    for _ in range(2):
        plain, m_plain = step(create_train_state(0, cfg, device="cuda"), batches[0])
        plain_runs.append((float(m_plain["loss"]), _grad_dict(plain.model)))
        del plain
        torch.cuda.empty_cache()
    loss_plain, grads_plain = plain_runs[0]
    full_plain_spread = _spread(plain_runs)
    del plain_runs
    small = next(synthetic_batches(2, 8, 32, 1, seed=11))
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(tmp, "store"),
                                world_size=1, rank=0)
        try:
            state = data_parallel(create_train_state(0, cfg, device="cuda"))
            torch.cuda.synchronize()
            _zero_launch_counts()
            t0 = time.perf_counter()
            state, m_dp = step(state, batches[0])
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
            counts = _launch_counts()
            full = _compare_steps(float(m_dp["loss"]), _grad_dict(state.model), loss_plain,
                                  grads_plain)
            step(state, batches[1])
            (state, _), syncs = count_syncs(lambda: step(state, batches[2]))
            torch.cuda.synchronize()
            collectives, device_events = collections.Counter(), collections.Counter()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step(state, batches[0])
                torch.cuda.synchronize()
                profiled_ms = (time.perf_counter() - t0) * 1e3
            nccl_ms = 0.0
            for evt in prof.events():
                if evt.device_type == torch.autograd.DeviceType.CPU:
                    if evt.name.startswith("nccl:"):
                        collectives[evt.name] += 1
                elif "nccl" in evt.name.lower():
                    device_events[evt.name.split("(")[0][:60]] += 1
                    nccl_ms += evt.device_time_total / 1e3
            del state
            torch.cuda.empty_cache()
            dp_runs = [_dp_step_grads(small) for _ in range(2)]
        finally:
            dist.destroy_process_group()
    ref_runs = [_step_grads("cuda", small) for _ in range(2)]
    cmp = _compare_steps(*dp_runs[0], *ref_runs[0])
    small_spread = {"dp": _spread(dp_runs), "plain": _spread(ref_runs)}
    del batches
    torch.cuda.empty_cache()
    want = (cfg.clip_length - 1, cfg.clip_length - 2, 2 * (cfg.clip_length - 1))
    log(f"dp (a): one-rank NCCL group, the full-width data-parallel fused step: loss "
        f"{float(m_dp['loss']):.6f} vs the plain step's {loss_plain:.6f} (rel "
        f"{full['loss_rel']:.2e}, limit {LOSS_TOL:.0e}); launches (K2, K3, K4) {counts}, "
        f"implied {want}; gradients vs the plain step rel L2 {full['grad_rel']:.2e} (limit "
        f"{DP_FULL_GRAD_TOL:.0e}), worst leaf {full['leaf_rel']:.2e} (limit "
        f"{DP_FULL_LEAF_TOL:.0e}), zero leaves {full['zero_leaf']:.2e} (limit {ZERO_LEAF:.0e}); "
        f"two plain steps apart by {full_plain_spread:.2e} (information); first DP step "
        f"{first_ms:.1f} ms (host clock, information only)")
    log(f"  the third step: calls that wait for the device "
        f"{sum(syncs.values())} {dict(syncs)}; collectives (host record) "
        f"{sum(collectives.values())} {dict(collectives)}; device events named nccl "
        f"{sum(device_events.values())}, {nccl_ms:.3f} ms; profiled step {profiled_ms:.1f} ms")
    log(f"  phase 6's (2, 3, 8, 32, 32) step on the card, data-parallel vs plain: loss rel "
        f"{cmp['loss_rel']:.2e} (limit {LOSS_TOL:.0e}), gradients rel L2 {cmp['grad_rel']:.2e} "
        f"(limit {GRAD_TOL:.0e}), worst leaf {cmp['leaf_rel']:.2e} (limit {LEAF_TOL:.0e}), "
        f"zero leaves {cmp['zero_leaf']:.2e} (limit {ZERO_LEAF:.0e}); two runs of each "
        f"apart by {small_spread['dp']:.2e} (data-parallel) and {small_spread['plain']:.2e} (plain) "
        f"(information)")
    if not (full["loss_rel"] <= LOSS_TOL and full["grad_rel"] <= DP_FULL_GRAD_TOL
            and full["leaf_rel"] <= DP_FULL_LEAF_TOL and full["zero_leaf"] <= ZERO_LEAF
            and cmp["loss_rel"] <= LOSS_TOL
            and cmp["grad_rel"] <= GRAD_TOL and cmp["leaf_rel"] <= LEAF_TOL
            and cmp["zero_leaf"] <= ZERO_LEAF):
        raise AssertionError("the data-parallel step disagrees with the plain step")
    if counts != want or syncs:
        raise AssertionError(f"DP step: launches {counts} (implied {want}), "
                             f"synchronizing calls {dict(syncs)}")
    names = ("warp_forward", "warp_image_grad", "warp_coord_grad")
    return {"launches": dict(zip(names, counts)), "full_width": full, "small": cmp,
            "spread": {"full_width_plain": full_plain_spread, **small_spread},
            "collectives": sum(collectives.values()), "collectives_by_name": dict(collectives),
            "nccl_device_events": sum(device_events.values()), "nccl_ms": nccl_ms,
            "syncs_per_step": sum(syncs.values()), "first_step_ms": first_ms,
            "profiled_step_ms": profiled_ms}


def phase_dp_engine(main_run):
    """Phase 9b: the engine sharded over two replicas on the card against
    phase 4's unsharded fp32 masks; K1's launches held at the plan's."""
    from echoflow_torch.infer.pipeline import _build_host_operands

    engine = VideoSegmenter(main_run["state"], devices=["cuda:0", "cuda:0"],
                            dtype=torch.float32)
    videos = main_run["videos"]
    engine.segment_video(videos[0], num_clips=5, step=1, fuse_method="simple")   # warm-up
    torch.cuda.synchronize()
    want = 0
    for v in videos:
        length = v.shape[1]
        t_pad = max(engine.bucket, -(-length // engine.bucket) * engine.bucket)
        n_fwd = len(_build_host_operands(length, 5, 1, t_pad)["valid_clip_idx"])
        want += engine._chunk_plan(n_fwd)[0] * len(engine.devices)
    _zero_launches("decoder_heads")
    t0 = time.perf_counter()
    masks = list(engine.segment_videos(videos, num_clips=5, step=1, fuse_method="simple"))
    seconds = time.perf_counter() - t0
    launches = _launched("decoder_heads")
    mismatch = max(float((a != b).mean()) for a, b in zip(masks, main_run["masks"]))
    _, syncs = count_syncs(lambda: engine.segment_video_async(videos[0], num_clips=5, step=1))
    log(f"dp (b): engine on devices [cuda:0, cuda:0], fp32: K1 launches {launches}, plan "
        f"{want}; masks vs the unsharded engine: mismatch {mismatch:.2e} (limit "
        f"{MASK_TOL:.0e}); {len(videos)} videos in {seconds:.3f} s (information only); "
        f"calls that wait for the device in a dispatch: {sum(syncs.values())} {dict(syncs)}")
    if launches != want or mismatch > MASK_TOL:
        raise AssertionError("the sharded engine disagrees with the plan or the masks")
    del engine
    torch.cuda.empty_cache()
    return {"launches": launches, "mismatch": mismatch, "seconds": seconds,
            "syncs_per_video": sum(syncs.values())}


def phase_dp_dryrun():
    """Phase 9c: echoflow's six multichip cases on one spawned NCCL rank."""
    from echoflow_torch.parallel.dryrun import dryrun_multigpu

    t0 = time.perf_counter()
    lines = dryrun_multigpu(1, "nccl", timeout=600)
    seconds = time.perf_counter() - t0
    log(f"dp (c): dryrun_multigpu(1, nccl): {len(lines)} cases passed in {seconds:.1f} s "
        f"(a spawned rank, its start included)")
    if len(lines) != 6:
        raise AssertionError(f"dryrun: {len(lines)} of 6 cases")
    return {"cases": len(lines), "seconds": seconds}


CAMUS_SHAPE = (4, 10, 112, 112)   # batch, frames, height, width
CAMUS_VALUE_TOL = 1e-5             # relative, a loss value on the card vs the plain warp
CAMUS_TRAIN_TOL = 1e-3             # relative, a CAMUS training loss on the card vs the CPU


def camus_inputs():
    """Seeded inputs of phase 10a on the card: a 1-channel source, 4-class
    logits, their softmax, ED/ES labels and a smooth motion field of a few
    pixels (a 5x5 field x 0.06 upsampled: about 3 px at 112)."""
    n, t, h, w = CAMUS_SHAPE
    g = torch.Generator(device="cuda").manual_seed(10)
    logits = torch.randn((n, 4, t, h, w), device="cuda", generator=g)
    coarse = 0.06 * torch.randn((n * t, 4, 5, 5), device="cuda", generator=g)
    motion = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    return {"video": torch.rand((n, 1, t, h, w), device="cuda", generator=g),
            "motion": motion.reshape(n, t, 4, h, w).transpose(1, 2).contiguous(),
            "logits": logits, "softmax": torch.softmax(logits, dim=1),
            "lab_ed": torch.randint(0, 4, (n, h, w), device="cuda", generator=g),
            "lab_es": torch.randint(0, 4, (n, h, w), device="cuda", generator=g)}


def phase_camus():
    """Phase 10: the CAMUS losses on the card against the plain warp, then
    the CAMUS trainer on the card against the CPU."""
    import train_camus_torch
    from echoflow_torch.train.camus_losses import ota_loss, sgs_ots_loss

    _zero_launches("decoder_heads")
    x = camus_inputs()
    t = CAMUS_SHAPE[1]
    losses = {
        "ota": (lambda m, sm: ota_loss(x["video"], m), (2 * (t - 1), 0, 2 * (t - 1))),
        "sgs_ots": (lambda m, sm: sum(sgs_ots_loss(x["lab_ed"], x["lab_es"], m, sm)),
                    (2 * (t - 1), 2 * (t - 2), 2 * (t - 1))),
    }
    out = {}

    def run(fn):
        m = x["motion"].clone().requires_grad_()
        sm = x["softmax"].clone().requires_grad_()
        value = fn(m, sm)
        value.backward()
        return float(value), m.grad, sm.grad

    for name, (fn, want) in losses.items():
        _zero_launch_counts()
        value, g_m, g_sm = run(fn)
        torch.cuda.synchronize()
        counts = _launch_counts()
        with plain_warp():
            ref, r_m, r_sm = run(fn)
        rel = abs(value - ref) / abs(ref)
        grads = {k: float((a - b).norm() / b.norm())
                 for k, a, b in (("motion", g_m, r_m), ("softmax", g_sm, r_sm))
                 if b is not None}   # ota_loss does not read the softmax
        ms = cuda_ms(lambda: run(fn), reps=5, warmup=1)
        with plain_warp():
            plain_ms = cuda_ms(lambda: run(fn), reps=3, warmup=1)
        out[name] = dict(value=value, plain_value=ref, value_rel=rel, grad_rel=grads,
                         launches=counts, implied=want, ms=ms, plain_ms=plain_ms)
        log(f"camus (a) {name} at {CAMUS_SHAPE}: {value:.6f} vs plain {ref:.6f} (rel "
            f"{rel:.2e}, limit {CAMUS_VALUE_TOL:.0e}); gradients rel L2 {grads} (limit "
            f"{GRAD_TOL:.0e}); launches (K2, K3, K4) {counts}, implied {want}; value and "
            f"gradient {ms:.2f} ms, on the plain warp {plain_ms:.2f} ms")
        if rel > CAMUS_VALUE_TOL or max(grads.values()) > GRAD_TOL or counts != want:
            raise AssertionError(f"CAMUS {name} on the card disagrees with the plain warp")
    del x
    torch.cuda.empty_cache()

    runs = {}
    _zero_launch_counts()
    for acnn in (False, True):
        args = ["--synthetic", "--epochs", "2"] + (["--acnn"] if acnn else [])
        walls = {}
        losses_by = {}
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            model, summary, losses_by[device] = train_camus_torch.main(args + ["--device", device])
            walls[device] = time.perf_counter() - t0
            if device == "cuda":
                card_sha = state_sha(model)
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses_by["cuda"], losses_by["cpu"]))
        key = "acnn" if acnn else "plain"
        runs[key] = dict(losses=losses_by, rel=rel, wall_s=walls, dice=summary, sha=card_sha)
        log(f"camus (b) train_camus_torch {' '.join(args)}: losses on the card "
            f"{[round(v, 6) for v in losses_by['cuda']]}, on the CPU "
            f"{[round(v, 6) for v in losses_by['cpu']]} (rel {rel:.2e}, limit "
            f"{CAMUS_TRAIN_TOL:.0e}); wall {walls['cuda']:.2f} s on the card, "
            f"{walls['cpu']:.2f} s on the CPU")
        if not (np.isfinite(losses_by["cuda"]).all() and rel <= CAMUS_TRAIN_TOL):
            raise AssertionError(f"train_camus_torch {key}: card and CPU disagree")
    # The CAMUS trainer's SegNet runs no warp, and no phase-10 path runs K1.
    train_counts, k1_launches = _launch_counts(), _launched("decoder_heads")
    log(f"camus: launches in 10b (K2, K3, K4) {train_counts}, implied (0, 0, 0); K1 in "
        f"phase 10 {k1_launches}, implied 0")
    if train_counts != (0, 0, 0) or k1_launches:
        raise AssertionError("phase 10 launched kernels its code does not imply")
    names = ("warp_forward", "warp_image_grad", "warp_coord_grad")
    launches = {n: train_counts[i] + sum(r["launches"][i] for r in out.values())
                for i, n in enumerate(names)}
    launches["decoder_heads"] = k1_launches
    return {"losses": out, "train": runs, "launches": launches}


# Phase 11: bf16 mixed-precision and rematerialized train steps, and the
# native host normalizer.
PRECISION_VARIANTS = (("fp32", torch.float32, False), ("fp32_remat", torch.float32, True),
                      ("bf16", torch.bfloat16, False), ("bf16_remat", torch.bfloat16, True))
REMAT_STATS_TOL = 1e-6   # running statistics, remat vs plain step on the card (relative)
BF16_RATIO = 2.0         # card bf16 step's distance from float64 / the CPU port's, at most
BF16_GRAD_ABS = 0.5      # a bf16 step's gradients from float64, at most (relative L2)
BF16_LOSS_TOL = 1e-2     # a bf16 step's loss from float64, at most (relative)
STEM_STATS_TOL = 5e-4    # the stem's running-statistics update, card vs CPU bf16 (relative L2)
RESIDUAL_SCALE = 0.1     # `damped_residuals`: each residual branch's last BatchNorm scale x this


def damped_residuals(state_dict):
    """`state_dict` with each residual branch's last BatchNorm scale
    (`layer*.*.conv2.1.weight`) times `RESIDUAL_SCALE`: the network starts
    near its identity, as torchvision's `zero_init_residual` starts a
    ResNet, but every leaf keeps a gradient. At the plain seeded init a
    train-mode bf16 step is chaotic: each BatchNorm renormalizes its
    branch's bf16 rounding, which grows about 1.2x a conv through the 18
    layers, and the gradients come out 1.2 from float64 on the CPU and on
    the card alike, so a ratio of two such distances holds anything.
    Damped, they are about 0.2 (tests/test_torch_precision.py)."""
    return {k: v * RESIDUAL_SCALE if ".conv2.1.weight" in k and ".layer" in k else v
            for k, v in state_dict.items()}


def _stem_stats(model):
    """The stem's running statistics (its two BatchNorms), one float64
    vector on the CPU."""
    return torch.cat([v.detach().double().cpu().reshape(-1)
                      for k, v in model.state_dict().items()
                      if k.startswith("r2plus1d_model.stem.") and "running" in k])


def _damped_step(device, batch, dtype):
    """`_step_grads`' step from the seed-3 state with `damped_residuals`:
    its loss, gradients (float64, CPU) and the stem's running-statistics
    update."""
    n, _, t, h, _ = batch["video"].shape
    cfg = TrainConfig(clip_length=t, image_size=(h, h), batch_size=n,
                      compute_dtype=torch.bfloat16 if dtype == torch.bfloat16 else torch.float32)
    state = create_train_state(3, cfg, device=device)
    state.model.load_state_dict(damped_residuals(state.model.state_dict()))
    before = _stem_stats(state.model)
    b = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    if dtype == torch.float64:
        state.model.double().output_dtype = torch.float64
        b["video"] = b["video"].double()
    state, m = make_train_step(fused_ota=True)(state, b)
    return float(m["loss"]), _grad_dict(state.model), _stem_stats(state.model) - before


def sync_error(fn):
    """fn() under torch's sync debug mode "error": (fn's result, None), or
    (None, the error of the first call that waited for the device)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(), None
    except RuntimeError as exc:
        return None, str(exc).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)


def phase_precision_steps():
    """Phase 11a: 3 full-width fused steps of each of fp32, fp32 with
    remat, bf16 and bf16 with remat from the seed-0 state on phase 6's
    batches, after one warm-up step (cuDNN's first bf16 calls): the warp
    launches (zeroed just before, 31/30/62 a step), the median unprofiled
    step time, the peak allocated memory after a reset, and one more step
    under sync debug mode "error"."""
    cfg = TrainConfig()
    t = cfg.clip_length
    host = list(synthetic_batches(cfg.batch_size, t, cfg.image_size[0], 5, seed=0))
    want = (3 * (t - 1), 3 * (t - 2), 3 * 2 * (t - 1))
    names = ("warp_forward", "warp_image_grad", "warp_coord_grad")
    out = {}
    for name, dtype, remat in PRECISION_VARIANTS:
        state = create_train_state(0, dataclasses.replace(cfg, compute_dtype=dtype),
                                   device="cuda")
        batches = list(prefetch_to_device(iter(host), "cuda"))
        step = make_train_step(fused_ota=True, remat=remat)
        state, _ = step(state, batches[4])   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_launch_counts()
        step_ms, losses = [], []
        for batch in batches[:3]:
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
        counts = _launch_counts()
        peak = torch.cuda.max_memory_allocated()
        _, error = sync_error(lambda: step(state, batches[3]))
        out[name] = dict(launches=dict(zip(names, counts)), step_ms=step_ms,
                         median_ms=statistics.median(step_ms), peak_bytes=peak, losses=losses,
                         sync_error=error)
        log(f"precision (a) {name}: launches (K2, K3, K4) {counts}, implied {want}; step ms "
            f"{[round(x, 1) for x in step_ms]}, median {out[name]['median_ms']:.1f} (host "
            f"clock, unprofiled); peak allocated {peak / 2**30:.3f} GiB; losses "
            f"{[round(x, 5) for x in losses]}; waits under sync mode 'error': "
            f"{0 if error is None else error}")
        if counts != want or error is not None or not np.isfinite(losses).all():
            raise AssertionError(f"{name} step: launches {counts}, sync error {error}, "
                                 f"losses {losses}")
        if not all(p.dtype == torch.float32 for p in state.model.parameters()):
            raise AssertionError(f"{name}: the parameters are no longer fp32")
        del state, batches, step
        torch.cuda.empty_cache()
    return out


def phase_remat_vs_plain():
    """Phase 11b: one full-width fused step with and without remat from the
    same seed-0 state and batch: loss, gradients and leaves at phase 6's
    bars, running statistics within `REMAT_STATS_TOL`, and
    `num_batches_tracked` at exactly 1 (one update a forward)."""
    cfg = TrainConfig()
    host = next(synthetic_batches(cfg.batch_size, cfg.clip_length, cfg.image_size[0], 1, seed=0))
    runs = {}
    for remat in (False, True):
        state = create_train_state(0, cfg, device="cuda")
        before = {k: v.clone() for k, v in state.model.state_dict().items() if "running" in k}
        batch = {k: torch.as_tensor(v).to("cuda") for k, v in host.items()}
        state, m = make_train_step(fused_ota=True, remat=remat)(state, batch)
        stats = {k: v.double().cpu() for k, v in state.model.state_dict().items()
                 if "running" in k or "num_batches" in k}
        runs[remat] = (float(m["loss"]), _grad_dict(state.model), stats,
                       {k: v.double().cpu() for k, v in before.items()})
        del state, batch
        torch.cuda.empty_cache()
    cmp = _compare_steps(runs[True][0], runs[True][1], runs[False][0], runs[False][1])
    plain, remat = runs[False][2], runs[True][2]
    stat_keys = [k for k in plain if "running" in k]
    stats_rel = max(float((remat[k] - plain[k]).abs().max() / plain[k].abs().max())
                    for k in stat_keys)
    # What a second update with the same batch would add: 0.9 x the first move.
    second = max(float((0.9 * (plain[k] - runs[False][3][k])).abs().max()
                       / plain[k].abs().max()) for k in stat_keys)
    tracked = {int(v) for k, v in remat.items() if "num_batches" in k}
    log(f"precision (b) remat vs plain, one full-width step: loss rel {cmp['loss_rel']:.2e} "
        f"(limit {LOSS_TOL:.0e}), gradients {cmp['grad_rel']:.2e} (limit {GRAD_TOL:.0e}), "
        f"worst leaf {cmp['leaf_rel']:.2e} (limit {LEAF_TOL:.0e}), zero leaves "
        f"{cmp['zero_leaf']:.2e}; running stats {stats_rel:.2e} (limit "
        f"{REMAT_STATS_TOL:.0e}; a second update would move them {second:.2e}); "
        f"num_batches_tracked {sorted(tracked)} (want [1])")
    if not (cmp["loss_rel"] <= LOSS_TOL and cmp["grad_rel"] <= GRAD_TOL
            and cmp["leaf_rel"] <= LEAF_TOL and cmp["zero_leaf"] <= ZERO_LEAF
            and stats_rel <= REMAT_STATS_TOL and tracked == {1}):
        raise AssertionError("the remat step disagrees with the plain step")
    return dict(cmp, stats_rel=stats_rel, second_update=second)


def phase_bf16_vs_float64():
    """Phase 11c: the bf16 step at phase 6's (2, 3, 8, 32, 32) shape from
    the seed-3 state with `damped_residuals`, on the card and on the CPU,
    each measured from the CPU port's float64 step: the card's gradients
    and each live leaf at most `BF16_RATIO` x as far as the CPU's, all
    gradients at most `BF16_GRAD_ABS`, the loss within `BF16_LOSS_TOL`,
    and the stem's running-statistics update within `STEM_STATS_TOL` of
    the CPU's bf16 one (where the two bf16 forwards have not diverged yet,
    so statistics reduced in bf16 show). The loss is one number, the sum
    of many roundings, so the ratio of two such distances is noise (card
    2.1e-3 against the CPU's 8.0e-4 in one run); it has an absolute bar."""
    small = next(synthetic_batches(2, 8, 32, 1, seed=11))
    ref_loss, ref, _ = _damped_step("cpu", small, torch.float64)
    runs = {dev: _damped_step(dev, small, torch.bfloat16) for dev in ("cuda", "cpu")}
    dist = {dev: _compare_steps(loss, grads, ref_loss, ref)
            for dev, (loss, grads, _) in runs.items()}
    top = max(float(g.norm()) for g in ref.values())
    live = [k for k, g in ref.items() if float(g.norm()) > ZERO_LEAF * top]
    leaves = {k: tuple(float((runs[dev][1][k] - ref[k]).norm() / ref[k].norm())
                       for dev in ("cuda", "cpu")) for k in live}
    worst = max(leaves, key=lambda k: leaves[k][0] / leaves[k][1])
    stem = float((runs["cuda"][2] - runs["cpu"][2]).norm() / runs["cpu"][2].norm())
    card, cpu = dist["cuda"], dist["cpu"]
    log(f"precision (c) bf16 step at (2, 3, 8, 32, 32), damped residuals, from the CPU "
        f"float64 step: card loss {card['loss_rel']:.3e}, gradients {card['grad_rel']:.3e}; "
        f"CPU loss {cpu['loss_rel']:.3e}, gradients {cpu['grad_rel']:.3e} (limits: loss "
        f"{BF16_LOSS_TOL:.0e}, gradients {BF16_RATIO}x the CPU's and {BF16_GRAD_ABS}); "
        f"worst leaf ratio {worst} "
        f"{leaves[worst][0]:.3e} / {leaves[worst][1]:.3e}; CPU leaves under 0.5: "
        f"{sum(c < 0.5 for _, c in leaves.values())} of {len(live)}; stem statistics "
        f"{stem:.2e} from the CPU's (limit {STEM_STATS_TOL:.0e})")
    bad = [name for name, (a, b) in (("gradients", (card["grad_rel"], cpu["grad_rel"])),
                                     *leaves.items()) if a > BF16_RATIO * b]
    if bad or card["grad_rel"] > BF16_GRAD_ABS or card["loss_rel"] > BF16_LOSS_TOL \
            or stem > STEM_STATS_TOL:
        raise AssertionError(f"the card's bf16 step: {bad}, gradients {card['grad_rel']}, "
                             f"loss {card['loss_rel']}, stem statistics {stem}")
    return {"card": card, "cpu": cpu, "worst_leaf": [worst, *leaves[worst]], "stem": stem}


def phase_remat_dp():
    """Phase 11d: phase 9a's one-rank NCCL group with the remat step: in the
    fourth step, the collectives of one step (host records; the recompute
    issues BatchNorm's all-gathers again) and, under sync mode "error", no
    wait."""
    import torch.distributed as dist

    from echoflow_torch.train.loop import data_parallel

    cfg = TrainConfig()
    host = list(synthetic_batches(cfg.batch_size, cfg.clip_length, cfg.image_size[0], 3,
                                  seed=0))
    batches = list(prefetch_to_device(iter(host), "cuda"))
    step = make_train_step(fused_ota=True, remat=True)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(tmp, "store"),
                                world_size=1, rank=0)
        try:
            state = data_parallel(create_train_state(0, cfg, device="cuda"))
            state, _ = step(state, batches[0])
            state, _ = step(state, batches[1])
            _, error = sync_error(lambda: step(state, batches[2]))
            torch.cuda.synchronize()
            collectives = collections.Counter()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                step(state, batches[0])
                torch.cuda.synchronize()
            for evt in prof.events():
                if evt.device_type == torch.autograd.DeviceType.CPU and \
                        evt.name.startswith("nccl:"):
                    collectives[evt.name] += 1
            del state
        finally:
            dist.destroy_process_group()
    del batches
    torch.cuda.empty_cache()
    log(f"precision (d) remat DP step, one-rank NCCL group: collectives (host record) "
        f"{sum(collectives.values())} {dict(collectives)}; waits under sync mode 'error': "
        f"{0 if error is None else error}")
    if error is not None:
        raise AssertionError(f"the remat DP step waits for the device: {error}")
    return {"collectives": sum(collectives.values()), "by_name": dict(collectives)}


def phase_native_normalizer(videos):
    """Phase 11e: the native host normalizer, built here with the host
    compiler, bitwise the numpy path on phase 4's three uint8 videos;
    host times (median of 5) of both."""
    from echoflow_torch.ops.native import zeroone_normalize_native
    from echoflow_torch.ops.normalize import zeroone_normalizer_numpy

    t0 = time.perf_counter()
    zeroone_normalize_native(videos[0][:, :1])
    build_s = time.perf_counter() - t0
    times = {"native": [], "numpy": []}
    for v in videos:
        got, want = zeroone_normalize_native(v), zeroone_normalizer_numpy(v)
        if not np.array_equal(got, want):
            raise AssertionError("the native normalizer differs from the numpy path")
        for name, fn in (("native", zeroone_normalize_native),
                         ("numpy", zeroone_normalizer_numpy)):
            runs = []
            for _ in range(5):
                t0 = time.perf_counter()
                fn(v)
                runs.append((time.perf_counter() - t0) * 1e3)
            times[name].append(statistics.median(runs))
    log(f"precision (e) native normalizer: built and loaded in {build_s:.2f} s; bitwise the "
        f"numpy path on {len(videos)} uint8 videos {videos[0].shape}; host ms a video: "
        f"native {[round(x, 2) for x in times['native']]}, numpy "
        f"{[round(x, 2) for x in times['numpy']]} ({os.cpu_count()} host cores)")
    return {"build_s": build_s, "native_ms": times["native"], "numpy_ms": times["numpy"]}


# Phase 12: the train and eval steps as CUDA graphs (`train/graph.py`,
# echoflow's `jax.jit` of both), against the eager steps.
GRAPH_VARIANTS = (("fp32", torch.float32, False, "clasfv"),
                  ("fp32_remat", torch.float32, True, "clasfv"),
                  ("bf16", torch.bfloat16, False, "clasfv"),
                  ("bf16_remat", torch.bfloat16, True, "clasfv"),
                  ("ed_es_only", torch.float32, False, "ed_es_only"))
GRAPH_STEPS = 4        # the warm-up, the capture and its replay, two replays
GRAPH_LR_DROP = 2      # the LR drops at update 2: between the second and third replays
EAGER_RUNS = 2         # eager runs of each variant: their spread is the bar's scale
SPREAD_RATIO = 2.0     # graphed vs eager at most this x the eager runs apart (medians)
MOVE_FLOOR = 1e-6      # ... or this share of the moves: eager runs agree bitwise
# Two eager runs: every variant's eager runs repeat bit for bit (phase 14a
# holds it), so their spread is 0 and the bar is MOVE_FLOOR. While runs
# did not repeat, three were taken: two eager bf16 runs now and then
# agreed nearly bitwise, about ten times closer after 4 steps than two
# runs whose roundings differed (on an H100, a bar of 2 x 8.0e-3 against a
# graphed run 9.1e-2 away), and the median of three pairs was that small
# only when all three runs agreed.
EVAL_TOL = 1e-5        # the graphed eval step's metrics vs the eager one's (relative)
TIMED_REPLAYS = 5
# bf16's eager step is not repeatable to phase 6's bars. Two eager steps
# from one (damped) state and batch, on an H100: all gradients 2.9e-3 to
# 5.8e-3 apart, worst leaf 1.1e-2 to 1.3e-2. A planted fault reads more:
# the label warps' image gradient (K3) dropped moves all gradients by
# 1.0e-2 and the worst leaf by 0.61 (phase 6's note); the comb2 weight
# gradient zeroed moves that leaf by 1.0.
BF16_GRAD_TOL = 1e-2
BF16_LEAF_TOL = 3e-2
# The kernels a profiled replay counts by name: K1, K2, K3 (count, place,
# fill and reduce: K3_KERNELS a launch) and K4.
KERNEL_NAMES = ("decoder_heads_kernel", "warp_forward_kernel", "warp_image_grad_kernel",
                "warp_coord_grad_kernel")
K3_KERNELS = 4


def recipe_steps(recipe, t):
    """(train step factory taking `remat`, eval step factory, launches
    (K2, K3, K4) of a train step, of an eval step) of a recipe at clip
    length t, as its code implies.
    Fused CLAS-FV: one K2 pair launch and two K4 a chain step, K3 from the
    second chain step on (the first warps constant labels); its eval step
    runs the reference schedule (OTA's two batched warps, T-1 chain warps).
    Ed-or-es-only: OTA's two video warps for each clip set (K2 and K4 each),
    and two single-label chains of T-1 warps (K3 from the second step)."""
    from echoflow_torch.train.loop import make_ed_es_only_eval_step, make_ed_es_only_train_step

    if recipe == "clasfv":
        return (lambda remat: make_train_step(fused_ota=True, remat=remat), make_eval_step,
                (t - 1, t - 2, 2 * (t - 1)), (2 + (t - 1), 0, 0))
    return (lambda remat: make_ed_es_only_train_step(remat=remat), make_ed_es_only_eval_step,
            (4 + 2 * (t - 1), 2 * (t - 2), 4 + 2 * (t - 1)), (4 + 2 * (t - 1), 0, 0))


def _flat(tensors):
    return torch.cat([t.detach().reshape(-1).double() for t in tensors])


def _running_stats(model):
    return [v for k, v in model.state_dict().items() if "running" in k]


def _host_grads(model):
    """The gradients as `_compare_steps` takes them, copied to the host in
    their own dtype (fp32), so that the card holds nothing beside the step."""
    return {k: p.grad.detach().cpu() for k, p in model.named_parameters()}


def eager_twin(state, cfg):
    """A new state holding copies of `state`'s parameters, buffers, Adam
    state and update count: the eager step from exactly where `state`
    stands."""
    from echoflow_torch.train.loop import TrainState, make_optimizer

    model = copy.deepcopy(state.model)
    twin = TrainState(model=model, optimizer=make_optimizer(cfg, model.parameters()),
                      schedule=state.schedule, step=state.step)
    # A copy: `load_state_dict` keeps a tensor already on the right device.
    twin.optimizer.load_state_dict(copy.deepcopy(state.optimizer.state_dict()))
    return twin


def _trajectory(cfg, factory, batches, graph):
    """GRAPH_STEPS train steps from the seed-0 state, eager or through
    `graphed`: per step the loss, the launches (K2, K3, K4), the LR the
    update applied (the optimizer's, read after the step) and the host ms;
    the gradients after steps 1 and 3; the moves of the parameters and the
    running statistics over the run; `num_batches_tracked`; the peak
    allocated memory over steps 2-4 (eager) or over the capture and its
    replay (graphed), and the memory reserved after the run (a graph's
    pool keeps a step's activations). A graphed run also takes step 3 (a
    replay) on two eager twins from the same state and batch
    (`eager_twin`): their losses and gradients under "twins". bf16 runs
    start from the seed-0
    weights with `damped_residuals`: at the plain init a bf16 step is
    chaotic, and two eager bf16 steps from one state and batch differ by
    1.4e-2 in their gradients (cuDNN's and K3's run-to-run order,
    renormalized by each BatchNorm); damped, 5.0e-3. Returns (state, step,
    run)."""
    from echoflow_torch.train.graph import graphed

    state = create_train_state(0, cfg, device="cuda")
    if cfg.compute_dtype == torch.bfloat16:
        state.model.load_state_dict(damped_residuals(state.model.state_dict()))
    p0, s0 = _flat(state.model.parameters()).cpu(), _flat(_running_stats(state.model)).cpu()
    step = graphed(factory(), state) if graph else factory()
    steps, twins, peak = [], [], 0
    for i, batch in enumerate(batches[:GRAPH_STEPS]):
        if graph and i == 2:
            peak = torch.cuda.max_memory_allocated()   # over the capture and its replay
            twins = [eager_twin(state, cfg) for _ in range(2)]
        if i == 1:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        before = _launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        rec = dict(ms=(time.perf_counter() - t0) * 1e3, loss=float(m["loss"]),
                   launches=tuple(b - a for a, b in zip(before, _launch_counts())),
                   lr=float(state.optimizer.param_groups[0]["lr"]))
        if i in (0, 2):
            rec["grads"] = _host_grads(state.model)
        if twins:
            rec["twins"] = []
            for twin in twins:
                twin, m_twin = factory()(twin, batch)
                rec["twins"].append((float(m_twin["loss"]), _host_grads(twin.model)))
            twins = []
            torch.cuda.empty_cache()
        steps.append(rec)
    torch.cuda.empty_cache()
    run = dict(steps=steps, peak_bytes=peak if graph else torch.cuda.max_memory_allocated(),
               reserved_bytes=torch.cuda.memory_reserved(),
               param_move=_flat(state.model.parameters()).cpu() - p0,
               stats_move=_flat(_running_stats(state.model)).cpu() - s0,
               tracked=sorted({int(v) for k, v in state.model.state_dict().items()
                               if "num_batches" in k}))
    return state, step, run


def _move_dist(a, b):
    return float((a - b).norm() / b.norm())


def moves_sha(run):
    """SHA-256 of a run's parameter and running-statistics moves (their
    float64 bytes): equal hashes, the same bits."""
    h = hashlib.sha256()
    for k in ("param_move", "stats_move"):
        h.update(run[k].numpy().tobytes())
    return h.hexdigest()


def state_sha(model):
    """SHA-256 of a module's parameters and buffers, in state-dict order."""
    h = hashlib.sha256()
    for v in model.state_dict().values():
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _sci(values):
    return "[" + ", ".join(f"{v:.2e}" for v in values) + "]"


def profile_replay(call, watch=("nccl",)):
    """One `call()` (a replay of a graph, or an eager call to compare)
    under torch.profiler: wall ms, the device's busy ms, the launches of
    K1, K2, K3 (both its kernels) and K4 by kernel name (KERNEL_NAMES), and
    the device events whose name holds one of `watch` (lower case), by
    name."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, names, watched = 0.0, collections.Counter(), collections.Counter()
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CPU or \
                evt.name.startswith("echoflow_torch."):
            continue
        busy += evt.device_time_total / 1e3
        for short in KERNEL_NAMES:
            if short in evt.name:
                names[short] += 1
        if any(w in evt.name.lower() for w in watch):
            watched[evt.name.split("(")[0][:60]] += 1
    return wall, busy, tuple(names[n] for n in KERNEL_NAMES), watched


def step_tolerances(dtype):
    """The bars (all gradients, worst leaf) of a graphed step against the
    eager step from the same state and batch: phase 6's in fp32, BF16_*_TOL
    in bf16."""
    if dtype == torch.bfloat16:
        return {"grad_rel": BF16_GRAD_TOL, "leaf_rel": BF16_LEAF_TOL}
    return {"grad_rel": GRAD_TOL, "leaf_rel": LEAF_TOL}


def _graph_checks(name, res, want, want_eval):
    """The failures of phase 12's checks on one variant's readings."""
    bad = []
    eager, graphed_run = res["runs"][0], res["runs"][-1]
    tols = step_tolerances(res["dtype"])
    for label, c in (("step 1", res["warm_up"]), ("step 3", res["replay"])):
        if not (c["loss_rel"] <= LOSS_TOL and c["grad_rel"] <= tols["grad_rel"]
                and c["leaf_rel"] <= tols["leaf_rel"] and c["zero_leaf"] <= ZERO_LEAF):
            bad.append(f"{label} vs the eager step from the same state")
    for k, d in res["move_dist"].items():
        if d > max(SPREAD_RATIO * res["move_spread"][k], MOVE_FLOOR):
            bad.append(f"{k} {d:.2e} > {SPREAD_RATIO} x {res['move_spread'][k]:.2e}")
    if graphed_run["tracked"] != eager["tracked"]:
        bad.append("num_batches_tracked")
    for r in res["runs"]:
        if [rec["lr"] for rec in r["steps"]] != res["want_lr"]:
            bad.append("LR applied")
        if any(rec["launches"] != want for rec in r["steps"]):
            bad.append("launches a step")
        if not all(np.isfinite(rec["loss"]) for rec in r["steps"]):
            bad.append("loss not finite")
    if res["profiled_launches"] != (0, want[0], K3_KERNELS * want[1], want[2]):
        bad.append(f"kernels by name in a replay {res['profiled_launches']}")
    if res["k1_launches"] != 0:
        bad.append(f"K1 launched {res['k1_launches']} times (the train steps run the plain "
                   "decoder)")
    if res["sync_error"] is not None:
        bad.append(f"a replay waits: {res['sync_error']}")
    if res["evals"] and any(e["rel"] > EVAL_TOL or e["launches"] != want_eval
                            for e in res["evals"]):
        bad.append("graphed eval step")
    if bad:
        raise AssertionError(f"graphed {name} step: {bad}")


def phase_graphs():
    """Phase 12: for each of fp32, fp32 with remat, bf16, bf16 with remat
    and the ed-or-es-only recipe (fp32), GRAPH_STEPS steps from the seed-0
    state (bf16: residuals damped, `_trajectory`) on phase 6's batches,
    EAGER_RUNS times eagerly and once through `graphed`
    (a warm-up, a capture with its replay, two replays), with the LR
    dropping at update GRAPH_LR_DROP. Held against the eager step from
    the same state and batch: the graphed step 1 (the warm-up) against the
    first eager run's, and step 3 (a replay) against an eager twin of the
    graphed state (an eager run's state differs from the graphed run's
    wherever the two steps round apart, amplified by Adam), at phase 6's
    bars in fp32 and BF16_GRAD_TOL and
    BF16_LEAF_TOL in bf16 (`step_tolerances`; how far two eager steps
    from one state are apart is printed beside them: the first two eager
    runs at step 1, a second twin at step 3). After the run the median
    distance of its parameters and running statistics from the eager
    runs' at most SPREAD_RATIO x the median distance of the eager runs'
    pairs, and `num_batches_tracked` equal; the LR each update applied
    equal to the schedule's; launches zeroed just before each step and
    held at the recipe's
    (`recipe_steps`), and K1's zeroed at the variant's start and held at 0
    through all of it. Then on the graphed state the median of TIMED_REPLAYS
    unprofiled replays, one replay under the profiler (K1-K4 by kernel
    name at the step's launches; device busy and idle share) and
    one under sync debug mode "error"; for fp32 and ed-or-es-only the
    graphed eval step (warm-up, capture, replay) against the eager one
    within EVAL_TOL."""
    from echoflow_torch.train.graph import graphed
    from echoflow_torch.train.loop import lr_schedule
    from train_clasfv_torch import synthetic_ed_es_batches

    base = TrainConfig(lr_drop_step=GRAPH_LR_DROP)
    t = base.clip_length
    hosts = {"clasfv": list(synthetic_batches(base.batch_size, t, base.image_size[0],
                                              GRAPH_STEPS + 1, seed=0)),
             "ed_es_only": list(synthetic_ed_es_batches(base.batch_size, t, base.image_size[0],
                                                        GRAPH_STEPS + 1, seed=0))}
    sched = lr_schedule(base)
    want_lr = [float(torch.tensor(sched(k), dtype=torch.float32)) for k in range(GRAPH_STEPS)]
    out = {}
    for name, dtype, remat, recipe in GRAPH_VARIANTS:
        t_variant = time.perf_counter()
        cfg = dataclasses.replace(base, compute_dtype=dtype)
        train_f, eval_f, want, want_eval = recipe_steps(recipe, t)
        factory = functools.partial(train_f, remat)
        _zero_launches("decoder_heads")
        batches = list(prefetch_to_device(iter(hosts[recipe]), "cuda"))
        runs = []
        for graph in (False,) * EAGER_RUNS + (True,):
            state, step, run = _trajectory(cfg, factory, batches, graph)
            runs.append(run)
            if not graph:
                del state, step
                torch.cuda.empty_cache()
        eager, eager2, graphed_run = runs[0], runs[1], runs[-1]
        g1, g3 = graphed_run["steps"][0], graphed_run["steps"][2]
        warm_up = _compare_steps(g1["loss"], g1["grads"], eager["steps"][0]["loss"],
                                 eager["steps"][0]["grads"])
        replay = _compare_steps(g3["loss"], g3["grads"], *g3["twins"][0])
        twins_apart = _compare_steps(*g3["twins"][1], *g3["twins"][0])
        apart = {i: _compare_steps(eager2["steps"][i]["loss"], eager2["steps"][i]["grads"],
                                   eager["steps"][i]["loss"], eager["steps"][i]["grads"])
                 for i in (0, 2)}
        moves = ("param_move", "stats_move")
        dists = {k: [_move_dist(graphed_run[k], e[k]) for e in runs[:-1]] for k in moves}
        spreads = {k: [_move_dist(a[k], b[k]) for a, b in itertools.combinations(runs[:-1], 2)]
                   for k in moves}
        dist = {k: statistics.median(v) for k, v in dists.items()}
        spread = {k: statistics.median(v) for k, v in spreads.items()}
        for r in runs:
            for rec in r["steps"]:
                rec.pop("grads", None)
                rec.pop("twins", None)
            del r["param_move"], r["stats_move"]
        # The graphed state: replays timed, profiled, and under sync mode "error".
        timed = []
        for i in range(TIMED_REPLAYS):
            t0 = time.perf_counter()
            step(state, batches[i % GRAPH_STEPS])
            torch.cuda.synchronize()
            timed.append((time.perf_counter() - t0) * 1e3)
        wall, busy, named, _ = profile_replay(lambda: step(state, batches[0]))
        _, error = sync_error(lambda: step(state, batches[1]))
        evals = None
        if name in ("fp32", "ed_es_only"):
            ev_step = eval_f()
            ref = {k: float(v) for k, v in ev_step(state, batches[GRAPH_STEPS]).items()}
            g_eval = graphed(ev_step, state)
            evals = []
            for _ in range(3):
                before = _launch_counts()
                m = {k: float(v) for k, v in g_eval(state, batches[GRAPH_STEPS]).items()}
                counts = tuple(b - a for a, b in zip(before, _launch_counts()))
                evals.append(dict(rel=max(abs(m[k] - ref[k]) / max(abs(ref[k]), 1e-30)
                                          for k in ref), launches=counts))
            del g_eval
        k1_launches = _launched("decoder_heads")
        del state, step
        torch.cuda.empty_cache()
        eager_ms = [rec["ms"] for r in runs[:-1] for rec in r["steps"][1:]]
        res = out[name] = dict(
            dtype=dtype, k1_launches=k1_launches,
            warm_up=warm_up, replay=replay, eager_apart=apart, twins_apart=twins_apart,
            move_dist=dist, move_dists=dists,
            move_spread=spread, move_spreads=spreads, runs=runs, want_lr=want_lr,
            eager_median_ms=statistics.median(eager_ms), eager_ms=eager_ms,
            graphed_median_ms=statistics.median(timed), timed_ms=timed,
            capture_ms=graphed_run["steps"][1]["ms"], replay_wall_ms=wall,
            replay_busy_ms=busy, replay_idle_share=1.0 - busy / wall,
            profiled_launches=named, sync_error=error, evals=evals,
            seconds=time.perf_counter() - t_variant)
        log(f"graphs ({name}): graphed vs eager from the same state and batch: step 1 "
            f"(warm-up) loss {warm_up['loss_rel']:.2e}, gradients {warm_up['grad_rel']:.2e}, "
            f"worst leaf {warm_up['leaf_rel']:.2e}; step 3 (a replay, vs an eager twin) loss "
            f"{replay['loss_rel']:.2e}, gradients {replay['grad_rel']:.2e}, worst leaf "
            f"{replay['leaf_rel']:.2e}; two eager steps from one state and batch: step 1 "
            f"gradients {apart[0]['grad_rel']:.2e}, worst leaf {apart[0]['leaf_rel']:.2e}, step 3 "
            f"(the twins) {twins_apart['grad_rel']:.2e}, {twins_apart['leaf_rel']:.2e} "
            f"(information; limits: loss {LOSS_TOL:.0e}, gradients "
            f"{step_tolerances(dtype)['grad_rel']:.0e}, worst leaf "
            f"{step_tolerances(dtype)['leaf_rel']:.0e}); the two eager runs at step 3 "
            f"(diverged by then) loss {apart[2]['loss_rel']:.2e}, gradients "
            f"{apart[2]['grad_rel']:.2e} (information)")
        log(f"  after {GRAPH_STEPS} steps (medians; each distance in brackets): parameter moves "
            f"{dist['param_move']:.2e} from the eager runs' {_sci(dists['param_move'])}, eager "
            f"runs apart {spread['param_move']:.2e} {_sci(spreads['param_move'])}; running "
            f"statistics {dist['stats_move']:.2e} {_sci(dists['stats_move'])}, eager runs "
            f"{spread['stats_move']:.2e} {_sci(spreads['stats_move'])} (limit "
            f"{SPREAD_RATIO}x); num_batches_tracked {graphed_run['tracked']} (eager "
            f"{eager['tracked']}); LR applied {[r['lr'] for r in graphed_run['steps']]} "
            f"(schedule {want_lr}, eager {[r['lr'] for r in eager['steps']]})")
        log(f"  launches (K2, K3, K4) a step: graphed "
            f"{[r['launches'] for r in graphed_run['steps']]}, eager "
            f"{[r['launches'] for r in eager['steps']]}, implied {want}; in a profiled replay "
            f"by name (K1, K2, K3 x{K3_KERNELS}, K4) {named}; K1 in the variant {k1_launches}; waits in a "
            f"replay under sync mode 'error': {0 if error is None else error}")
        log(f"  step ms (host clock, unprofiled): eager median {res['eager_median_ms']:.1f} "
            f"{[round(x, 1) for x in eager_ms]}, graphed median {res['graphed_median_ms']:.1f} "
            f"{[round(x, 1) for x in timed]}; capture + first replay {res['capture_ms']:.1f}, "
            f"warm-up {graphed_run['steps'][0]['ms']:.1f}; profiled replay wall {wall:.1f}, "
            f"device busy {busy:.1f} (idle {res['replay_idle_share']:.1%}); peak allocated "
            f"eager {eager['peak_bytes'] / 2**30:.3f} GiB, in the capture "
            f"{graphed_run['peak_bytes'] / 2**30:.3f} GiB; reserved after the run eager "
            f"{eager['reserved_bytes'] / 2**30:.3f} GiB, graphed "
            f"{graphed_run['reserved_bytes'] / 2**30:.3f} GiB"
            + (f"; eval graphed vs eager rel {[e['rel'] for e in evals]} (limit "
               f"{EVAL_TOL:.0e}), launches {[e['launches'] for e in evals]}, implied {want_eval}"
               if evals else "") + f"; {res['seconds']:.1f} s")
        _graph_checks(name, res, want, want_eval)
    return out


TRAINER_STEPS, TRAINER_EPOCHS = 3, 2


def phase_graphed_trainer():
    """Phase 12f: `train_clasfv_torch.main` on the card at full width,
    TRAINER_EPOCHS epochs of TRAINER_STEPS steps with the LR drop after the
    first epoch: it makes its graphed steps once a run (`fit` takes them
    each epoch), so one train graph and one eval graph, replayed across
    the epochs; K2-K4 launches zeroed just before and held at the recipe's
    for every train and validation step, K1's zeroed with them and held at
    0; the LR in force after the run is the dropped one; the last
    checkpoint holds every update."""
    import train_clasfv_torch
    from echoflow_torch.train import checkpoint as ck
    from echoflow_torch.train import graph as graph_module
    from echoflow_torch.train import loop

    made = []

    def recorded(step_fn, state):
        made.append(graph_module.graphed(step_fn, state))
        return made[-1]

    t = TrainConfig().clip_length
    _, _, want, want_eval = recipe_steps("clasfv", t)
    val_steps = max(2, TRAINER_STEPS // 8)   # the trainer's synthetic validation split
    loop.graphed = recorded
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "ck.pth")
            _zero_launch_counts()
            _zero_launches("decoder_heads")
            t0 = time.perf_counter()
            state = train_clasfv_torch.main(
                ["--synthetic", "--steps", str(TRAINER_STEPS), "--epochs", str(TRAINER_EPOCHS),
                 "--lr-drop-epoch", "1", "--log-every", "1", "--out", out])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts, k1_launches = _launch_counts(), _launched("decoder_heads")
            saved_step = ck.load_checkpoint(out + ".last")["step"]
    finally:
        loop.graphed = graph_module.graphed
    train_calls, eval_calls = TRAINER_EPOCHS * TRAINER_STEPS, TRAINER_EPOCHS * val_steps
    implied = tuple(train_calls * a + eval_calls * b for a, b in zip(want, want_eval))
    graphs = [(len(g.graphs), sum(e.replays for e in g.graphs.values())) for g in made]
    lr = float(state.optimizer.param_groups[0]["lr"])
    log(f"graphs (trainer): train_clasfv_torch --synthetic --steps {TRAINER_STEPS} --epochs "
        f"{TRAINER_EPOCHS} --lr-drop-epoch 1 in {seconds:.1f} s (data, captures and checkpoints "
        f"included); graphed steps made {len(made)}, (graphs, replays) each {graphs}, want "
        f"[(1, {train_calls - 1}), (1, {eval_calls - 1})]; launches (K2, K3, K4) {counts}, "
        f"implied {implied}; K1 {k1_launches}; LR after the run {lr}; checkpoint step "
        f"{saved_step}")
    if graphs != [(1, train_calls - 1), (1, eval_calls - 1)] or counts != implied \
            or k1_launches != 0 or lr != float(torch.tensor(1e-5)) or saved_step != train_calls:
        raise AssertionError("the trainer's graphed steps: captures, launches, LR or steps "
                             "differ from the run's")
    return {"seconds": seconds, "graphs": graphs, "launches": counts, "k1_launches": k1_launches}


# Phase 13: the paths echoflow compiles that the port ran op by op before:
# the data-parallel train and eval steps (phase 9a's one-rank NCCL group),
# the rollouts (phase 7's inputs) and the CAMUS trainer, as CUDA graphs.
DP_GRAPH_VARIANTS = (("fp32", torch.float32, False), ("bf16", torch.bfloat16, False),
                     ("fp32_remat", torch.float32, True))
DP_TIMED = 5           # eager steps after the first, and replays, timed (median)


COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "broadcast")


def host_collectives(fn):
    """fn() with each torch.distributed collective of COLLECTIVES counted
    as it is called (the port's code looks them up on the module at each
    call): (fn's result, the calls by name). Inside a capture each call
    puts its collective into the graph."""
    import torch.distributed as dist

    counts, real = collections.Counter(), {name: getattr(dist, name) for name in COLLECTIVES}

    def counted(name):
        def call(*args, **kwargs):
            counts[name] += 1
            return real[name](*args, **kwargs)
        return call

    for name in COLLECTIVES:
        setattr(dist, name, counted(name))
    try:
        out = fn()
    finally:
        for name, f in real.items():
            setattr(dist, name, f)
    return out, counts


def dp_eager_twin(state, cfg):
    """`eager_twin` of a data-parallel state, itself made data-parallel in
    the state's group (the copy leaves BatchNorm's group out)."""
    from echoflow_torch.models.r2plus1d import sync_batchnorm
    from echoflow_torch.train.loop import data_parallel

    group = state.group
    sync_batchnorm(state.model, None)
    try:
        twin = eager_twin(state, cfg)
    finally:
        sync_batchnorm(state.model, group)
    return data_parallel(twin, group)


def _timed_calls(call, batches, count):
    """Host ms of `count` calls of `call(batch)`, each ended by a
    synchronize, and each call's launches (K2, K3, K4)."""
    times, launches = [], []
    for i in range(count):
        before = _launch_counts()
        t0 = time.perf_counter()
        call(batches[i % len(batches)])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        launches.append(tuple(b - a for a, b in zip(before, _launch_counts())))
    return times, launches


def _dp_graph_variant(name, fn, state, batches, compare, profile_eager=True):
    """One variant of phase 13a on a data-parallel state: `fn(state, batch)`
    (a train step returning (state, metrics) or an eval step) eagerly, the
    first call then DP_TIMED timed, the collectives of one call (host
    record) and, with `profile_eager`, one profiled call; then through
    `graphed`: the warm-up, the
    capture (its collectives, host record) with its replay, DP_TIMED timed
    replays, `compare(step)` (the replay against the eager call from the
    same state and batch), one profiled replay and one under sync mode
    "error", and the memory reserved with the graphs (the cache emptied
    first). In a one-rank NCCL group no collective launches a kernel (the
    all-reduces work in place and do nothing; each all-gather is a copy),
    so a replay shows none by name; the host record of the capture shows
    each one the graph holds."""
    from echoflow_torch.train.graph import graphed

    t0 = time.perf_counter()
    _zero_launches("decoder_heads")

    def run(step):
        return lambda batch: step(state, batch)

    eager_ms, eager_launches = _timed_calls(run(fn), batches, 1 + DP_TIMED)
    _, eager_coll = host_collectives(lambda: fn(state, batches[0]))
    e_wall = e_busy = e_named = None
    e_nccl = {}
    if profile_eager:
        e_wall, e_busy, e_named, e_nccl = profile_replay(lambda: fn(state, batches[1]))
    g = graphed(fn, state)
    warm_ms, _ = _timed_calls(run(g), batches[:1], 1)
    t1 = time.perf_counter()
    _, capture_coll = host_collectives(lambda: g(state, batches[1]))
    torch.cuda.synchronize()
    capture_ms = (time.perf_counter() - t1) * 1e3
    graph_ms, graph_launches = _timed_calls(run(g), batches, DP_TIMED)
    values = compare(g)
    wall, busy, named, nccl = profile_replay(lambda: g(state, batches[3]))
    _, error = sync_error(lambda: g(state, batches[0]))
    gc.collect()
    torch.cuda.empty_cache()
    res = dict(
        eager_median_ms=statistics.median(eager_ms[1:]), eager_ms=eager_ms,
        graphed_median_ms=statistics.median(graph_ms), graphed_ms=graph_ms,
        warm_up_ms=warm_ms[0], capture_ms=capture_ms, eager_launches=eager_launches,
        graph_launches=graph_launches, eager_collectives=dict(eager_coll),
        capture_collectives=dict(capture_coll), eager_nccl_events=dict(e_nccl),
        replay_nccl_events=dict(nccl), eager_profiled=(e_wall, e_busy, e_named),
        replay_wall_ms=wall, replay_busy_ms=busy, replay_idle_share=1.0 - busy / wall,
        profiled_launches=named, sync_error=error, values=values,
        reserved_bytes=torch.cuda.memory_reserved(), k1_launches=_launched("decoder_heads"),
        graphs=len(g.graphs))
    log(f"dp graphs ({name}): eager median {res['eager_median_ms']:.1f} ms "
        f"{[round(x, 1) for x in eager_ms]}, graphed median {res['graphed_median_ms']:.1f} "
        f"{[round(x, 1) for x in graph_ms]} (host clock); warm-up {warm_ms[0]:.1f}, capture "
        f"with its replay {capture_ms:.1f}; collectives called: eager step "
        f"{sum(eager_coll.values())} {dict(eager_coll)}, in the capture "
        f"{sum(capture_coll.values())} {dict(capture_coll)}; device events named nccl "
        f"(information; ranges fire only in the eager call): eager {dict(e_nccl)}, replay "
        f"{dict(nccl)}")
    eager_profile = (f"; the eager call's {e_wall:.1f} / {e_busy:.1f}" if profile_eager else "")
    log(f"  profiled replay wall {wall:.1f} ms, device busy {busy:.1f} (idle "
        f"{res['replay_idle_share']:.1%}{eager_profile}); "
        f"K1-K4 by name (K1, K2, K3 x{K3_KERNELS}, K4) replay {named}, eager {e_named}; launches "
        f"(K2, K3, K4) eager {eager_launches[-1]}, graphed {graph_launches}; K1 "
        f"{_launched('decoder_heads')}; waits in a replay: {0 if error is None else error}; "
        f"reserved {res['reserved_bytes'] / 2**30:.3f} GiB; values {values}; "
        f"{time.perf_counter() - t0:.1f} s")
    return res, g


def phase_dp_graphs():
    """Phase 13a: in a one-rank NCCL group (`init_distributed` with a
    `file://` store), for each of fp32, bf16 (residuals damped) and fp32
    with remat, the fused train step of a `data_parallel` state from the
    seed-0 state on phase 6's batches, eager and through `graphed`
    (`_dp_graph_variant`): the replay against the eager step of a twin from
    the same state and batch at phase 12's bars (`step_tolerances`), the
    collectives called in the capture equal to the eager step's, K1-K4
    by name in a replay 0/31/60/62 and by counter 31/30/62 a call, no wait
    in a replay; then the data-parallel eval step on the fp32 state, its
    replays against the eager eval within EVAL_TOL. Medians of DP_TIMED
    eager steps (after the first) and replays, the idle share of a replay
    and the memory reserved with the graphs are printed. Last,
    `_dp_fit_on_mesh` in the same group. Returns (the variants' results,
    the `fit_on_mesh` run's)."""
    from echoflow_torch.parallel.mesh import init_distributed
    from echoflow_torch.train.loop import data_parallel
    import torch.distributed as dist

    gc.collect()
    torch.cuda.empty_cache()
    cfg_base = TrainConfig()
    t = cfg_base.clip_length
    _, _, want, want_eval = recipe_steps("clasfv", t)
    host = list(synthetic_batches(cfg_base.batch_size, t, cfg_base.image_size[0], 5, seed=0))
    batches = list(prefetch_to_device(iter(host), "cuda"))
    out, bad = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        init_distributed("file://" + os.path.join(tmp, "store"), world_size=1, rank=0)
        try:
            for name, dtype, remat in DP_GRAPH_VARIANTS:
                cfg = dataclasses.replace(cfg_base, compute_dtype=dtype)
                state = create_train_state(0, cfg, device="cuda")
                if dtype == torch.bfloat16:
                    state.model.load_state_dict(damped_residuals(state.model.state_dict()))
                state = data_parallel(state)
                factory = functools.partial(make_train_step, fused_ota=True, remat=remat)

                def compare(g, state=state, cfg=cfg, factory=factory):
                    twin, m_twin = factory()(dp_eager_twin(state, cfg), batches[2])
                    want_loss, want_grads = float(m_twin["loss"]), _host_grads(twin.model)
                    del twin
                    _, m = g(state, batches[2])
                    return _compare_steps(float(m["loss"]), _host_grads(state.model),
                                          want_loss, want_grads)

                res, g = _dp_graph_variant(name, factory(), state, batches, compare,
                                           profile_eager=name == "fp32")
                tols = step_tolerances(dtype)
                c = res["values"]
                if not (c["loss_rel"] <= LOSS_TOL and c["grad_rel"] <= tols["grad_rel"]
                        and c["leaf_rel"] <= tols["leaf_rel"] and c["zero_leaf"] <= ZERO_LEAF):
                    bad.append(f"{name}: replay vs the eager twin {c}")
                if name == "fp32":
                    res_eval, g_eval = _dp_eval_variant(state, batches)
                    out["eval"] = res_eval
                    del g_eval
                del g, state, compare
                gc.collect()
                torch.cuda.empty_cache()
                out[name] = res
            fit = _dp_fit_on_mesh(cfg_base, host)
        finally:
            dist.destroy_process_group()
    del batches
    torch.cuda.empty_cache()
    for name, res in out.items():
        launches = want_eval if name == "eval" else want
        if res["capture_collectives"] != res["eager_collectives"]:
            bad.append(f"{name}: collectives in the capture {res['capture_collectives']}, "
                       f"eager {res['eager_collectives']}")
        if any(c != launches for c in res["graph_launches"] + res["eager_launches"]):
            bad.append(f"{name}: launches a call")
        if res["profiled_launches"] != (0, launches[0], K3_KERNELS * launches[1], launches[2]) \
                or res["k1_launches"] != 0:
            bad.append(f"{name}: kernels by name {res['profiled_launches']}, K1 "
                       f"{res['k1_launches']}")
        if res["sync_error"] is not None or res["graphs"] != 1:
            bad.append(f"{name}: waits {res['sync_error']}, graphs {res['graphs']}")
    if bad:
        raise AssertionError(f"graphed data-parallel steps: {bad}")
    return out, fit


def _dp_fit_on_mesh(cfg, host):
    """Phase 13a's entry points: `fit_on_mesh` over the host batches
    `host` (4 train, 3 eval) from the seed-0 state, on the graphed steps
    that `compiled_steps` makes for the data-parallel state (as
    `train_clasfv_torch.py` under torchrun passes them), against the same
    run on the eager steps: both steps graphed, the train graph replayed 3
    times and the eval graph twice, the launches (K1-K4) of the graphed run
    from the counters (0 before it) 4 train and 3 eval steps' worth, every
    metric finite, and the first two losses (the warm-up, and the capture's
    replay after one update) within LOSS_TOL of the eager run's. Then
    `parallel/dryrun.dp_train_steps`, the repo's other `fit_on_mesh`
    driver, on 3 batches: its gradients, read after each step, and 2
    replays (the capture's, then one)."""
    from echoflow_torch.parallel.dryrun import dp_train_steps
    from echoflow_torch.train.graph import GraphedStep
    from echoflow_torch.train.loop import compiled_steps, data_parallel, fit_on_mesh

    train, evaluate = host[:4], host[4:] * 3
    histories = {}
    for mode in ("eager", "graphed"):
        state = data_parallel(create_train_state(0, cfg, device="cuda"))
        steps = (compiled_steps(state) if mode == "graphed"
                 else (make_train_step(), make_eval_step()))
        _zero_launch_counts()
        _zero_launches("decoder_heads")
        t0 = time.perf_counter()
        state, histories[mode] = fit_on_mesh(state, train, evaluate, log_every=1,
                                             log_fn=lambda line: None, steps=steps)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = (_launched("decoder_heads"), *_launch_counts())
        replays = [sum(e.replays for e in s.graphs.values()) if isinstance(s, GraphedStep)
                   else None for s in steps]
        del steps, state
        gc.collect()
        torch.cuda.empty_cache()
    losses = {m: [h["loss"] for h in hist[:4]] for m, hist in histories.items()}
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["graphed"], losses["eager"])]
    finite = all(np.isfinite(v) for h in histories["graphed"] for v in h.values())
    sd = {k: v.detach().cpu().numpy()
          for k, v in create_train_state(0, cfg, device="cpu").model.state_dict().items()}
    driver = dp_train_steps(0, 1, sd, host[:3])
    driver_ok = (driver["replays"] == 2 and len(driver["grads"]) == 3 and driver["step"] == 3
                 and all(np.isfinite(h["loss"]) for h in driver["history"]))
    del sd, driver["grads"], driver["state"]
    gc.collect()
    torch.cuda.empty_cache()
    res = dict(replays=replays, launches=counts, losses=losses, rel=rel, finite=finite,
               seconds=seconds, driver_ok=driver_ok, driver_replays=driver["replays"],
               eval=histories["graphed"][-1])
    log(f"fit_on_mesh on graphs: replays (train, eval) {replays}; launches (K1, K2, K3, K4) "
        f"{counts}, implied (0, {4 * 31 + 3 * 33}, {4 * 30}, {4 * 62}); losses graphed "
        f"{[round(x, 6) for x in losses['graphed']]}, eager "
        f"{[round(x, 6) for x in losses['eager']]}, rel {[f'{x:.1e}' for x in rel]} (the "
        f"first two held to {LOSS_TOL:.0e}); eval {res['eval']}; {seconds:.2f} s (host clock); "
        f"dp_train_steps: replays {driver['replays']}, step {driver['step']}, ok {driver_ok}")
    if replays != [3, 2] or counts != (0, 4 * 31 + 3 * 33, 4 * 30, 4 * 62) or not finite \
            or max(rel[:2]) > LOSS_TOL or not driver_ok:
        raise AssertionError(f"fit_on_mesh on the graphed data-parallel steps: {res}")
    return res


def _dp_eval_variant(state, batches):
    """Phase 13a's eval step on a data-parallel state: each replay's
    metrics against the eager eval step's on the same batch (EVAL_TOL)."""
    from echoflow_torch.train.loop import make_eval_step

    fn = make_eval_step()
    ref = {k: float(v) for k, v in fn(state, batches[2]).items()}

    def compare(g):
        got = {k: float(v) for k, v in g(state, batches[2]).items()}
        rel = max(abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-30) for k in ref)
        return {"rel": rel}

    res, g = _dp_graph_variant("eval", fn, state, batches, compare)
    if res["values"]["rel"] > EVAL_TOL:
        raise AssertionError(f"graphed data-parallel eval step: {res['values']}")
    return res, g


def graph_kernel_nodes(graph):
    """The kernel nodes of `graph` (a CUDAGraph captured with debug mode on,
    as a wrapper of `utils/graphs.py` with `debug` set captures) by name
    (KERNEL_NAMES), read from the graph itself (`cudaGraphDebugDotPrint`):
    what every replay of it launches."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "graph.dot")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # debug_dump announces itself
            graph.debug_dump(path)
        with open(path) as f:
            text = f.read()
    return tuple(text.count(name) for name in KERNEL_NAMES)


def phase_graphed_rollouts(inputs):
    """Phase 13b: phase 7's rollouts (`deform_forback` nearest and bilinear,
    `deform_images_forback`) through their graphs (`infer/propagate.py`
    on CUDA tensors), each wrapper cleared first and capturing in debug
    mode: after the warm-up and the capture, one replay bitwise the eager
    rollout (`fn.__wrapped__`); the launches of that replay by counter, all
    four counters set to 0 just before it (K1, K2, K3, K4: 0, 62 or 32, 0,
    0) and by kernel name among the nodes of the graph the replay ran (the
    wrapper's graph at the call's key, `graph_kernel_nodes`); the call's
    capture the one new graph of its wrapper; eager and graphed call times
    (CUDA events, median of 5); a profiled replay's device busy time, idle
    share and K2 records. The profiler's records are information here:
    late in this script's process they have read one K2 fewer than the
    graph holds (61 of 62), where the counter, the bitwise result and the
    graph's nodes show every launch."""
    from echoflow_torch.infer import propagate

    label_ed, label_es, mot, images = inputs
    calls = {"deform_forback": (propagate.deform_forback, (label_ed, label_es, mot), {}, 0),
             "deform_forback_bilinear": (propagate.deform_forback, (label_ed, label_es, mot),
                                         {"mode": "bilinear"}, 2 * 31),
             "deform_images_forback": (propagate.deform_images_forback, (images, mot), {},
                                       1 + 31)}
    wrappers = {id(fn): fn for fn, *_ in calls.values()}.values()
    for fn in wrappers:
        fn.clear()
        fn.debug = True
    out, bad = {}, []
    try:
        for name, (fn, args, kw, want) in calls.items():
            graphed_call = functools.partial(fn, *args, **kw)
            eager_call = functools.partial(fn.__wrapped__, *args, **kw)
            ref = eager_call()
            held = set(fn.graphs)
            graphed_call()            # the warm-up
            graphed_call()            # the capture and its replay
            key = fn.key(*args, **kw)
            made = set(fn.graphs) - held
            torch.cuda.synchronize()
            _zero_launch_counts()
            _zero_launches("decoder_heads")
            got = graphed_call()
            torch.cuda.synchronize()
            counts = (_launched("decoder_heads"), *_launch_counts())     # K1, K2, K3, K4
            bitwise = all(torch.equal(a, b) for a, b in zip(got, ref))
            nodes = graph_kernel_nodes(fn.graphs[key].graph)       # K1, K2, K3 x4, K4
            eager_ms = cuda_ms(eager_call, reps=5, warmup=1)
            graphed_ms = cuda_ms(graphed_call, reps=5, warmup=1)
            wall, busy, named, _ = profile_replay(graphed_call)
            out[name] = dict(launches=counts, by_name=nodes, bitwise=bitwise,
                             profiler_records=named[1], graphs_made=len(made),
                             eager_ms=eager_ms, graphed_ms=graphed_ms, replay_wall_ms=wall,
                             replay_busy_ms=busy, replay_idle_share=1.0 - busy / wall)
            log(f"rollout graphs ({name}): bitwise the eager rollout {bitwise}; a replay's "
                f"launches (K1, K2, K3, K4) {counts} (counters), {nodes} (by name among the "
                f"nodes of the graph it ran; K3 four names a launch), implied (0, {want}, 0, 0); "
                f"graphs its calls made {len(made)}; the profiler's K2 records {named[1]}; "
                f"eager {eager_ms:.3f} ms, graphed {graphed_ms:.3f} ms (CUDA events, median "
                f"of 5); profiled replay wall {wall:.3f} ms, device busy {busy:.3f} (idle "
                f"{out[name]['replay_idle_share']:.1%})")
            if not bitwise or counts != (0, want, 0, 0) or nodes != (0, want, 0, 0) or \
                    made != {key}:
                bad.append(name)
            del got, ref
    finally:
        for fn in wrappers:
            del fn.debug
            fn.clear()
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"graphed rollouts: {bad}")
    return out


def phase_graphed_camus():
    """Phase 13c: `train_camus_torch.main --synthetic --epochs 2` on the
    card through its graphs (`train/generic.py`: the "fold" and "fold +
    update" graphs of the step, made once a run and replayed across the
    epochs, and the validation forward's) against the same run eager (the
    wrappers swapped for the functions they wrap), with and without
    `--acnn`: losses within CAMUS_TRAIN_TOL, graphs and replays of each
    wrapper, K1-K4 launches (0: the SegNet runs no warp)."""
    import train_camus_torch
    from echoflow_torch.train import generic

    real = generic.GraphedFunction
    out, bad = {}, []
    for acnn in (False, True):
        argv = ["--synthetic", "--epochs", "2", "--device", "cuda"] + (["--acnn"] if acnn else [])
        generic.GraphedFunction = lambda fn, **kw: fn
        try:
            t0 = time.perf_counter()
            model, _, eager_losses = train_camus_torch.main(argv)
            eager_s = time.perf_counter() - t0
            eager_sha = state_sha(model)
        finally:
            generic.GraphedFunction = real
        made = []

        def recording(fn, **kw):
            made.append(real(fn, **kw))
            return made[-1]

        _zero_launch_counts()
        _zero_launches("decoder_heads")
        generic.GraphedFunction = recording
        try:
            t0 = time.perf_counter()
            model, _, losses = train_camus_torch.main(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            sha = state_sha(model)
        finally:
            generic.GraphedFunction = real
        counts = (*_launch_counts(), _launched("decoder_heads"))
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, eager_losses))
        graphs = [(len(g.graphs), sum(e.replays for e in g.graphs.values())) for g in made]
        key = "acnn" if acnn else "plain"
        out[key] = dict(losses=losses, eager_losses=eager_losses, rel=rel, graphs=graphs,
                        launches=counts, seconds=seconds, eager_seconds=eager_s, sha=sha,
                        eager_sha=eager_sha)
        log(f"camus graphs ({key}): losses graphed {[round(x, 5) for x in losses]}, eager "
            f"{[round(x, 5) for x in eager_losses]}, rel {rel:.2e} (limit "
            f"{CAMUS_TRAIN_TOL:.0e}); wrappers made (graphs, replays) {graphs}; launches "
            f"(K2, K3, K4, K1) {counts}; {seconds:.2f} s graphed, {eager_s:.2f} s eager "
            f"(host clock, set-up included)")
        if rel > CAMUS_TRAIN_TOL or any(counts) or not graphs or \
                any(n < 1 or r < 1 for n, r in graphs):
            bad.append(key)
    if bad:
        raise AssertionError(f"the graphed CAMUS trainer: {bad}")
    return out


# Phase 14: repeatable training, and the last two paths echoflow compiles,
# the inference engine and `ClipForward`, as CUDA graphs.
REPEAT_RUNS = 2        # eager runs of phase 12's recipe compared in each setting
STREAM_VIDEOS = 12     # 14b's stream of mixed lengths
LAYOUT_TRANSPOSES = ("nchwtonhwc", "nhwctonchw")   # cuDNN's layout kernels, lower case
STREAM_LENGTHS = (100, 300)
CHILD_TIMEOUT_S = 600  # the fresh process of phase 14a
# The cost line: phase 12's graphed step on the parent's route (every conv
# the plain functional conv on cuDNN's defaults), on `ops/conv.py`'s
# repeatable route, and on the parent's route with the global
# `torch.backends.cudnn.deterministic`, in turns.
COST_ORDER = {"fp32": ("parent", "route", "global", "route", "parent"),
              "bf16": ("parent", "route", "route", "parent")}


@contextlib.contextmanager
def torch_deterministic():
    """torch's deterministic algorithms inside the block, warning (not
    raising) for an op that has none: `index_add_` adds through a sort,
    cuDNN takes deterministic algorithms. The ctypes-launched kernels are
    invisible to it."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


@contextlib.contextmanager
def plain_convs():
    """Inside the block every convolution of the port is the plain
    functional conv, whose backward takes cuDNN's default engines: the
    route before `ops/conv.py` (phase 14a's cost line)."""
    from echoflow_torch.ops import conv as conv_ops

    routed = conv_ops.repeatable
    conv_ops.repeatable = lambda x, weight: False
    try:
        yield
    finally:
        conv_ops.repeatable = routed


def cost_setting(name):
    """The context of one entry of COST_ORDER."""
    if name == "route":
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(plain_convs())
    if name == "global":
        stack.enter_context(deterministic_cudnn())
    return stack


def repeat_settings():
    """The settings of phase 14a's probe: (a) as the trainer runs, (b) the
    plain warp (K3 an `index_add_`) under torch's deterministic algorithms,
    (c) the port's K3 under them, (d) the port's K3 with only cuDNN's
    deterministic algorithms."""
    def plain_deterministic():
        stack = contextlib.ExitStack()
        stack.enter_context(plain_warp())
        stack.enter_context(torch_deterministic())
        return stack
    return {"a": contextlib.nullcontext, "b": plain_deterministic, "c": torch_deterministic,
            "d": deterministic_cudnn}


def repeat_batches(cfg):
    """Phase 12's batches of the CLAS-FV recipe, on the card."""
    host = synthetic_batches(cfg.batch_size, cfg.clip_length, cfg.image_size[0],
                             GRAPH_STEPS + 1, seed=0)
    return list(prefetch_to_device(iter(list(host)), "cuda"))


def repeat_pair(cfg, batches, setting=contextlib.nullcontext, runs=REPEAT_RUNS):
    """REPEAT_RUNS eager runs of phase 12's recipe (`_trajectory`: GRAPH_STEPS
    steps from the seed-0 state, bf16 damped) under `setting`: whether the
    parameters and running statistics after the run are bitwise equal in
    all of them, the largest relative L2 distance of the moves from the
    first run's, and of the step-3 gradients; the first run's `moves_sha`."""
    factory = lambda: make_train_step(fused_ota=True)   # noqa: E731
    t0 = time.perf_counter()
    out = []
    for _ in range(runs):
        with setting():
            state, _, run = _trajectory(cfg, factory, batches, graph=False)
        del state
        out.append(run)
    torch.cuda.empty_cache()
    first = out[0]
    res = dict(bitwise=all(torch.equal(r[k], first[k]) for r in out[1:]
                           for k in ("param_move", "stats_move")),
               param_dist=max(_move_dist(r["param_move"], first["param_move"]) for r in out[1:]),
               stats_dist=max(_move_dist(r["stats_move"], first["stats_move"]) for r in out[1:]),
               step3_grad_rel=max(_compare_steps(
                   r["steps"][2]["loss"], r["steps"][2]["grads"], first["steps"][2]["loss"],
                   first["steps"][2]["grads"])["grad_rel"] for r in out[1:]),
               sha=moves_sha(first), seconds=time.perf_counter() - t0)
    return res


def repeat_child():
    """Setting (a) of phase 14a in this process: one eager fp32 run of
    phase 12's recipe; prints its `moves_sha` as the last line. Phase 14a
    runs it in a fresh process (`start_repeat_child`)."""
    cfg = TrainConfig(lr_drop_step=GRAPH_LR_DROP)
    _, _, run = _trajectory(cfg, lambda: make_train_step(fused_ota=True), repeat_batches(cfg),
                            graph=False)
    print(moves_sha(run), flush=True)


def start_repeat_child():
    """`repeat_child` in a fresh Python process (the kernels are built)."""
    return subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.repeat_child()"],
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def child_sha(proc):
    """The hash the fresh process printed; it is stopped if it overruns."""
    try:
        out, err = proc.communicate(timeout=CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"the fresh process ran over {CHILD_TIMEOUT_S} s")
    if proc.returncode != 0 or not out.strip():
        raise AssertionError(f"the fresh process failed ({proc.returncode}): {err[-3000:]}")
    return out.strip().splitlines()[-1]


def dp_repeat_pair(cfg, batches):
    """REPEAT_RUNS eager runs of phase 12's recipe on a `data_parallel`
    state (phase 13a's: a one-rank NCCL group, global BatchNorm, the flat
    gradient all-reduce): whether their moves are bitwise equal, and the
    largest relative L2 distance of the parameter moves."""
    from echoflow_torch.parallel.mesh import init_distributed
    from echoflow_torch.train.loop import data_parallel
    import torch.distributed as dist

    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        init_distributed("file://" + os.path.join(tmp, "store"), world_size=1, rank=0)
        try:
            for _ in range(REPEAT_RUNS):
                state = data_parallel(create_train_state(0, cfg, device="cuda"))
                p0 = _flat(state.model.parameters()).cpu()
                s0 = _flat(_running_stats(state.model)).cpu()
                step = make_train_step(fused_ota=True)
                for batch in batches[:GRAPH_STEPS]:
                    state, _ = step(state, batch)
                runs.append(dict(param_move=_flat(state.model.parameters()).cpu() - p0,
                                 stats_move=_flat(_running_stats(state.model)).cpu() - s0))
                del state, step
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    first = runs[0]
    return dict(bitwise=all(torch.equal(r[k], first[k]) for r in runs[1:]
                            for k in ("param_move", "stats_move")),
                param_dist=max(_move_dist(r["param_move"], first["param_move"])
                               for r in runs[1:]))


def camus_repeat(camus, camus_graphs):
    """One more eager run of the CAMUS trainer (phase 13c's: `--synthetic
    --epochs 2`, the graph wrappers swapped for the functions they wrap),
    with and without `--acnn`, against phase 13c's eager run: the same
    losses and the same model bits (`state_sha`); and phase 10b's graphed
    run on the card against 13c's graphed run."""
    import train_camus_torch
    from echoflow_torch.train import generic

    out = {}
    real = generic.GraphedFunction
    for key, extra in (("plain", []), ("acnn", ["--acnn"])):
        generic.GraphedFunction = lambda fn, **kw: fn
        try:
            model, _, losses = train_camus_torch.main(
                ["--synthetic", "--epochs", "2", "--device", "cuda"] + extra)
        finally:
            generic.GraphedFunction = real
        earlier = camus_graphs[key]
        out[key] = dict(eager=state_sha(model) == earlier["eager_sha"]
                        and losses == earlier["eager_losses"],
                        graphed=camus["train"][key]["sha"] == earlier["sha"]
                        and camus["train"][key]["losses"]["cuda"] == earlier["losses"])
    return out


def nondeterministic_ops(cfg, batches):
    """The ops of one eager fp32 step that torch knows have no deterministic
    implementation: the distinct messages (to their first clause) of
    `use_deterministic_algorithms(True, warn_only=True)`, counted."""
    state = create_train_state(0, cfg, device="cuda")
    step = make_train_step(fused_ota=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with torch_deterministic():
            step(state, batches[0])
            torch.cuda.synchronize()
    del state
    return dict(collections.Counter(str(w.message).split(",")[0][:120] for w in caught
                                    if "determinis" in str(w.message)))


def graphed_step_ms(cfg, batches, setting):
    """The median of TIMED_REPLAYS unprofiled replays of phase 12's graphed
    step (`cfg`'s dtype) in the COST_ORDER setting `setting`."""
    from echoflow_torch.train.graph import graphed

    with cost_setting(setting):
        state = create_train_state(0, cfg, device="cuda")
        if cfg.compute_dtype == torch.bfloat16:
            state.model.load_state_dict(damped_residuals(state.model.state_dict()))
        step = graphed(make_train_step(fused_ota=True), state)
        for batch in batches[:2]:
            state, _ = step(state, batch)
        times = []
        for i in range(TIMED_REPLAYS):
            t0 = time.perf_counter()
            step(state, batches[i % GRAPH_STEPS])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    del state, step
    torch.cuda.empty_cache()
    return statistics.median(times)


def cost_line(cfg, batches):
    """COST_ORDER's graphed steps of `cfg`'s dtype: ms by setting, and the
    cost of the route and of the global switch against the parent's route."""
    order = COST_ORDER["bf16" if cfg.compute_dtype == torch.bfloat16 else "fp32"]
    ms = collections.defaultdict(list)
    for name in order:
        ms[name].append(graphed_step_ms(cfg, batches, name))
    parent = statistics.mean(ms["parent"])
    return dict(ms=dict(ms), order=order,
                **{f"{k}_cost": statistics.mean(ms[k]) / parent - 1.0
                   for k in ("route", "global") if k in ms})


def phase_repeatable_training(graphs, camus, camus_graphs):
    """Phase 14a: fp32 training repeats bit for bit with the trainer's
    defaults (`ops/conv.py`'s routes). A fresh process runs setting (a)
    meanwhile. Two eager fp32 runs of phase 12's recipe in each of the
    settings (a)-(d) (`repeat_settings`): (a) as the trainer runs, held
    bitwise, (b) the plain warp under torch's deterministic algorithms,
    (c) and (d) held bitwise as before; phase 12's eager runs and graphed
    run of fp32 and of fp32 with remat: the eager runs held
    bitwise, graphed against eager by their distance; two eager runs of
    the one-rank NCCL data-parallel step (`dp_repeat_pair`) and of the
    CAMUS trainer (`camus_repeat`, graphed against graphed too), held
    bitwise; the fresh process's hash held equal to (a)'s; the ops torch
    names nondeterministic in one step; two eager bf16 runs, held bitwise;
    the cost line (`cost_line`) of phase 12's graphed fp32 step, the
    route's cost held below the global switch's, and of the bf16 step;
    K3's device time a launch in an eager fp32 step."""
    child = start_repeat_child()
    base = TrainConfig(lr_drop_step=GRAPH_LR_DROP)
    batches = repeat_batches(base)
    out = {"settings": {}}
    try:
        for name, setting in repeat_settings().items():
            r = out["settings"][name] = repeat_pair(base, batches, setting)
            log(f"repeatable training ({name}): two eager fp32 runs of phase 12's recipe, "
                f"bitwise {r['bitwise']}; parameter moves {r['param_dist']:.3e} apart, running "
                f"statistics {r['stats_dist']:.3e}, step-3 gradients "
                f"{r['step3_grad_rel']:.3e}; {r['seconds']:.1f} s")
        for name in ("fp32", "fp32_remat"):
            g = graphs[name]
            out[name] = dict(eager_bitwise=max(max(v) for v in g["move_spreads"].values()) == 0,
                             graphed_dist={k: max(v) for k, v in g["move_dists"].items()})
            log(f"  phase 12 {name}: {EAGER_RUNS} eager runs bitwise "
                f"{out[name]['eager_bitwise']}; the graphed run from them (largest, parameter "
                f"moves / running statistics) {_sci(out[name]['graphed_dist'].values())}")
        r = out["dp"] = dp_repeat_pair(base, batches)
        log(f"  data-parallel (one-rank NCCL): two eager fp32 runs bitwise {r['bitwise']}, "
            f"parameter moves {r['param_dist']:.3e} apart")
        r = out["camus"] = camus_repeat(camus, camus_graphs)
        log(f"  CAMUS trainer (--synthetic --epochs 2): the same losses and model bits, eager "
            f"run against eager run / phase 10b's graphed run against 13c's: "
            f"{ {k: (v['eager'], v['graphed']) for k, v in r.items()} }")
    finally:
        sha = child_sha(child)
    out["child_sha"] = sha
    log(f"  a fresh process, setting (a)'s run: SHA-256 of its moves {sha[:16]}..., this "
        f"process's {out['settings']['a']['sha'][:16]}..., equal "
        f"{sha == out['settings']['a']['sha']}")
    out["nondeterministic_ops"] = nondeterministic_ops(base, batches)
    log(f"  ops torch names nondeterministic in one fp32 step (warn_only): "
        f"{out['nondeterministic_ops'] or 'none'}")
    bf16 = dataclasses.replace(base, compute_dtype=torch.bfloat16)
    r = out["bf16"] = repeat_pair(bf16, batches)
    log(f"  defaults, bf16 (damped): bitwise {r['bitwise']}; parameter moves "
        f"{r['param_dist']:.3e} apart, running statistics {r['stats_dist']:.3e}, step-3 "
        f"gradients {r['step3_grad_rel']:.3e}")
    for cfg in (base, bf16):
        c = out[f"cost_{'bf16' if cfg is bf16 else 'fp32'}"] = cost_line(cfg, batches)
        log(f"  phase 12's graphed {'bf16 (damped)' if cfg is bf16 else 'fp32'} step, "
            f"{' / '.join(c['order'])} (host clock, median of {TIMED_REPLAYS} replays each): "
            + "; ".join(f"{k} {_sci(v)} ms" for k, v in c["ms"].items())
            + f"; the route {c['route_cost']:+.2%} against the parent's"
            + (f", the global switch {c['global_cost']:+.2%}" if "global_cost" in c else ""))
    state = create_train_state(0, base, device="cuda")
    step = make_train_step(fused_ota=True)
    state, _ = step(state, batches[0])
    before = _launched("warp_image_grad")
    _, k3_ms = device_ms(lambda: step(state, batches[1]), reps=3, match="warp_image_grad_kernel")
    launches = (_launched("warp_image_grad") - before) // 4   # device_ms calls it 4 times
    del state
    torch.cuda.empty_cache()
    out["k3_us_in_step"] = k3_ms * 1e3 / launches
    log(f"  K3 in an eager fp32 step: {out['k3_us_in_step']:.2f} us a launch ({launches} a step, "
        f"its four kernels by name; the float4-atomic K3 read 6.2 us, bound 1.20 us)")
    bad = [f"setting ({k})" for k in ("a", "c", "d") if not out["settings"][k]["bitwise"]]
    bad += [f"phase 12 {k} eager runs" for k in ("fp32", "fp32_remat")
            if not out[k]["eager_bitwise"]]
    bad += ["data-parallel"] * (not out["dp"]["bitwise"]) + ["bf16"] * (not out["bf16"]["bitwise"])
    bad += [f"CAMUS {k} {m}" for k, v in out["camus"].items() for m, ok in v.items() if not ok]
    if sha != out["settings"]["a"]["sha"]:
        bad.append("the fresh process's run")
    if not out["cost_fp32"]["route_cost"] < out["cost_fp32"]["global_cost"]:
        bad.append("the route costs the graphed fp32 step no less than the global switch")
    if bad:
        raise AssertionError(f"repeatable training: {bad}")
    return out


def _count_calls(wrapper):
    """Counts of `wrapper`'s warm-ups and captures from now on (its methods
    wrapped on the instance)."""
    counts = collections.Counter()
    for method, name in ((wrapper._warm_up, "warm_ups"), (wrapper._record, "captures")):
        def counted(*a, _m=method, _n=name, **kw):
            counts[_n] += 1
            return _m(*a, **kw)
        setattr(wrapper, method.__name__, counted)
    return counts


def _engine_pass(engine, videos):
    """One `segment_videos` pass (phase 4's recipe): (masks, host seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    masks = list(engine.segment_videos(videos, num_clips=5, step=1, fuse_method="simple"))
    return masks, time.perf_counter() - t0


def _eager_engine(state, **kw):
    engine = VideoSegmenter(state, **kw)
    engine._run = engine._run.__wrapped__
    return engine


def _engine_key(engine, length):
    """(t_pad, k_num, n_fwd) of a video of `length` frames at 5 shifts,
    step 1: what selects its graph, besides the fusion method and mono."""
    t_pad = max(engine.bucket, -(-length // engine.bucket) * engine.bucket)
    return (t_pad, *engine._operands(length, 5, 1, t_pad)[:2])


def stream_videos():
    """14b's seeded stream: STREAM_VIDEOS synthetic 112x112 uint8 videos,
    lengths drawn from STREAM_LENGTHS."""
    rng = np.random.RandomState(14)
    lengths = rng.randint(STREAM_LENGTHS[0], STREAM_LENGTHS[1] + 1, STREAM_VIDEOS)
    return [make_beating_video(num_frames=int(n), period=float(p), seed=100 + i)
            .video.astype(np.uint8)
            for i, (n, p) in enumerate(zip(lengths, rng.uniform(36.0, 52.0, STREAM_VIDEOS)))]


def phase_engine_graphs(main_run):
    """Phase 14b: the engine on phase 4's three videos through its graphs
    against the eager body (`_run.__wrapped__`), fp32 and the bf16 default:
    masks bitwise, K1's launches by counter (3, the capture's and two
    replays) and by name in a profiled pass, in bf16 no cuDNN layout
    transpose (LAYOUT_TRANSPOSES) in that pass, no wait in a replayed
    dispatch, frames/s of each (in turns), a profiled pass's busy time and
    idle share, captures and the memory reserved; then a seeded stream of
    STREAM_VIDEOS mixed lengths (bf16 default) through a fresh engine of
    each kind: captures, warm-ups, replays, wall time, masks bitwise."""
    state, videos = main_run["state"], main_run["videos"]
    frames = sum(v.shape[1] for v in videos)
    out, bad = {}, []
    for name, dtype in (("fp32", torch.float32), ("bf16", "auto")):
        gc.collect()
        torch.cuda.empty_cache()
        eager = _eager_engine(state, dtype=dtype)
        eager.segment_video(videos[0], num_clips=5, step=1, fuse_method="simple")
        eager_masks, _ = _engine_pass(eager, videos)
        torch.cuda.empty_cache()
        reserved_eager = torch.cuda.memory_reserved()
        engine = VideoSegmenter(state, dtype=dtype)
        counts = _count_calls(engine._run)
        engine.segment_video(videos[0], num_clips=5, step=1, fuse_method="simple")  # warm-up
        _zero_launches("decoder_heads")
        masks, _ = _engine_pass(engine, videos)       # the capture at video 0, two replays
        k1 = _launched("decoder_heads")
        torch.cuda.empty_cache()
        reserved_graphed = torch.cuda.memory_reserved()
        times = {"eager": [], "graphed": []}
        for kind in ("eager", "graphed", "graphed", "eager"):
            got, sec = _engine_pass(eager if kind == "eager" else engine, videos)
            times[kind].append(sec)
            if not all(np.array_equal(a, b) for a, b in zip(got, eager_masks)):
                bad.append(f"{name}: a timed {kind} pass differs")
        wall, busy, named, transposes = profile_replay(lambda: _engine_pass(engine, videos),
                                                       watch=LAYOUT_TRANSPOSES)
        _, error = sync_error(lambda: engine.segment_video_async(videos[1], num_clips=5, step=1,
                                                                 fuse_method="simple"))
        bitwise = all(np.array_equal(a, b) for a, b in zip(masks, eager_masks))
        fps = {k: frames / statistics.median(v) for k, v in times.items()}
        res = out[name] = dict(
            bitwise=bitwise, k1_launches=k1, k1_by_name=named[0],
            layout_transposes=sum(transposes.values()), sync_error=error,
            frames_per_s=fps, seconds=times, replay_wall_ms=wall, replay_busy_ms=busy,
            replay_idle_share=1.0 - busy / wall, captures=counts["captures"],
            warm_ups=counts["warm_ups"], graphs=len(engine._run.graphs),
            reserved_gib={"eager": reserved_eager / 2**30, "graphed": reserved_graphed / 2**30})
        log(f"engine graphs ({name}): masks bitwise the eager body's {bitwise}; K1 launches "
            f"{k1} (counter, 3 videos; the capture's and two replays'), {named[0]} by name in a "
            f"profiled pass; NCHW<->NHWC transposes there {dict(transposes)}; waits in a "
            f"replayed dispatch: {0 if error is None else error}; "
            f"frames/s eager {fps['eager']:.1f}, graphed {fps['graphed']:.1f} (median of 2 "
            f"passes each, in turns, host clock, {frames} frames); a profiled "
            f"graphed pass: wall {wall:.1f} ms, device busy {busy:.1f} ms (idle "
            f"{res['replay_idle_share']:.1%}); warm-ups {counts['warm_ups']}, captures "
            f"{counts['captures']}; reserved GiB after eager {res['reserved_gib']['eager']:.3f}, "
            f"with the graphed engine {res['reserved_gib']['graphed']:.3f}")
        if not bitwise or k1 != len(videos) or named[0] != len(videos) or error is not None \
                or counts["captures"] != 1 or (name == "bf16" and transposes):
            bad.append(name)
        del eager, engine, eager_masks, masks
    gc.collect()
    torch.cuda.empty_cache()
    stream = stream_videos()
    eager = _eager_engine(state)
    engine = VideoSegmenter(state)
    counts = _count_calls(engine._run)
    want, eager_s = _engine_pass(eager, stream)
    got, graphed_s = _engine_pass(engine, stream)
    keys = {_engine_key(engine, v.shape[1]) for v in stream}
    replays = sum(e.replays for e in engine._run.graphs.values())
    res = out["stream"] = dict(
        lengths=[int(v.shape[1]) for v in stream], keys=len(keys), warm_ups=counts["warm_ups"],
        captures=counts["captures"], replays=replays, eager_s=eager_s, graphed_s=graphed_s,
        bitwise=all(np.array_equal(a, b) for a, b in zip(got, want)))
    log(f"  stream of {STREAM_VIDEOS} videos, lengths {res['lengths']} (bf16 default, fresh "
        f"engines): {len(keys)} keys; warm-ups {res['warm_ups']}, captures {res['captures']}, "
        f"replays {replays}; wall eager {eager_s:.3f} s, graphed {graphed_s:.3f} s (host clock, "
        f"first pass of each, set-up of each key included); masks bitwise {res['bitwise']}")
    if not res["bitwise"]:
        bad.append("stream")
    del eager, engine
    gc.collect()
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"engine graphs: {bad}")
    return out


def phase_clip_graphs():
    """Phase 14c: `ClipForward` (fp32, 8 clips a chunk, motion head) on
    phase 7's 16 clips through its graphs against its eager forward
    (`_forward.__wrapped__`): outputs bitwise, K1's launches by counter (2:
    two replays), host ms of a call (median of 5, in turns)."""
    from echoflow_torch.infer.clips import ClipForward

    state, video, _, starts = clip_workload()
    clips = np.stack([video[:, s:s + 32] for s in starts])
    graphed_fwd = ClipForward(state, dtype=torch.float32, forward_chunk=CLIP_CHUNK)
    eager = ClipForward(state, dtype=torch.float32, forward_chunk=CLIP_CHUNK)
    eager._forward = eager._forward.__wrapped__
    want = eager(clips)
    graphed_fwd(clips)                  # the warm-up, then the capture and its replay
    _zero_launches("decoder_heads")
    got = graphed_fwd(clips)
    k1 = _launched("decoder_heads")
    bitwise = all(np.array_equal(a, b) for a, b in zip(got, want))
    times = {"eager": [], "graphed": []}
    for _ in range(5):
        for kind, fn in (("eager", eager), ("graphed", graphed_fwd)):
            t0 = time.perf_counter()
            fn(clips)
            times[kind].append((time.perf_counter() - t0) * 1e3)
    ms = {k: statistics.median(v) for k, v in times.items()}
    log(f"clip graphs: outputs bitwise the eager forward's {bitwise}; K1 launches {k1} "
        f"(implied {-(-len(starts) // CLIP_CHUNK)}); a call of {len(starts)} clips, host ms "
        f"(to numpy, median of 5, in turns): eager {ms['eager']:.1f}, graphed "
        f"{ms['graphed']:.1f}; graphs {len(graphed_fwd._forward.graphs)}")
    del graphed_fwd, eager
    torch.cuda.empty_cache()
    if not bitwise or k1 != -(-len(starts) // CLIP_CHUNK):
        raise AssertionError(f"clip graphs: bitwise {bitwise}, K1 {k1}")
    return {"bitwise": bitwise, "k1_launches": k1, "ms": ms, "times_ms": times}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script "
                         "needs an NVIDIA GPU")
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} ({smi}); torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    seconds = {}

    def timed(phase, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[phase] = round(time.perf_counter() - t0, 1)
        return out

    k1 = timed("3", phase_k1)
    launches, main_run = timed("4", phase_main_path)
    warp = timed("5", phase_warp)
    train = timed("6", phase_train)
    clips = timed("7", phase_clips)
    cli = timed("8", phase_cli)
    dp = {"train": timed("9a", phase_dp_train), "engine": timed("9b", phase_dp_engine, main_run)}
    main_run = {k: main_run[k] for k in ("state", "videos")}   # for phase 14b
    dp["dryrun"] = timed("9c", phase_dp_dryrun)
    camus = timed("10", phase_camus)
    precision = {"steps": timed("11a", phase_precision_steps),
                 "remat_vs_plain": timed("11b", phase_remat_vs_plain),
                 "bf16_vs_float64": timed("11c", phase_bf16_vs_float64),
                 "remat_dp": timed("11d", phase_remat_dp),
                 "native_normalizer": timed("11e", phase_native_normalizer, main_path_videos())}
    graphs = timed("12", phase_graphs)
    trainer = timed("12f", phase_graphed_trainer)
    # Phase 12's graphs went with their states; their pools go back to the card here.
    gc.collect()
    torch.cuda.empty_cache()
    log(f"before phase 13: {torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved")
    dp_graphs, dp_fit = timed("13a", phase_dp_graphs)
    rollout_graphs = timed("13b", phase_graphed_rollouts, clips.pop("rollout_inputs"))
    camus_graphs = timed("13c", phase_graphed_camus)
    gc.collect()
    torch.cuda.empty_cache()
    repeat = timed("14a", phase_repeatable_training, graphs, camus, camus_graphs)
    engine_graphs = timed("14b", phase_engine_graphs, main_run)
    clip_graphs = timed("14c", phase_clip_graphs)
    log(f"seconds by phase: {seconds}")

    main_variant = k1[False]
    kernels = [{
        "name": "decoder_heads",
        "route": "cuda",
        "source": "echoflow_torch/csrc/decoder_heads.cu",
        "replaces": "echoflow/ops/pallas/decoder_kernel.py:59",
        "launches": launches,
        "max_abs_err": max(k1[False]["max_abs_err"], k1[True]["max_abs_err"]),
        "ms": main_variant["ms"],
        "plain_ms": main_variant["plain_ms"],
        "bound_ms": main_variant["bound_ms"],
        "bound_by": main_variant["bound_by"],
        # Computed from the inputs, not measured: each pipe's least time and
        # the earlier all-fp32-CUDA-core bound, kept for continuity.
        "bounds": main_variant["bounds"],
        # No single PyTorch call computes upsample-sum + comb2 + heads.
        "library_ms": None,
        "ms_with_motion": k1[True]["ms"],
        "plain_ms_with_motion": k1[True]["plain_ms"],
        "bound_ms_with_motion": k1[True]["bound_ms"],
        # Phase 7: the clip path's launches (with motion, 8 clips a launch).
        "clip_launches": clips["clip_launches"],
        "clip_ms": clips["k1_ms_per_launch"],
        "clip_bound_ms": clips["k1_bound_ms"],
        # Phase 9b: the engine sharded over two replicas; phase 10: none implied.
        "dp_launches": dp["engine"]["launches"],
        "camus_launches": camus["launches"]["decoder_heads"],
        # Phase 12 and 12f, read from the counter (each replay adds the
        # launches its capture made) and, in one profiled replay a
        # variant, by kernel name; held at 0 (training runs the plain decoder).
        "graph_launches": {v: r["k1_launches"] for v, r in graphs.items()},
        "graph_launches_by_name": {v: r["profiled_launches"][0] for v, r in graphs.items()},
        "trainer_launches": trainer["k1_launches"],
        # Phase 13a: a replay of each graphed data-parallel step (counter,
        # by name) and `fit_on_mesh` on them (counter); 13b: one replay of
        # each rollout's graph (counter, and by name among its nodes).
        "dp_graph_launches": {v: r["k1_launches"] for v, r in dp_graphs.items()},
        "dp_graph_launches_by_name": {v: r["profiled_launches"][0]
                                      for v, r in dp_graphs.items()},
        "dp_fit_launches": dp_fit["launches"][0],
        "rollout_graph_launches": sum(r["launches"][0] for r in rollout_graphs.values()),
        "rollout_graph_launches_by_name": sum(r["by_name"][0] for r in rollout_graphs.values()),
        # Phase 14b: phase 4's three videos through the engine's graphs
        # (counter: the capture's replay and two replays; by name in a
        # profiled pass of replays), fp32 and bf16; 14c: phase 7's 16
        # clips through ClipForward's graphs (two replays, counter).
        "engine_graph_launches": {k: engine_graphs[k]["k1_launches"] for k in ("fp32", "bf16")},
        "engine_graph_launches_by_name": {k: engine_graphs[k]["k1_by_name"]
                                          for k in ("fp32", "bf16")},
        "engine_graph_layout_transposes": {k: engine_graphs[k]["layout_transposes"]
                                           for k in ("fp32", "bf16")},
        "clip_graph_launches": clip_graphs["k1_launches"],
    }]
    replaces = {"warp_forward": "echoflow/ops/pallas/warp_kernel.py:67",
                "warp_image_grad": "echoflow/ops/pallas/warp_kernel.py:81",
                "warp_coord_grad": "echoflow/ops/pallas/warp_kernel.py:101"}
    for name, by_shape in warp.items():
        # The fused chain step's warp: K2's pair launch (label and video at
        # the same coordinates), K3 and K4 of its label warp.
        main_shape = by_shape["chain" if name == "warp_forward" else "label"]
        kernels.append({
            "name": name, "route": "cuda", "source": "echoflow_torch/csrc/warp.cu",
            "replaces": replaces[name], "launches": train["launches"][name],
            "eval_launches": train["eval_launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in by_shape.values()),
            **{k: main_shape[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                           "library_ms")},
            "shapes": by_shape,
            # Phase 9a: one DP step; phase 10a: both CAMUS losses; phase 11a:
            # 3 steps of each precision and remat variant.
            "dp_launches": dp["train"]["launches"][name],
            "camus_launches": camus["launches"][name],
            "precision_launches": {v: r["launches"][name]
                                   for v, r in precision["steps"].items()},
            # Phase 12: the graphed step's launches, 4 steps of each variant
            # (the warm-up, the capture's replay, two replays), from the
            # counter (each replay adds the launches its capture made); by
            # kernel name in one profiled replay (K3: four kernels a launch).
            "graph_launches": {v: sum(rec["launches"][list(replaces).index(name)]
                                      for rec in r["runs"][-1]["steps"])
                               for v, r in graphs.items()},
            "graph_launches_by_name": {
                v: r["profiled_launches"][1 + list(replaces).index(name)]
                for v, r in graphs.items()},
            # Phase 12f: the trainer's run (graphed train and eval steps),
            # from the counter.
            "trainer_launches": trainer["launches"][list(replaces).index(name)],
            # Phase 13a: one replay of each graphed data-parallel step, from
            # the counter and by kernel name (K3: four a launch); 13b: one
            # replay of each rollout's graph, counter and nodes by name.
            "dp_graph_launches": {v: r["graph_launches"][0][list(replaces).index(name)]
                                  for v, r in dp_graphs.items()},
            "dp_graph_launches_by_name": {
                v: r["profiled_launches"][1 + list(replaces).index(name)]
                for v, r in dp_graphs.items()},
            # `fit_on_mesh` on the graphed steps (4 train, 3 eval calls), counters.
            "dp_fit_launches": dp_fit["launches"][1 + list(replaces).index(name)],
            "rollout_graph_launches": sum(r["launches"][1 + list(replaces).index(name)]
                                          for r in rollout_graphs.values()),
            "rollout_graph_launches_by_name": sum(r["by_name"][1 + list(replaces).index(name)]
                                                  for r in rollout_graphs.values()),
        })
    # Phase 14a: K3 sums in a fixed order; its device time a launch in an
    # eager fp32 step, and how far two eager fp32 runs of phase 12's recipe
    # are apart after 4 steps (parameter moves, relative L2).
    next(k for k in kernels if k["name"] == "warp_image_grad").update(
        deterministic=all(r["run_to_run_abs_diff"] == 0.0
                          for r in warp["warp_image_grad"].values()),
        step_us=repeat["k3_us_in_step"],
        run_to_run_param_dist=repeat["settings"]["a"]["param_dist"])
    # Phase 7: K2 in the bilinear rollouts of infer/propagate.py.
    next(k for k in kernels if k["name"] == "warp_forward").update(
        inference_launches=clips["k2_launches"], inference_ms=clips["k2_ms_per_launch"],
        inference_bound_ms=clips["k2_bound_ms_per_launch"])
    log(f"cli wall {cli['seconds']:.2f} s; clip forward {clips['clip_seconds'] * 1e3:.1f} ms; "
        f"DP step collectives {dp['train']['collectives']}, syncs "
        f"{dp['train']['syncs_per_step']}; dryrun {dp['dryrun']['seconds']:.1f} s; remat DP "
        f"step collectives {precision['remat_dp']['collectives']}; step ms (median) and peak "
        f"GiB: " + ", ".join(f"{k} {v['median_ms']:.1f} / {v['peak_bytes'] / 2**30:.3f}"
                             for k, v in precision["steps"].items()) + "; graphed steps, "
        f"median ms eager / graphed: " + ", ".join(
            f"{k} {v['eager_median_ms']:.1f} / {v['graphed_median_ms']:.1f}"
            for k, v in graphs.items()) + "; graphed DP steps, median ms eager / graphed: "
        + ", ".join(f"{k} {v['eager_median_ms']:.1f} / {v['graphed_median_ms']:.1f}"
                    for k, v in dp_graphs.items()) + "; rollouts ms eager / graphed: "
        + ", ".join(f"{k} {v['eager_ms']:.3f} / {v['graphed_ms']:.3f}"
                    for k, v in rollout_graphs.items()) + f"; CAMUS graphed vs eager loss rel "
        + ", ".join(f"{k} {v['rel']:.1e}" for k, v in camus_graphs.items())
        + "; engine frames/s eager / graphed: " + ", ".join(
            f"{k} {engine_graphs[k]['frames_per_s']['eager']:.1f} / "
            f"{engine_graphs[k]['frames_per_s']['graphed']:.1f}" for k in ("fp32", "bf16"))
        + f"; clip forward ms eager / graphed {clip_graphs['ms']['eager']:.1f} / "
        f"{clip_graphs['ms']['graphed']:.1f} ({smi})")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
