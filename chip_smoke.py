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
     version and `F.grid_sample` (a yardstick the port never calls), and
     K3's run-to-run difference;
  6. training at full width: `create_train_state(device="cuda")`, fp32,
     TF32 off, 3 steps of `make_train_step(fused_ota=True)` at batch
     4 x 3 x 32 x 112 x 112 on synthetic samples, then one eval step, with
     the warp launch counts zeroed just before and read just after each and
     held against the counts the code implies; the count of calls in one
     more fused step that wait for the device (torch's sync debug mode,
     information only); then one small step on the card and on the CPU from
     the same state (loss, all gradients, and each leaf's gradient by its
     relative L2 error).

Prints the nvidia-smi line, then one JSON line {"kernels": [...]}, and as
the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import json
import statistics
import subprocess
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
from echoflow_torch.ops import warp_kernel as wk
from echoflow_torch.ops.decoder_heads import decoder_heads, reference_decoder_heads
from echoflow_torch.ops.normalize import zeroone_normalizer
from echoflow_torch.ops.warp import offset_coords
from echoflow_torch.train.loop import (TrainConfig, create_train_state, make_eval_step,
                                       make_train_step, prefetch_to_device)
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
# (`image_grad_tolerance`): fp32 atomics add in a run-dependent order.
K4_TOL = 1e-6          # relative to 1 + |plain|
# Card vs CPU, one fused train step at (2, 3, 8, 32, 32): fp32 rounding on
# both sides, cuDNN's and the CPU's conv algorithms, K3's atomics. Measured
# on an H100: loss 6.7e-7, all gradients 1.6e-3, worst leaf 2.3e-3. A
# planted fault in the CPU port, the label warps' image gradient (K3)
# dropped, moves all gradients by 1.0e-2 and the worst leaf by 0.61; K4
# without its border zeroing moves them by 0.14 and 8.9.
LOSS_TOL = 1e-5        # relative loss difference
GRAD_TOL = 5e-3        # relative L2 error of all gradients together
LEAF_TOL = 1e-2        # relative L2 error of each leaf's gradient
ZERO_LEAF = 1e-4       # below this share of the largest leaf's norm: 0 in exact arithmetic
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


def device_ms(fn, reps: int = 20, match: str | None = None):
    """Device time per call of `fn` from torch.profiler: the summed duration
    of the device kernels (and memsets/copies) it launches, over `reps`
    back-to-back calls after one warm-up; with `match`, also the time of
    the kernels whose name contains it. A session that records no device
    event (it happens, rarely, on the card's sandbox) is repeated up to
    three times. Returns (total_ms, matched_ms)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = matched = 0.0
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CPU:
                continue
            total += evt.device_time_total
            if match is not None and match in evt.name:
                matched += evt.device_time_total
        if total > 0.0:
            return total / reps / 1e3, matched / reps / 1e3
    raise RuntimeError("torch.profiler recorded no device time in three sessions")


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

        # K3: two launches on the same inputs, against the plain version
        # and against each other.
        tol = wk.image_grad_tolerance(grad, px, py)
        got1, got2 = wk.warp_image_grad(grad, px, py), wk.warp_image_grad(grad, px, py)
        want = wk.reference_warp_image_grad(grad, px, py)
        err = float((got1 - want).abs().max())
        run_diff = float((got1 - got2).abs().max())
        if not (bool(((got1 - want).abs() <= tol).all())
                and bool(((got1 - got2).abs() <= tol).all())):
            raise AssertionError(f"K3 {shape}: max abs err {err}, run-to-run {run_diff}, "
                                 f"beyond the per-element bound")
        call, ms = device_ms(lambda: wk.warp_image_grad(grad, px, py),
                             match="warp_image_grad_kernel")
        plain, _ = device_ms(lambda: wk.reference_warp_image_grad(grad, px, py), reps=5)
        lib, _ = device_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
            grad, image, grid, 0, 1, False, [True, False]))
        out["warp_image_grad"][label] = dict(
            shape=list(shape), max_abs_err=err, run_to_run_abs_diff=run_diff,
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
                + (f", run-to-run {r['run_to_run_abs_diff']:.3e}"
                   if "run_to_run_abs_diff" in r else ""))
        del image, grad, px, py, grid, got, want, got1, got2, tol
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


def _launch_counts():
    return (wk.warp_forward.launches, wk.warp_image_grad.launches,
            wk.warp_coord_grad.launches)


def _zero_launch_counts():
    wk.warp_forward.launches = wk.warp_image_grad.launches = wk.warp_coord_grad.launches = 0


def _step_grads(device, batch):
    """Loss and per-parameter gradients (float64, CPU) of one fused train
    step from the seed-3 state at the batch's size, on `device`."""
    n, _, t, h, _ = batch["video"].shape
    cfg = TrainConfig(clip_length=t, image_size=(h, h), batch_size=n)
    state = create_train_state(3, cfg, device=device)
    state, m = make_train_step(fused_ota=True)(
        state, {k: torch.as_tensor(v).to(device) for k, v in batch.items()})
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
        f"(information only) {dict(syncs)}")
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


def phase_main_path():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    state = smoke_weights()
    engine = VideoSegmenter(state, dtype=torch.float32)
    videos = [make_beating_video(num_frames=176, period=p, seed=s).video.astype(np.uint8)
              for s, p in ((1, 38.0), (2, 44.0), (3, 50.0))]
    engine.segment_video(videos[0], num_clips=5, step=1, fuse_method="simple")  # warm-up
    torch.cuda.synchronize()

    decoder_heads.launches = 0
    t0 = time.perf_counter()
    masks = list(engine.segment_videos(videos, num_clips=5, step=1, fuse_method="simple"))
    seconds = time.perf_counter() - t0
    launches = decoder_heads.launches
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
    return launches


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

    k1 = phase_k1()
    launches = phase_main_path()
    warp = phase_warp()
    train = phase_train()

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
        })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
