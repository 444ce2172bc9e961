#!/usr/bin/env python3
"""Where the time of echoflow_torch's main path goes on one NVIDIA GPU.

    python3 profile_torch.py [--videos 3] [--dtype float32|bfloat16] [--out PATH]
    python3 profile_torch.py --train [--compute-dtype fp32|bf16] [--remat] [--out PATH]
    python3 profile_torch.py --clips 8 [--out PATH]
    python3 profile_torch.py --convs [--conv-models clasfv camus csn] [--out PATH]
    python3 profile_torch.py --backbone-convs [--dtype bfloat16] [--out PATH]
    python3 profile_torch.py CHECKPOINT [CHECKPOINT ...] [--out PATH]

Runs the engine of chip_smoke.py (full-width R(2+1)D-18, seeded weights,
5 shifts, step 1, SIMPLE fusion, 176-frame 112x112 uint8 videos) once to
warm up, then under torch.profiler, and prints one JSON line: wall time,
device busy time and idle share, device time by layer and by kernel, and
`syncs_per_video`: the calls that waited for the device while one more
video was dispatched (`segment_video_async`, torch's sync debug mode "warn",
by line; fetching the mask afterwards waits by design). The split by layer
is the eager body's (`engine._run.__wrapped__`: a replay of the engine's
graph fires no range); `graphed` is the same videos through the engine's
graphs, after a warm-up and a capture: wall, device busy time and idle
share of a profiled pass, and K1's launches by kernel name.

With --train it profiles one full-width fused CLAS-FV train step instead
(batch 4 x 3 x 32 x 112 x 112, fp32, TF32 off, after two warm-up steps),
split by the step's ranges `echoflow_torch.train.{forward,ota_and_chains,
backward,optimizer}`, with the warp kernels K2-K4 by name (ms in the step,
launches, us per launch). The backward's kernels are launched from
autograd's device thread, outside the range opened on the calling thread;
they count for `train.backward`. One more step, not profiled, runs with
torch's sync debug mode set to "warn": `syncs_per_step` counts the calls
in it that waited for the device, by the line that made them.
`--compute-dtype bf16` profiles the bf16 mixed-precision step
(`TrainConfig.compute_dtype`), `--remat` the rematerialized one, whose
forward runs again in the backward under the range
`echoflow_torch.train.recompute`; `peak_gib` is the step's peak allocated
memory. `graphed` is the same step as CUDA graphs (`train/graph.py`, what
`fit` runs on the card): after its warm-up and capture, a replay's wall
time unprofiled and profiled, its device busy time and idle share, and
K2-K4's launches by kernel name (a replay fires no range, so the split by
layer is the eager step's).

With --clips CHUNK it profiles `chip_smoke.py` phase 7's workload: one
`ClipForward` call (fp32, with the motion head, its eager forward) on 16
full-width clips in chunks of CHUNK, by layer, and the bilinear rollouts
on their motion with K2's launches by device time.

With --convs it times the backward of every distinct convolution of the
fp32 train steps, one by one at the shape the step runs it: the
convolutions of one full-width fused CLAS-FV step (batch 4 x 3 x 32 x
112 x 112), of the CAMUS trainer (`train_camus_torch.main --synthetic
--epochs 1 --acnn`) and of one fused step of CLAS-FV over ir-CSN-152 at
CLAS-FV's batch ("csn"), each recorded where `ops/conv.convolution` takes
its repeatable backward; `--conv-models` names the models to record (all
three by default). A geometry is (input shape, weight shape, stride,
padding, transposed, groups). For each, the input gradient (where the step wants
it), the weight gradient and the forward apart, on seeded inputs: whether
cuDNN's default engine gives the same bits in three calls, its time (CUDA
events, median of 10), the same with cuDNN's deterministic engines
(`ops/conv.deterministic_cudnn`), and each candidate route of `ops/conv.py`
("subpixel" for an input gradient, "gemm" for a weight gradient, of a
conv of one group: time, same bits, relative L2 from the deterministic
engine's result), beside
the routes `ops/conv.ROUTES` takes for the geometry's class. `sums_ms`
adds each column over the first model's step's convolutions (`sums_of`;
CLAS-FV's by default), each geometry times
its calls in the step; `*.taken` is the routes that `ROUTES` takes.
`by_class_ms` adds them by model and geometry class, with the calls whose
default engine gave other bits (`calls_apart`).

With --backbone-convs it times the forward of every distinct conv of the
engine's folded R(2+1)D-18 backbone in `--dtype`, at the engine's chunk
shape (30 clips x 3 x 32 x 112 x 112), in each of four variants: as
folded ("folded"), after `models/fold_bn.pad_widths` ("padded"), after
`fold_bn.temporal_convs_as_2d` ("temporal_2d"), and after both and
`fold_bn.channels_last`, its weights and inputs channels-last-3d, as the
16-bit engine runs it ("engine"); and the padded stem's (1,7,7) conv once
more with its 3 input channels zero-padded to 8 ("stem_in8"). A
geometry is (input shape, weight shape, stride, padding); each row gives
the modules that run it, its time (CUDA events, median of 10) and the
kernels one call launches, by name with their device ms (torch.profiler,
3 calls): the conv kernel, cuDNN's `convertTensor` dtype casts, the
NCHW<->NHWC transposes. `backbone` is the whole backbone's forward in each
variant, the same way; `sums_ms` adds each variant's convs (every module
its own call) and their kernels by kind.

With CHECKPOINT arguments (the port's `.pth`, e.g. `train_clasfv_torch.py`'s
`<out>.last`) it evaluates them instead, as echoflow's bf16 training study
does: each is loaded into one fp32 model and run through the same fp32
eval step (`train/loop.make_eval_step`) on the same held-out synthetic set
of 16 batches of 4 x 3 x 32 x 112 x 112, drawn from a seed population
disjoint from training's, so two runs that differ in their training dtype
are compared on their weights alone; the first checkpoint's weights then
run the engine in fp32, bf16 and mixed (bf16 backbone) on chip_smoke.py
phase 4's three videos (5 shifts, step 1, SIMPLE): the share of pixels
where the bf16 and mixed masks differ from fp32's.

A layer is a `record_function` range of the engine (`echoflow_torch.<layer>`,
see echoflow_torch/infer/pipeline.py): each device kernel or copy counts
for the innermost range around the host call that launched it. The
profiler records the host calls of the thread that runs it, so the eager
profile stages and dispatches the videos from this thread
(`engine._stage_and_run`, what `segment_video_async` runs on the engine's
dispatch thread), and every launch is recorded under its range. The
port's own kernels are launched through ctypes, which the profiler does
not link to a host call; their device time counts for the range of the
wrapper that alone launches them (`OWN_KERNELS`).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import count_syncs, main_path_videos, nvidia_smi_line, smoke_weights
from echoflow_torch.data.synthetic import make_beating_video
from echoflow_torch.infer.pipeline import VideoSegmenter, _unpackbits
from echoflow_torch.ops import _build
from echoflow_torch.utils.profiling import counters

RANGE_PREFIX = "echoflow_torch."
UNATTRIBUTED = "(outside any range)"
UNLINKED = "(not linked to a host call)"
# Kernel name of each ctypes-launched kernel -> the range its wrapper runs in.
OWN_KERNELS = {"decoder_heads_kernel": "decoder_tail"}
# ... in a train step: K2 runs in the loss, K3 and K4 in the backward.
TRAIN_KERNELS = {"warp_forward_kernel": "train.ota_and_chains",
                 "warp_image_grad_kernel": "train.backward",
                 "warp_coord_grad_kernel": "train.backward"}


def layer_of(evt) -> str:
    """The innermost `echoflow_torch.*` range around a host event."""
    while evt is not None:
        if evt.name.startswith(RANGE_PREFIX):
            return evt.name[len(RANGE_PREFIX):]
        evt = evt.cpu_parent
    return UNATTRIBUTED


def split_device_time(prof, own_kernels, other_thread_layer=None):
    """(layers_ms, kernels_ms) of a profile: each kernel's device time goes
    to the innermost range around the host call that launched it; a host
    call outside any range on another thread than the caller's counts for
    `other_thread_layer`; ctypes-launched kernels, which are linked to no
    host call, count for the range of `own_kernels`."""
    layers, linked, kernels = {}, {}, {}
    main_thread = None
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CPU and \
                evt.name.startswith(RANGE_PREFIX):
            main_thread = evt.thread
            break
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CPU:
            layer = layer_of(evt)
            if layer == UNATTRIBUTED and other_thread_layer and evt.thread != main_thread:
                layer = other_thread_layer
            for k in evt.kernels:   # device work launched by this host event
                ms = k.duration / 1e3
                layers[layer] = layers.get(layer, 0.0) + ms
                linked[k.name] = linked.get(k.name, 0.0) + ms
        elif not evt.name.startswith(RANGE_PREFIX):   # not a range's GPU mirror
            kernels[evt.name] = kernels.get(evt.name, 0.0) + evt.device_time_total / 1e3
    for name, ms in kernels.items():
        unlinked = ms - linked.get(name, 0.0)
        if unlinked > 1e-6:   # beyond float round-off of the sums
            layer = next((v for k, v in own_kernels.items() if k in name), UNLINKED)
            layers[layer] = layers.get(layer, 0.0) + unlinked
    return layers, kernels


def top_kernels(kernels, n=12):
    by_name = {}   # long template names, summed on a readable prefix
    for name, ms in kernels.items():
        by_name[name[:100]] = by_name.get(name[:100], 0.0) + ms
    return dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:n])


def profile_train(out_path=None, compute_dtype="fp32", remat=False):
    """One full-width fused train step under the profiler."""
    from echoflow_torch.train.loop import (TrainConfig, create_train_state, make_train_step,
                                           prefetch_to_device)
    from train_clasfv_torch import synthetic_batches

    cfg = TrainConfig(compute_dtype={"fp32": torch.float32,
                                     "bf16": torch.bfloat16}[compute_dtype])
    state = create_train_state(0, cfg, device="cuda")
    batches = list(prefetch_to_device(
        synthetic_batches(cfg.batch_size, cfg.clip_length, cfg.image_size[0], 4, seed=0),
        "cuda"))
    step = make_train_step(fused_ota=True, remat=remat)
    for batch in batches[:2]:
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warps = ("warp_forward", "warp_image_grad", "warp_coord_grad")
    launches0 = counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batches[2])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    assert np.isfinite(float(metrics["loss"]))
    launches1 = counters()
    launches = [launches1.get(f"{k}.launches", 0) - launches0.get(f"{k}.launches", 0)
                for k in warps]
    _, syncs = count_syncs(lambda: step(state, batches[3]))
    graph = profile_graphed_step(state, make_train_step(fused_ota=True, remat=remat), batches)
    layers, kernels = split_device_time(prof, TRAIN_KERNELS, "train.backward")
    busy_ms = sum(kernels.values())
    warp = {}
    for (short, name), count in zip(TRAIN_KERNELS.items(), launches):
        ms = sum(v for k, v in kernels.items() if short in k)
        warp[short] = {"ms_per_step": ms, "launches": count,
                       "us_per_launch": ms * 1e3 / max(count, 1)}
    result = {
        "card": nvidia_smi_line(), "mode": "train", "batch": list(batches[0]["video"].shape),
        "dtype": compute_dtype, "remat": remat, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms, "peak_gib": peak / 2**30,
        "layers_ms": dict(sorted(layers.items(), key=lambda kv: -kv[1])),
        "warp_kernels": warp, "top_kernels_ms": top_kernels(kernels),
        "syncs_per_step": sum(syncs.values()), "sync_sites": dict(syncs), "graphed": graph,
    }
    print(json.dumps(result))
    if out_path:
        with open(out_path, "w") as f:
            json.dump(dict(result, kernels_ms=kernels), f, indent=1)


def profile_graphed_step(state, step_fn, batches):
    """The same step as CUDA graphs (`train/graph.graphed`): after its
    warm-up and capture, one replay timed unprofiled and one under the
    profiler, whose device time is the kernels of the graph (its ranges
    do not fire on a replay): wall, device busy and idle share, and the
    launches of K2, K3 and K4 by kernel name."""
    from echoflow_torch.train.graph import graphed

    step = graphed(step_fn, state)
    for batch in batches[:2]:
        step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(state, batches[2])
    torch.cuda.synchronize()
    unprofiled_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batches[3])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    _, kernels = split_device_time(prof, {})
    busy_ms = sum(kernels.values())
    launches = {short: sum(1 for evt in prof.events()
                           if evt.device_type != torch.autograd.DeviceType.CPU
                           and short in evt.name) for short in TRAIN_KERNELS}
    return {"wall_ms": wall_ms, "unprofiled_ms": unprofiled_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms, "warp_launches": launches}


def profile_graphed_engine(engine, videos):
    """The videos through the engine's graphs (after a warm-up and a
    capture of their key) under the profiler, dispatched ahead as in the
    eager profile: wall, device busy and idle share, and K1's launches by
    kernel name (a replay fires no range)."""
    for _ in range(2):
        engine.segment_video(videos[0], num_clips=5, step=1, fuse_method="simple")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        handles = [engine.segment_video_async(v, num_clips=5, step=1, fuse_method="simple")
                   for v in videos]
        for p, _ in handles:
            p.numpy()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    _, kernels = split_device_time(prof, {})
    busy_ms = sum(kernels.values())
    k1 = sum(1 for evt in prof.events() if evt.device_type != torch.autograd.DeviceType.CPU
             and "decoder_heads_kernel" in evt.name)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms, "k1_launches": k1,
            "graphs": len(engine._run.graphs)}


def profile_clips(chunk, out_path=None):
    """`chip_smoke.py` phase 7's workload under the profiler: one
    `ClipForward` call (fp32, motion head) on the 16 clips around one ED
    frame, in chunks of `chunk`, split by layer; then each rollout of
    `infer/propagate.py` on their motion, a replay of its CUDA graph (after
    the warm-up and the capture), with its K2 launches' device times (the
    largest apart: `deform_images_forback`'s single launch over every
    frame)."""
    from chip_smoke import clip_workload, rollout_inputs
    from echoflow_torch.infer.clips import ClipForward
    from echoflow_torch.infer.propagate import deform_forback, deform_images_forback

    state, video, ed, starts = clip_workload()
    clips = np.stack([video[:, s:s + 32] for s in starts])
    fwd = ClipForward(state, dtype=torch.float32, forward_chunk=chunk)
    fwd._forward = fwd._forward.__wrapped__    # the ranges fire in the eager forward only
    fwd(clips[:chunk])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        probs, motion = fwd(clips)
        wall_ms = (time.perf_counter() - t0) * 1e3
    layers, kernels = split_device_time(prof, OWN_KERNELS)
    busy_ms = sum(kernels.values())
    labels = np.argmax(probs, axis=1).astype(np.uint8)
    label_ed, label_es, mot, images = rollout_inputs(labels, motion, clips, ed, starts)
    rollouts = {}
    for name, fn in (("deform_forback_bilinear",
                      lambda: deform_forback(label_ed, label_es, mot, mode="bilinear")),
                     ("deform_images_forback", lambda: deform_images_forback(images, mot))):
        fn()   # the warm-up
        fn()   # the capture and its replay
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            call_ms = (time.perf_counter() - t0) * 1e3
        k2 = sorted((e.device_time_total / 1e3 for e in prof.events()
                     if e.device_type != torch.autograd.DeviceType.CPU
                     and "warp_forward_kernel" in e.name), reverse=True)
        device = sum(e.device_time_total / 1e3 for e in prof.events()
                     if e.device_type != torch.autograd.DeviceType.CPU
                     and not e.name.startswith(RANGE_PREFIX))
        rollouts[name] = {"wall_ms": call_ms, "device_busy_ms": device, "k2_launches": len(k2),
                          "k2_largest_us": k2[0] * 1e3 if k2 else None,
                          "k2_others_us_mean": sum(k2[1:]) * 1e3 / max(len(k2) - 1, 1)}
    result = {
        "card": nvidia_smi_line(), "mode": "clips", "clips": len(starts), "chunk": chunk,
        "dtype": "float32", "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "layers_ms": dict(sorted(layers.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": top_kernels(kernels), "rollouts": rollouts,
    }
    print(json.dumps(result))
    if out_path:
        with open(out_path, "w") as f:
            json.dump(dict(result, kernels_ms=kernels), f, indent=1)


STUDY_EVAL_BATCHES = 16


def evaluate_checkpoints(paths, out_path=None):
    """The bf16 study's evaluation (see the module docstring): held-out
    loss and ED/ES Dice of each checkpoint, then the engine's bf16 and
    mixed masks against fp32's on the first checkpoint's weights."""
    from echoflow_torch.train.checkpoint import load_checkpoint
    from echoflow_torch.train.loop import (TrainConfig, create_train_state, make_eval_step,
                                           prefetch_to_device)
    from train_clasfv_torch import synthetic_batches

    host = synthetic_batches(4, 32, 112, STUDY_EVAL_BATCHES, seed=999_999,
                             pool_seed_base=90_000_000)
    batches = list(prefetch_to_device(host, "cuda"))
    state = create_train_state(0, TrainConfig(), device="cuda")
    eval_step = make_eval_step()
    metrics = {}
    for path in paths:
        state.model.load_state_dict(load_checkpoint(path)["model"])
        sums = {"loss": 0.0, "ed_dice": 0.0, "es_dice": 0.0}
        for batch in batches:
            m = eval_step(state, batch)
            for k in sums:
                sums[k] += float(m[k])
        metrics[path] = {("val_loss" if k == "loss" else k): v / len(batches)
                         for k, v in sums.items()}
    weights = load_checkpoint(paths[0])["model"]
    videos = main_path_videos()
    masks = {}
    for name, kw in (("fp32", dict(dtype=torch.float32)), ("bf16", dict(dtype=torch.bfloat16)),
                     ("mixed", dict(dtype=torch.float32, backbone_dtype=torch.bfloat16))):
        engine = VideoSegmenter(weights, **kw)
        masks[name] = list(engine.segment_videos(videos, num_clips=5, step=1,
                                                 fuse_method="simple"))
    result = {"card": nvidia_smi_line(), "eval_batches": len(batches), "metrics": metrics,
              "masks": {"foreground_fp32": float(np.mean([m.mean() for m in masks["fp32"]])),
                        **{f"{name}_vs_fp32": [float((a != b).mean())
                                               for a, b in zip(masks[name], masks["fp32"])]
                           for name in ("bf16", "mixed")}}}
    print(json.dumps(result))
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)
    return result


CONV_REPS = 10       # timed calls of each backward (median)
CONV_REPEATS = 3     # calls whose bits are compared


CONV_MODELS = ("clasfv", "camus", "csn")


def conv_geometries(models=CONV_MODELS):
    """The convolutions that take `ops/conv.convolution`'s repeatable
    backward in one fp32 CLAS-FV train step at full width, in the CAMUS
    trainer with `--acnn` and in one fp32 step of CLAS-FV over ir-CSN-152,
    those of `models`, recorded as they run: {key: row}, key (model, input
    shape, weight shape, stride, padding, transposed, groups), the row
    with the calls seen and whether the input gradient is wanted."""
    import train_camus_torch
    from echoflow_torch.ops import conv as conv_ops
    from echoflow_torch.train.loop import (TrainConfig, create_train_state, make_train_step,
                                           prefetch_to_device)
    from train_clasfv_torch import synthetic_batches

    seen, model = {}, [None]
    plain = conv_ops.convolution

    def recording(x, weight, bias=None, stride=1, padding=0, transposed=False, groups=1):
        if conv_ops.repeatable(x, weight):
            nd = x.dim() - 2
            key = (model[0], tuple(x.shape), tuple(weight.shape),
                   (stride,) * nd if isinstance(stride, int) else tuple(stride),
                   (padding,) * nd if isinstance(padding, int) else tuple(padding), transposed,
                   groups)
            row = seen.setdefault(key, dict(calls=0, wants_input_grad=False,
                                             bias=bias is not None))
            row["calls"] += 1
            row["wants_input_grad"] |= x.requires_grad
        return plain(x, weight, bias, stride, padding, transposed, groups)

    def clasfv_step(backbone):
        cfg = TrainConfig(backbone=backbone)
        state = create_train_state(0, cfg, device="cuda")
        batch = next(iter(prefetch_to_device(
            synthetic_batches(cfg.batch_size, cfg.clip_length, cfg.image_size[0], 1, seed=0),
            "cuda")))
        make_train_step(fused_ota=True)(state, batch)
        torch.cuda.synchronize()
        del state, batch
        torch.cuda.empty_cache()

    conv_ops.convolution = recording
    try:
        for model[0] in models:
            if model[0] == "camus":
                train_camus_torch.main(["--synthetic", "--epochs", "1", "--acnn", "--device",
                                        "cuda"])
            else:
                clasfv_step("ir_csn_152" if model[0] == "csn" else "r2plus1d_18")
    finally:
        conv_ops.convolution = plain
    torch.cuda.empty_cache()
    return seen


def _event_ms(fn, reps=CONV_REPS):
    """Median milliseconds of `fn` over `reps` calls after one warm-up,
    each between two CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def _measure(fn, reference=None):
    outs = [fn() for _ in range(CONV_REPEATS)]
    row = dict(ms=_event_ms(fn), same_bits=all(torch.equal(o, outs[0]) for o in outs[1:]))
    if reference is not None:
        row["rel_l2"] = float((outs[0].double() - reference.double()).norm()
                              / reference.double().norm())
    return row, outs[0]


def profile_convs(out_path=None, models=CONV_MODELS):
    """`--convs`: see the module docstring."""
    from echoflow_torch.ops import conv as C

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    g = torch.Generator(device="cuda").manual_seed(0)
    for (model, xs, ws, stride, padding, transposed, groups), seen in \
            conv_geometries(models).items():
        nd = len(stride)
        x = torch.randn(xs, device="cuda", generator=g)
        fan_in = ws[0 if transposed else 1] * int(np.prod(ws[2:]))
        w = torch.randn(ws, device="cuda", generator=g) * (2.0 / fan_in) ** 0.5
        fwd = (C._CONV_T if transposed else C._CONV)[nd]
        kw = {} if transposed else {"groups": groups}
        dy = torch.randn_like(fwd(x, w, stride=stride, padding=padding, **kw))
        flop = 2 * (x if transposed else dy).numel() // (x if transposed else dy).shape[1] \
            * ws[0] * ws[1] * int(np.prod(ws[2:]))
        row = dict(model=model, input=list(xs), weight=list(ws), stride=list(stride),
                   padding=list(padding), transposed=transposed, groups=groups,
                   geometry_class=C.geometry_class(ws, stride, transposed, groups),
                   gflop=flop / 1e9, **seen)

        def grads(mask, det):
            i = mask.index(True)
            return lambda: C.cudnn_grads(x, w, dy, stride, padding, transposed, mask, det,
                                         groups)[i]

        # The forward's bits too: a transposed conv's forward is an
        # input-gradient engine (`ops/conv.conv_forward`).
        parts = {"forward": dict(default=_measure(lambda: fwd(x, w, stride=stride,
                                                              padding=padding, **kw))[0])}
        if transposed:
            parts["forward"]["cudnn_deterministic"] = _measure(
                lambda: C.conv_forward(x, w, None, stride, padding, True))[0]
        if seen["wants_input_grad"]:
            mask = (True, False, False)
            det, ref = _measure(grads(mask, True))
            routes = {} if transposed or groups > 1 else {
                "subpixel": lambda: C.input_grad_subpixel(dy, w, stride, padding, xs[2:])}
            parts["input_grad"] = dict(default=_measure(grads(mask, False), ref)[0],
                                       cudnn_deterministic=det,
                                       **{k: _measure(f, ref)[0] for k, f in routes.items()})
        mask = (False, True, False)
        det, ref = _measure(grads(mask, True))
        gemm = {} if groups > 1 else {"gemm": _measure(lambda: C._weight_grad(
            "gemm", x, w, dy, stride, padding, transposed), ref)[0]}
        parts["weight_grad"] = dict(default=_measure(grads(mask, False), ref)[0],
                                    cudnn_deterministic=det, **gemm)
        routes = C.ROUTES.get(row["geometry_class"], C.DEFAULT_ROUTE)
        row["routes"] = dict(zip(("input_grad", "weight_grad"), routes))
        row.update(parts)
        rows.append(row)
        print(json.dumps(row), flush=True)
        del x, w, dy, ref
        torch.cuda.empty_cache()
    sums, by_class = {}, {}
    for row in rows:
        cls = by_class.setdefault(f"{row['model']} {row['geometry_class']}", {"calls": 0})
        cls["calls"] += row["calls"]
        for part in ("input_grad", "weight_grad"):
            if part not in row:
                continue
            # The route ROUTES takes ("cudnn" is the default engine).
            taken = {"cudnn": "default"}.get(row["routes"][part], row["routes"][part])
            cells = cls.setdefault(part, {"route": row["routes"][part], "calls_apart": 0})
            cells["calls_apart"] += row["calls"] * (not row[part]["default"]["same_bits"])
            for route, r in list(row[part].items()) + [("taken", row[part][taken])]:
                cells[route] = cells.get(route, 0.0) + row["calls"] * r["ms"]
                if row["model"] == models[0]:
                    key = f"{part}.{route}"
                    sums[key] = sums.get(key, 0.0) + row["calls"] * r["ms"]
    result = {"card": nvidia_smi_line(), "mode": "convs", "geometries": len(rows),
              "sums_of": models[0],
              "calls": sum(r["calls"] for r in rows if r["model"] == models[0]),
              "sums_ms": sums, "by_class_ms": by_class, "rows": rows}
    print(json.dumps({k: v for k, v in result.items() if k != "rows"}))
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)


ENGINE_CHUNK = 30    # VideoSegmenter's forward_chunk
BACKBONE_VARIANTS = ("folded", "padded", "temporal_2d", "engine")


def folded_backbone(dtype, variant):
    """The engine's folded R(2+1)D-18 backbone (seeded weights) in `dtype`
    on the card: as folded, with its widths padded (`fold_bn.pad_widths`),
    with its temporal convs as 2D convs (`fold_bn.temporal_convs_as_2d`),
    or with both and channels-last-3d (`fold_bn.channels_last`), as the
    engine runs it in 16 bits (`variant`, one of BACKBONE_VARIANTS)."""
    from echoflow_torch.models.fold_bn import (channels_last, fold_state_dict, pad_widths,
                                               temporal_convs_as_2d)
    from echoflow_torch.models.r2plus1d import R2Plus1DMotionSegNet, create_model

    model = R2Plus1DMotionSegNet(folded=True)
    model.load_state_dict(fold_state_dict(create_model(seed=0).state_dict()))
    backbone = model.backbone.eval().requires_grad_(False).to(dtype)
    if variant in ("padded", "engine"):
        pad_widths(backbone)
    if variant in ("temporal_2d", "engine"):
        temporal_convs_as_2d(backbone)
    if variant == "engine":
        channels_last(backbone)
    return backbone.cuda()


def _kernels_ms(fn, calls=3):
    """{kernel name: device ms a call} of `fn` under torch.profiler, after
    one call outside it."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    _, kernels = split_device_time(prof, {})
    return {k: ms / calls for k, ms in sorted(kernels.items(), key=lambda kv: -kv[1])}


def kernel_kind(name: str) -> str:
    """The kind of a kernel of a 16-bit conv: cuDNN's fp32 fallback, a
    dtype cast, a layout transpose, or the rest."""
    if "f32f32" in name:
        return "fp32_conv"
    if "convertTensor" in name:
        return "convert"
    if "nchwToNhwc" in name or "nhwcToNchw" in name:
        return "transpose"
    return "other"


def profile_backbone_convs(out_path=None, dtype="bfloat16"):
    """`--backbone-convs`: see the module docstring."""
    import torch.nn as nn

    from echoflow_torch.models.fast_forward import backbone_input

    dt = getattr(torch, dtype)
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand((ENGINE_CHUNK, 3, 32, 112, 112), device="cuda", generator=g).to(dt)
    rows, whole, sums = [], {}, {}
    for variant in (*BACKBONE_VARIANTS, "stem_in8"):
        backbone = folded_backbone(dt, "padded" if variant == "stem_in8" else variant)
        convs = {name: m for name, m in backbone.named_modules() if isinstance(m, nn.Conv3d)}
        names, shapes = {m: name for name, m in convs.items()}, {}

        def record(mod, args):
            shapes[names[mod]] = tuple(args[0].shape)

        xb = backbone_input(backbone, x)
        hooks = [m.register_forward_pre_hook(record) for m in convs.values()]
        with torch.no_grad():
            backbone(xb)
        for h in hooks:
            h.remove()
        if variant == "stem_in8":   # the stem alone, its input zero-padded to 8
            stem = backbone.stem[0]
            wide = nn.Conv3d(8, stem.out_channels, stem.kernel_size, stem.stride,
                             stem.padding).to("cuda", dt).requires_grad_(False)
            wide.weight.zero_()
            wide.weight[:, :3] = stem.weight
            wide.bias.copy_(stem.bias)
            convs, shapes = {"stem.0": wide}, {"stem.0": (ENGINE_CHUNK, 8, *x.shape[2:])}
        else:
            with torch.no_grad():
                whole[variant] = dict(ms=_event_ms(lambda: backbone(xb)),
                                      kernels_ms=_kernels_ms(lambda: backbone(xb)))
        geometries = {}
        for name, m in convs.items():
            key = (shapes[name], tuple(m.weight.shape), m.stride, m.padding)
            geometries.setdefault(key, []).append(name)
        totals = sums.setdefault(variant, {"convs": 0.0})
        for (xs, ws, stride, padding), modules in geometries.items():
            conv = convs[modules[0]]
            xi = torch.rand(xs, device="cuda", generator=g).to(dt)
            if variant == "engine":
                xi = xi.contiguous(memory_format=torch.channels_last_3d)
            with torch.no_grad():
                out = conv(xi)
                gmac = out.numel() // out.shape[1] * ws[0] * int(np.prod(ws[1:])) / 1e9
                row = dict(variant=variant, modules=modules, module=type(conv).__name__,
                           input=list(xs), weight=list(ws),
                           stride=list(stride), padding=list(padding), gmac=gmac,
                           ms=_event_ms(lambda: conv(xi)), kernels_ms=_kernels_ms(lambda: conv(xi)))
            totals["convs"] += len(modules) * row["ms"]
            for k, ms in row["kernels_ms"].items():
                kind = kernel_kind(k)
                totals[kind] = totals.get(kind, 0.0) + len(modules) * ms
            rows.append(row)
            print(json.dumps({**row, "kernels_ms": dict(list(row["kernels_ms"].items())[:4])}),
                  flush=True)
            del xi, out
        del backbone
        torch.cuda.empty_cache()
    result = {"card": nvidia_smi_line(), "mode": "backbone_convs", "dtype": dtype,
              "chunk": ENGINE_CHUNK,
              "backbone_ms": {v: w["ms"] for v, w in whole.items()},
              "backbone_kernels_ms": {v: top_kernels(w["kernels_ms"]) for v, w in whole.items()},
              "sums_ms": sums}
    print(json.dumps(result))
    if out_path:
        with open(out_path, "w") as f:
            json.dump({**result, "rows": rows}, f, indent=1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoints", nargs="*",
                    help="evaluate these CLAS-FV checkpoints instead (the bf16 study)")
    ap.add_argument("--videos", type=int, default=3)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    ap.add_argument("--train", action="store_true",
                    help="profile one full-width fused train step instead")
    ap.add_argument("--compute-dtype", choices=("fp32", "bf16"), default="fp32",
                    help="with --train: the model's compute dtype")
    ap.add_argument("--remat", action="store_true",
                    help="with --train: the rematerialized step")
    ap.add_argument("--clips", type=int, default=None, metavar="CHUNK",
                    help="profile chip_smoke.py phase 7's ClipForward (clips a chunk) "
                         "and rollouts instead")
    ap.add_argument("--convs", action="store_true",
                    help="time the fp32 train steps' convolution backwards one by one instead")
    ap.add_argument("--conv-models", nargs="+", choices=CONV_MODELS, default=CONV_MODELS,
                    help="with --convs: the models whose convolutions are recorded "
                         "(sums_ms adds the first's)")
    ap.add_argument("--backbone-convs", action="store_true",
                    help="time the folded backbone's forward convs one by one in --dtype, "
                         "in each variant of fold_bn.fit_tensor_cores, instead")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch: needs an NVIDIA GPU")
    _build.build_all()
    if args.convs:
        return profile_convs(args.out, tuple(args.conv_models))
    if args.backbone_convs:
        return profile_backbone_convs(args.out, args.dtype)
    if args.checkpoints:
        return evaluate_checkpoints(args.checkpoints, args.out)
    if args.train:
        return profile_train(args.out, args.compute_dtype, args.remat)
    if args.clips:
        return profile_clips(args.clips, args.out)
    engine = VideoSegmenter(smoke_weights(), dtype=getattr(torch, args.dtype))
    graphed_run = engine._run
    engine._run = graphed_run.__wrapped__     # the eager body: its ranges fire
    videos = [make_beating_video(num_frames=176, period=38.0 + 6 * i, seed=i + 1)
              .video.astype(np.uint8) for i in range(args.videos)]

    def dispatch(video):   # on this thread, which the profiler records
        return engine._stage_and_run(video, 5, 1, "simple", None, next(engine._seqs),
                                     time.time_ns())

    dispatch(videos[0])[0].numpy()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        handles = [dispatch(v) for v in videos]
        masks = [_unpackbits(p.numpy(), width)[:length] for p, (length, width) in handles]
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    assert len(masks) == len(videos) and masks[0].shape == (176, 112, 112)

    layers, kernels = split_device_time(prof, OWN_KERNELS)
    busy_ms = sum(kernels.values())
    (pending, (length, width)), syncs = count_syncs(lambda: dispatch(videos[0]))
    assert _unpackbits(pending.numpy(), width)[:length].shape == (176, 112, 112)
    engine._run = graphed_run
    graph = profile_graphed_engine(engine, videos)
    print(json.dumps({
        "card": nvidia_smi_line(), "dtype": args.dtype, "videos": len(videos),
        "frames": 176 * len(videos), "wall_ms": wall_ms,
        "device_busy_ms": busy_ms, "device_idle_share": 1.0 - busy_ms / wall_ms,
        "layers_ms": dict(sorted(layers.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": top_kernels(kernels),
        "syncs_per_video": sum(syncs.values()), "sync_sites": dict(syncs), "graphed": graph,
    }))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": nvidia_smi_line(), "layers_ms": layers, "kernels_ms": kernels},
                      f, indent=1)


if __name__ == "__main__":
    main()
