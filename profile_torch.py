#!/usr/bin/env python3
"""Where the time of echoflow_torch's main path goes on one NVIDIA GPU.

    python3 profile_torch.py [--videos 3] [--dtype float32|bfloat16] [--out PATH]
    python3 profile_torch.py --train [--out PATH]

Runs the engine of chip_smoke.py (full-width R(2+1)D-18, seeded weights,
5 shifts, step 1, SIMPLE fusion, 176-frame 112x112 uint8 videos) once to
warm up, then under torch.profiler, and prints one JSON line: wall time,
device busy time and idle share, device time by layer and by kernel.

With --train it profiles one full-width fused CLAS-FV train step instead
(batch 4 x 3 x 32 x 112 x 112, fp32, TF32 off, after two warm-up steps),
split by the step's ranges `echoflow_torch.train.{forward,ota_and_chains,
backward,optimizer}`, with the warp kernels K2-K4 by name (ms in the step,
launches, us per launch). The backward's kernels are launched from
autograd's device thread, outside the range opened on the calling thread;
they count for `train.backward`. One more step, not profiled, runs with
torch's sync debug mode set to "warn": `syncs_per_step` counts the calls
in it that waited for the device, by the line that made them.

A layer is a `record_function` range of the engine (`echoflow_torch.<layer>`,
see echoflow_torch/infer/pipeline.py): each device kernel or copy counts
for the innermost range around the host call that launched it. The videos
are dispatched ahead from this thread with `segment_video_async` (what
`segment_videos` does from a worker thread), so every launch is recorded
under its range. The port's own kernels are launched through ctypes, which
the profiler does not link to a host call; their device time counts for
the range of the wrapper that alone launches them (`OWN_KERNELS`).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import count_syncs, nvidia_smi_line, smoke_weights
from echoflow_torch.data.synthetic import make_beating_video
from echoflow_torch.infer.pipeline import VideoSegmenter, _unpackbits
from echoflow_torch.ops import _build

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


def profile_train(out_path=None):
    """One full-width fused train step under the profiler."""
    from echoflow_torch.ops import warp_kernel as wk
    from echoflow_torch.train.loop import (TrainConfig, create_train_state, make_train_step,
                                           prefetch_to_device)
    from train_clasfv_torch import synthetic_batches

    cfg = TrainConfig()
    state = create_train_state(0, cfg, device="cuda")
    batches = list(prefetch_to_device(
        synthetic_batches(cfg.batch_size, cfg.clip_length, cfg.image_size[0], 4, seed=0),
        "cuda"))
    step = make_train_step(fused_ota=True)
    for batch in batches[:2]:
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    launches0 = (wk.warp_forward.launches, wk.warp_image_grad.launches,
                 wk.warp_coord_grad.launches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batches[2])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    assert np.isfinite(float(metrics["loss"]))
    launches = [b - a for a, b in zip(launches0, (wk.warp_forward.launches,
                                                  wk.warp_image_grad.launches,
                                                  wk.warp_coord_grad.launches))]
    _, syncs = count_syncs(lambda: step(state, batches[3]))
    layers, kernels = split_device_time(prof, TRAIN_KERNELS, "train.backward")
    busy_ms = sum(kernels.values())
    warp = {}
    for (short, name), count in zip(TRAIN_KERNELS.items(), launches):
        ms = sum(v for k, v in kernels.items() if short in k)
        warp[short] = {"ms_per_step": ms, "launches": count,
                       "us_per_launch": ms * 1e3 / max(count, 1)}
    result = {
        "card": nvidia_smi_line(), "mode": "train", "batch": list(batches[0]["video"].shape),
        "dtype": "float32", "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "layers_ms": dict(sorted(layers.items(), key=lambda kv: -kv[1])),
        "warp_kernels": warp, "top_kernels_ms": top_kernels(kernels),
        "syncs_per_step": sum(syncs.values()), "sync_sites": dict(syncs),
    }
    print(json.dumps(result))
    if out_path:
        with open(out_path, "w") as f:
            json.dump(dict(result, kernels_ms=kernels), f, indent=1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--videos", type=int, default=3)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    ap.add_argument("--train", action="store_true",
                    help="profile one full-width fused train step instead")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch: needs an NVIDIA GPU")
    _build.build_all()
    if args.train:
        return profile_train(args.out)
    engine = VideoSegmenter(smoke_weights(), dtype=getattr(torch, args.dtype))
    videos = [make_beating_video(num_frames=176, period=38.0 + 6 * i, seed=i + 1)
              .video.astype(np.uint8) for i in range(args.videos)]
    engine.segment_video(videos[0], num_clips=5, step=1, fuse_method="simple")
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        handles = [engine.segment_video_async(v, num_clips=5, step=1, fuse_method="simple")
                   for v in videos]
        masks = [_unpackbits(p.numpy(), width)[:length] for p, (length, width) in handles]
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    assert len(masks) == len(videos) and masks[0].shape == (176, 112, 112)

    layers, kernels = split_device_time(prof, OWN_KERNELS)
    busy_ms = sum(kernels.values())
    print(json.dumps({
        "card": nvidia_smi_line(), "dtype": args.dtype, "videos": len(videos),
        "frames": 176 * len(videos), "wall_ms": wall_ms,
        "device_busy_ms": busy_ms, "device_idle_share": 1.0 - busy_ms / wall_ms,
        "layers_ms": dict(sorted(layers.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": top_kernels(kernels),
    }))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": nvidia_smi_line(), "layers_ms": layers, "kernels_ms": kernels},
                      f, indent=1)


if __name__ == "__main__":
    main()
