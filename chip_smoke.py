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
     median), and the kernel's bound on this card;
  4. main path: a full-width R(2+1)D-18 MotionNet (seeded init, seg head
     x50 with a centred bias) in `VideoSegmenter(dtype=float32)`;
     `segment_videos` over 3 synthetic 176-frame 112x112 uint8 videos,
     5 shifts, step 1, SIMPLE fusion, then per-beat EF. The kernel's
     launch count is zeroed just before and read just after. The masks are
     held against the same engine with decoder="model" on the card, and one
     short video against the CPU engine (plain decoder, fp32).

Prints the nvidia-smi line, then one JSON line {"kernels": [...]}, and as
the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

from echoflow_torch.data.synthetic import make_beating_video
from echoflow_torch.infer.ef import compute_ef_using_putative_clips
from echoflow_torch.infer.pipeline import VideoSegmenter
from echoflow_torch.models.r2plus1d import create_model
from echoflow_torch.ops import _build
from echoflow_torch.ops.decoder_heads import decoder_heads, reference_decoder_heads
from echoflow_torch.ops.normalize import zeroone_normalizer

# Peak rates of an H100 SXM (NVIDIA data sheet): fp32 outside the tensor
# cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
K1_TOL = 1e-4          # fp32 on both sides; only the summation order differs
MASK_TOL = 1e-4        # argmax near-ties between two fp32 decoders


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


def k1_bound(projs, with_motion):
    """(bound_ms, bound_by, flops, bytes) of the decoder tail on these inputs: each
    input read once, each output written once; per output pixel 8 FLOP per
    source channel for the bilinear sum, 2 for +b1/ReLU, 2*64*64 for comb2,
    2*64*2 for the seg head (+ 2*64*4 for the motion head)."""
    bsz, t = projs[0].shape[:2]
    pixels = bsz * t * 112 * 112
    c = projs[0].shape[-1]
    per_px = 8 * c * len(projs) + 2 * c + 2 * c * c + 2 * c * 2 + (2 * c * 4 if with_motion else 0)
    flops = pixels * per_px
    nbytes = sum(p.numel() * 4 for p in projs) + (c + c * c + c + c * 2 + 2) * 4
    nbytes += pixels * (2 + (4 if with_motion else 0)) * 4
    compute_ms, memory_ms = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    bound_by = "operations" if compute_ms >= memory_ms else "bytes"
    return max(compute_ms, memory_ms), bound_by, flops, nbytes


def phase_k1():
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    projs = [torch.randn(30, 32, s, s, 64, device="cuda", generator=g) * 0.2
             for s in (56, 28, 14, 7)]
    shapes = dict(b1=(64,), w2=(64, 64), b2=(64,), ws=(64, 2), bs=(2,), wm=(64, 4), bm=(4,))
    w = {k: torch.randn(*s, device="cuda", generator=g) * 0.3 for k, s in shapes.items()}
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
        bound_ms, bound_by, flops, nbytes = k1_bound(projs, with_motion)
        result[with_motion] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                   bound_ms=bound_ms, bound_by=bound_by)
        log(f"K1 with_motion={with_motion}: max_abs_err {err:.3e}, kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
            f"({flops / 1e9:.1f} GFLOP, {nbytes / 1e9:.3f} GB)")
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
        # No single PyTorch call computes upsample-sum + comb2 + heads.
        "library_ms": None,
        "ms_with_motion": k1[True]["ms"],
        "plain_ms_with_motion": k1[True]["plain_ms"],
        "bound_ms_with_motion": k1[True]["bound_ms"],
    }]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
