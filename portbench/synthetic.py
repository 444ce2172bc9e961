"""Synthetic echocardiograms, frozen copies of the port's generators
(`data/synthetic.make_beating_video` and `make_training_sample`) with the
frames drawn in one call each: `RandomState.randn(T, H, W)` draws the same
numbers as T calls of `randn(H, W)`, so a seed gives the generators'
videos.

A beating ellipse (the left ventricle) with speckle, intensity falloff
and noise, its masks and its ED/ES frames.
"""

from __future__ import annotations

import numpy as np


def beating_video(num_frames, height=112, width=112, period=40.0, base_radius=20.0,
                  amplitude=8.0, noise=12.0, seed=0):
    """(video (3, T, H, W) float32 raw intensities, masks (T, H, W) uint8,
    ed frames, es frames)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    cy, cx = height * 0.45, width * 0.5
    speckle = rng.rand(height, width) * 30.0
    falloff = np.exp(-(((yy - cy) / (0.9 * height)) ** 2 + ((xx - cx) / (0.9 * width)) ** 2))
    radii = base_radius + amplitude * np.sin(2 * np.pi * np.arange(num_frames) / period)
    r = radii[:, None, None]
    masks = (((yy - cy) / (1.6 * r)) ** 2 + ((xx - cx) / r) ** 2) <= 1.0
    img = 35.0 + 95.0 * (~masks) * falloff + 18.0 * masks
    img = img + speckle + noise * rng.randn(num_frames, height, width)
    frames = np.clip(img, 0, 255).astype(np.float32)
    t = np.arange(1, num_frames - 1)
    ed = t[(radii[t] >= radii[t - 1]) & (radii[t] > radii[t + 1])]
    es = t[(radii[t] <= radii[t - 1]) & (radii[t] < radii[t + 1])]
    return np.stack([frames] * 3), masks.astype(np.uint8), ed, es


def normalize(video):
    """Per-channel (x - min) / (max - min) in float32 (the reference's
    `zeroone_normalizer`)."""
    c = video.shape[0]
    flat = video.reshape(c, -1).astype(np.float32)
    lo = flat.min(axis=1, keepdims=True)
    hi = flat.max(axis=1, keepdims=True)
    return ((flat - lo) / (hi - lo)).reshape(video.shape).astype(np.float32)


def training_sample(clip_length=32, height=112, width=112, seed=0):
    """One CLAS-FV sample: a clip from ED to past ES of a 3-clip video with
    a random period, contraction and heart size; its ED/ES labels and their
    frames within the clip."""
    rng = np.random.RandomState(seed)
    period = float(rng.uniform(1.2, 2.0) * clip_length)
    amplitude = float(rng.uniform(3.5, 11.0))
    base_radius = float(rng.uniform(17.0, 24.0))
    video, masks, eds, ess = beating_video(clip_length * 3, height, width, period=period,
                                           seed=seed, amplitude=amplitude,
                                           base_radius=base_radius)
    ed = int(eds[0])
    es = int(ess[ess > ed][0])
    start = max(0, min(ed, video.shape[1] - clip_length))
    return {"video": normalize(video[:, start:start + clip_length]),
            "ed_label": masks[ed], "es_label": masks[es],
            "ed_idx": ed - start, "es_idx": min(es - start, clip_length - 1)}


def training_batch(samples):
    """Host batch of samples, with the trainer's dtypes."""
    return {"video": np.stack([s["video"] for s in samples]).astype(np.float32),
            "ed_label": np.stack([s["ed_label"] for s in samples]).astype(np.int32),
            "es_label": np.stack([s["es_label"] for s in samples]).astype(np.int32),
            "ed_idx": np.asarray([s["ed_idx"] for s in samples], np.int32),
            "es_idx": np.asarray([s["es_idx"] for s in samples], np.int32)}
