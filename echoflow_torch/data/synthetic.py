"""Synthetic echocardiogram video (numpy copy of
`echoflow.data.synthetic.make_beating_video`).

A beating ellipse (the LV) with speckle texture, intensity falloff and a
known ED/ES ground truth: enough structure for the full pipeline
(segmentation, peak picking, EF) on machines without the access-gated
EchoNet-Dynamic data or an AVI decoder.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SyntheticBeat:
    video: np.ndarray        # (3, T, H, W) float32 raw intensities
    masks: np.ndarray        # (T, H, W) uint8 LV ground truth
    ed_frames: np.ndarray    # diastole frame indices
    es_frames: np.ndarray    # systole frame indices


def make_beating_video(
    num_frames: int = 96,
    height: int = 112,
    width: int = 112,
    period: float = 40.0,
    base_radius: float = 20.0,
    amplitude: float = 8.0,
    noise: float = 12.0,
    seed: int = 0,
) -> SyntheticBeat:
    """A beating-ellipse echo lookalike. Radius r(t) = base + amp*sin(2πt/T);
    diastoles at the radius maxima, systoles at the minima."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    cy, cx = height * 0.45, width * 0.5

    frames = np.empty((num_frames, height, width), np.float32)
    masks = np.empty((num_frames, height, width), np.uint8)
    speckle = rng.rand(height, width) * 30.0
    falloff = np.exp(-(((yy - cy) / (0.9 * height)) ** 2 + ((xx - cx) / (0.9 * width)) ** 2))

    phases = 2 * np.pi * np.arange(num_frames) / period
    radii = base_radius + amplitude * np.sin(phases)
    for t in range(num_frames):
        r = radii[t]
        mask = (((yy - cy) / (1.6 * r)) ** 2 + ((xx - cx) / r) ** 2) <= 1.0
        img = 35.0 + 95.0 * (~mask) * falloff + 18.0 * mask
        img = img + speckle + noise * rng.randn(height, width)
        frames[t] = np.clip(img, 0, 255)
        masks[t] = mask.astype(np.uint8)

    # True extrema of r(t) within the clip.
    ed, es = [], []
    for t in range(1, num_frames - 1):
        if radii[t] >= radii[t - 1] and radii[t] > radii[t + 1]:
            ed.append(t)
        if radii[t] <= radii[t - 1] and radii[t] < radii[t + 1]:
            es.append(t)
    video = np.stack([frames, frames, frames]).astype(np.float32)
    return SyntheticBeat(video, masks, np.asarray(ed), np.asarray(es))
