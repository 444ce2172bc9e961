"""Synthetic echocardiogram videos and training samples (numpy copy of
`echoflow.data.synthetic`: `make_beating_video`, `write_synthetic_avi`,
`make_training_sample`, `make_ed_es_only_sample`).

A beating ellipse (the LV) with speckle texture, intensity falloff and a
known ED/ES ground truth: enough structure for the full pipeline
(segmentation, peak picking, EF) on machines without the access-gated
EchoNet-Dynamic data; `write_synthetic_avi` needs cv2, imported when it
is called.
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


def write_avi(path: str, frames: np.ndarray, fps: float = 30.0):
    """Write (T, H, W) grayscale intensities as an MJPG AVI, each frame
    replicated to three channels (cv2 is imported here, on first use)."""
    import cv2

    height, width = frames.shape[1:]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), fps, (width, height))
    if not writer.isOpened():
        raise RuntimeError(f"could not open AVI writer at {path}")
    try:
        for frame in frames.astype(np.uint8):
            writer.write(np.stack([frame, frame, frame], axis=-1))   # BGR
    finally:
        writer.release()


def write_synthetic_avi(path: str, num_frames: int = 96, height: int = 112,
                        width: int = 112, seed: int = 0,
                        period: float = 40.0) -> SyntheticBeat:
    """Write a synthetic echo video as an AVI (for CLI-path verification)."""
    beat = make_beating_video(num_frames, height, width, period=period, seed=seed)
    write_avi(path, beat.video[0], fps=30.0)
    return beat


def _sample_beat(clip_length, height, width, seed):
    """The sample generators' shared draw: a 3-clip-long beating video with
    random period, contraction and heart size, and its first ED frame."""
    rng = np.random.RandomState(seed)
    period = float(rng.uniform(1.2, 2.0) * clip_length)
    # Contraction strength and heart size vary from sample to sample, so a
    # model trained on them sees a range of ejection fractions.
    amplitude = float(rng.uniform(3.5, 11.0))
    base_radius = float(rng.uniform(17.0, 24.0))
    beat = make_beating_video(num_frames=clip_length * 3, height=height, width=width,
                              period=period, seed=seed, amplitude=amplitude,
                              base_radius=base_radius)
    return rng, beat, int(beat.ed_frames[0])


def make_training_sample(clip_length: int = 32, height: int = 112, width: int = 112,
                         seed: int = 0):
    """One CLAS-FV training sample: a clip covering ED -> ES with labels.
    Returns a dict: video (3, T, H, W) normalized float32, ed_label /
    es_label (H, W) uint8, ed_idx / es_idx ints."""
    from echoflow_torch.ops.normalize import zeroone_normalizer

    _, beat, ed = _sample_beat(clip_length, height, width, seed)
    es = int(beat.es_frames[beat.es_frames > ed][0])
    start = max(0, min(ed, beat.video.shape[1] - clip_length))
    video = beat.video[:, start:start + clip_length].copy()
    return {
        "video": zeroone_normalizer(video),
        "ed_label": beat.masks[ed],
        "es_label": beat.masks[es],
        "ed_idx": ed - start,
        "es_idx": min(es - start, clip_length - 1),
    }


def make_ed_es_only_sample(clip_length: int = 32, height: int = 112, width: int = 112,
                           seed: int = 0):
    """One ed-or-es-only training sample (the two-clip recipe): a clip whose
    random window covers the ED frame and one covering the ES frame, each
    with the labeled frame's index within its own clip. Returns a dict:
    ed_video / es_video (3, T, H, W) normalized, ed_label / es_label (H, W)
    uint8, ed_idx / es_idx ints."""
    from echoflow_torch.data.echonet import random_start_given_mid_point
    from echoflow_torch.ops.normalize import zeroone_normalizer

    rng, beat, ed = _sample_beat(clip_length, height, width, seed)
    es = int(beat.es_frames[beat.es_frames > ed][0])
    out = {"ed_label": beat.masks[ed], "es_label": beat.masks[es]}
    for name, mid in (("ed", ed), ("es", es)):
        start, _ = random_start_given_mid_point(mid, beat.video.shape[1], clip_length, rng)
        out[name + "_video"] = zeroone_normalizer(
            beat.video[:, start:start + clip_length].copy())
        out[name + "_idx"] = mid - start
    return out
