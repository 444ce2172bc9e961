"""Plain full-video segmentation with shift-ensemble SIMPLE fusion (the
reference's `segment_a_video_with_fusion`, src/fuse_utils.py:36-102),
written from the method, not from the program.

For each shift k (offset k * step) the video from that frame on is
stretched in time (trilinear, align_corners=False) to the nearest multiple
of 32 frames (half to even), cut into 32-frame clips and forwarded; the
softmax probabilities are stretched back to the shift's length and
argmaxed. Frame i is then labelled by SIMPLE fusion of the shifts that
cover it: frame 0 by shift 0 alone, frame i >= 1 by the shifts k < min(i, K)
that reach it. SIMPLE (Langerak et al., IEEE TMI 2010): start from the
majority vote of the raters, then five times score every active rater by
Dice against the estimate, drop those below mean - std of the active
scores (the best one always stays), and vote again.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.model import forward

CLIP = 32
EPS_DICE = 1e-7


def shift_plan(length: int, num_clips: int, step: int):
    """[(offset, length of the shift, its stretched length)]: as many shifts
    as fit a clip after them (at least one)."""
    if length < CLIP + num_clips * step:
        num_clips = (length - CLIP) // step
    num_clips = max(num_clips, 1)
    plan = []
    for k in range(num_clips):
        lk = length - k * step
        plan.append((k * step, lk, max(CLIP, int(np.round(lk / CLIP)) * CLIP)))
    return plan


def _stretch(x, frames):
    """(C, T, H, W) -> (C, frames, H, W), linear in time."""
    if x.shape[1] == frames:
        return x
    return F.interpolate(x[None], size=(frames, *x.shape[2:]), mode="trilinear",
                         align_corners=False)[0]


def _majority(raters, weights):
    """raters (F, R, H, W) 0/1, weights (F, R) -> (F, H, W) 0/1 float."""
    num = (weights[..., None, None] * raters).sum(dim=1)
    den = weights.sum(dim=1).clamp(min=1e-12)[..., None, None]
    return (num / den > 0.5).float()


def simple_fusion(raters, live, iters=5):
    """raters (F, R, H, W) 0/1 float, live (F, R) 0/1 -> (F, H, W) uint8."""
    active = live.clone()
    est = _majority(raters, active)
    for _ in range(iters):
        inter = (raters * est[:, None]).sum(dim=(2, 3))
        dice = (2 * inter + EPS_DICE) / (raters.sum(dim=(2, 3)) + est.sum(dim=(1, 2))[:, None]
                                        + EPS_DICE)
        n = active.sum(dim=1).clamp(min=1.0)
        mean = (dice * active).sum(dim=1) / n
        std = torch.sqrt((active * (dice - mean[:, None]) ** 2).sum(dim=1) / n)
        keep = active * (dice >= (mean - std)[:, None]).float()
        best = torch.argmax(torch.where(active > 0, dice, float("-inf")), dim=1)
        keep[torch.arange(len(best)), best] = 1.0
        active = keep
        est = _majority(raters, active)
    n_live = live.sum(dim=1)
    first = raters[torch.arange(raters.shape[0]), torch.argmax(live, dim=1)]
    est = torch.where(n_live[:, None, None] <= 1, first, est)
    return est.to(torch.uint8)


@torch.no_grad()
def segment_video(params, cfg, video, num_clips=5, step=1, block=4, precision=None):
    """video (3, L, H, W) uint8 (numpy or tensor) -> (L, H, W) uint8 mask,
    on the device of `params`."""
    device = params["comb_1_layer.weight"].device
    v = torch.as_tensor(np.asarray(video)).to(device).float()
    length = v.shape[1]
    flat = v.reshape(v.shape[0], -1)
    lo, hi = flat.min(dim=1).values, flat.max(dim=1).values
    v = (v - lo[:, None, None, None]) / (hi - lo)[:, None, None, None]
    plan = shift_plan(length, num_clips, step)
    labels = []
    for off, lk, lki in plan:
        stretched = _stretch(v[:, off:], lki)
        clips = stretched.reshape(3, lki // CLIP, CLIP, *stretched.shape[2:]).movedim(1, 0)
        probs = []
        for i in range(0, clips.shape[0], block):
            seg, _ = forward(params, clips[i:i + block].contiguous(), cfg, train=False,
                             precision=precision, with_motion=False)
            probs.append(torch.softmax(seg, dim=1))
        probs = torch.cat(probs).movedim(0, 1).reshape(2, lki, *stretched.shape[2:])
        labels.append(torch.argmax(_stretch(probs, lk), dim=0).float())
    k_num = len(plan)
    h, w = v.shape[2:]
    raters = torch.zeros((length, k_num, h, w), device=device)
    live = torch.zeros((length, k_num), device=device)
    for i in range(length):
        for k, (off, lk, _) in enumerate(plan):
            ok = k == 0 if i == 0 else (k < min(i, k_num) and i - off >= 0)
            if ok and i - off < lk:
                raters[i, k] = labels[k][i - off]
                live[i, k] = 1.0
        if live[i].sum() == 0:
            raters[i, 0] = labels[0][i]
            live[i, 0] = 1.0
    return simple_fusion(raters, live).cpu().numpy()
