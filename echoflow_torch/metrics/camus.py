"""CAMUS validation metrics and overlays (a copy of `echoflow.metrics.camus`).

Equivalents of reference src/utils/camus_validate.py:41-279: the 4-class
label name map, per-class batch Dice (`getDices`), named/combined Dice
(`camus_dice_by_name`, e.g. LVepi = LV+Myo union), the metric-dict merge
helper, and the color map used by overlays.
"""

from __future__ import annotations

import numpy as np
from scipy.special import softmax

LAB_NAME_MAP = {0: "BG", 1: "LV", 2: "Myo", 3: "LA"}
NAME_LAB_MAP = {v: k for k, v in LAB_NAME_MAP.items()}


def labColorMap():
    """Class -> RGB display colors (reference camus_validate.py:41-46)."""
    return {0: (0.0, 0.0, 0.0), 1: (0.8, 0.1, 0.1),
            2: (0.1, 0.8, 0.1), 3: (0.1, 0.1, 0.8)}


def getDices(autoseg: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """(N, C, H, W) logits + (N, 1, H, W) labels -> (N, C) Dice
    (reference camus_validate.py:187-208)."""
    pred = np.argmax(softmax(autoseg, axis=1), axis=1)
    labels = np.asarray(labels).squeeze()
    if labels.ndim == 2:
        labels = labels[None]
    out = np.zeros((autoseg.shape[0], len(LAB_NAME_MAP)))
    for case in range(autoseg.shape[0]):
        for key in LAB_NAME_MAP:
            seg = (pred[case] == key).astype(np.uint8)
            lab = (labels[case] == key).astype(np.uint8)
            out[case][key] = 2.0 * (seg * lab).sum() / (seg.sum() + lab.sum())
    return out


def dict_extend_values(d: dict, d_add: dict) -> dict:
    """Concatenate per-key arrays; union of keys
    (reference camus_validate.py:213-224)."""
    out = {}
    for key in d:
        out[key] = np.concatenate([d[key], d_add[key]]) if key in d_add else d[key]
    for key in d_add:
        if key not in d:
            out[key] = d_add[key]
    return out


def camus_dice_by_name(autoseg: np.ndarray, labels: np.ndarray,
                       combs: dict = None) -> dict:
    """Per-name (and per-combination, default LVepi = LV+Myo) Dice lists
    over a batch (reference camus_validate.py:237-279). `autoseg` is
    (N, C, H, W) logits or (N, H, W) label maps."""
    combs = {"LVepi": [1, 2]} if combs is None else combs
    autoseg = np.asarray(autoseg)
    if autoseg.ndim == 4:
        pred = np.argmax(softmax(autoseg, axis=1), axis=1)
    else:
        pred = autoseg.copy()

    labels = np.asarray(labels)
    if labels.ndim == 4:
        labels = np.argmax(labels, axis=1) if labels.shape[1] > 1 else np.squeeze(labels, 1)

    ret = {name: [] for name in list(NAME_LAB_MAP) + list(combs)}
    for case in range(pred.shape[0]):
        for name, key in NAME_LAB_MAP.items():
            seg = (pred[case] == key).astype(np.uint8)
            lab = (labels[case] == key).astype(np.uint8)
            ret[name].append(2.0 * (seg * lab).sum() / (seg.sum() + lab.sum()))
        for name, keys in combs.items():
            seg = np.zeros(pred.shape[1:])
            lab = np.zeros(labels.shape[1:])
            for key in keys:
                seg += pred[case] == key
                lab += labels[case] == key
            assert seg.max() < 2 and lab.max() < 2, \
                "combination labels should not overlap"
            ret[name].append(2.0 * (seg * lab).sum() / (seg.sum() + lab.sum()))
    return ret


def camus_overlay(image: np.ndarray, label_map: np.ndarray,
                  alpha: float = 0.4) -> np.ndarray:
    """Blend a 4-class label map over a grayscale frame
    (reference camus_validate.py:48-170, core blending only)."""
    colors = labColorMap()
    rgb = np.stack([np.asarray(image, np.float32)] * 3, axis=-1)
    if rgb.max() > 1.5:
        rgb = rgb / 255.0
    for key, color in colors.items():
        if key == 0:
            continue
        m = label_map == key
        for c in range(3):
            rgb[..., c][m] = (1 - alpha) * rgb[..., c][m] + alpha * color[c]
    return np.clip(rgb, 0, 1)
