"""Dice overlap metrics (non-differentiable; numpy copy of
`echoflow.metrics.dice`).

Matches reference src/clasfv_losses.py:60-68 (`categorical_dice`).
"""

from __future__ import annotations

import numpy as np


def categorical_dice(prediction, truth, k: int, epsilon: float = 1e-5) -> float:
    """Dice overlap between integer label maps for class value k."""
    pred_k = np.asarray(prediction) == k
    true_k = np.asarray(truth) == k
    inter = np.sum(pred_k & true_k)
    return float(2.0 * inter / (pred_k.sum() + true_k.sum() + epsilon))


def lv_dice(prediction, truth, epsilon: float = 1e-5) -> float:
    """Left-ventricle (class 1) Dice — the reference's headline metric."""
    return categorical_dice(prediction, truth, 1, epsilon)
