"""Segmentation cleanup: largest-connected-component + hole filling (a copy
of `echoflow.utils.cleanup`).

Equivalents of reference src/utils/camus_validate.py:284-359
(`cleanupBinary`, `cleanupSegmentation`). Host-side (scipy.ndimage); the
EchoNet EF benchmark does not call these — they serve the CAMUS path and
general post-processing.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def cleanup_binary(mask: np.ndarray, fill_holes: bool = True) -> np.ndarray:
    """Keep the largest 4-connected component; optionally fill holes
    (reference cleanupBinary, camus_validate.py:284-301)."""
    mask = np.asarray(mask).astype(bool)
    if not mask.any():
        return mask.astype(np.uint8)
    labeled, num = ndimage.label(mask)
    if num > 1:
        sizes = ndimage.sum_labels(mask, labeled, index=np.arange(1, num + 1))
        mask = labeled == (1 + int(np.argmax(sizes)))
    if fill_holes:
        mask = ndimage.binary_fill_holes(mask)
    return mask.astype(np.uint8)


def cleanup_segmentation(labels: np.ndarray, num_classes: int | None = None,
                         fill_holes: bool = True) -> np.ndarray:
    """Per-class largest-CC cleanup of a label video (T, H, W) or a single
    frame (H, W) (reference cleanupSegmentation, camus_validate.py:305-359).
    Background (class 0) absorbs removed pixels."""
    labels = np.asarray(labels)
    single = labels.ndim == 2
    frames = labels[None] if single else labels
    if num_classes is None:
        num_classes = int(frames.max()) + 1

    out = np.zeros_like(frames)
    for t in range(frames.shape[0]):
        for k in range(1, num_classes):
            cleaned = cleanup_binary(frames[t] == k, fill_holes=fill_holes)
            out[t][cleaned.astype(bool)] = k
    return out[0] if single else out


# Reference-named aliases.
cleanupBinary = cleanup_binary
cleanupSegmentation = cleanup_segmentation
