"""Visualization: segmentation overlays and the annotated GIF the CLI emits
(numpy copy of `echoflow.utils.visualize`).

Covers the reference's user-facing outputs (src/visualization_utils.py:346-538):
`echonet_overlay` draws the predicted LV on the echo frame; `make_annotated_gif`
renders overlay frames side by side with a live LV-area strip chart and
writes a GIF (PIL writer here; the reference shelled out to imagemagick).
matplotlib, PIL and cv2 are imported inside the functions that use them.
"""

from __future__ import annotations

import numpy as np


# The reference's LV overlay color and its complement, used for the
# prediction-vs-truth difference view (visualization_utils.py:341-343,
# 385-390: complement of [r,g,b] is [max-r, max-g, max-b]).
LV_COLOR = (0.3, 0.3, 0.0)
LV_COMP_COLOR = (0.0, 0.0, 0.3)


def echonet_overlay(frame: np.ndarray, mask: np.ndarray,
                    truth: np.ndarray | None = None,
                    color=(0.1, 0.9, 0.3), alpha: float = 0.35) -> np.ndarray:
    """Blend an LV mask over a grayscale/RGB frame. frame (H, W) or (H, W, 3)
    in [0, 1]; mask (H, W) {0,1}. Returns (H, W, 3) float in [0, 1].

    With `truth` (a clinician (H, W) {0,1} mask), returns the reference's
    prediction-vs-truth *difference* overlay instead
    (visualization_utils.py:424-434): false positives (predicted LV where
    truth disagrees) are tinted the LV color, false negatives its color
    complement, and agreeing pixels stay plain echo."""
    if frame.ndim == 2:
        rgb = np.stack([frame] * 3, axis=-1)
    else:
        rgb = frame.copy()
    m = mask.astype(bool)
    if truth is not None:
        t = np.asarray(truth).squeeze().astype(bool)
        fp = m & ~t
        fn = ~m & t
        for c in range(3):
            rgb[..., c][fp] += LV_COLOR[c]
            rgb[..., c][fn] += LV_COMP_COLOR[c]
        return np.clip(rgb, 0, 1)
    for c in range(3):
        rgb[..., c][m] = (1 - alpha) * rgb[..., c][m] + alpha * color[c]
    # Contour: boundary pixels fully saturated.
    from echoflow_torch.metrics.simpson import find_boundaries_thick

    b = find_boundaries_thick(mask.astype(int)) & m
    for c in range(3):
        rgb[..., c][b] = color[c]
    return np.clip(rgb, 0, 1)


def simpson_volume_curve(segmentations: np.ndarray) -> np.ndarray:
    """Per-frame monoplane Simpson LV volume — the quantity the reference's
    annotated GIF strip plots live (visualization_utils.py:490-496: the
    same mask is passed as both views). (L, H, W) -> (L,) float (ml at
    1.0 mm/px)."""
    from echoflow_torch.metrics.simpson import computeSimpsonVolume

    return np.asarray([
        computeSimpsonVolume(seg, seg, (1.0, 1.0), (1.0, 1.0))
        for seg in np.asarray(segmentations)
    ])


def make_annotated_gif(segmentations: np.ndarray, video: np.ndarray,
                       filename: str, fps: int = 20):
    """Write an annotated GIF: overlay on the left, the live Simpson LV
    *volume* strip on the right — revealed up to the current frame, exactly
    the reference's annotation (visualization_utils.py:476-538).
    segmentations (L, H, W) uint8; video (3, L, H, W) float in [0, 1]."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from PIL import Image

    length = segmentations.shape[0]
    volume = simpson_volume_curve(segmentations)

    frames = []
    fig, (ax_img, ax_curve) = plt.subplots(1, 2, figsize=(7, 3.2), dpi=80)
    # Reference strip framing: fixed limits with +-100 ml headroom and one
    # trailing frame of x slack (visualization_utils.py:516-518).
    ylim = (volume.min() - 100, volume.max() + 100)
    for t in range(length):
        ax_img.clear()
        ax_curve.clear()
        ax_img.imshow(echonet_overlay(video[0, t], segmentations[t]))
        ax_img.set_title(f"frame {t}")
        ax_img.axis("off")
        ax_curve.plot(np.arange(t + 1), volume[:t + 1], c="limegreen", lw=1.2)
        ax_curve.set_xlim(0, length + 1)
        ax_curve.set_ylim(*ylim)
        ax_curve.set_title("LV Volume (ml)")
        fig.tight_layout()
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
        frames.append(Image.fromarray(buf.copy()))
    plt.close(fig)

    frames[0].save(filename, save_all=True, append_images=frames[1:],
                   duration=int(1000 / fps), loop=0)
    return filename


# ----------------------------------------------------------- small helpers
# Equivalents of reference src/visualization_utils.py:16-262.

def labColorMap():
    """Class -> RGB (reference visualization_utils.py:16-19)."""
    return {0: (0.0, 0.0, 0.0), 1: (0.8, 0.1, 0.1),
            2: (0.1, 0.8, 0.1), 3: (0.1, 0.1, 0.8)}


def label2LabColorMap(label_map: np.ndarray) -> np.ndarray:
    """(H, W) int labels -> (H, W, 3) float RGB
    (reference visualization_utils.py:39-55)."""
    colors = labColorMap()
    out = np.zeros((*label_map.shape, 3), np.float32)
    for key, color in colors.items():
        out[label_map == key] = color
    return out


def get_class_pixels(label_map: np.ndarray, class_index: int) -> np.ndarray:
    """Binary mask of one class (reference visualization_utils.py:206-220)."""
    return (np.asarray(label_map) == class_index).astype(np.uint8)


def find_outlier(values) -> np.ndarray:
    """IQR outlier mask (reference visualization_utils.py:239-244)."""
    values = np.asarray(values, np.float64)
    q1, q3 = np.percentile(values, [25, 75])
    iqr = q3 - q1
    return (values < q1 - 1.5 * iqr) | (values > q3 + 1.5 * iqr)


def box_plot_outliers(values_by_name: dict, filename: str | None = None):
    """Box plot of metric distributions with outliers flagged
    (reference visualization_utils.py:247-262)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(1.5 * len(values_by_name) + 2, 4), dpi=80)
    ax.boxplot(list(values_by_name.values()), tick_labels=list(values_by_name))
    if filename:
        fig.savefig(filename)
    plt.close(fig)
    return {name: find_outlier(v) for name, v in values_by_name.items()}


def plotContours(image: np.ndarray, masks, colors=None, thickness: int = 1) -> np.ndarray:
    """Draw each mask's contours over the image (reference
    visualization_utils.py:264-336; cv2.findContours there and here).
    image (H, W) or (H, W, 3) in [0, 1]; masks: list of (H, W) binaries."""
    import cv2

    rgb = image if image.ndim == 3 else np.stack([image] * 3, axis=-1)
    canvas = (np.clip(rgb, 0, 1) * 255).astype(np.uint8).copy()
    palette = colors or [(50, 230, 80), (230, 80, 50), (80, 50, 230)]
    for i, mask in enumerate(masks):
        contours, _ = cv2.findContours(np.asarray(mask, np.uint8),
                                       cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)
        cv2.drawContours(canvas, contours, -1, palette[i % len(palette)], thickness)
    return canvas.astype(np.float32) / 255.0


def show_sequence_of_images(images, filename: str | None = None, cols: int = 8):
    """Grid plot of a frame sequence (reference visualization_utils.py:22-36)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    images = np.asarray(images)
    n = images.shape[0]
    rows = -(-n // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(2 * cols, 2 * rows), dpi=60)
    for i, ax in enumerate(np.atleast_1d(axes).ravel()):
        ax.axis("off")
        if i < n:
            ax.imshow(images[i], cmap="gray")
    if filename:
        fig.savefig(filename)
    plt.close(fig)
    return filename


def show_pred_labels(frames, label_maps, filename: str | None = None, cols: int = 8):
    """Grid of overlay frames (reference visualization_utils.py:187-203)."""
    overlays = [echonet_overlay(np.asarray(f, np.float32), np.asarray(m))
                for f, m in zip(frames, label_maps)]
    return show_sequence_of_images(np.stack(overlays), filename, cols)


def save_animation_from_images(images, filename: str, fps: int = 15):
    """Image sequence -> GIF (reference visualization_utils.py:223-236)."""
    from PIL import Image

    pil = []
    for img in images:
        arr = np.asarray(img)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
        pil.append(Image.fromarray(arr))
    pil[0].save(filename, save_all=True, append_images=pil[1:],
                duration=int(1000 / fps), loop=0)
    return filename


def categorical_dice(truth, pred, k, epi=False, individual=False,
                     epsilon=1e-7):
    """Statistics-flavored class dice on argmax label maps (reference
    visualization_utils.py:133-162; note the (truth, pred) argument order —
    the loss-flavored twin in echoflow_torch.metrics.dice takes (prediction,
    truth)). `epi=True` groups LV+Myo (labels 1 and 2); `individual=True`
    returns per-sample dices over the trailing 2 axes instead of the mean."""
    truth = np.asarray(truth)
    pred = np.asarray(pred)
    if epi:
        a = ((pred == 1) | (pred == 2)).astype(np.float32)
        b = ((truth == 1) | (truth == 2)).astype(np.float32)
    else:
        a = (pred == k).astype(np.float32)
        b = (truth == k).astype(np.float32)
    inter = np.sum(a * b, axis=(-1, -2))
    dice = 2.0 * inter / (np.sum(a, axis=(-1, -2)) + np.sum(b, axis=(-1, -2)) + epsilon)
    return dice if individual else float(np.mean(dice))


def get_all_dice(pred, truth, LVepi=False, individual=False):
    """Per-class dice dict over the 4 CAMUS classes (reference
    visualization_utils.py:165-184). `LVepi=True` reports Background / Endo
    (LV) / Epi (LV+Myo union) / LA."""
    names = ["Background", "Endo", "Epi", "LA"] if LVepi else \
        ["Background", "LV", "Myo", "LA"]
    return {name: categorical_dice(truth, pred, index, epi=(name == "Epi"),
                                   individual=individual)
            for index, name in enumerate(names)}
