"""Ejection-fraction computation from a segmented video (numpy copy of
`echoflow.infer.ef`, kept here so the port never imports the JAX package).

Exact semantics of reference `compute_ef_using_putative_clips`
(src/fuse_utils.py:105-148): LV-area curve -> percentile trim ->
find_peaks(distance=20, prominence=0.5*(p95-p5)) on -area (systoles) and
+area (diastoles) -> keep diastoles >= p85, prepend frame 0 if the first
three frames average >= p85 -> nearest-prior-diastole pairing -> per-beat
monoplane Simpson EF, negative EFs discarded.
"""

from __future__ import annotations

import numpy as np

from echoflow_torch.metrics.pairs import EDESpairs
from echoflow_torch.metrics.simpson import get2dPucks
from echoflow_torch.ops.peaks import find_peaks_1d
from echoflow_torch.utils.profiling import span


def get_all_possible_start_points(ed_index: int, es_index: int,
                                  video_length: int, clip_length: int = 32) -> np.ndarray:
    """All clip start points whose 32-frame window covers ED..ES (the
    consecutive-clip study notebooks' helper). Empty if the systole exceeds
    the clip length."""
    if es_index - ed_index + 1 > clip_length:
        return np.asarray([], dtype=np.int64)
    lo = max(0, es_index - clip_length + 1)
    hi = min(ed_index, video_length - clip_length)
    return np.arange(lo, hi + 1, dtype=np.int64) if hi >= lo else np.asarray([], np.int64)


def start_points_covering_frame(mid_index: int, video_length: int,
                                clip_length: int = 32) -> np.ndarray:
    """All clip starts whose window contains `mid_index` — the ed/es-only
    study notebook's single-frame `get_all_possible_start_points`
    (echonet_dynamic_test_dataset_ed_or_es_only_clips.ipynb cell 3).

    Reference quirks preserved: whenever the unclamped window would run past
    the video, the upper end is clamped to `video_length - clip_length - 1`,
    which the exclusive arange turns into a maximum returned start of
    `video_length - clip_length - 2` — two short of the last valid start."""
    lo = max(0, mid_index - clip_length + 1)
    hi = mid_index + 1
    if hi + clip_length >= video_length:
        hi = video_length - clip_length - 1
    return np.arange(lo, hi, dtype=np.int64)


def start_points_of_ed_to_es_clips(ed_index: int, es_index: int,
                                   video_length: int,
                                   clip_length: int = 32) -> np.ndarray:
    """Exact-semantics twin of the notebooks'
    `get_all_possible_start_points_of_ED_to_ES_clips` (consecutive-clips
    notebook cell 3). Same result as `get_all_possible_start_points` except
    for a systole strictly longer than the clip, where the reference
    returns `[ed]` (a window that cannot actually cover ES) instead of the
    empty set. One deliberate divergence: for videos so short that the
    reference's arithmetic yields negative start indices (which would slice
    from the video's tail), starts are clamped to 0."""
    if es_index - ed_index > clip_length:
        return np.asarray([ed_index], dtype=np.int64)
    return get_all_possible_start_points(ed_index, es_index, video_length,
                                         clip_length)


def ef_from_traces(ed_mask: np.ndarray, es_mask: np.ndarray) -> float:
    """Oracle EF from ground-truth ED/ES masks — the clinical-trace-derived
    EF floor of the reference's EF notebook (cells 15-17)."""
    return simpson_ef(ed_mask, es_mask)


def lv_area_curve(segmentations: np.ndarray) -> np.ndarray:
    """(L, H, W) labels -> (L,) LV pixel counts. The reference sums raw
    label values (fuse_utils.py:106); identical for binary {0,1} labels."""
    return np.sum(segmentations, axis=(1, 2)).ravel().astype(np.float64)


def detect_ed_es_frames(size: np.ndarray):
    """Peak-pick the area curve. Returns (diastole_indices, systole_indices)."""
    p05, p85, p95 = np.percentile(size, [5, 85, 95])
    prominence = 0.50 * (p95 - p05)
    systole = find_peaks_1d(-size, distance=20, prominence=prominence)
    diastole = find_peaks_1d(size, distance=20, prominence=prominence)

    diastole = [int(x) for x in diastole if size[x] >= p85]
    if np.mean(size[:3]) >= p85:
        diastole = [0] + diastole
    return np.asarray(diastole, dtype=np.int64), np.asarray(systole, dtype=np.int64)


def simpson_ef(mask_ed: np.ndarray, mask_es: np.ndarray) -> float:
    """Single-beat monoplane Simpson EF in percent (fuse_utils.py:128-138)."""
    length_ed, radius_ed = get2dPucks((mask_ed == 1).astype(int), (1.0, 1.0))
    length_es, radius_es = get2dPucks((mask_es == 1).astype(int), (1.0, 1.0))
    edv = np.sum(np.pi * radius_ed * radius_ed * length_ed / len(radius_ed))
    esv = np.sum(np.pi * radius_es * radius_es * length_es / len(radius_es))
    with np.errstate(divide="ignore", invalid="ignore"):
        return float((edv - esv) / edv * 100.0)


def compute_ef_using_putative_clips(fused_segmentations: np.ndarray,
                                    test_pat_index=None, return_edes: bool = False):
    """(L, H, W) label video -> list of per-beat EFs (negative EFs dropped,
    as the reference does, fuse_utils.py:140-142). Runs in the host span
    `ef` (`utils/profiling.span`)."""
    with span("ef"):
        size = lv_area_curve(fused_segmentations)
        diastole, systole = detect_ed_es_frames(size)
        pairs = EDESpairs(diastole, systole)

        frames = fused_segmentations.reshape(-1, *fused_segmentations.shape[1:])
        efs = []
        for ed, es in pairs:
            ef = simpson_ef(frames[ed], frames[es])
            if not np.isfinite(ef) or ef < 0:
                # The reference only drops negatives; a zero-EDV degenerate
                # mask yields NaN there and would poison the mean — drop
                # those too.
                continue
            efs.append(ef)
    if return_edes:
        return efs, pairs
    return efs
