"""1-D peak finding matching `scipy.signal.find_peaks` for the subset of
features the pipeline uses (distance + prominence).

The reference calls `find_peaks(±size, distance=20, prominence=0.5*range)`
(src/fuse_utils.py:112-113) to locate systoles/diastoles on the LV-area
curve; EF pairing is sensitive to ±1 frame, so tie-breaking must match scipy
exactly (SURVEY.md §7.3). Curves are short (≤ a few thousand frames), so this
runs on host in numpy; scipy itself remains available for cross-checks and is
used as the oracle in tests.

Semantics reproduced:
  - local maxima with plateau handling: a peak is reported at the (floor)
    midpoint of any flat plateau that is strictly higher than both sides.
  - `distance`: peaks are kept highest-first; any not-yet-removed peak closer
    than ceil(distance) to a kept peak is removed. Ties in height are broken
    by ascending stable argsort of the heights (scipy behavior).
  - `prominence` (wlen unrestricted): walk left/right from the peak until a
    strictly higher sample or the signal edge; the prominence is
    peak height − max(min of left walk, min of right walk).
"""

from __future__ import annotations

import math

import numpy as np


def local_maxima_1d(x: np.ndarray) -> np.ndarray:
    """Indices of strict local maxima (plateau midpoints), scipy-compatible."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    out = []
    i = 1
    i_max = n - 1
    while i < i_max:
        if x[i - 1] < x[i]:
            ahead = i + 1
            while ahead < i_max and x[ahead] == x[i]:
                ahead += 1
            if x[ahead] < x[i]:
                left = i
                right = ahead - 1
                out.append((left + right) // 2)
                i = ahead
        i += 1
    return np.asarray(out, dtype=np.intp)


def _select_by_distance(peaks: np.ndarray, heights: np.ndarray, distance: float) -> np.ndarray:
    """Boolean keep-mask: highest peaks win, closer-than-distance ones drop."""
    dist = math.ceil(distance)
    npk = peaks.shape[0]
    keep = np.ones(npk, dtype=bool)
    priority = np.argsort(heights, kind="stable")
    for i in range(npk - 1, -1, -1):
        j = priority[i]
        if not keep[j]:
            continue
        k = j - 1
        while k >= 0 and peaks[j] - peaks[k] < dist:
            keep[k] = False
            k -= 1
        k = j + 1
        while k < npk and peaks[k] - peaks[j] < dist:
            keep[k] = False
            k += 1
    return keep


def peak_prominences(x: np.ndarray, peaks: np.ndarray) -> np.ndarray:
    """Prominence of each peak with an unrestricted window (wlen=None)."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    proms = np.empty(peaks.shape[0], dtype=np.float64)
    for idx, peak in enumerate(peaks):
        h = x[peak]
        i = peak
        left_min = h
        while i >= 0 and x[i] <= h:
            if x[i] < left_min:
                left_min = x[i]
            i -= 1
        i = peak
        right_min = h
        while i < n and x[i] <= h:
            if x[i] < right_min:
                right_min = x[i]
            i += 1
        proms[idx] = h - max(left_min, right_min)
    return proms


def find_peaks_1d(
    x: np.ndarray,
    distance: float | None = None,
    prominence: float | None = None,
) -> np.ndarray:
    """scipy.signal.find_peaks(x, distance=..., prominence=...)[0] equivalent.

    Conditions are applied in scipy's order: distance first, prominence
    second (order matters — distance removal changes nothing about
    prominences, but prominence-filtering before distance would).
    """
    x = np.asarray(x, dtype=np.float64)
    peaks = local_maxima_1d(x)
    if distance is not None:
        keep = _select_by_distance(peaks, x[peaks], distance)
        peaks = peaks[keep]
    if prominence is not None:
        proms = peak_prominences(x, peaks)
        peaks = peaks[proms >= prominence]
    return peaks
