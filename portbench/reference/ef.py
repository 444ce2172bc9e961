"""Plain ejection fraction of a segmented video (the reference's
`compute_ef_using_putative_clips`, src/fuse_utils.py:105-148, with
`get2dPucks` of src/utils/echo_utils.py:259-385), written from the method
with scipy's peak finder and grey morphology.

LV area per frame -> systoles at the peaks of -area and diastoles at the
peaks of +area (scipy.signal.find_peaks, distance 20, prominence half the
5th-95th percentile range), diastoles kept at or above the 85th
percentile, frame 0 added when its first three frames average that much
-> each systole paired with the nearest earlier diastole (one pair a
diastole) -> per-beat monoplane Simpson EF from 10 pucks along the mask's
principal axis; negative (and undefined) EFs dropped.

LV areas are pixel counts, so two peaks of equal height often fall closer
than the distance, and which of them stays is a matter of rank. scipy
ranks equal heights by numpy's default sort, whose order among equals is
unspecified (and differs once a curve has more than 16 local maxima);
echoflow and its port rank them by a stable sort. Both follow the method,
so `ef_lists` gives every list the method allows: scipy's own ranking and
equal heights taken earlier frame first or later frame first, in each of
the two peak searches.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage, signal

_CROSS = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], bool)


def pucks(mask, npucks=10):
    """(length along the principal axis, npucks median boundary radii)."""
    mask = np.asarray(mask) > 0
    if not mask.any():
        return 1.0, np.zeros(npucks)
    coords = np.stack(np.nonzero(mask)).astype(np.float64)
    try:
        vals, vecs = np.linalg.eig(np.cov(coords, rowvar=True))
    except Exception:   # the reference's guard around the decomposition
        return 0.0, np.zeros(npucks)
    vecs = vecs[:, np.argsort(vals)[::-1]]
    if vecs[0, 0] < 0:
        vecs[:, 0] = -vecs[:, 0]
    if vecs[1, 1] < 0:
        vecs[:, 1] = -vecs[:, 1]
    center = coords.mean(axis=1, keepdims=True)
    m = mask.astype(np.uint8)
    boundary = (ndimage.grey_dilation(m, footprint=_CROSS, mode="nearest")
                != ndimage.grey_erosion(m, footprint=_CROSS, mode="nearest"))
    if not boundary.any():
        return 0.0, np.zeros(npucks)
    proj = (np.stack(np.nonzero(boundary)).astype(np.float64) - center).T @ vecs
    lo, hi = proj.min(axis=0), proj.max(axis=0)
    edges = np.linspace(lo[0], hi[0], npucks + 1)
    radii = np.zeros(npucks)
    for i in range(npucks):
        inside = (proj[:, 0] >= edges[i]) & (proj[:, 0] < edges[i + 1])
        if inside.any():
            radii[i] = np.median(np.abs(proj[inside, 1]))
    return float((hi - lo)[0]), radii


def simpson_ef(mask_ed, mask_es):
    volumes = []
    for mask in (mask_ed, mask_es):
        length, radii = pucks(mask)
        volumes.append(np.sum(np.pi * radii * radii * length / len(radii)))
    with np.errstate(divide="ignore", invalid="ignore"):
        return float((volumes[0] - volumes[1]) / volumes[0] * 100.0)


DISTANCE = 20
# How equal heights are ranked in the distance rule: as scipy's own sort
# ranks them, the earlier frame first, or the later frame first.
TIES = ("scipy", "first", "last")


def find_peaks(x, prominence, ties="scipy"):
    """scipy.signal.find_peaks(x, distance=DISTANCE, prominence=prominence)[0],
    with equal heights ranked as `ties` says (TIES). The distance rule keeps
    the highest peak and drops those nearer to it than DISTANCE, then the
    next highest left; the prominence of a peak is the curve's, whichever
    peaks stay, so it filters afterwards as scipy does."""
    if ties == "scipy":
        return signal.find_peaks(x, distance=DISTANCE, prominence=prominence)[0]
    peaks = signal.find_peaks(x)[0]          # local maxima, plateau midpoints
    rank = np.lexsort((peaks if ties == "first" else -peaks, -x[peaks]))
    keep = np.ones(len(peaks), bool)
    for j in rank:
        if keep[j]:
            near = np.abs(peaks - peaks[j]) < DISTANCE
            near[j] = False
            keep[near] = False
    peaks = peaks[keep]
    if len(peaks) == 0:
        return peaks
    return peaks[signal.peak_prominences(x, peaks)[0] >= prominence]


def beat_pairs(size, ties_es="scipy", ties_ed="scipy"):
    """[(ED, ES)] frames of an LV area curve, equal heights ranked by
    `ties_es` among the systoles and `ties_ed` among the diastoles."""
    p05, p85, p95 = np.percentile(size, [5, 85, 95])
    prominence = 0.5 * (p95 - p05)
    systoles = find_peaks(-size, prominence, ties_es)
    diastoles = [int(x) for x in find_peaks(size, prominence, ties_ed) if size[x] >= p85]
    if np.mean(size[:3]) >= p85:
        diastoles = [0] + diastoles
    pairs = []
    for es in sorted(int(s) for s in systoles):
        earlier = [d for d in diastoles if d < es]
        if earlier and (not pairs or pairs[-1][0] != max(earlier)):
            pairs.append((max(earlier), es))
    return pairs


def _efs(masks, pairs, cache):
    efs = []
    for pair in pairs:
        if pair not in cache:
            cache[pair] = simpson_ef(masks[pair[0]], masks[pair[1]])
        if np.isfinite(cache[pair]) and cache[pair] >= 0:
            efs.append(cache[pair])
    return efs


def ef_list(masks):
    """(L, H, W) 0/1 labels -> list of per-beat EFs, with scipy's ranking."""
    size = np.sum(masks, axis=(1, 2)).astype(np.float64)
    return _efs(masks, beat_pairs(size), {})


def ef_lists(masks):
    """Every list of per-beat EFs that the method gives for (L, H, W) 0/1
    labels, equal LV areas ranked either way (TIES) in each peak search;
    scipy's own first."""
    size = np.sum(masks, axis=(1, 2)).astype(np.float64)
    cache, out = {}, []
    for ties_es in TIES:
        for ties_ed in TIES:
            efs = _efs(masks, beat_pairs(size, ties_es, ties_ed), cache)
            if efs not in out:
                out.append(efs)
    return out
