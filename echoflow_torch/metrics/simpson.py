"""Simpson's method-of-disks volume from a 2-D binary LV mask.

Matches reference src/utils/echo_utils.py:259-385 (`get2dPucks`) and :235-256
(`computeSimpsonVolume`). The algorithm: PCA of the mask's pixel coordinates
gives a principal (long) axis; the mask boundary is projected into the PCA
frame; the extent along the principal axis is the ventricle length L; the
boundary is partitioned into `npucks` slabs along that axis and the median
|secondary-axis| coordinate in each slab is the puck radius.

skimage is not a dependency: `find_boundaries(mode='thick')` is
re-implemented as dilation != erosion with a 4-connected cross footprint
(exactly skimage's definition for connectivity=1), using edge-replicated
shifts — identical to skimage's reflect-padded grey morphology for a
radius-1 footprint.

These run per ED/ES frame on the host (a handful of frames per video); kept
in numpy for bit-parity with the reference (np.linalg.eig, np.median).
"""

from __future__ import annotations

import numpy as np


def _shift_pad_edge(a: np.ndarray, dy: int, dx: int) -> np.ndarray:
    """Shift a 2-D array by (dy, dx), replicating edge values."""
    out = a
    if dy > 0:
        out = np.concatenate([out[:1].repeat(dy, axis=0), out[:-dy]], axis=0)
    elif dy < 0:
        out = np.concatenate([out[-dy:], out[-1:].repeat(-dy, axis=0)], axis=0)
    if dx > 0:
        out = np.concatenate([out[:, :1].repeat(dx, axis=1), out[:, :-dx]], axis=1)
    elif dx < 0:
        out = np.concatenate([out[:, -dx:], out[:, -1:].repeat(-dx, axis=1)], axis=1)
    return out


def find_boundaries_thick(mask: np.ndarray) -> np.ndarray:
    """Thick boundaries of a 2-D label image, 4-connectivity.

    Pixels where the cross-neighborhood max differs from the min — skimage's
    `find_boundaries(img, mode='thick')` with the default connectivity=1.
    """
    m = np.asarray(mask)
    shifts = [m]
    for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        shifts.append(_shift_pad_edge(m, dy, dx))
    stack = np.stack(shifts)
    return stack.max(axis=0) != stack.min(axis=0)


def get2dPucks(abin: np.ndarray, apix, npucks: int = 10):
    """Principal-axis length and `npucks` median boundary radii of a binary
    mask. Returns (L, R) with R shape (npucks,).

    Degenerate cases follow the reference exactly: empty mask -> (1.0, zeros);
    eigendecomposition failure -> (0.0, zeros); empty slab -> radius 0.
    """
    abin = np.asarray(abin)
    if not np.any(abin):
        return 1.0, np.zeros((npucks,))

    rows, cols = np.where(abin > 0)
    coords = np.stack([rows, cols]).astype(np.float64)
    if coords.shape[1] < 1:
        return 0.0, np.zeros((npucks,))
    coords = coords * np.asarray(apix, dtype=np.float64)[:, None]

    try:
        eigval, eigvec = np.linalg.eig(np.cov(coords, rowvar=True))
    except Exception:
        return 0.0, np.zeros((npucks,))

    order = np.argsort(eigval)[::-1]
    eigvec = eigvec[:, order]

    # Deterministic sign convention (reference echo_utils.py:288-291).
    if eigvec[0, 0] < 0:
        eigvec[:, 0] = -eigvec[:, 0]
    if eigvec[1, 1] < 0:
        eigvec[:, 1] = -eigvec[:, 1]

    center = coords.mean(axis=1, keepdims=True)

    boundary = find_boundaries_thick(abin)
    if not boundary.any():
        # A constant mask (e.g. all-foreground) has no thick boundary; the
        # reference crashes on the empty reduction here — degrade to the
        # same convention as its other degenerate paths instead.
        return 0.0, np.zeros((npucks,))
    bcoords = np.stack(np.where(boundary)).astype(np.float64)
    bcoords = bcoords * np.asarray(apix, dtype=np.float64)[:, None]
    proj = (bcoords - center).T @ eigvec  # (M, 2): principal / secondary

    lo = proj.min(axis=0)
    hi = proj.max(axis=0)
    length = (hi - lo)[0]

    # Slab assignment + per-slab medians, vectorized. Identical to the
    # reference's per-slab loop `(x >= edges[i]) & (x < edges[i+1])`:
    # searchsorted(edges, x, side='right') - 1 lands exactly-on-edge points
    # in the same slab the loop's comparisons do, points at the top edge
    # fall in no slab (the reference loop excludes x == edges[-1]), and the
    # median of a lexsorted group is its middle element (odd count) or the
    # mean of the middle two (even) — np.median's exact arithmetic.
    edges = np.linspace(lo[0], hi[0], npucks + 1)
    slab = np.searchsorted(edges, proj[:, 0], side="right") - 1
    sec = np.abs(proj[:, 1])
    order = np.lexsort((sec, slab))
    slab_s = slab[order]
    sec_s = sec[order]
    bounds = np.searchsorted(slab_s, np.arange(npucks + 1))
    counts = np.diff(bounds)
    last = len(sec_s) - 1
    mid_lo = np.minimum(bounds[:-1] + (counts - 1) // 2, last)
    mid_hi = np.minimum(bounds[:-1] + counts // 2, last)
    radii = np.where(counts > 0, (sec_s[mid_lo] + sec_s[mid_hi]) / 2.0, 0.0)

    return float(length), np.asarray(radii)


def simpson_monoplane_volume(mask: np.ndarray, pix=(1.0, 1.0), npucks: int = 10) -> float:
    """Monoplane Simpson volume: sum of circular-disk volumes, as the EF
    pipeline computes it (reference src/fuse_utils.py:132-137)."""
    length, radii = get2dPucks(np.asarray(mask).astype(int), pix, npucks)
    return float(np.sum(np.pi * radii * radii * length / len(radii)))


def computeSimpsonVolume(a2bin, a4bin, a2pix, a4pix) -> float:
    """Biplane Simpson volume from A2/A4 views (reference
    echo_utils.py:235-256): stacked elliptical pucks with the longer of the
    two view lengths as the common height."""
    l2, r2 = get2dPucks(a2bin, a2pix)
    l4, r4 = get2dPucks(a4bin, a4pix)
    return float(((max(l2, l4) * np.pi) / len(r2)) * np.sum(r2 * r4))


def nan_helper(y):
    """Logical NaN indices + logical->positional converter, the reference's
    interpolation helper (echo_utils.py:217-232):

        nans, x = nan_helper(y)
        y[nans] = np.interp(x(nans), x(~nans), y[~nans])
    """
    y = np.asarray(y)
    return np.isnan(y), lambda z: z.nonzero()[0]
