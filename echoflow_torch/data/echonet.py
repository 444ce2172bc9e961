"""EchoNet-Dynamic data layer, reimplemented without the `echonet` package
(numpy copy of `echoflow.data.echonet`; its trilinear resizes run the
port's `ops/resize.trilinear_resize` on CPU tensors).

The reference wraps `echonet.datasets.Echo` (src/echonet_dataset.py:53-156);
that package reads FileList.csv / VolumeTracings.csv, decodes AVIs, and
rasterizes the clinician chord traces into LV masks. This module provides
the same data contract natively:

  - `EchoNetIndex`: FileList.csv / VolumeTracings.csv parsing.
  - `rasterize_trace`: chord list -> binary LV mask (the polygon
    construction from the reference meta notebook cell 17: the first chord
    is the long axis and is excluded; the remaining chords' endpoints are
    walked down one side and back up the other, then filled).
  - `get_mean_and_std`: dataset-level channel statistics (reference
    echonet_dataset.py:74 computes these over a full split pass).
  - `EchoNetDynamicDataset`: reference-parity __getitem__, including the
    period division, the test-patient-919 3x temporal upsample, the ED>ES
    rejection, random 32-frame ED..ES windows with trilinear shrink for
    long systoles, [0,1] per-channel normalization, and the 6 "blue" test
    videos' grayscale replication (echonet_dataset.py:96-156).

Note on normalization order: the reference z-normalizes with dataset
mean/std inside `Echo` and then re-normalizes to [0,1] per channel. Since
both are per-channel affine maps, the composition equals `zeroone` alone
for ordinary videos — the z-norm only changes the result for the "blue"
videos, whose grayscale conversion mixes channels. Both steps are kept, in
order.

cv2 (AVI decoding, trace filling) and pandas (the CSVs) are imported inside
the functions that use them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from echoflow_torch.ops.normalize import zeroone_normalizer
from echoflow_torch.ops.resize import trilinear_resize

# Reference echonet_dataset.py:35 — test videos with broken RGB normalization.
BLUE_VIDEOS = [89, 105, 325, 653, 721, 739]

# Reference echonet_dataset.py:104-111 — test index whose video has a broken
# frame rate (3x-upsampled temporally by the data layer). Single source of
# truth: data.qa reports against these same constants.
BROKEN_FRAMERATE_TEST_INDEX = 919


def _resize(video: np.ndarray, size, align_corners: bool) -> np.ndarray:
    """Trilinear resize of a (3, F, H, W) float32 video to `size` (F', H', W')
    on the CPU."""
    x = torch.from_numpy(np.ascontiguousarray(video, np.float32))[None]
    return trilinear_resize(x, size, align_corners=align_corners)[0].numpy()


def load_avi(path: str) -> np.ndarray:
    """Decode an AVI to (3, F, H, W) float32 RGB in [0, 255]."""
    import cv2

    capture = cv2.VideoCapture(str(path))
    frame_count = int(capture.get(cv2.CAP_PROP_FRAME_COUNT))
    frames = []
    for i in range(frame_count):
        ret, frame = capture.read()
        if not ret:
            raise ValueError(f"Failed to read frame {i} of {path}")
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    capture.release()
    video = np.stack(frames)  # (F, H, W, 3)
    return video.transpose(3, 0, 1, 2).astype(np.float32)


def polygon_mask(ys: np.ndarray, xs: np.ndarray, shape: tuple[int, int]) -> np.ndarray:
    """Fill a polygon given vertex rows/cols (even-odd rule at pixel
    centers, vertices included) — skimage.draw.polygon semantics for the
    integer-rounded traces EchoNet uses."""
    import cv2

    mask = np.zeros(shape, np.uint8)
    pts = np.stack([np.asarray(xs), np.asarray(ys)], axis=1).astype(np.int32)
    cv2.fillPoly(mask, [pts], 1)
    return mask


def rasterize_trace(chords: np.ndarray, shape: tuple[int, int]) -> np.ndarray:
    """chords: (N, 4) rows of (x1, y1, x2, y2); row 0 is the long axis and is
    excluded from the polygon (meta notebook cell 17 / echonet semantics)."""
    x1, y1, x2, y2 = chords[:, 0], chords[:, 1], chords[:, 2], chords[:, 3]
    x = np.concatenate((x1[1:], np.flip(x2[1:])))
    y = np.concatenate((y1[1:], np.flip(y2[1:])))
    return polygon_mask(np.rint(y).astype(int), np.rint(x).astype(int), shape)


@dataclass
class EchoNetIndex:
    """Parses an EchoNet-Dynamic root:
        root/FileList.csv, root/VolumeTracings.csv, root/Videos/*.avi
    """

    root: str
    file_list: "object" = field(init=False)
    traces: dict = field(init=False)

    def __post_init__(self):
        import pandas as pd

        root = Path(self.root)
        fl = pd.read_csv(root / "FileList.csv")
        # Filenames may or may not carry the .avi extension.
        fl["FileName"] = fl["FileName"].astype(str).map(
            lambda s: s if s.endswith(".avi") else s + ".avi")
        self.file_list = fl

        vt = pd.read_csv(root / "VolumeTracings.csv")
        vt["FileName"] = vt["FileName"].astype(str).map(
            lambda s: s if s.endswith(".avi") else s + ".avi")
        self.traces = {}
        # Frame numbers in CSV file order per video — the echonet package
        # relies on this order (systolic first, diastolic last) to assign
        # Small/Large; kept for the order="file" parity mode.
        self.trace_frame_order = {}
        for (fname, frame), grp in vt.groupby(["FileName", "Frame"], sort=False):
            self.traces.setdefault(fname, {})[int(frame)] = (
                grp[["X1", "Y1", "X2", "Y2"]].to_numpy(np.float64))
            order = self.trace_frame_order.setdefault(fname, [])
            if int(frame) not in order:
                order.append(int(frame))

    def split(self, name: str):
        sel = self.file_list[self.file_list["Split"].str.lower() == name.lower()]
        return sel.reset_index(drop=True)

    def video_path(self, filename: str) -> str:
        return str(Path(self.root) / "Videos" / filename)

    def traced_frames(self, filename: str, shape: tuple[int, int],
                      order: str = "area"):
        """Returns (large_index, small_index, large_mask, small_mask): the
        ED (large) and ES (small) traces.

        order="area" (default): frames ranked by rasterized mask area —
        robust to reordered CSVs and to the handful of mislabeled videos the
        reference meta notebook documents.
        order="file": the echonet package's convention (echonet
        datasets/echo.py): VolumeTracings lists the systolic frame first and
        the diastolic frame last per video, so small = frames[0] and
        large = frames[-1] in file order. This is the bit-parity mode — on
        the known-malformed labels it reproduces the reference's (wrong)
        assignment instead of silently correcting it."""
        per_frame = self.traces[filename]
        masks = {f: rasterize_trace(per_frame[f], shape) for f in per_frame}
        if order == "file":
            file_order = self.trace_frame_order[filename]
            small, large = file_order[0], file_order[-1]
        elif order == "area":
            frames = sorted(per_frame.keys())
            areas = {f: int(masks[f].sum()) for f in frames}
            large = max(frames, key=lambda f: areas[f])
            small = min(frames, key=lambda f: areas[f])
        else:
            raise ValueError(f"unknown trace order {order!r} (use 'area' or 'file')")
        return large, small, masks[large], masks[small]


def get_mean_and_std(index: EchoNetIndex, split: str = "train",
                     max_videos: int = 128, seed: int = 0):
    """Dataset-level per-channel mean/std (reference echonet_dataset.py:74
    runs echonet.utils.get_mean_and_std — a sampled pass over the split)."""
    rng = np.random.RandomState(seed)
    files = index.split(split)["FileName"].tolist()
    if len(files) > max_videos:
        files = [files[i] for i in rng.choice(len(files), max_videos, replace=False)]
    n, s1, s2 = 0, np.zeros(3), np.zeros(3)
    for f in files:
        v = load_avi(index.video_path(f))  # (3, F, H, W)
        flat = v.reshape(3, -1).astype(np.float64)
        n += flat.shape[1]
        s1 += flat.sum(axis=1)
        s2 += (flat ** 2).sum(axis=1)
    mean = s1 / n
    std = np.sqrt(np.maximum(s2 / n - mean ** 2, 0))
    return mean.astype(np.float32), std.astype(np.float32)


def random_start_and_end(ed_index: int, es_index: int, video_length: int,
                         length: int = 32, rng: np.random.RandomState | None = None):
    """Random clip window covering ED..ES (reference echonet_dataset.py:11-30)."""
    assert es_index - ed_index > 0, (
        "INVALID ED & ES INDICES:\nNo systolic clip found. ES frame comes before ED frame")
    rng = rng or np.random
    possible_shift = length - (es_index - ed_index + 1)
    if length > video_length:
        return ed_index, es_index + 1
    if possible_shift <= 0:
        start = ed_index
    else:
        lo = max(ed_index - possible_shift + 1, 0)
        hi = min(video_length - length + 1, ed_index + 1)
        start = int(rng.randint(lo, hi))
    return start, start + length


class EchoNetDynamicDataset:
    """Reference-parity dataset (echonet_dataset.py:53-156).

    __getitem__ returns
      (video, (filename, EF, es_clip_index, ed_clip_index, es_index,
               ed_index, es_frame, ed_frame, es_label, ed_label))
    video: (3, clip_length|F, H, W) float32 normalized to [0, 1].
    """

    def __init__(self, root: str, split: str = "train", clip_length=32,
                 image_size=(112, 112), period: int = 1,
                 raise_for_es_ed: bool = True, subset_indices=None,
                 norm=zeroone_normalizer, mean_std=None, seed: int | None = None,
                 trace_order: str = "area"):
        self.trace_order = trace_order
        self.index = EchoNetIndex(root)
        self.split = split
        self.clip_length = clip_length
        self.image_size = image_size
        self.period = period
        self.raise_for_es_ed = raise_for_es_ed
        self.norm = norm
        self.rng = np.random.RandomState(seed)
        self.files = self.index.split(split)
        self.subset_indices = (list(subset_indices) if subset_indices is not None
                               else list(range(len(self.files))))
        if mean_std is None:
            mean_std = get_mean_and_std(self.index, split)
        self.mean, self.std = mean_std

    def __len__(self):
        return len(self.subset_indices)

    def __getitem__(self, i: int):
        idx = self.subset_indices[i]
        row = self.files.iloc[idx]
        filename = row["FileName"]
        ef = float(row["EF"])

        video = load_avi(self.index.video_path(filename))  # (3, F, H, W), [0,255]
        # Dataset-level z-normalization (the reference's Echo does this
        # before the [0,1] normalization; see module docstring).
        video = (video - self.mean[:, None, None, None]) / self.std[:, None, None, None]

        ed_index, es_index, ed_label, es_label = self._labels(filename, video.shape[2:])
        ed_frame = video[:, ed_index].copy()
        es_frame = video[:, es_index].copy()

        if self.period > 1:
            video = video[:, ::self.period]
        es_index //= self.period
        ed_index //= self.period

        # Test patient 919 has a broken frame rate (echonet_dataset.py:104-111).
        if idx == BROKEN_FRAMERATE_TEST_INDEX and self.split == "test":
            factor = 3
            video = _resize(video, (video.shape[1] * factor, video.shape[2], video.shape[3]),
                            align_corners=True)
            ed_index *= factor
            es_index *= factor

        if ed_index > es_index and self.raise_for_es_ed:
            raise ValueError("ED and ES come from different heartbeats "
                             f"({ed_index} > {es_index}) in {filename}")

        if self.clip_length == "full":
            ed_clip_index, es_clip_index = ed_index, es_index
        else:
            try:
                start, end = random_start_and_end(
                    ed_index, es_index, video.shape[1], self.clip_length, self.rng)
            except (AssertionError, ValueError):   # ES before ED, or no window fits
                start, end = ed_index, es_index + 1
            if end - start < self.clip_length:
                clip = video[:, start:end]
                video = _resize(clip, (self.clip_length, *self.image_size),
                                align_corners=True)
                ed_clip_index = 0
                es_clip_index = self.clip_length - 1
            else:
                video = video[:, start:end]
                ed_clip_index = ed_index - start
                es_clip_index = ed_clip_index + (es_index - ed_index)

        if self.norm is not None:
            video = self.norm(np.ascontiguousarray(video))
            es_frame = np.squeeze(self.norm(np.expand_dims(es_frame, 0).copy()))
            ed_frame = np.squeeze(self.norm(np.expand_dims(ed_frame, 0).copy()))

        if idx in BLUE_VIDEOS and self.split == "test":
            gray = np.dot(video.transpose(1, 2, 3, 0),
                          np.array([0.2989, 0.5870, 0.1140])).copy()
            video = np.stack([gray, gray, gray]).astype(np.float32)

        return video.astype(np.float32), (filename, ef, es_clip_index, ed_clip_index,
                                          es_index, ed_index, es_frame, ed_frame,
                                          es_label, ed_label)

    def _labels(self, filename: str, shape):
        large, small, large_mask, small_mask = self.index.traced_frames(
            filename, shape, order=self.trace_order)
        # Large volume = end-diastole.
        return large, small, large_mask, small_mask


def random_start_given_mid_point(mid_point_index: int, video_length: int,
                                 length: int = 32,
                                 rng: np.random.RandomState | None = None):
    """Random clip window covering a single labeled frame (the ed-or-es-only
    recipe's sampler, `echonet_dynamic_ed_or_es_only_clip_R2plus1D.ipynb`
    cell 2 `random_start_given_mid_point`). All the reference's boundary
    quirks are preserved, including `possible_end = L - length - 1` when the
    window would overrun the end (NOT L - length + 1 — the last two valid
    start positions are unreachable)."""
    rng = rng or np.random
    if video_length < length:
        return 0, video_length
    possible_start = mid_point_index - length + 1
    possible_end = mid_point_index + 1
    if mid_point_index == 0:
        return 0, length
    if mid_point_index == video_length - 1:
        return video_length - length, video_length
    if mid_point_index < length:
        possible_start = 0
    if mid_point_index + length > video_length:
        possible_end = video_length - length - 1
    # Guard beyond the reference: when the quirky possible_end falls at or
    # below possible_start (e.g. L == length), the reference's randint would
    # raise — clamp to the single valid start instead.
    if possible_end <= possible_start:
        start = possible_start
    else:
        start = int(rng.randint(possible_start, possible_end))
    return start, start + length


class EchoNetEDESOnlyDataset(EchoNetDynamicDataset):
    """Two-clip dataset of the ed-or-es-only recipe (reference
    `echonet_dynamic_ed_or_es_only_clip_R2plus1D.ipynb` cell 2,
    `EchoNetDynamicDataset.__getitem__`): per sample, one random
    `clip_length`-frame window covering the ED frame and one covering the
    ES frame, each independently [0,1]-normalized; short videos are
    trilinearly shrunk to `clip_length` with align_corners=False and the
    labeled frame's clip index rescaled by int(mid * L_clip / L_window).

    __getitem__ returns a dict with keys ed_video_clip / es_video_clip
    (3, T, H, W) float32, ed_clip_index / es_clip_index int, ed_label /
    es_label (H, W) uint8, ed_frame / es_frame, filename, EF."""

    def __getitem__(self, i: int):
        idx = self.subset_indices[i]
        row = self.files.iloc[idx]
        filename = row["FileName"]
        ef = float(row["EF"])

        video = load_avi(self.index.video_path(filename))
        video = (video - self.mean[:, None, None, None]) / self.std[:, None, None, None]
        ed_index, es_index, ed_label, es_label = self._labels(filename, video.shape[2:])
        ed_frame = video[:, ed_index].copy()
        es_frame = video[:, es_index].copy()

        if self.period > 1:
            video = video[:, ::self.period]
        es_index //= self.period
        ed_index //= self.period
        # NOTE: this recipe does NOT reject ED > ES (the notebook comments
        # the raise out) — each clip only needs to cover its own frame.

        out = {"filename": filename, "EF": ef,
               "es_index": es_index, "ed_index": ed_index,
               "es_label": es_label, "ed_label": ed_label}
        for name, mid in (("ed", ed_index), ("es", es_index)):
            start, end = random_start_given_mid_point(
                mid, video.shape[1], self.clip_length, self.rng)
            if end - start < self.clip_length:
                clip = video[:, start:end]
                clip = _resize(clip, (self.clip_length, *self.image_size),
                               align_corners=False)
                clip_index = int(mid * (self.clip_length / (end - start)))
            else:
                clip = video[:, start:end].copy()
                clip_index = mid - start
            if self.norm is not None:
                clip = self.norm(np.ascontiguousarray(clip))
            out[name + "_video_clip"] = clip.astype(np.float32)
            out[name + "_clip_index"] = clip_index

        if self.norm is not None:
            out["es_frame"] = np.squeeze(self.norm(np.expand_dims(es_frame, 0).copy()))
            out["ed_frame"] = np.squeeze(self.norm(np.expand_dims(ed_frame, 0).copy()))
        else:
            out["es_frame"], out["ed_frame"] = es_frame, ed_frame
        return out


def load_fold_indices(path: str) -> list[int]:
    """Read the reference's pinned fold pickles
    (fold_indexes/stanford_{train,valid}_sampled_indices)."""
    import pickle

    with open(path, "rb") as f:
        return list(pickle.load(f))
