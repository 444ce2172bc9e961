"""EchoNet-Dynamic dataset QA (numpy copy of `echoflow.data.qa`): the
real-entry-point equivalent of the reference's `echonet_dynamic_meta.ipynb`
hand-audit machinery.

The reference's data hygiene is notebook-driven: it discovers videos whose
VolumeTracings rows are malformed (cell 5: a well-formed video has exactly
two traced frames x 21 chords = 42 rows), excludes the one unreadable test
video (cell 3), measures the mean systole length (cells 11-12, ~16.4
frames on the train split) and the mean clips-per-video (cell 3). This
module exposes those audits as library functions plus a CLI:

    python -m echoflow_torch.data.qa /path/to/EchoNet-Dynamic [--split train]

The known-bad-video tables the reference hard-codes across its notebooks
and data layer are collected here AS DATA so downstream code has one source
of truth (echonet_dataset.py:35 blue videos; :104-111 patient 919;
fusion notebook cell 8 patient 1053; meta notebook cell 3 unreadable).
"""

from __future__ import annotations

import numpy as np

# Meta notebook cell 3: this TEST video cannot be read and is excluded from
# frame-count statistics (and skipped by the ad-hoc try/except in the EF
# notebooks).
UNREADABLE_VIDEOS = ["0X5DD5283AC43CCDD1.avi"]

# Single source of truth for the hand-audited special-case indices is the
# data layer itself (echoflow_torch/data/echonet.py) — the QA surface reports
# against the SAME constants the loading path applies.
from echoflow_torch.data.echonet import BLUE_VIDEOS as BLUE_TEST_INDICES
from echoflow_torch.data.echonet import BROKEN_FRAMERATE_TEST_INDEX

BROKEN_FRAMERATE_TEST_INDICES = [BROKEN_FRAMERATE_TEST_INDEX]

# Fusion notebook cell 8 — test index whose video is truncated to its
# first 80 frames before evaluation.
TRUNCATED_TEST_INDICES = {1053: 80}

# A well-formed video has exactly 2 traced frames x 21 chords.
CHORDS_PER_FRAME = 21
EXPECTED_TRACE_ROWS = 42


def find_multi_trace_videos(index) -> dict:
    """Videos whose VolumeTracings rows are malformed (meta notebook
    cell 5): more than two traced frames, or a row count != 42. Returns
    {filename: {"frames": [...], "counts": [...], "split": str}}."""
    split_of = dict(zip(index.file_list["FileName"], index.file_list["Split"]))
    flagged = {}
    for fname, per_frame in index.traces.items():
        frames = index.trace_frame_order.get(fname, sorted(per_frame))
        counts = [int(len(per_frame[f])) for f in frames]
        if len(frames) > 2 or sum(counts) != EXPECTED_TRACE_ROWS:
            flagged[fname] = {
                "frames": [int(f) for f in frames],
                "counts": counts,
                "split": str(split_of.get(fname, "?")),
            }
    return flagged


def systole_length_stats(index, split: str = "train", order: str = "area",
                         shape=(112, 112)) -> dict:
    """Distribution of ES - ED (in frames) over a split (meta notebook
    cells 11-12; the reference reports mean ~16.4 on its train split).
    Negative values mean the traced ED comes after the traced ES — the
    cross-heartbeat cases the training dataset rejects."""
    lengths = []
    negatives = []
    for fname in index.split(split)["FileName"]:
        if fname not in index.traces or fname in UNREADABLE_VIDEOS:
            continue
        ed, es, _, _ = index.traced_frames(fname, shape, order=order)
        d = int(es - ed)
        lengths.append(d)
        if d < 0:
            negatives.append(fname)
    arr = np.asarray(lengths, np.float64)
    return {
        "n": int(arr.size),
        "mean": float(arr.mean()) if arr.size else None,
        "std": float(arr.std()) if arr.size else None,
        "min": int(arr.min()) if arr.size else None,
        "max": int(arr.max()) if arr.size else None,
        "over_32": int((arr > 32).sum()),
        "negative": negatives,
    }


def clips_per_video_stats(index, split: str = "test",
                          clip_length: int = 32) -> dict:
    """Mean round(frames/32) over a split, excluding the unreadable video
    (meta notebook cell 3)."""
    sel = index.split(split)
    sel = sel[~sel["FileName"].isin(UNREADABLE_VIDEOS)]
    if "NumberOfFrames" not in sel.columns:
        return {"n": int(len(sel)), "mean_clips": None,
                "note": "FileList.csv has no NumberOfFrames column"}
    clips = np.round(sel["NumberOfFrames"].to_numpy(np.float64) / clip_length)
    return {"n": int(len(sel)), "mean_clips": float(clips.mean())}


def trace_order_mismatches(index, shape=(112, 112)) -> list:
    """Videos where the echonet package's file-order ED/ES assignment
    (systolic trace listed first) disagrees with the rasterized-area
    ranking — the silently mislabeled cases the meta notebook eyeballs.
    These are exactly the videos where `traced_frames(order='file')` and
    `order='area'` differ."""
    from echoflow_torch.data.echonet import rasterize_trace

    mismatched = []
    for fname in index.traces:
        try:
            # Rasterize each video's traces ONCE and derive both the
            # area-order and file-order assignments from the same masks
            # (two traced_frames calls would rasterize everything twice).
            per_frame = index.traces[fname]
            frames = sorted(per_frame.keys())
            areas = {f: int(rasterize_trace(per_frame[f], shape).sum())
                     for f in frames}
            ed_a = max(frames, key=lambda f: areas[f])
            es_a = min(frames, key=lambda f: areas[f])
            file_order = index.trace_frame_order[fname]
            es_f, ed_f = file_order[0], file_order[-1]
        except Exception:
            continue
        if (ed_a, es_a) != (ed_f, es_f):
            mismatched.append(fname)
    return mismatched


def qa_report(root: str, split: str = "train") -> dict:
    """Full QA sweep of an EchoNet-Dynamic directory."""
    from echoflow_torch.data.echonet import EchoNetIndex

    index = EchoNetIndex(root)
    return {
        "split": split,
        "multi_trace_videos": find_multi_trace_videos(index),
        "systole_length": systole_length_stats(index, split),
        "clips_per_video": clips_per_video_stats(
            index, "test" if "test" in set(index.file_list["Split"].str.lower())
            else split),
        "trace_order_mismatches": trace_order_mismatches(index),
        "known_bad": {
            "unreadable": UNREADABLE_VIDEOS,
            "blue_test_indices": BLUE_TEST_INDICES,
            "broken_framerate_test_indices": BROKEN_FRAMERATE_TEST_INDICES,
            "truncated_test_indices": TRUNCATED_TEST_INDICES,
        },
    }


def main(argv=None):
    import argparse
    import json

    ap = argparse.ArgumentParser(description="EchoNet-Dynamic dataset QA")
    ap.add_argument("root")
    ap.add_argument("--split", default="train")
    args = ap.parse_args(argv)
    print(json.dumps(qa_report(args.root, args.split), indent=2))


if __name__ == "__main__":
    main()
