"""Synthetic EchoNet-Dynamic-format dataset fixtures (numpy copy of
`echoflow.data.fixtures`).

Writes a directory with FileList.csv, VolumeTracings.csv, and Videos/*.avi
in the real dataset's layout so the whole data layer (CSV parsing, AVI
decode, trace rasterization, dataset iteration) is testable without the
access-gated real data (SURVEY.md §7.3).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from echoflow_torch.data.synthetic import make_beating_video, write_avi


def _ellipse_chords(cy, cx, ry, rx, n_chords: int = 12):
    """Chord rows (x1, y1, x2, y2) for an upright ellipse, echonet-style:
    row 0 is the long axis (apex -> base), subsequent rows are perpendicular
    chords walked along it."""
    rows = [(cx, cy - ry, cx, cy + ry)]
    ys = np.linspace(cy - ry, cy + ry, n_chords + 2)[1:-1]
    for y in ys:
        half = rx * np.sqrt(max(0.0, 1 - ((y - cy) / ry) ** 2))
        rows.append((cx - half, y, cx + half, y))
    return np.asarray(rows)


def make_synthetic_echonet_root(root: str, n_videos: int = 4,
                                num_frames: int = 80, height: int = 112,
                                width: int = 112, seed: int = 0,
                                trace_file_order: str = "ed_first") -> Path:
    """trace_file_order: which traced frame's rows come first in
    VolumeTracings.csv. The real dataset follows the echonet package's
    convention of listing the systolic (small) frame first ("es_first");
    "ed_first" (default, kept for existing tests) produces files whose
    file-order and area-order ED/ES assignments deliberately disagree —
    the QA module's trace_order_mismatches case."""
    import pandas as pd

    root = Path(root)
    (root / "Videos").mkdir(parents=True, exist_ok=True)
    file_rows = []
    trace_rows = []
    rng = np.random.RandomState(seed)

    for i in range(n_videos):
        period = float(rng.uniform(34, 46))
        beat = make_beating_video(num_frames=num_frames, height=height,
                                  width=width, period=period, seed=seed + i)
        name = f"synth{i:04d}.avi"
        write_avi(root / "Videos" / name, beat.video[0], fps=50.0)

        ed = int(beat.ed_frames[0])
        es_candidates = beat.es_frames[beat.es_frames > ed]
        es = int(es_candidates[0])
        cy, cx = height * 0.45, width * 0.5
        base, amp = 20.0, 8.0
        r_ed = base + amp * np.sin(2 * np.pi * ed / period)
        r_es = base + amp * np.sin(2 * np.pi * es / period)
        frame_order = ((ed, r_ed), (es, r_es))
        if trace_file_order == "es_first":
            frame_order = ((es, r_es), (ed, r_ed))
        for frame_idx, r in frame_order:
            # 21 rows per traced frame (long axis + 20 chords), matching the
            # real dataset's layout (meta notebook cell 5: 2 x 21 = 42 rows).
            for (x1, y1, x2, y2) in _ellipse_chords(cy, cx, 1.6 * r, r,
                                                    n_chords=20):
                trace_rows.append(dict(FileName=name, X1=x1, Y1=y1, X2=x2,
                                       Y2=y2, Frame=frame_idx))

        ef = (1 - (r_es / r_ed) ** 3) * 100
        split = ["TRAIN", "VAL", "TEST"][i % 3] if n_videos >= 3 else "TRAIN"
        file_rows.append(dict(FileName=name, EF=round(ef, 2), ESV=50.0, EDV=120.0,
                              FrameHeight=height, FrameWidth=width, FPS=50,
                              NumberOfFrames=num_frames, Split=split))

    pd.DataFrame(file_rows).to_csv(root / "FileList.csv", index=False)
    pd.DataFrame(trace_rows).to_csv(root / "VolumeTracings.csv", index=False)
    return root


# ---------------------------------------------------------------------------
# ITK-fusion golden fixtures (docs/ITK_FUSION_FIDELITY.md).
#
# echoflow's SIMPLE/STAPLE fusers (echoflow/ops/fusion.py, ported as
# echoflow_torch/ops/fusion.py) are reimplemented
# from the published algorithms, while the reference calls the ITK-backed
# `LabelFusion` package (reference src/fuse_utils.py:2,95). Diffing the two
# needs an environment with SimpleITK + LabelFusion installed — absent here
# (zero egress; see the memo). These stacks are the agreed exchange format:
# `benchmarks/make_itk_goldens.py` regenerates the SAME stacks from the SAME
# seeds in an ITK-capable environment and records ITK's fused outputs;
# tests/test_fusion.py consumes the resulting goldens file when present.
# ---------------------------------------------------------------------------

def make_fusion_rater_stacks(height: int = 112, width: int = 112):
    """Deterministic multi-rater stacks spanning the engine's real operating
    range (rater counts 2-10, per-rater noise, gross outliers, near-tie
    splits). Returns [(name, (R, H, W) uint8 stack)], stable across
    numpy versions (RandomState, not Generator)."""
    def disk(cy, cx, r):
        yy, xx = np.mgrid[:height, :width]
        return (((yy - cy) ** 2 + (xx - cx) ** 2) <= r * r).astype(np.uint8)

    def noisy(rng, truth, n, flip):
        out = []
        for _ in range(n):
            m = truth.copy()
            flips = rng.rand(*truth.shape) < flip
            m[flips] = 1 - m[flips]
            out.append(m)
        return np.stack(out)

    stacks = []
    truth = disk(56, 56, 24)
    for n in (2, 3, 5, 7, 10):
        rng = np.random.RandomState(1000 + n)
        stacks.append((f"noisy{n}_flip3", noisy(rng, truth, n, 0.03)))
    for n in (3, 5, 10):
        rng = np.random.RandomState(2000 + n)
        stacks.append((f"noisy{n}_flip10", noisy(rng, truth, n, 0.10)))
    # Gross outliers: one (or two) raters segment a different structure.
    for n, n_bad in ((3, 1), (5, 1), (5, 2), (10, 3)):
        rng = np.random.RandomState(3000 + 10 * n + n_bad)
        good = noisy(rng, truth, n - n_bad, 0.03)
        bad = noisy(rng, disk(30, 80, 14), n_bad, 0.03)
        stacks.append((f"outlier{n}_{n_bad}bad", np.concatenate([good, bad])))
    # Empty / full degenerate raters mixed in.
    rng = np.random.RandomState(4000)
    stacks.append(("with_empty5", np.concatenate(
        [noisy(rng, truth, 4, 0.03), np.zeros((1, height, width), np.uint8)])))
    stacks.append(("with_full5", np.concatenate(
        [noisy(rng, truth, 4, 0.03), np.ones((1, height, width), np.uint8)])))
    # Near-tie splits: two equal camps disagreeing on a boundary band —
    # the documented divergence class (split-vote ties).
    a, b = disk(56, 56, 24), disk(56, 58, 24)
    stacks.append(("split2", np.stack([a, b])))
    stacks.append(("split4", np.stack([a, a, b, b])))
    stacks.append(("split6", np.stack([a, a, a, b, b, b])))
    # Shifted-ensemble realism: raters are the same beating shape observed
    # at slightly different phases (what the shift ensemble actually fuses).
    rng = np.random.RandomState(5000)
    phases = [disk(56, 56, 20 + 2 * k) for k in range(5)]
    stacks.append(("phase5", np.stack(
        [np.where(rng.rand(height, width) < 0.02, 1 - p, p) for p in phases]
    ).astype(np.uint8)))
    # Unanimous stack (fusion must be the identity) and concentric raters
    # (systematic over/under-segmentation rather than iid noise).
    stacks.append(("agree3", np.stack([truth, truth, truth])))
    stacks.append(("concentric5", np.stack(
        [disk(56, 56, r) for r in (20, 22, 24, 26, 28)])))
    assert len(stacks) == 20
    return stacks
