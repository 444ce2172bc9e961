"""EchoNet-Dynamic sampling helpers (port of the part of
`echoflow.data.echonet` that the synthetic training samples use; the
dataset and its AVI decoding wait for the data slice of the port)."""

from __future__ import annotations

import numpy as np


def random_start_given_mid_point(mid_point_index: int, video_length: int,
                                 length: int = 32,
                                 rng: np.random.RandomState | None = None):
    """Random clip window covering a single labeled frame (the ed-or-es-only
    recipe's sampler, `echonet_dynamic_ed_or_es_only_clip_R2plus1D.ipynb`
    cell 2). The reference's boundary quirks are kept, including
    `possible_end = L - length - 1` when the window would overrun the end
    (the last two valid starts are unreachable). Returns (start, end)."""
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
    # Where the quirky possible_end falls at or below possible_start (e.g.
    # L == length) the reference's randint would raise: take the single
    # valid start, as echoflow does.
    if possible_end <= possible_start:
        start = possible_start
    else:
        start = int(rng.randint(possible_start, possible_end))
    return start, start + length
