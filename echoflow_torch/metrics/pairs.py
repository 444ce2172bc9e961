"""ED/ES beat pairing.

Matches reference src/echonet_dataset.py:159-172 (`EDESpairs`): for each
systolic (minimum-area) frame, pair it with the nearest *prior* diastolic
(maximum-area) frame, deduplicating systoles that map to the same diastole.
"""

from __future__ import annotations

import numpy as np


def EDESpairs(diastole, systole) -> list[tuple[int, int]]:
    dia = np.sort(np.asarray(diastole, dtype=np.int64))
    sys_ = np.sort(np.asarray(systole, dtype=np.int64))
    pairs: list[tuple[int, int]] = []
    positions = np.searchsorted(dia, sys_, side="left")
    for pos, sf in zip(positions, sys_):
        if pos == 0:
            continue  # no diastole before this systole
        ed = dia[pos - 1]
        if not pairs or ed != pairs[-1][0]:
            pairs.append((int(ed), int(sf)))
    return pairs
