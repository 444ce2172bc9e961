"""The port's host EF chain (numpy copies) against echoflow's: peaks,
ED/ES pairs, Simpson pucks, Dice, synthetic videos and per-beat EF."""

import numpy as np
import pytest

from echoflow.data.synthetic import make_beating_video as jax_beating_video
from echoflow.infer import ef as JE
from echoflow.metrics import dice as JD
from echoflow.metrics.pairs import EDESpairs as jax_pairs
from echoflow.metrics.simpson import get2dPucks as jax_pucks
from echoflow.ops.peaks import find_peaks_1d as jax_peaks

from echoflow_torch.data.synthetic import make_beating_video
from echoflow_torch.infer import ef as TE
from echoflow_torch.metrics import dice as TD
from echoflow_torch.metrics.pairs import EDESpairs
from echoflow_torch.metrics.simpson import get2dPucks
from echoflow_torch.ops.peaks import find_peaks_1d


def _noisy_masks(seed, num_frames, period, amplitude):
    beat = make_beating_video(num_frames=num_frames, period=period,
                              amplitude=amplitude, seed=seed)
    rng = np.random.RandomState(seed)
    masks = beat.masks.copy()
    flips = rng.rand(*masks.shape) < 0.01
    masks[flips] = 1 - masks[flips]
    return beat, masks


@pytest.mark.parametrize("seed,num_frames,period,amplitude", [
    (0, 120, 40.0, 9.0), (1, 176, 45.0, 7.0), (2, 200, 52.0, 11.0), (3, 96, 28.0, 4.0),
])
def test_ef_lists_and_pairs_identical(seed, num_frames, period, amplitude):
    beat, noisy = _noisy_masks(seed, num_frames, period, amplitude)
    for masks in (beat.masks, noisy):
        got_ef, got_pairs = TE.compute_ef_using_putative_clips(masks, return_edes=True)
        want_ef, want_pairs = JE.compute_ef_using_putative_clips(masks, return_edes=True)
        assert got_pairs == want_pairs
        assert got_ef == want_ef   # same numpy arithmetic: exact
        assert len(got_ef) >= 1


def test_synthetic_video_identical():
    a = make_beating_video(num_frames=40, height=32, width=48, seed=3)
    b = jax_beating_video(num_frames=40, height=32, width=48, seed=3)
    for field in ("video", "masks", "ed_frames", "es_frames"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


def test_host_helpers_identical():
    rng = np.random.RandomState(0)
    for _ in range(20):
        x = np.cumsum(rng.randn(150))
        np.testing.assert_array_equal(find_peaks_1d(x, distance=20, prominence=2.0),
                                      jax_peaks(x, distance=20, prominence=2.0))
        dia = np.sort(rng.choice(150, 6, replace=False))
        sys_ = np.sort(rng.choice(150, 6, replace=False))
        assert EDESpairs(dia, sys_) == jax_pairs(dia, sys_)
    beat = make_beating_video(num_frames=8, seed=4)
    for m in beat.masks:
        ln, r = get2dPucks(m.astype(int), (1.0, 1.0))
        jl, jr = jax_pucks(m.astype(int), (1.0, 1.0))
        assert ln == jl
        np.testing.assert_array_equal(r, jr)
    a, b = beat.masks[0], beat.masks[4]
    assert TD.lv_dice(a, b) == JD.lv_dice(a, b)
    assert TE.get_all_possible_start_points(10, 30, 100).tolist() == \
        JE.get_all_possible_start_points(10, 30, 100).tolist()
