"""The port's synthetic training samples and clip-window sampler are
array-equal to echoflow's for the same seed."""

import numpy as np
import pytest

from echoflow.data import echonet as jechonet
from echoflow.data import synthetic as jsynthetic
from echoflow_torch.data import echonet as techonet
from echoflow_torch.data import synthetic as tsynthetic


def _assert_same(got: dict, want: dict):
    assert got.keys() == want.keys()
    for key in want:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("size", [(32, 112, 112), (8, 32, 32)])
def test_training_sample_equals_echoflows(seed, size):
    t, h, w = size
    _assert_same(tsynthetic.make_training_sample(t, h, w, seed=seed),
                 jsynthetic.make_training_sample(t, h, w, seed=seed))


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("size", [(32, 112, 112), (8, 32, 32)])
def test_ed_es_only_sample_equals_echoflows(seed, size):
    t, h, w = size
    _assert_same(tsynthetic.make_ed_es_only_sample(t, h, w, seed=seed),
                 jsynthetic.make_ed_es_only_sample(t, h, w, seed=seed))


def test_random_start_given_mid_point_equals_echoflows():
    """Every mid point of several video lengths, including L == length
    (where the reference's `L - length - 1` end would make randint raise)
    and L < length, drawing from equal generators."""
    for video_length in (20, 32, 33, 34, 40, 96):
        for mid in range(video_length):
            a = techonet.random_start_given_mid_point(mid, video_length, 32,
                                                      np.random.RandomState(mid))
            b = jechonet.random_start_given_mid_point(mid, video_length, 32,
                                                      np.random.RandomState(mid))
            assert a == b, (video_length, mid)
            start, end = a
            if video_length >= 32:
                assert start <= mid < end and end - start == 32


def test_random_start_keeps_the_unreachable_last_starts():
    """The reference's quirk: near the end, `possible_end = L - length - 1`
    with randint's exclusive bound, so the last two valid starts are never
    drawn."""
    rng = np.random.RandomState(0)
    starts = {techonet.random_start_given_mid_point(90, 96, 32, rng)[0] for _ in range(500)}
    assert max(starts) == 96 - 32 - 2
