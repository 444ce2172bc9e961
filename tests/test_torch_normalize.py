"""echoflow_torch.ops.normalize against echoflow.ops.normalize."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from echoflow.ops import normalize as JN

from echoflow_torch.ops import normalize as TN

torch.set_num_threads(2)


def _video(seed, dtype):
    rng = np.random.RandomState(seed)
    v = rng.randint(3, 250, size=(3, 10, 16, 16))
    return v.astype(dtype) if dtype == np.uint8 else (v * 0.37 + 1.5).astype(dtype)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_device_normalize_matches(dtype):
    v = _video(0, dtype)
    got = TN.zeroone_normalize(torch.from_numpy(v).float()).numpy()
    want = np.asarray(JN.zeroone_normalize(jnp.asarray(v).astype(jnp.float32)))
    np.testing.assert_array_equal(got, want)
    assert got.min() == 0.0 and got.max() == 1.0
    # Idempotent: a normalized video passes through unchanged.
    np.testing.assert_array_equal(TN.zeroone_normalize(torch.from_numpy(got)).numpy(), got)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_host_normalizer_matches(dtype):
    v = _video(1, dtype)
    got = TN.zeroone_normalizer(v.copy())
    want = JN.zeroone_normalizer(v.copy())
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_host_normalizer_float_is_in_place_and_copies_read_only():
    v = _video(2, np.float32)
    out = TN.zeroone_normalizer(v)
    assert np.shares_memory(out, v)
    ro = _video(2, np.float32)
    ro.flags.writeable = False
    np.testing.assert_array_equal(TN.zeroone_normalizer(ro), out)
