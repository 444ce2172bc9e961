"""echoflow_torch.ops.resize against echoflow.ops.resize and F.interpolate."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from echoflow.ops import resize as JR

from echoflow_torch.ops import resize as TR

torch.set_num_threads(2)


@pytest.mark.parametrize("align_corners", [True, False])
def test_matrices_bitwise_equal(align_corners):
    for src in (1, 2, 3, 7, 14, 28, 31, 32, 45, 56, 64, 112, 176):
        for dst in (1, 2, 5, 32, 64, 96, 112, 160, 192):
            TR._linear_resize_matrix_np.cache_clear()
            got = TR._linear_resize_matrix_np(src, dst, align_corners)
            want = JR._linear_resize_matrix_np(src, dst, align_corners)
            np.testing.assert_array_equal(got, want)
            t = TR.linear_resize_matrix(src, dst, align_corners)
            assert t.dtype == torch.float32 and np.array_equal(t.numpy(), want)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("size", [(8, 16, 16), (5, 7, 9), (16, 3, 20)])
def test_trilinear_matches_echoflow_and_interpolate(size, align_corners):
    x = np.random.RandomState(0).randn(2, 3, 6, 10, 12).astype(np.float32)
    got = TR.trilinear_resize(torch.from_numpy(x), size, align_corners).numpy()
    want = np.asarray(JR.trilinear_resize(jnp.asarray(x), size, align_corners))
    ref = F.interpolate(torch.from_numpy(x), size=size, mode="trilinear",
                        align_corners=align_corners).numpy()
    # fp32 sums of two-term products in different orders.
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_resize_linear_axis_and_identity():
    x = torch.from_numpy(np.random.RandomState(1).rand(4, 9, 5).astype(np.float32))
    assert TR.resize_linear(x, 1, 9, True) is x
    got = TR.resize_linear(x, -2, 20, False)
    want = np.asarray(JR.resize_linear(jnp.asarray(x.numpy()), -2, 20, False))
    assert got.shape == (4, 20, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
