"""Separable linear / trilinear resize matching PyTorch `F.interpolate`
(port of `echoflow.ops.resize`).

Both align_corners conventions are used (the model decoder upsamples with
align_corners=True; the engine's tail-stretch and softmax re-interpolation
use align_corners=False). Each 1-D resize is a dense (dst, src) weight
matrix built on the host exactly as `echoflow` builds it (float32
coordinates, as torch's area_pixel_compute_source_index computes them), and
applied as a matrix product on the tensor's device. The device copy of each
matrix is made once per (src, dst, align_corners, device, dtype), without a
synchronizing copy: the model's decoder and the engine's forward ask for
the same few matrices in every step and chunk.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from echoflow_torch.utils.device import device_constant, upload


@functools.lru_cache(maxsize=512)
def _linear_resize_matrix_np(src_len: int, dst_len: int, align_corners: bool):
    if src_len == dst_len:
        return np.eye(dst_len, dtype=np.float32)
    # Coordinates in float32, exactly as torch's area_pixel_compute_source_index
    # computes them (scalar_t = float); float64 here would produce weights a
    # few ULPs away from torch's.
    i = np.arange(dst_len, dtype=np.float32)
    if align_corners:
        if dst_len == 1:
            coord = np.zeros_like(i)
        else:
            scale = np.float32(src_len - 1) / np.float32(dst_len - 1)
            coord = i * scale
    else:
        scale = np.float32(src_len) / np.float32(dst_len)
        coord = (i + np.float32(0.5)) * scale - np.float32(0.5)
    coord = np.clip(coord, np.float32(0.0), np.float32(src_len - 1))
    lo = np.floor(coord).astype(np.int64)
    hi = np.minimum(lo + 1, src_len - 1)
    w_hi = (coord - lo.astype(np.float32)).astype(np.float32)
    w_lo = np.float32(1.0) - w_hi
    mat = np.zeros((dst_len, src_len), dtype=np.float32)
    mat[np.arange(dst_len), lo] += w_lo
    mat[np.arange(dst_len), hi] += w_hi
    return mat


@device_constant(512)
def _device_matrix(src_len: int, dst_len: int, align_corners: bool,
                   device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    mat = torch.from_numpy(_linear_resize_matrix_np(src_len, dst_len, align_corners))
    return upload(mat.to(dtype), device)


def linear_resize_matrix(src_len: int, dst_len: int, align_corners: bool,
                         device=None, dtype=torch.float32) -> torch.Tensor:
    """(dst_len, src_len) interpolation matrix for one axis, cached on
    `device`: callers only read it."""
    return _device_matrix(int(src_len), int(dst_len), bool(align_corners),
                          torch.device(device or "cpu"), dtype)


def resize_linear(x: torch.Tensor, axis: int, dst_len: int,
                  align_corners: bool) -> torch.Tensor:
    """Linearly resize `x` along `axis` to `dst_len` (torch semantics)."""
    axis = axis % x.ndim
    src_len = x.shape[axis]
    if src_len == dst_len:
        return x
    mat = linear_resize_matrix(src_len, dst_len, align_corners, x.device, x.dtype)
    return torch.movedim(torch.movedim(x, axis, -1) @ mat.T, -1, axis)


def trilinear_resize(x: torch.Tensor, size, align_corners: bool,
                     axes=(-3, -2, -1)) -> torch.Tensor:
    """Trilinear resize of the three `axes` of `x` to `size`: the same as
    `F.interpolate(x, size=size, mode="trilinear", align_corners=...)` on
    an (N, C, D, H, W) tensor with the default axes; any rank works, since
    the interpolation is separable."""
    for axis, dst in zip(axes, size):
        x = resize_linear(x, axis, dst, align_corners)
    return x
