"""Per-channel [0, 1] intensity normalization (port of
`echoflow.ops.normalize`; reference src/echonet_dataset.py:38-50,
`zeroone_normalizer`: per-RGB-channel min/max over the whole video)."""

from __future__ import annotations

import numpy as np
import torch


def zeroone_normalize(image_data: torch.Tensor) -> torch.Tensor:
    """Device-side per-channel [0, 1] normalization; the channel axis is
    axis 0, e.g. a (3, T, H, W) video."""
    c = image_data.shape[0]
    flat = image_data.reshape(c, -1)
    flat = flat - flat.amin(dim=1, keepdim=True)
    flat = flat / flat.amax(dim=1, keepdim=True)
    return flat.reshape(image_data.shape)


def zeroone_normalizer(image_data: np.ndarray) -> np.ndarray:
    """Host version with the reference's contract, including the in-place
    mutation of float input (read-only float input is copied first).

    uint8 input (as it comes off the AVI decoder) returns a new float32
    array from the native single-pass loop (`ops/native.py`, as echoflow
    routes it), bitwise `zeroone_normalizer_numpy`'s. Float input keeps the
    in-place numpy path, which echoflow measured faster than the native
    loop once the data is float.
    """
    if image_data.dtype == np.uint8:
        from echoflow_torch.ops.native import zeroone_normalize_native

        return zeroone_normalize_native(image_data)
    norm = image_data
    if not norm.flags.writeable:
        norm = norm.copy()
    shape = norm.shape
    norm = norm.reshape(3, -1)
    norm -= np.min(norm, axis=1).reshape(3, 1)
    norm /= np.max(norm, axis=1).reshape(3, 1)
    return norm.reshape(shape)


def zeroone_normalizer_numpy(image_data: np.ndarray) -> np.ndarray:
    """The plain version of the native loop: a new float32 array, per
    channel (axis 0) (x - min) / (max - min) in float32."""
    c = image_data.shape[0]
    flat = image_data.reshape(c, -1).astype(np.float32)
    lo = flat.min(axis=1, keepdims=True)
    hi = flat.max(axis=1, keepdims=True)
    return ((flat - lo) / (hi - lo)).reshape(image_data.shape).astype(np.float32)


def one_hot_channels(label: torch.Tensor, num_classes: int,
                     dtype=torch.float32) -> torch.Tensor:
    """(N, 1, H, W) integer labels -> (N, num_classes, H, W) one-hot float
    (reference `convert_to_1hot`, src/loss_functions.py:123-134). A value
    outside [0, num_classes) gives an all-zero vector, as `jax.nn.one_hot`."""
    classes = torch.arange(num_classes, device=label.device).reshape(1, num_classes, 1, 1)
    return (label.long() == classes).to(dtype)
