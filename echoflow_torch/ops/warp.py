"""Differentiable bilinear warp with `F.grid_sample` semantics and the
reference's motion-field convention (port of `echoflow.ops.warp`).

  - Motion channel 0 displaces the x (width) coordinate and channel 1 the
    y (height) coordinate, in normalized [-1, 1] units, added to a base
    grid of `linspace(-1, 1, size)` per axis.
  - `grid_sample(align_corners=False, mode=..., padding_mode='border')`:
    px = ((gx + 1) * W - 1) / 2, clamped to [0, W-1] before the corners
    are taken (torch's clip_coordinates), the x0+1 corner clamped to W-1.

The coordinates are computed bit for bit as echoflow computes them: the
base grid is `np.linspace` in float64, cast to the offsets' dtype, and
px = ((gx + 1) * W - 1) * 0.5 in that dtype. `floor` decides the corners,
so a one-ulp drift would move a pixel to another corner.

The bilinear warp goes through `ops.warp_kernel.warp_coords`: the CUDA
kernels for CUDA tensors, their plain versions for CPU tensors. There is no
backend switch: echoflow's "matmul" backend and `set_warp_backend` existed
because TPU gathers are slow, and are not ported. `warp_bilinear_border`
is the plain gather formulation, kept as its own function (the oracle of
the kernels and of echoflow's "gather" backend).
"""

from __future__ import annotations

import numpy as np
import torch

from echoflow_torch.ops.warp_kernel import reference_warp_forward, warp_coords
from echoflow_torch.utils.device import device_constant, upload


def _pixel_coords(grid_x, grid_y, h, w):
    """Normalized grids -> unclamped pixel coordinates (align_corners=False)."""
    return ((grid_x + 1.0) * w - 1.0) * 0.5, ((grid_y + 1.0) * h - 1.0) * 0.5


def warp_bilinear_border(image, grid_x, grid_y):
    """Sample `image` (N, C, H, W) at normalized coords (N, H, W) per axis
    with four gathers and a blend (echoflow's gather formulation)."""
    _, _, h, w = image.shape
    px, py = _pixel_coords(grid_x, grid_y, h, w)
    return reference_warp_forward(image, px, py)


def warp_nearest_border(image, grid_x, grid_y):
    """Nearest-neighbour sampling: round-half-to-even of the unnormalized
    coordinate (`torch.round`, as `jnp.round`), border clamp."""
    n, c, h, w = image.shape
    px, py = _pixel_coords(grid_x, grid_y, h, w)
    xi = torch.clamp(torch.round(px).long(), 0, w - 1)
    yi = torch.clamp(torch.round(py).long(), 0, h - 1)
    idx = (yi * w + xi).reshape(n, 1, h * w).expand(n, c, h * w)
    return torch.gather(image.reshape(n, c, h * w), 2, idx).reshape(n, c, h, w)


@device_constant(64)
def _base_grids(h: int, w: int, device: torch.device, dtype: torch.dtype):
    """The base grids (1, 1, W) and (1, H, 1): float64 `np.linspace(-1, 1, n)`
    cast to dtype, on device. Made once per key: a pageable host-to-device
    copy would wait for all queued device work, and the training chain
    loop asks for them at every step. The CUDA copy goes from pinned memory
    without blocking. Callers only read them."""
    xs = [upload(torch.from_numpy(np.linspace(-1.0, 1.0, size)).to(dtype), device)
          for size in (w, h)]
    return xs[0][None, None, :], xs[1][None, :, None]


def offset_grids(offsets):
    """(N, 2, H, W) motion -> normalized (grid_x, grid_y), each (N, H, W)."""
    h, w = offsets.shape[-2:]
    base_x, base_y = _base_grids(h, w, offsets.device, offsets.dtype)
    return base_x + offsets[:, 0], base_y + offsets[:, 1]


def offset_coords(offsets):
    """(N, 2, H, W) motion -> unclamped pixel coordinates (px, py), each
    (N, H, W): what the kernels take. A caller that warps several images
    with one motion computes them once (the fused training loss does)."""
    h, w = offsets.shape[-2:]
    return _pixel_coords(*offset_grids(offsets), h, w)


def warp_image_with_offsets(image, offsets, mode: str = "bilinear"):
    """Warp `image` (N, C, H, W) by a 2-channel motion field (N, 2, H, W):
    offsets[:, 0] displaces x, offsets[:, 1] displaces y, in normalized
    units. Equivalent to the reference's
    `F.grid_sample(image, generate_2dmotion_field(image, offsets),
                   align_corners=False, mode=mode, padding_mode='border')`."""
    if mode == "nearest":
        return warp_nearest_border(image, *offset_grids(offsets))
    if mode != "bilinear":
        raise ValueError(f"unknown warp mode: {mode}")
    return warp_coords(image, *offset_coords(offsets))
