"""Convolutions with flax's "SAME" padding, for the port's copies of small
flax models (the CAMUS harness's SegNet and ShapeAutoencoder).

torch's symmetric `padding` is not flax's SAME: a stride-2 3x3 conv on an
even size pads 0 before and 1 after in flax, and flax's `ConvTranspose`
(transpose_kernel=False) is torch's `conv_transpose2d` with the kernel
flipped, cropped to in * stride. Both modules compute the padding from the
input, as `lax.padtype_to_pads` and lax's transposed-conv padding do.
`models/convert.load_flax_params` fills them from flax variables. Their
backward repeats bit for bit on the card (`ops/conv.convolution`).
"""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from echoflow_torch.ops import conv as conv_ops


def _same_pads(size: int, k: int, s: int):
    """(before, after) of flax's SAME for one axis of length `size`."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """`nn.Conv2d` (no padding of its own) with flax's SAME padding."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int = 1):
        super().__init__(cin, cout, kernel_size, stride)

    def forward(self, x):
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        top, bottom = _same_pads(x.shape[-2], kh, sh)
        left, right = _same_pads(x.shape[-1], kw, sw)
        return conv_ops.convolution(F.pad(x, (left, right, top, bottom)), self.weight,
                                    self.bias, self.stride)


class SameConvTranspose2d(nn.ConvTranspose2d):
    """flax `ConvTranspose(..., padding="SAME")`: output size in * stride.
    The weight is torch's (in, out, kh, kw), flax's kernel flipped. A kernel
    smaller than its stride (where lax pads beyond torch's full output) is
    refused."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int = 1):
        if kernel_size < stride:
            raise ValueError("SameConvTranspose2d: kernel_size >= stride")
        super().__init__(cin, cout, kernel_size, stride)

    def forward(self, x):
        # padding 0: the full (in - 1) * s + k
        y = conv_ops.convolution(x, self.weight, self.bias, self.stride, transposed=True)
        crops = []
        for size, k, s in zip(x.shape[-2:], self.kernel_size, self.stride):
            pad_len = k + s - 2
            before = k - 1 if s > k - 1 else -(-pad_len // 2)
            start = k - 1 - before
            crops.append(slice(start, start + size * s))
        return y[..., crops[0], crops[1]]
