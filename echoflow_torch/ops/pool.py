"""A 3-D max pool whose backward repeats bit for bit on the card.

torch's CUDA `max_pool3d` backward adds each output's gradient into the
input position it took with a float atomic add. Where windows overlap
(ir-CSN's stem pool: kernel (1,3,3), stride (1,2,2)) up to four outputs
take one position, and their sum then depends on the order the adds land
in. `max_pool3d` keeps the forward's indices (the same positions torch's
backward uses) and adds the gradient of each kernel tap in turn, one
strided add a tap over the whole tensor: the same order every call.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F


class _RepeatableMaxPool3d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, stride, padding):
        y, index = F.max_pool3d(x, kernel, stride, padding, return_indices=True)
        ctx.save_for_backward(index)
        ctx.conf = (tuple(x.shape), kernel, stride, padding)
        return y

    @staticmethod
    def backward(ctx, dy):
        index, = ctx.saved_tensors
        shape, kernel, stride, padding = ctx.conf
        size, out = shape[2:], dy.shape[2:]
        # The input position each output took, as its tap in the window.
        t, rest = index.div(size[1] * size[2], rounding_mode="floor"), index % (size[1] * size[2])
        h, w = rest.div(size[2], rounding_mode="floor"), rest % size[2]
        taps = []
        for pos, d in zip((t, h, w), range(3)):
            o = torch.arange(out[d], device=dy.device).view(
                [out[d] if i == d else 1 for i in range(3)])
            taps.append(pos - (o * stride[d] - padding[d]))
        tap = (taps[0] * kernel[1] + taps[1]) * kernel[2] + taps[2]
        # The padded input's gradient: each tap's outputs land s q + a.
        dx = dy.new_zeros((*shape[:2], *(s + 2 * p for s, p in zip(size, padding))))
        for i, a in enumerate(itertools.product(*(range(k) for k in kernel))):
            dx[(slice(None), slice(None)) + tuple(
                slice(ai, ai + s * (o - 1) + 1, s) for ai, s, o in zip(a, stride, out))] += (
                dy * (tap == i))
        return (dx[(slice(None), slice(None)) + tuple(
            slice(p, p + s) for p, s in zip(padding, size))], None, None, None)


def max_pool3d(x, kernel, stride, padding):
    """`F.max_pool3d(x, kernel, stride, padding)` (no dilation, floor mode)
    whose backward repeats (module docstring) where a gradient is wanted;
    elsewhere the plain pool."""
    triple = [(v,) * 3 if isinstance(v, int) else tuple(v) for v in (kernel, stride, padding)]
    if torch.is_grad_enabled() and x.requires_grad:
        return _RepeatableMaxPool3d.apply(x, *triple)
    return F.max_pool3d(x, *triple)
