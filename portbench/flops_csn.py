"""Model FLOPs and the depthwise convs' least bytes of CLAS-FV over
ir-CSN-152, from the layer shapes of a configuration
(`reference/csn.conv_layers`).

FLOPs are counted as `portbench/flops.py` counts CLAS-FV's: a conv's
forward costs 2 x out x in/groups x kernel volume x output positions;
inference is every backbone conv's forward, comb1 as each tap's projection
at the tap's resolution, comb2 and the seg head; training is 3x each
conv's forward, the motion head included, less the stem's input gradient,
which no step needs. Element-wise work is not counted.

`depthwise_bytes` is the least traffic of the depthwise 3x3x3 convs of a
train step, fp32: the forward reads x and w and writes y; the input
gradient reads dy and w and writes dx; the weight gradient reads x and dy
and writes dW; each operand once.
"""

from __future__ import annotations

import math

from portbench.reference.csn import conv_layers


def _flops(layer):
    _, co, ci, k, _, _, g, out = layer
    return 2 * co * (ci // g) * math.prod(k) * math.prod(out)


def clip_flops(cfg, train=False):
    """Model FLOPs of one clip of `cfg` (module docstring)."""
    layers, _ = conv_layers(cfg)
    heads = {"motion_head"} if not train else set()
    total = sum(_flops(layer) for layer in layers if layer[0] not in heads)
    if not train:
        return total
    return 3 * total - _flops(layers[0])


def depthwise_bytes(cfg, batch):
    """Least bytes of the depthwise convs' forward, input gradient and
    weight gradient in a train step of `batch` clips (module docstring)."""
    layers, _ = conv_layers(cfg)
    total, prev_out = 0, None
    for key, co, ci, k, s, p, g, out in layers:
        if g > 1 and ci == co == g:
            x = batch * ci * math.prod(prev_out)
            y = batch * co * math.prod(out)
            w = co * math.prod(k)
            total += 4 * ((x + w + y) + (y + w + x) + (x + y + w))
        if not key.endswith(".downsample.0"):
            prev_out = out
    return total
