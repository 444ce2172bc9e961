"""Model FLOPs of CLAS-FV, counted from the layer shapes of a configuration.

A conv's forward costs 2 x out x in x kernel volume x output positions. The
work counted is the model's, whatever implements it:

- inference (`clip_flops(cfg, train=False)`): every backbone conv's
  forward; comb1 as the projection of each tap to the decoder width at the
  tap's own resolution (the concatenation of upsampled taps is linear, so
  that is the least the model needs); comb2 and the seg head at full
  resolution. The motion head is left out: the archive path does not ask
  for motion.
- training (`clip_flops(cfg, train=True)`): each conv's forward, input
  gradient and weight gradient (3x its forward), the motion head included;
  the stem's input gradient is left out, because no step needs it.

Element-wise work (BatchNorm, ReLU, resizes, the loss's warps) is not
counted.
"""

from __future__ import annotations

import math

from portbench.reference.model import conv_layers


def _out_size(size, kernel, stride, padding):
    return [(s + 2 * p - k) // st + 1 for s, k, st, p in zip(size, kernel, stride, padding)]


def conv_flops(cfg, frames=None):
    """[(key, forward FLOPs of one clip)] of the backbone convs, and the
    (T, H, W) of each tap."""
    size = [frames or cfg["clip_length"], cfg["height"], cfg["width"]]
    out, taps, block_in = [], [], None
    for key, cout, cin, kernel, stride, padding in conv_layers(cfg):
        if not key.startswith("r2plus1d_model"):
            break
        src = block_in if key.endswith("downsample.0") else size
        dst = _out_size(src, kernel, stride, padding)
        out.append((key, 2 * cout * cin * math.prod(kernel) * math.prod(dst)))
        if key.endswith("conv1.0.0"):
            block_in = size
        if not key.endswith("downsample.0"):
            size = dst
        if key.endswith(("stem.3", f".{cfg['blocks_per_stage'] - 1}.conv2.0.3")):
            taps.append(tuple(size))   # the stem's output and each stage's
    return out, taps


def clip_flops(cfg, train=False):
    """Model FLOPs of one clip of `cfg` (see the module docstring)."""
    convs, taps = conv_flops(cfg)
    widths = [cfg["stage_widths"][0], *cfg["stage_widths"]]
    d = cfg["decoder_width"]
    full = cfg["clip_length"] * cfg["height"] * cfg["width"]
    heads = [d, cfg["seg_classes"]] + ([cfg["motion_channels"]] if train else [])
    decoder = (sum(2 * c * d * math.prod(t) for c, t in zip(widths, taps))
               + sum(2 * d * o * full for o in heads))
    total = sum(f for _, f in convs) + decoder
    if not train:
        return total
    stem = convs[0][1]
    return 3 * total - stem
