"""Model FLOPs and the attention core's least work of CLAS-FV over Video
Swin-B, from the token shapes of a configuration.

FLOPs follow `portbench/flops.py`: a matrix product of an (m x k) and a
(k x n) operand costs 2 m k n; inference is the patch embedding's conv,
every Linear of every block and merging, both attention products of every
window and head (q k^T and P v, 2 N^2 d each), comb1 as each tap's
projection at the tap's resolution, comb2 and the seg head at full
resolution; training is 3x each product's forward (its forward and two
gradients), the motion head included, less the patch embedding's input
gradient, which no step needs. Element-wise work (LayerNorm, GELU,
softmax, the bias, the roll, the resizes, the loss's warps) is not
counted. Window padding is counted as the program computes it: the padded
tokens of each window.

`attention_flops` and `attention_bytes` are the attention core's least
work in a train step (`ops/attention.window_attention`, forward and
backward): its two products forward and four backward, and its least
traffic in fp32: forward reads q, k, v and the bias table and writes the
output; backward reads q, k, v, the output and its gradient and writes
the gradients of q, k, v and of the table; each operand once.
"""

from __future__ import annotations

import math


def _stages(cfg, frames=None):
    """[(tokens (D, H, W) of the stage, width C, heads, depth, (window
    tokens N, windows of a clip))], with the merging to the next stage's
    size (odd H, W padded)."""
    size = [-(-s // p) for s, p in zip((frames or cfg["clip_length"], cfg["height"],
                                        cfg["width"]), cfg["patch_size"])]
    out = []
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        win = [min(s, w) for s, w in zip(size, cfg["window_size"])]
        padded = [-(-s // w) * w for s, w in zip(size, win)]
        n = math.prod(win)
        out.append((tuple(size), cfg["embed_dim"] * 2 ** i, heads, depth,
                    (n, math.prod(padded) // n)))
        size = [size[0], -(-size[1] // 2), -(-size[2] // 2)]
    return out


def _attention_forward(cfg, frames=None):
    """Both attention products of one clip's forward, every block."""
    return sum(depth * 4 * n * n * c * windows
               for _, c, _, depth, (n, windows) in _stages(cfg, frames))


def clip_flops(cfg, train=False):
    """Model FLOPs of one clip of `cfg` (module docstring)."""
    stages = _stages(cfg)
    t0 = stages[0][0]
    embed = 2 * cfg["embed_dim"] * cfg["in_channels"] * math.prod(cfg["patch_size"]) * math.prod(t0)
    linears = 0
    for i, (size, c, _, depth, _) in enumerate(stages):
        tokens = math.prod(size)
        linears += depth * 2 * tokens * c * c * (3 + 1 + 2 * cfg["mlp_ratio"])
        if i + 1 < len(stages):
            linears += 2 * math.prod(stages[i + 1][0]) * 4 * c * 2 * c
    d = cfg["decoder_width"]
    taps = [(cfg["embed_dim"], t0)] + [(c, size) for size, c, _, _, _ in stages]
    full = cfg["clip_length"] * cfg["height"] * cfg["width"]
    heads = [d, cfg["seg_classes"]] + ([cfg["motion_channels"]] if train else [])
    decoder = (sum(2 * c * d * math.prod(t) for c, t in taps)
               + sum(2 * d * o * full for o in heads))
    total = embed + linears + _attention_forward(cfg) + decoder
    return 3 * total - embed if train else total


def attention_flops(cfg, batch):
    """The attention core's products in a train step of `batch` clips:
    forward 4 N^2 d a window and head, backward twice that."""
    return 3 * batch * _attention_forward(cfg)


def attention_bytes(cfg, batch):
    """The attention core's least bytes in a train step (module
    docstring): per block, fp32, 3C (qkv) + C (output) a token forward,
    3C + C + C read and 3C written backward, and the table (rows x heads)
    read twice and its gradient written."""
    rows = math.prod(2 * w - 1 for w in cfg["window_size"])
    total = 0
    for _, c, heads, depth, (n, windows) in _stages(cfg):
        tokens = batch * n * windows
        total += depth * 4 * (tokens * c * (4 + 8) + 3 * rows * heads)
    return total
