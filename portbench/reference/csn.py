"""Plain CLAS-FV over ir-CSN-152: the channel-separated video ResNet of Tran
et al. (ICCV 2019, arXiv:1904.02811) as facebookresearch/VMZ builds it
(`vmz/models/csn.py`, `ir_csn_152`), under CLAS-FV's decoder and heads,
over a state dict keyed as VMZ's backbone (`ir_csn_model.layer3.17.conv2.0
.weight`, ...) and CLAS-FV's decoder.

- Stem: conv (3,7,7)/(1,2,2) pad (1,3,3) -> BN -> ReLU, the first tap;
  then a (1,3,3)/(1,2,2) max pool, pad (0,1,1).
- Stages: `stage_blocks` bottlenecks of middle width `stage_mid_widths`
  and `expansion` x that out; the first block of a stage strides by
  `stage_strides` in every dimension and projects its shortcut (1x1x1
  conv, BN). A bottleneck: 1x1x1 conv, BN, ReLU; depthwise 3x3x3 conv
  (groups = channels), BN, ReLU; 1x1x1 conv, BN; + shortcut; ReLU. Each
  stage's output is a tap.
- Decoder (`decode`): comb1 (1x1x1, sum of the taps' channels -> 64) over
  the taps upsampled to the input (trilinear, align_corners=True) and
  concatenated, written as the sum over the taps of each tap's slice of
  comb1 at the tap's resolution, upsampled: the same linear map, which
  does not hold the 3904-channel concatenation at full resolution. Then
  BN, ReLU, comb2 + BN + ReLU, the seg head and the tanh motion head.

BatchNorm: the backbone's eps `bn_eps`, the decoder's `decoder_bn_eps`;
batch statistics in training mode, running ones in eval mode. Plain
`torch.nn.functional` calls only (`F.conv3d(..., groups=)`,
`F.batch_norm`, `F.max_pool3d`, `F.interpolate`): no folding, no kernel of
the program. `precision` is `reference/model.Precision`, which `_conv`
applies to the grouped convs too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.model import Precision, _bn, _Fp8Grad, _round_fp8, _round_tf32

BACKBONE = "ir_csn_model"


def _conv(prec, x, w, b, stride, padding, groups=1):
    """`prec.conv` (reference/model.Precision), with `groups`."""
    if groups == 1:
        return prec.conv(x, w, b, stride, padding)
    if prec.name == "fp8":
        return _Fp8Grad.apply(F.conv3d(_round_fp8(x), _round_fp8(w), b, stride, padding, 1,
                                       groups))
    if prec.name == "tf32" and not x.is_cuda:
        x, w = _round_tf32(x), _round_tf32(w)
    return F.conv3d(x, w, b, stride, padding, 1, groups)


def _stages(cfg):
    return list(zip(cfg["stage_blocks"], cfg["stage_mid_widths"], cfg["stage_strides"]))


def _conv_specs(cfg):
    """(key, out, in, kernel, stride, padding, groups, bn key) of every conv
    of the backbone, in forward order (a block's shortcut last)."""
    b = BACKBONE
    stem = cfg["stem_width"]
    specs = [(f"{b}.stem.0", stem, cfg["in_channels"], tuple(cfg["stem_kernel"]),
              tuple(cfg["stem_stride"]), tuple(cfg["stem_padding"]), 1, f"{b}.stem.1")]
    prev = stem
    for i, (blocks, mid, stride) in enumerate(_stages(cfg), 1):
        out = cfg["expansion"] * mid
        for j in range(blocks):
            s = stride if j == 0 else 1
            p = f"{b}.layer{i}.{j}"
            specs += [(f"{p}.conv1.0", mid, prev, (1, 1, 1), (1, 1, 1), (0, 0, 0), 1,
                       f"{p}.conv1.1"),
                      (f"{p}.conv2.0", mid, mid, (3, 3, 3), (s, s, s), (1, 1, 1), mid,
                       f"{p}.conv2.1"),
                      (f"{p}.conv3.0", out, mid, (1, 1, 1), (1, 1, 1), (0, 0, 0), 1,
                       f"{p}.conv3.1")]
            if s != 1 or prev != out:
                specs.append((f"{p}.downsample.0", out, prev, (1, 1, 1), (s, s, s),
                              (0, 0, 0), 1, f"{p}.downsample.1"))
            prev = out
    return specs


def tap_channels(cfg):
    return [cfg["stem_width"]] + [cfg["expansion"] * mid for mid in cfg["stage_mid_widths"]]


def state_shapes(cfg) -> dict:
    """Every key of the unfolded state dict and its shape."""
    shapes = {}

    def bn(key, ch):
        for part in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{key}.{part}"] = (ch,)
        shapes[f"{key}.num_batches_tracked"] = ()

    for key, out, inp, k, _, _, groups, bn_key in _conv_specs(cfg):
        shapes[f"{key}.weight"] = (out, inp // groups, *k)
        bn(bn_key, out)
    last = tap_channels(cfg)[-1]
    shapes[f"{BACKBONE}.fc.weight"] = (cfg["kinetics_classes"], last)
    shapes[f"{BACKBONE}.fc.bias"] = (cfg["kinetics_classes"],)
    d = cfg["decoder_width"]
    for key, out, inp in (("comb_1_layer", d, sum(tap_channels(cfg))), ("comb_2_layer", d, d),
                          ("motion_head", cfg["motion_channels"], d),
                          ("segmentation_head", cfg["seg_classes"], d)):
        shapes[f"{key}.weight"] = (out, inp, 1, 1, 1)
        shapes[f"{key}.bias"] = (out,)
    bn("comb_batch_norm_1", d)
    bn("comb_batch_norm_2", d)
    return shapes


def _out(size, kernel, stride, padding):
    return tuple((s + 2 * p - k) // st + 1 for s, k, st, p in zip(size, kernel, stride, padding))


def conv_layers(cfg, frames=None):
    """(key, out, in, kernel, stride, padding, groups, output size (T, H, W))
    of every conv the model runs in forward order, backbone then decoder,
    the decoder's comb1 as its slice for each tap at the tap's resolution
    (`decode`); and the (T, H, W) of each tap."""
    size = (frames or cfg["clip_length"], cfg["height"], cfg["width"])
    out, taps, block_in = [], [], size
    for key, co, ci, k, s, p, g, _ in _conv_specs(cfg):
        if key.endswith(".conv1.0"):
            block_in = size
        src = block_in if key.endswith(".downsample.0") else size
        dst = _out(src, k, s, p)
        out.append((key, co, ci, k, s, p, g, dst))
        if key.endswith(".stem.0"):
            taps.append(dst)
            size = _out(dst, cfg["pool_kernel"], cfg["pool_stride"], cfg["pool_padding"])
        elif not key.endswith(".downsample.0"):
            size = dst
        if key.endswith(".conv3.0"):
            last = key.split(".")
            i, j = int(last[1][len("layer"):]), int(last[2])
            if j == cfg["stage_blocks"][i - 1] - 1:
                taps.append(size)
    d, full = cfg["decoder_width"], (frames or cfg["clip_length"], cfg["height"], cfg["width"])
    for c, t in zip(tap_channels(cfg), taps):
        out.append(("comb_1_layer", d, c, (1, 1, 1), (1, 1, 1), (0, 0, 0), 1, t))
    for key, co in (("comb_2_layer", d), ("segmentation_head", cfg["seg_classes"]),
                    ("motion_head", cfg["motion_channels"])):
        out.append((key, co, d, (1, 1, 1), (1, 1, 1), (0, 0, 0), 1, full))
    return out, taps


def backbone_taps(p, video, cfg, train=False, precision=None):
    """The five taps of the backbone: the stem's output, then each stage's."""
    prec = precision or Precision()
    eps = cfg["bn_eps"]

    def conv_bn(x, spec, relu):
        key, _, _, _, stride, padding, groups, bn_key = spec
        x = _bn(p, bn_key, _conv(prec, x, p[f"{key}.weight"], None, stride, padding, groups),
                train, eps)
        return torch.relu(x) if relu else x

    specs = iter(_conv_specs(cfg))
    x = conv_bn(video, next(specs), True)
    taps = [x]
    x = F.max_pool3d(x, cfg["pool_kernel"], cfg["pool_stride"], cfg["pool_padding"])
    for blocks, mid, stride in _stages(cfg):
        for j in range(blocks):
            c1, c2, c3 = next(specs), next(specs), next(specs)
            s = stride if j == 0 else 1
            down = next(specs) if s != 1 or x.shape[1] != c3[1] else None
            y = conv_bn(conv_bn(conv_bn(x, c1, True), c2, True), c3, False)
            x = torch.relu(y + (x if down is None else conv_bn(x, down, False)))
        taps.append(x)
    return taps


def decode(p, taps, size, cfg, train=False, precision=None, with_motion=True):
    """The decoder and heads over `taps` at the output size (T, H, W):
    (seg logits, motion or None)."""
    prec = precision or Precision()
    eps = cfg.get("decoder_bn_eps", cfg["bn_eps"])
    w = p["comb_1_layer.weight"]
    y, offset = None, 0
    for tap in taps:
        c = tap.shape[1]
        proj = prec.conv(tap, w[:, offset:offset + c], None, 1, 0)
        up = F.interpolate(proj, size=size, mode="trilinear", align_corners=True)
        y = up if y is None else y + up
        offset += c
    y = y + p["comb_1_layer.bias"].reshape(1, -1, 1, 1, 1)
    y = torch.relu(_bn(p, "comb_batch_norm_1", y, train, eps))
    y = prec.conv(y, p["comb_2_layer.weight"], p["comb_2_layer.bias"], 1, 0)
    y = torch.relu(_bn(p, "comb_batch_norm_2", y, train, eps))
    seg = prec.conv(y, p["segmentation_head.weight"], p["segmentation_head.bias"], 1, 0)
    if not with_motion:
        return seg, None
    return seg, torch.tanh(prec.conv(y, p["motion_head.weight"], p["motion_head.bias"], 1, 0))


def forward(p, video, cfg, train=False, precision=None, with_motion=True):
    """video (N, 3, T, H, W) float32 -> (seg logits (N, 2, T, H, W), motion
    (N, 4, T, H, W) or None)."""
    taps = backbone_taps(p, video, cfg, train, precision)
    return decode(p, taps, tuple(video.shape[2:]), cfg, train, precision, with_motion)
