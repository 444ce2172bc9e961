"""ir-CSN-152 under CLAS-FV's decoder: the channel-separated video ResNet of
Tran, Wang, Torresani and Feiszli (ICCV 2019, arXiv:1904.02811), as
facebookresearch/VMZ builds it (`vmz/models/csn.py`, `ir_csn_152`, on
torchvision's `VideoResNet`), in place of R(2+1)D-18.

- Stem: Conv3d(3 -> 64, (3,7,7), stride (1,2,2), pad (1,3,3)) -> BN ->
  ReLU (tap 0), then MaxPool3d((1,3,3), (1,2,2), (0,1,1)).
- Stages 1-4: 3, 8, 36 and 3 "interaction-reduced" bottlenecks of middle
  width 64, 128, 256, 512 and output 4x that; each stage's first block
  strides (1, 2, 2, 2 in every dimension) and has a projection shortcut.
  A block: 1x1x1 conv -> BN -> ReLU, depthwise 3x3x3 conv (one group a
  channel) -> BN -> ReLU, 1x1x1 conv -> BN, plus the shortcut, ReLU. The
  stage outputs are taps 1-4.
- The unused 400-way Kinetics fc, kept for parameter-count parity.

State-dict keys are VMZ's (`stem.0`, `layer3.17.conv2.0`, `downsample.1`,
...) under `ir_csn_model.`, and the decoder's are CLAS-FV's. The backbone's
BatchNorm takes VMZ's eps 1e-3 and torch momentum 0.9 ("exact Caffe2
momentum"); the decoder's keeps CLAS-FV's 1e-5 and 0.1.

Every conv goes through `ops/conv.convolution` (the depthwise convs in
the span `conv.depthwise`) and the pool through `ops/pool.max_pool3d`, so
an fp32 train step repeats bit for bit on the card. With `folded=True`
every BatchNorm is an `nn.Identity` and its conv has a bias
(`models/fold_bn.py`).
"""

from __future__ import annotations

import torch.nn as nn

from echoflow_torch.models.r2plus1d import Conv3d, MotionSegNet, _bn
from echoflow_torch.ops.pool import max_pool3d

BN_EPS = 1e-3
BN_MOMENTUM = 0.9
# (blocks, middle width, stride) of each stage of ir-CSN-152.
STAGES = ((3, 64, 1), (8, 128, 2), (36, 256, 2), (3, 512, 2))
EXPANSION = 4
STEM_WIDTH = 64


def _conv_bn(cin, cout, kernel, stride, padding, folded, relu, groups=1):
    layers = [Conv3d(cin, cout, kernel, stride, padding, groups=groups, bias=folded),
              _bn(cout, folded, BN_EPS, BN_MOMENTUM)]
    return nn.Sequential(*layers, *([nn.ReLU(inplace=True)] if relu else []))


class MaxPool3d(nn.MaxPool3d):
    """`nn.MaxPool3d` whose backward repeats (`ops/pool.max_pool3d`)."""

    def forward(self, x):
        return max_pool3d(x, self.kernel_size, self.stride, self.padding)


class Bottleneck(nn.Module):
    """ir-CSN's bottleneck (module docstring)."""

    def __init__(self, cin: int, mid: int, stride: int = 1, folded: bool = False):
        super().__init__()
        cout = EXPANSION * mid
        self.conv1 = _conv_bn(cin, mid, 1, 1, 0, folded, relu=True)
        self.conv2 = _conv_bn(mid, mid, 3, stride, 1, folded, relu=True, groups=mid)
        self.conv3 = _conv_bn(mid, cout, 1, 1, 0, folded, relu=False)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = _conv_bn(cin, cout, 1, stride, 0, folded, relu=False)
        self.relu = nn.ReLU(inplace=True)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        return self.relu(self.conv3(self.conv2(self.conv1(x))) + identity)


class IrCSNBackbone(nn.Module):
    """Stem + 4 stages (+ the unused Kinetics fc); `forward` returns the
    five taps: the stem's output before its pool, then each stage's.
    `stages` gives each stage's (blocks, middle width, stride): ir-CSN-152's
    by default; the tests build smaller ones."""

    def __init__(self, folded: bool = False, stages=STAGES, stem_width: int = STEM_WIDTH):
        super().__init__()
        self.stem = nn.Sequential(
            Conv3d(3, stem_width, (3, 7, 7), (1, 2, 2), (1, 3, 3), bias=folded),
            _bn(stem_width, folded, BN_EPS, BN_MOMENTUM), nn.ReLU(inplace=True),
            MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1)))
        cin = stem_width
        for i, (blocks, mid, stride) in enumerate(stages, start=1):
            layer = []
            for b in range(blocks):
                layer.append(Bottleneck(cin, mid, stride if b == 0 else 1, folded))
                cin = EXPANSION * mid
            setattr(self, f"layer{i}", nn.Sequential(*layer))
        self.tap_channels = (stem_width, *(EXPANSION * mid for _, mid, _ in stages))
        self.fc = nn.Linear(cin, 400)  # unused; checkpoint/param-count parity

    def forward(self, x):
        x = self.stem[2](self.stem[1](self.stem[0](x)))
        taps = [x]
        x = self.stem[3](x)
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
            taps.append(x)
        return taps


def fold_pairs(state_dict) -> list:
    """[(layer prefix, its BatchNorm's prefix or None, that BatchNorm's
    eps)] of every conv and the fc of an unfolded CSN state dict, in its
    order (`models/fold_bn.fold_state_dict`)."""
    decoder = {"comb_1_layer": "comb_batch_norm_1", "comb_2_layer": "comb_batch_norm_2"}
    pairs = []
    for key in state_dict:
        if not key.endswith(".weight") or f"{key[:-7]}.running_var" in state_dict:
            continue
        prefix = key[:-7]
        if prefix in decoder:
            pairs.append((prefix, decoder[prefix], 1e-5))
        elif prefix.endswith(".0") and f"{prefix[:-2]}.1.running_var" in state_dict:
            pairs.append((prefix, f"{prefix[:-2]}.1", BN_EPS))
        else:
            pairs.append((prefix, None, None))
    return pairs


class CSNMotionSegNet(MotionSegNet):
    """CLAS-FV's decoder and heads over ir-CSN-152 (`MotionSegNet`): comb1
    reads the taps' 64 + 256 + 512 + 1024 + 2048 = 3904 channels. At the
    published widths 29,958,294 parameters."""

    name, backbone_attr, title, kinetics_init = "ir_csn_152", "ir_csn_model", "ir-CSN-152", False
    fold_pairs = staticmethod(fold_pairs)

    def __init__(self, folded: bool = False, stages=STAGES, stem_width: int = STEM_WIDTH):
        super().__init__()
        self.ir_csn_model = IrCSNBackbone(folded, stages, stem_width)
        self._add_decoder(folded)
