"""Plain CLAS-FV: the R(2+1)D-18 MotionNet forward as the published model
writes it (src/model/R2plus1D_18_MotionNet.py), over a state dict whose
keys are the published model's own.

Each tap of the backbone (stem, layer1..4) is upsampled to the input's
resolution (trilinear, align_corners=True), the five are concatenated to
1024 channels, and the decoder runs comb1 (1x1x1, 1024 -> 64) + BN + ReLU,
comb2 (64 -> 64) + BN + ReLU, the seg head (64 -> 2) and the tanh motion
head (64 -> 4). BatchNorm uses the batch statistics in training mode and
the running ones in eval mode. Plain `torch.nn.functional` calls only: no
folding, no merged projections, no kernel of the program.

`precision` turns the control's lower precision on for every conv: "fp32"
(none), "tf32" (the card's TF32 where the call runs on a card, the same
10-bit operand rounding on the CPU) or "fp8" (each conv's operands scaled
per tensor and rounded to float8 e4m3 in the forward, and the output
gradient its backward takes scaled per tensor and rounded to float8 e5m2,
as fp8 training runs both passes: the configuration's bf16 convs run in
bf16 both ways).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def midplanes(cin: int, cout: int) -> int:
    """torchvision's (2+1)D mid-planes rule."""
    return (cin * cout * 27) // (cin * 9 + 3 * cout)


def _conv_specs(cfg):
    """(key, out, in, kernel, stride, padding, bn key or None) of every conv
    of the backbone, in forward order."""
    cin, stem = cfg["in_channels"], cfg["stem_width"]
    w0 = cfg["stage_widths"][0]
    specs = [("r2plus1d_model.stem.0", stem, cin, tuple(cfg["stem_kernel"]),
              tuple(cfg["stem_stride"]), (0, 3, 3), "r2plus1d_model.stem.1"),
             ("r2plus1d_model.stem.3", w0, stem, tuple(cfg["stem_temporal_kernel"]),
              (1, 1, 1), (1, 0, 0), "r2plus1d_model.stem.4")]
    prev = w0
    for i, (width, stride) in enumerate(zip(cfg["stage_widths"], cfg["stage_strides"]), 1):
        for b in range(cfg["blocks_per_stage"]):
            s = stride if b == 0 else 1
            mid = midplanes(prev, width)
            p = f"r2plus1d_model.layer{i}.{b}"
            specs += [(f"{p}.conv1.0.0", mid, prev, (1, 3, 3), (1, s, s), (0, 1, 1), f"{p}.conv1.0.1"),
                      (f"{p}.conv1.0.3", width, mid, (3, 1, 1), (s, 1, 1), (1, 0, 0), f"{p}.conv1.1"),
                      (f"{p}.conv2.0.0", mid, width, (1, 3, 3), (1, 1, 1), (0, 1, 1), f"{p}.conv2.0.1"),
                      (f"{p}.conv2.0.3", width, mid, (3, 1, 1), (1, 1, 1), (1, 0, 0), f"{p}.conv2.1")]
            if s != 1 or prev != width:
                specs.append((f"{p}.downsample.0", width, prev, (1, 1, 1), (s, s, s), (0, 0, 0),
                              f"{p}.downsample.1"))
            prev = width
    return specs


def state_shapes(cfg) -> dict:
    """Every key of the unfolded state dict and its shape."""
    shapes = {}

    def bn(key, ch):
        for part in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{key}.{part}"] = (ch,)
        shapes[f"{key}.num_batches_tracked"] = ()

    for key, out, inp, k, _, _, bn_key in _conv_specs(cfg):
        shapes[f"{key}.weight"] = (out, inp, *k)
        bn(bn_key, out)
    last = cfg["stage_widths"][-1]
    shapes["r2plus1d_model.fc.weight"] = (cfg["kinetics_classes"], last)
    shapes["r2plus1d_model.fc.bias"] = (cfg["kinetics_classes"],)
    d = cfg["decoder_width"]
    taps = cfg["stage_widths"][0] + sum(cfg["stage_widths"])
    for key, out, inp in (("comb_1_layer", d, taps), ("comb_2_layer", d, d),
                          ("motion_head", cfg["motion_channels"], d),
                          ("segmentation_head", cfg["seg_classes"], d)):
        shapes[f"{key}.weight"] = (out, inp, 1, 1, 1)
        shapes[f"{key}.bias"] = (out,)
    bn("comb_batch_norm_1", d)
    bn("comb_batch_norm_2", d)
    return shapes


def conv_layers(cfg):
    """(key, out, in, kernel, stride, padding) of every conv the model runs,
    backbone then decoder (flops.py counts their work)."""
    d = cfg["decoder_width"]
    taps = cfg["stage_widths"][0] + sum(cfg["stage_widths"])
    return ([s[:6] for s in _conv_specs(cfg)]
            + [("comb_1_layer", d, taps, (1, 1, 1), (1, 1, 1), (0, 0, 0)),
               ("comb_2_layer", d, d, (1, 1, 1), (1, 1, 1), (0, 0, 0)),
               ("segmentation_head", cfg["seg_classes"], d, (1, 1, 1), (1, 1, 1), (0, 0, 0)),
               ("motion_head", cfg["motion_channels"], d, (1, 1, 1), (1, 1, 1), (0, 0, 0))])


def _round_tf32(x):
    """x rounded to TF32's 10-bit mantissa (to nearest, ties away), with
    the gradient of x (a straight-through rounding)."""
    bits = x.detach().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return x + (bits.view(torch.float32) - x).detach()


def _quantize(x, dtype, largest):
    """x scaled per tensor to `largest`, rounded to `dtype` and scaled back."""
    scale = largest / x.abs().amax().clamp(min=1e-12)
    return (x * scale).to(dtype).to(x.dtype) / scale


def _round_fp8(x):
    """x rounded to float8 e4m3 (scaled per tensor), with the gradient of x
    (a straight-through rounding)."""
    return x + (_quantize(x.detach(), torch.float8_e4m3fn, 448.0) - x).detach()


class _Fp8Grad(torch.autograd.Function):
    """The identity, whose backward rounds the gradient to float8 e5m2
    (scaled per tensor): what a conv's backward takes in fp8 training."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, dy):
        return _quantize(dy, torch.float8_e5m2, 57344.0)


class Precision:
    """The precision every conv of the reference runs in."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "tf32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def conv(self, x, w, b, stride, padding):
        if self.name == "fp8":
            return _Fp8Grad.apply(F.conv3d(_round_fp8(x), _round_fp8(w), b, stride, padding))
        if self.name == "tf32" and not x.is_cuda:
            x, w = _round_tf32(x), _round_tf32(w)
        return F.conv3d(x, w, b, stride, padding)

    @contextlib.contextmanager
    def flags(self):
        """cuDNN's and cuBLAS's TF32 switches as this precision wants them,
        put back on exit."""
        saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        on = self.name == "tf32"
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = on
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _bn(p, key, x, train, eps):
    if train:
        return F.batch_norm(x, None, None, p[f"{key}.weight"], p[f"{key}.bias"], True, 0.0, eps)
    return F.batch_norm(x, p[f"{key}.running_mean"], p[f"{key}.running_var"],
                        p[f"{key}.weight"], p[f"{key}.bias"], False, 0.0, eps)


def features(p, video, cfg, train=False, precision=None):
    """video (N, 3, T, H, W) float32 -> the decoder's features before the
    heads (N, 64, T, H, W). `p` maps the state dict's keys to tensors."""
    prec = precision or Precision()
    eps = cfg["bn_eps"]
    t, h, w = video.shape[2:]

    def conv_bn(x, spec, relu):
        key, _, _, _, stride, padding, bn_key = spec
        x = _bn(p, bn_key, prec.conv(x, p[f"{key}.weight"], None, stride, padding), train, eps)
        return torch.relu(x) if relu else x

    specs = iter(_conv_specs(cfg))
    x = conv_bn(video, next(specs), True)
    x = conv_bn(x, next(specs), True)
    taps = [x]
    for i, stride in enumerate(cfg["stage_strides"], 1):
        for b in range(cfg["blocks_per_stage"]):
            c1a, c1b, c2a, c2b = (next(specs) for _ in range(4))
            down = None
            if (stride if b == 0 else 1) != 1 or x.shape[1] != c1b[1]:
                down = next(specs)
            y = conv_bn(conv_bn(x, c1a, True), c1b, True)
            y = conv_bn(conv_bn(y, c2a, True), c2b, False)
            identity = x if down is None else conv_bn(x, down, False)
            x = torch.relu(y + identity)
        taps.append(x)
    up = torch.cat([F.interpolate(tap, size=(t, h, w), mode="trilinear", align_corners=True)
                    for tap in taps], dim=1)
    y = prec.conv(up, p["comb_1_layer.weight"], p["comb_1_layer.bias"], 1, 0)
    del up
    y = torch.relu(_bn(p, "comb_batch_norm_1", y, train, eps))
    y = prec.conv(y, p["comb_2_layer.weight"], p["comb_2_layer.bias"], 1, 0)
    return torch.relu(_bn(p, "comb_batch_norm_2", y, train, eps))


def forward(p, video, cfg, train=False, precision=None, with_motion=True):
    """video (N, 3, T, H, W) float32 -> (seg logits (N, 2, T, H, W), motion
    (N, 4, T, H, W) or None)."""
    prec = precision or Precision()
    y = features(p, video, cfg, train, prec)
    seg = prec.conv(y, p["segmentation_head.weight"], p["segmentation_head.bias"], 1, 0)
    if not with_motion:
        return seg, None
    motion = torch.tanh(prec.conv(y, p["motion_head.weight"], p["motion_head.bias"], 1, 0))
    return seg, motion
