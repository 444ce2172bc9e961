"""BatchNorm folding for inference (port of `echoflow.models.fold_bn`).

In eval mode every BatchNorm applies a per-channel affine map with running
statistics, which is absorbed exactly into the preceding convolution:

    BN(conv(x, W)) = conv(x, W * s) + (beta - mean * s),
    s = scale / sqrt(var + eps)

The arithmetic runs in float32 numpy in the same order as `echoflow`'s, so
a folded state dict is bitwise the conversion of `fold_variables`' tree.
An ir-CSN-152 state dict (`models/csn.py`) folds the same way, each
BatchNorm with its own eps, the depthwise convs included.

For cuDNN's 16-bit tensor-core convs, `fit_tensor_cores` changes a folded
backbone on the card, leaving its function as it is: `pad_widths`
zero-pads its inner widths that are not a multiple of 8,
`temporal_convs_as_2d` runs its (k, 1, 1) convs as 2D convs, and
`channels_last` keeps its weights, and so its activations, in
`torch.channels_last_3d` (NDHWC), the layout of cuDNN's 16-bit kernels.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn as nn

from echoflow_torch.models.r2plus1d import Conv3d, TemporalConv3d, backbone_of, backbones
from echoflow_torch.utils.profiling import count


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def is_folded(state_dict: Mapping) -> bool:
    return not any(k.endswith("running_var") for k in state_dict)


def fold_state_dict(state_dict: Mapping) -> dict:
    """Unfolded state dict -> state dict of the folded model over the same
    backbone (`models/r2plus1d.motion_seg_net(backbone_of(state_dict),
    folded=True)`): every (conv, BN) pair of its net's `fold_pairs`
    becomes a biased conv; heads and fc pass through."""
    pairs = backbones()[backbone_of(state_dict)].fold_pairs(state_dict)
    out: dict = {}
    for prefix, bn_prefix, eps in pairs:
        weight = _np(state_dict[f"{prefix}.weight"]).astype(np.float32)
        bias = state_dict.get(f"{prefix}.bias")
        if bn_prefix is not None:
            bn = {part: _np(state_dict[f"{bn_prefix}.{part}"]).astype(np.float32)
                  for part in ("weight", "bias", "running_mean", "running_var")}
            s = bn["weight"] / np.sqrt(bn["running_var"] + eps)
            # O is axis 0 of a Conv3d weight (flax folds along its last axis).
            weight = weight * s.reshape(-1, *([1] * (weight.ndim - 1)))
            base = _np(bias).astype(np.float32) if bias is not None else 0.0
            bias = (base - bn["running_mean"]) * s + bn["bias"]
        out[f"{prefix}.weight"] = torch.from_numpy(np.ascontiguousarray(weight))
        if bias is not None:
            out[f"{prefix}.bias"] = torch.from_numpy(np.asarray(_np(bias), np.float32))
    return out


def _plain_conv(mod) -> bool:
    return isinstance(mod, nn.Conv3d) and mod.groups == 1


def _zero_grow(conv: nn.Conv3d, dim: int, pad: int):
    """`pad` zero filters (dim 0, with zero bias) or zero input channels
    (dim 1) appended to `conv`."""
    def grown(p, axis):
        shape = list(p.shape)
        shape[axis] = pad
        return nn.Parameter(torch.cat([p.detach(), p.new_zeros(shape)], axis),
                            requires_grad=p.requires_grad)

    conv.weight = grown(conv.weight, dim)
    if dim == 0:
        conv.out_channels += pad
        if conv.bias is not None:
            conv.bias = grown(conv.bias, 0)
    else:
        conv.in_channels += pad


@torch.no_grad()
def pad_widths(backbone: nn.Module, multiple: int = 8) -> int:
    """Zero-pad the inner width of every conv -> ReLU -> conv pair of a
    folded backbone up to a multiple of `multiple`; returns the number of
    pairs padded.

    A pair is two one-group `Conv3d`s of one `nn.Sequential` with only
    `nn.Identity` (a folded BatchNorm) and `nn.ReLU` between them: in
    R(2+1)D-18 the stem's [0]/[3] and each (2+1)D conv's [0]/[3], whose
    middle widths 45, 230, 460 and 921 (torchvision's midplanes) become
    48, 232, 464 and 928. The first conv gains `-m % multiple` filters of
    zero weight and zero bias, the second as many input channels of zero
    weight. A padded channel is 0 after the first conv and its ReLU and
    adds exact zeros to the second, so the backbone computes the same
    function and no tap's width changes. A second call pads nothing.
    ir-CSN-152 has no pair (each conv has its own Sequential, and every
    width is a multiple of 8); a depthwise conv is never padded. An
    unfolded backbone has a BatchNorm in each pair and is left alone.

    cuDNN's bf16 and fp16 tensor-core convs take channels in 16-byte
    multiples: at the widths above cuDNN 9.2 adds a channel-padding
    transform and memsets around the conv, 1% of the 16-bit backbone's
    time on an H100."""
    padded = 0
    for seq in backbone.modules():
        if not isinstance(seq, nn.Sequential):
            continue
        mods = list(seq)
        for i, first in enumerate(mods):
            j = i + 1
            while j < len(mods) and isinstance(mods[j], (nn.Identity, nn.ReLU)):
                j += 1
            if not (_plain_conv(first) and j < len(mods) and _plain_conv(mods[j])):
                continue
            pad = -first.out_channels % multiple
            if pad:
                _zero_grow(first, 0, pad)
                _zero_grow(mods[j], 1, pad)
                padded += 1
    return padded


def temporal_convs_as_2d(backbone: nn.Module) -> int:
    """Make every one-group `Conv3d` of `backbone` whose kernel, stride and
    padding act on time alone, kernel (k > 1, 1, 1), a `TemporalConv3d`
    (same parameters and function, computed as a 2D conv over (T, H*W));
    returns how many. R(2+1)D-18 has 17 (the stem's and each (2+1)D
    conv's second); ir-CSN-152 none."""
    n = 0
    for mod in backbone.modules():
        if (type(mod) is Conv3d and mod.groups == 1 and mod.kernel_size[0] > 1
                and mod.kernel_size[1:] == (1, 1) and mod.stride[1:] == (1, 1)
                and mod.padding[1:] == (0, 0)):
            mod.__class__ = TemporalConv3d
            n += 1
    return n


def channels_last(backbone: nn.Module) -> bool:
    """Put every conv weight of `backbone` in `torch.channels_last_3d`
    (NDHWC) if all its convs are one-group; returns whether it did.

    cuDNN's 16-bit tensor-core convs read and write NHWC: on NCDHW
    operands each conv transposes its input and weight in and its output
    back out (`nchwToNhwcKernel`, `nhwcToNchwKernel`), 27% of the bf16
    engine's device time on an H100 at R(2+1)D-18. With the weights
    channels-last, cuDNN's output is channels-last, and so is every
    activation after it: residual adds and in-place ReLUs keep the layout,
    and a `TemporalConv3d`'s (N, C, T, H*W) view of a channels-last-3d
    tensor is 2D channels-last. Its input is laid out the same way once
    (`fast_forward.backbone_input`). A depthwise conv (ir-CSN-152) runs on
    aten's `conv_depthwise3d`, which wants NCDHW: a backbone that has one
    is left as it is."""
    if any(isinstance(m, nn.Conv3d) and m.groups != 1 for m in backbone.modules()):
        return False
    backbone.to(memory_format=torch.channels_last_3d)
    return True


def fit_tensor_cores(backbone: nn.Module, device) -> int:
    """For a folded backbone whose parameters are bf16 or fp16 and that
    runs on CUDA: `pad_widths`, counted as `engine.padded_widths`,
    `temporal_convs_as_2d` and `channels_last`; returns the pairs padded.
    Elsewhere (fp32, the CPU) 0, and the backbone is left as it is."""
    dtype = next(backbone.parameters()).dtype
    if torch.device(device).type != "cuda" or dtype not in (torch.bfloat16, torch.float16):
        return 0
    n = pad_widths(backbone)
    count("engine.padded_widths", n)
    temporal_convs_as_2d(backbone)
    channels_last(backbone)
    return n
