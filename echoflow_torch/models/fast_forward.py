"""Inference fast path: folded forward with the decoder-tail kernel (port of
`echoflow.models.fast_forward`).

`folded_forward` computes what a folded `MotionSegNet` (`R2Plus1DMotionSegNet`
or `CSNMotionSegNet` with `folded=True`) computes
(backbone, same-resolution-merged tap projections, decoder, heads), but
runs the decoder tail through `ops/decoder_heads.decoder_heads`: the CUDA
kernel on the card, its plain version on the CPU. `plain_decoder` is the
twin of echoflow's `_xla_decoder`.
"""

from __future__ import annotations

import torch

from echoflow_torch.ops.decoder_heads import decoder_heads
from echoflow_torch.ops.resize import linear_resize_matrix, resize_linear
from echoflow_torch.utils.profiling import count, span


def merged_projections(taps, comb1_weight: torch.Tensor, dtype=torch.float32):
    """Project each (N, C, T, H, W) tap with its slice of the comb1 weight
    (sum of the taps' C -> 64; the backbone's `tap_channels`) to a
    channels-last (N, T, H, W, 64) projection, and sum projections that
    share a resolution (exact: upsampling is linear). Returns the
    projections ordered by first appearance. A channels-last-3d tap is
    read in place, as a (NTHW, C) matrix."""
    w = comb1_weight.reshape(comb1_weight.shape[0], -1).to(dtype)   # (64, sum of C)
    projs: dict = {}
    offset = 0
    for tap in taps:
        ch = tap.shape[1]
        proj = torch.einsum("ncthw,dc->nthwd", tap.to(dtype), w[:, offset:offset + ch])
        shape = tuple(tap.shape[2:5])
        projs[shape] = proj if shape not in projs else projs[shape] + proj
        offset += ch
    return list(projs.values())


def backbone_input(backbone, video):
    """`video` in the dtype and the memory layout of `backbone`'s stem
    weight: channels-last-3d for a backbone fitted so
    (`fold_bn.channels_last`), one copy a chunk; else as it is."""
    w = backbone.stem[0].weight
    layout = (torch.channels_last_3d if w.is_contiguous(memory_format=torch.channels_last_3d)
              else torch.contiguous_format)
    return video.to(w.dtype, memory_format=layout)


def decoder_weights(model):
    """(b1, w2, b2, ws, bs, wm, bm) as float32 matrices of a folded model."""
    def mat(conv):   # 1x1x1 Conv3d (O, I, 1, 1, 1) -> (I, O)
        return conv.weight.reshape(conv.weight.shape[:2]).t().float().contiguous()

    return (model.comb_1_layer.bias.float(), mat(model.comb_2_layer),
            model.comb_2_layer.bias.float(), mat(model.segmentation_head),
            model.segmentation_head.bias.float(), mat(model.motion_head),
            model.motion_head.bias.float())


def folded_forward(model, video, *, dtype=torch.float32, with_motion=True):
    """video (N, 3, T, H, W) -> (seg (N, 2, T, H, W), motion (N, 4, T, H, W)
    or None), both float32. `model` must be folded; its backbone runs in the
    dtype and layout of its own parameters (the engine casts it once for a
    bf16 backbone; `backbone_input`), the projections in `dtype`, the
    decoder tail in float32. Each of the three runs in a device span
    (`utils/profiling.span`): backbone, projections, decoder_tail. A
    forward whose five taps all come out channels-last-3d counts
    `backbone.channels_last`."""
    if not model.folded:
        raise ValueError("folded_forward needs a folded model (models/fold_bn.py)")
    t, h, w = video.shape[2:]
    backbone = model.backbone
    with span("backbone", device=video.device):
        taps = backbone(backbone_input(backbone, video))
    if all(tap.is_contiguous(memory_format=torch.channels_last_3d) for tap in taps):
        count("backbone.channels_last")
    with span("projections", device=video.device):
        projs = merged_projections(taps, model.comb_1_layer.weight, dtype)
        # The kernel upsamples H/W; the cheap low-resolution T resize runs
        # here. align_corners=True everywhere (reference decoder convention).
        projs = [resize_linear(pr, 1, t, align_corners=True).float().contiguous()
                 for pr in projs]
        args = decoder_weights(model)
    with span("decoder_tail", device=video.device):
        seg, mot = decoder_heads(projs, *args, out_hw=(h, w), with_motion=with_motion)
        seg = seg.permute(0, 4, 1, 2, 3).float()
        if mot is None:
            return seg, None
        return seg, mot.permute(0, 4, 1, 2, 3).float()


def plain_decoder(projs, b1, w2, b2, ws, bs, wm, bm, out_hw, dtype=torch.float32):
    """Twin of echoflow's `_xla_decoder`: T/W resize per group at native
    height, then ONE H contraction over the groups concatenated along H
    (sum_r Hm_r @ A_r == [Hm_1 .. Hm_n] @ [A_1; ..; A_n])."""
    h, w = out_hw
    t = projs[0].shape[1]
    ints, mats = [], []
    for pr in projs:
        pr = resize_linear(pr, 1, t, align_corners=True)
        pr = resize_linear(pr, 3, w, align_corners=True)
        ints.append(pr)
        mats.append(linear_resize_matrix(pr.shape[2], h, True, pr.device, dtype))
    if len(ints) == 1:
        acc = resize_linear(ints[0], 2, h, align_corners=True)
    else:
        acc = torch.einsum("ntswc,hs->nthwc", torch.cat(ints, dim=2), torch.cat(mats, dim=1))
    y = torch.relu(acc + b1.to(dtype))
    y = torch.relu(y @ w2.to(dtype) + b2.to(dtype))
    seg = y @ ws.to(dtype) + bs.to(dtype)
    mot = torch.tanh(y @ wm.to(dtype) + bm.to(dtype))
    return seg, mot
