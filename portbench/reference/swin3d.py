"""Plain CLAS-FV over Video Swin-B: the Video Swin Transformer of Liu et al.
(CVPR 2022, arXiv:2106.13230) as github SwinTransformer/Video-Swin-Transformer
builds it (`mmaction/models/backbones/swin_transformer.py`,
`SwinTransformer3D`, config `swin_base_patch244_window877_kinetics400_1k`),
under CLAS-FV's decoder and heads (`reference/csn.decode`), over a state
dict keyed as the published backbone (`swin3d_model.layers.2.blocks.17.attn
.qkv.weight`, ...) and CLAS-FV's decoder.

- Patch embedding: conv `patch_size`/`patch_size` from 3 to `embed_dim`
  channels (the clip zero-padded at the end to a multiple of the patch),
  LayerNorm: the first tap.
- Stages of `depths` blocks, width `embed_dim` x 2^i, `num_heads` heads.
  A block: x + Proj(WMSA(LN1(x))), then x + FC2(GELU(FC1(LN2(x)))), GELU
  exact (erf), the MLP `mlp_ratio` x wide. WMSA: the tokens, zero-padded
  to a multiple of the window, are rolled back by the shift (half the
  window, every other block), gathered into windows, and in each window
  and head softmax(q k^T / sqrt(d) + bias + mask) v, written out as
  products and a softmax. bias: each head's table at each pair's relative
  position (`relative_index`, a window clipped to N tokens reading the
  full window's [:N, :N] corner, as the published code does); mask: -100
  between tokens that the roll brought from different regions. A
  dimension no larger than the window is one window, not shifted. Then
  the windows go back to their places, the roll is undone, the padding
  cut. Each stage's output before its merging is a tap.
- Merging after every stage but the last: H and W padded to even, the
  2x2 neighbours (0,0), (1,0), (0,1), (1,1) concatenated, LayerNorm,
  Linear without bias.
- A LayerNorm after the last stage: the last tap.
- Stochastic depth: the residual branches of block i (of all, counted
  from 0) keep a sample by `drop_masks` (one (B,) 0/1 tensor a branch,
  attention then MLP, block by block, for the blocks whose rate, linear
  from 0 to `drop_path_rate`, is above 0), divided by 1 - rate; the
  reference draws no masks itself. A configuration's `drop_path_rate` 0
  needs none.

Written apart from the program: windows are gathered and put back through
index tables of token positions computed here, the roll as index
arithmetic, the bias index pair by pair. Plain `torch` calls only.
`precision` is `reference/model.Precision`: its TF32 (the card's switches,
or 10-bit operand rounding on the CPU) and fp8 (operands e4m3 forward,
the output gradient e5m2) apply to every conv, every Linear and both
attention products.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import csn
from portbench.reference.model import Precision, _Fp8Grad, _round_fp8, _round_tf32

BACKBONE = "swin3d_model"
MASKED = -100.0


def _round(prec, *xs):
    """The control's operand rounding of a product's operands."""
    if prec.name == "fp8":
        return [_round_fp8(x) for x in xs]
    if prec.name == "tf32" and not xs[0].is_cuda:
        return [_round_tf32(x) for x in xs]
    return list(xs)


def _out(prec, y):
    return _Fp8Grad.apply(y) if prec.name == "fp8" else y


def linear(prec, x, w, b=None):
    x, w = _round(prec, x, w)
    return _out(prec, F.linear(x, w, b))


def matmul(prec, a, b):
    a, b = _round(prec, a, b)
    return _out(prec, a @ b)


def widths(cfg):
    return [cfg["embed_dim"] * 2 ** i for i in range(len(cfg["depths"]))]


def tap_channels(cfg):
    return [cfg["embed_dim"]] + widths(cfg)


def drop_rates(cfg):
    """Each block's stochastic-depth rate, linear from 0 to the last."""
    return np.linspace(0.0, cfg["drop_path_rate"], sum(cfg["depths"])).tolist()


def state_shapes(cfg) -> dict:
    """Every key of the unfolded state dict and its shape."""
    b, shapes = BACKBONE, {}
    e, pd, ph, pw = cfg["embed_dim"], *cfg["patch_size"]
    shapes[f"{b}.patch_embed.proj.weight"] = (e, cfg["in_channels"], pd, ph, pw)
    shapes[f"{b}.patch_embed.proj.bias"] = (e,)
    shapes[f"{b}.patch_embed.norm.weight"] = shapes[f"{b}.patch_embed.norm.bias"] = (e,)
    rows = math.prod(2 * w - 1 for w in cfg["window_size"])
    for i, (depth, heads, c) in enumerate(zip(cfg["depths"], cfg["num_heads"], widths(cfg))):
        hidden = cfg["mlp_ratio"] * c
        for j in range(depth):
            k = f"{b}.layers.{i}.blocks.{j}"
            for part, shape in (("norm1.weight", (c,)), ("norm1.bias", (c,)),
                                ("attn.relative_position_bias_table", (rows, heads)),
                                ("attn.qkv.weight", (3 * c, c)), ("attn.qkv.bias", (3 * c,)),
                                ("attn.proj.weight", (c, c)), ("attn.proj.bias", (c,)),
                                ("norm2.weight", (c,)), ("norm2.bias", (c,)),
                                ("mlp.fc1.weight", (hidden, c)), ("mlp.fc1.bias", (hidden,)),
                                ("mlp.fc2.weight", (c, hidden)), ("mlp.fc2.bias", (c,))):
                shapes[f"{k}.{part}"] = shape
        if i < len(cfg["depths"]) - 1:
            k = f"{b}.layers.{i}.downsample"
            shapes[f"{k}.reduction.weight"] = (2 * c, 4 * c)
            shapes[f"{k}.norm.weight"] = shapes[f"{k}.norm.bias"] = (4 * c,)
    last = widths(cfg)[-1]
    shapes[f"{b}.norm.weight"] = shapes[f"{b}.norm.bias"] = (last,)
    shapes[f"{b}.fc.weight"] = (cfg["kinetics_classes"], last)
    shapes[f"{b}.fc.bias"] = (cfg["kinetics_classes"],)
    d = cfg["decoder_width"]
    for key, out, inp in (("comb_1_layer", d, sum(tap_channels(cfg))), ("comb_2_layer", d, d),
                          ("motion_head", cfg["motion_channels"], d),
                          ("segmentation_head", cfg["seg_classes"], d)):
        shapes[f"{key}.weight"] = (out, inp, 1, 1, 1)
        shapes[f"{key}.bias"] = (out,)
    for key in ("comb_batch_norm_1", "comb_batch_norm_2"):
        for part in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{key}.{part}"] = (d,)
        shapes[f"{key}.num_batches_tracked"] = ()
    return shapes


def window_and_shift(size, cfg, shifted):
    """The window and shift at token size `size`: a dimension no larger
    than the configured window is one window, unshifted."""
    win, shift = [], []
    for s, w in zip(size, cfg["window_size"]):
        win.append(min(s, w))
        shift.append(w // 2 if shifted and s > w else 0)
    return win, shift


def relative_index(window, n):
    """The bias row of each pair of the first n tokens of a full window."""
    coords = [(a, b, c) for a in range(window[0]) for b in range(window[1])
              for c in range(window[2])][:n]
    span_h, span_w = 2 * window[1] - 1, 2 * window[2] - 1
    return torch.tensor([[(i[0] - j[0] + window[0] - 1) * span_h * span_w
                          + (i[1] - j[1] + window[1] - 1) * span_w + (i[2] - j[2] + window[2] - 1)
                          for j in coords] for i in coords])


def window_tokens(padded, win, shift):
    """(nW, N) flat token positions in the padded grid that each window
    gathers after the roll by -shift: window slot x reads token x + shift."""
    d, h, w = padded
    out = []
    for a in range(0, d, win[0]):
        for b in range(0, h, win[1]):
            for c in range(0, w, win[2]):
                out.append([((a + i + shift[0]) % d) * h * w + ((b + j + shift[1]) % h) * w
                            + (c + k + shift[2]) % w
                            for i in range(win[0]) for j in range(win[1]) for k in range(win[2])])
    return torch.tensor(out)


def _region(pos, size, win, shift):
    """The region of the roll of a position of the rolled grid: 0 before
    size - win, 1 before size - shift, 2 after."""
    return 0 if pos < size - win else (1 if pos < size - shift else 2)


def shift_mask(padded, win, shift):
    """(nW, N, N): -100 where two tokens of a window lie in different
    regions of the roll in some dimension, else 0."""
    labels = []
    d, h, w = padded
    for a in range(0, d, win[0]):
        for b in range(0, h, win[1]):
            for c in range(0, w, win[2]):
                labels.append([(_region(a + i, d, win[0], shift[0]) if shift[0] else 0,
                                _region(b + j, h, win[1], shift[1]) if shift[1] else 0,
                                _region(c + k, w, win[2], shift[2]) if shift[2] else 0)
                               for i in range(win[0]) for j in range(win[1])
                               for k in range(win[2])])
    lab = torch.tensor(labels)                                   # (nW, N, 3)
    differ = (lab[:, :, None, :] != lab[:, None, :, :]).any(-1)
    return torch.where(differ, MASKED, 0.0)


def block(p, key, x, cfg, heads, shifted, rate, masks, train, prec):
    """One Swin block on tokens (B, D, H, W, C)."""
    bsz, size, c = x.shape[0], tuple(x.shape[1:4]), x.shape[-1]
    eps = cfg["layer_norm_eps"]
    win, shift = window_and_shift(size, cfg, shifted)
    padded = [s + (-s % w) for s, w in zip(size, win)]
    y = F.layer_norm(x, (c,), p[f"{key}.norm1.weight"], p[f"{key}.norm1.bias"], eps)
    y = F.pad(y, (0, 0, 0, padded[2] - size[2], 0, padded[1] - size[1], 0, padded[0] - size[0]))
    tokens = window_tokens(padded, win, shift).to(x.device)       # (nW, N)
    nw, n = tokens.shape
    windows = y.reshape(bsz, -1, c)[:, tokens.reshape(-1)].reshape(bsz * nw, n, c)
    qkv = linear(prec, windows, p[f"{key}.attn.qkv.weight"], p[f"{key}.attn.qkv.bias"])
    d = c // heads
    q, k, v = qkv.reshape(bsz * nw, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    attn = matmul(prec, q * d ** -0.5, k.transpose(-2, -1))
    table = p[f"{key}.attn.relative_position_bias_table"]
    index = relative_index(cfg["window_size"], n).to(x.device)
    attn = attn + table[index].permute(2, 0, 1)[None]
    if any(shift):
        mask = shift_mask(padded, win, shift).to(device=x.device, dtype=x.dtype)
        attn = (attn.view(bsz, nw, heads, n, n) + mask[None, :, None]).view(-1, heads, n, n)
    out = matmul(prec, torch.softmax(attn, dim=-1), v).transpose(1, 2).reshape(bsz * nw, n, c)
    out = linear(prec, out, p[f"{key}.attn.proj.weight"], p[f"{key}.attn.proj.bias"])
    back = torch.zeros(bsz, math.prod(padded), c, dtype=out.dtype, device=out.device)
    back = back.index_copy(1, tokens.reshape(-1), out.reshape(bsz, nw * n, c))
    y = back.reshape(bsz, *padded, c)[:, :size[0], :size[1], :size[2]]
    x = x + _drop(y, rate, masks, train)
    y = F.layer_norm(x, (c,), p[f"{key}.norm2.weight"], p[f"{key}.norm2.bias"], eps)
    y = F.gelu(linear(prec, y, p[f"{key}.mlp.fc1.weight"], p[f"{key}.mlp.fc1.bias"]))
    y = linear(prec, y, p[f"{key}.mlp.fc2.weight"], p[f"{key}.mlp.fc2.bias"])
    return x + _drop(y, rate, masks, train)


def _drop(y, rate, masks, train):
    if not train or rate == 0.0:
        return y
    if masks is None:
        raise ValueError("stochastic depth above 0 needs the branches' masks (drop_masks)")
    keep = next(masks).to(device=y.device, dtype=y.dtype).view(-1, 1, 1, 1, 1)
    return y / (1.0 - rate) * keep


def merge(p, key, x, cfg, prec):
    """Patch merging of tokens (B, D, H, W, C) as the published code does."""
    h, w = x.shape[2:4]
    if h % 2 or w % 2:
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
    x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2], x[:, :, 0::2, 1::2],
                   x[:, :, 1::2, 1::2]], -1)
    x = F.layer_norm(x, (x.shape[-1],), p[f"{key}.norm.weight"], p[f"{key}.norm.bias"],
                     cfg["layer_norm_eps"])
    return linear(prec, x, p[f"{key}.reduction.weight"])


def backbone_taps(p, video, cfg, train=False, precision=None, drop_masks=None):
    """The five taps (N, C, T, H, W): the patch embedding's, then each
    stage's output before its merging, the last after the final norm."""
    prec = precision or Precision()
    b, eps = BACKBONE, cfg["layer_norm_eps"]
    patch = cfg["patch_size"]
    pads = [-s % q for s, q in zip(video.shape[2:], patch)]
    video = F.pad(video, (0, pads[2], 0, pads[1], 0, pads[0]))
    w_embed, = _round(prec, p[f"{b}.patch_embed.proj.weight"])
    x = F.conv3d(*_round(prec, video), w_embed, p[f"{b}.patch_embed.proj.bias"], patch)
    x = _out(prec, x).permute(0, 2, 3, 4, 1)
    x = F.layer_norm(x, (x.shape[-1],), p[f"{b}.patch_embed.norm.weight"],
                     p[f"{b}.patch_embed.norm.bias"], eps)
    taps = [x]
    rates = iter(drop_rates(cfg))
    masks = iter(drop_masks) if drop_masks is not None else None
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        for j in range(depth):
            x = block(p, f"{b}.layers.{i}.blocks.{j}", x, cfg, heads, j % 2 == 1, next(rates),
                      masks, train, prec)
        if i == len(cfg["depths"]) - 1:
            x = F.layer_norm(x, (x.shape[-1],), p[f"{b}.norm.weight"], p[f"{b}.norm.bias"], eps)
            taps.append(x)
        else:
            taps.append(x)
            x = merge(p, f"{b}.layers.{i}.downsample", x, cfg, prec)
    return [t.permute(0, 4, 1, 2, 3) for t in taps]


def forward(p, video, cfg, train=False, precision=None, with_motion=True, drop_masks=None):
    """video (N, 3, T, H, W) float32 -> (seg logits (N, 2, T, H, W), motion
    (N, 4, T, H, W) or None)."""
    taps = backbone_taps(p, video, cfg, train, precision, drop_masks)
    return csn.decode(p, taps, tuple(video.shape[2:]), cfg, train, precision, with_motion)
