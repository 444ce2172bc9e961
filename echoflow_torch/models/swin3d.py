"""Video Swin-B under CLAS-FV's decoder: the Video Swin Transformer of Liu,
Ning, Cao, Wei, Zhang, Lin and Hu (CVPR 2022, arXiv:2106.13230) as
SwinTransformer/Video-Swin-Transformer builds it
(`mmaction/models/backbones/swin_transformer.py`, `SwinTransformer3D`;
config `swin_base_patch244_window877_kinetics400_1k`), in place of
R(2+1)D-18.

- Patch embedding: Conv3d(3 -> 128, (2,4,4), stride (2,4,4)) on the clip
  (zero-padded at the end of each dimension to a multiple of the patch),
  then LayerNorm: tap 0.
- Four stages of 2, 2, 18 and 2 blocks at widths 128, 256, 512, 1024 and
  4, 8, 16, 32 heads of 32 channels. A block, on tokens (B, D, H, W, C):

      x = x + DropPath(Proj(WMSA(LN1(x))))
      x = x + DropPath(FC2(GELU(FC1(LN2(x)))))

  WMSA (`ops/attention.window_attention`) attends within windows of
  (8, 7, 7) tokens; in every other block the tokens are first rolled by
  -shift (4, 3, 3) and the pairs that the roll brought together from
  different regions take -100 (the mask). A dimension no larger than the
  window is one window and is not shifted; a dimension that the window
  does not divide is zero-padded after LN1 and cropped after the reverse.
  Each head adds its relative-position bias, a learned table of
  (2*8-1)(2*7-1)(2*7-1) = 2535 rows, at each pair's row of the full
  window's index; a window clipped to N tokens takes the index's
  [:N, :N] corner, as the published code slices it. The MLP widens 4x with
  the exact (erf) GELU. Each stage's output before its merging is a tap.
- Patch merging after stages 1-3: odd H or W zero-padded by one, each 2x2
  spatial neighbourhood's four tokens concatenated (4C), LayerNorm,
  Linear(4C -> 2C, no bias).
- A final LayerNorm after stage 4: tap 4. Taps: 128 + 128 + 256 + 512 +
  1024 = 2048 channels into comb1.
- Stochastic depth at the published linear schedule (0 at the first block
  to `drop_path_rate` at the last): each residual branch of a training
  forward keeps a sample with probability 1 - p, scaled by 1 / (1 - p),
  drawn by `torch.rand((B,), generator=...)` from the backbone's
  `generator` (the train state's, `train/loop.create_train_state`; the
  default generator if none), attention branch then MLP branch, block by
  block. A block with p = 0 draws nothing.
- The unused 400-way Kinetics head (`fc`), for parameter-count parity.

The roll with the window partition, and the window reverse with the
unroll, are one autograd function each (`_Windows`, `_Unwindows`: each is
the other's backward), and so is the merging's pad and gather
(`_Merge`), all in the device span `swin.windows`. The relative-position
index, each bias row's positions and the masks are device constants
(`utils/device.device_constant`), made at a step's warm-up, before any
capture. The patch embedding goes through `ops/conv.convolution`.

State-dict keys are the published backbone's (`patch_embed.proj`,
`layers.2.blocks.17.attn.relative_position_bias_table`,
`layers.0.downsample.reduction`, `norm`) under `swin3d_model.`, and the
decoder's are CLAS-FV's. The backbone has no BatchNorm: folding
(`models/fold_bn.py`) folds the decoder's alone, and `init_backbone` draws
the published init (trunc-normal 0.02 Linears and bias tables, identity
LayerNorms, the patch embedding as `nn.Conv3d` inits itself).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from echoflow_torch.models.r2plus1d import Conv3d, MotionSegNet
from echoflow_torch.ops.attention import window_attention
from echoflow_torch.utils.device import device_constant
from echoflow_torch.utils.profiling import span

PATCH = (2, 4, 4)
EMBED_DIM = 128
DEPTHS = (2, 2, 18, 2)
HEADS = (4, 8, 16, 32)
WINDOW = (8, 7, 7)
MLP_RATIO = 4
# The published Kinetics-400 config's stochastic depth.
DROP_PATH_RATE = 0.3
MASKED = -100.0


def clipped(size, window, shift):
    """The window and shift used at token size `size` (D, H, W): a
    dimension no larger than the window is one window and is not shifted
    (the published `get_window_size`)."""
    win = tuple(min(s, w) for s, w in zip(size, window))
    return win, tuple(0 if s <= w else sh for s, w, sh in zip(size, window, shift))


def relative_index(window) -> np.ndarray:
    """The published relative-position index (N x N) of a full window of
    N = prod(window) tokens, into a table of prod(2w - 1) rows."""
    coords = np.stack(np.meshgrid(*[np.arange(w) for w in window], indexing="ij")).reshape(3, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) + (np.array(window) - 1)
    wd, wh, ww = (2 * np.array(window) - 1)
    return rel[..., 0] * wh * ww + rel[..., 1] * ww + rel[..., 2]


@device_constant(maxsize=16)
def bias_indices(window, n: int, device):
    """(index, rows) of a window clipped to `n` tokens, on `device`: the
    [:n, :n] corner of `relative_index(window)` flattened, and for each
    table row the flat positions that read it, padded with n x n (a
    position that reads zero) to the longest row's count
    (`ops/attention.table_grad`)."""
    index = relative_index(window)[:n, :n].reshape(-1)
    order = np.argsort(index, kind="stable")
    counts = np.bincount(index, minlength=math.prod(2 * w - 1 for w in window))
    rows = np.full((len(counts), max(int(counts.max()), 1)), n * n, np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for r in np.flatnonzero(counts):
        rows[r, :counts[r]] = order[starts[r]:starts[r] + counts[r]]
    return (torch.from_numpy(index.astype(np.int64)).to(device),
            torch.from_numpy(rows).to(device))


@device_constant(maxsize=16)
def shift_mask(size, window, shift, device, dtype):
    """The published mask (nW, N, N) of the shifted windows over padded
    token size `size`: each token labelled by its region of the roll in
    each dimension, pairs of different labels -100, others 0."""
    label = np.zeros(size, np.int64)
    cnt = 0
    regions = [(slice(-w), slice(-w, -s), slice(-s, None)) for w, s in zip(window, shift)]
    for d in regions[0]:
        for h in regions[1]:
            for w in regions[2]:
                label[d, h, w] = cnt
                cnt += 1
    wins = _partition_np(label, window)
    mask = np.where(wins[:, None, :] != wins[:, :, None], MASKED, 0.0)
    return torch.from_numpy(mask).to(device=device, dtype=dtype)


def _partition_np(x: np.ndarray, window) -> np.ndarray:
    (d, h, w), (a, b, c) = x.shape, window
    x = x.reshape(d // a, a, h // b, b, w // c, c).transpose(0, 2, 4, 1, 3, 5)
    return x.reshape(-1, a * b * c)


def _pads(size, window):
    return tuple(-s % w for s, w in zip(size, window))


def partition(x, window, shift):
    """Tokens (B, D, H, W, C) -> windows (B x nW, N, C): zero-padded to a
    multiple of the window, rolled by -shift, cut into windows."""
    pads = _pads(x.shape[1:4], window)
    if any(pads):
        x = F.pad(x, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
    if any(shift):
        x = torch.roll(x, [-s for s in shift], dims=(1, 2, 3))
    b, d, h, w, c = x.shape
    (p, q, r) = window
    x = x.view(b, d // p, p, h // q, q, w // r, r, c).permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(-1, p * q * r, c)


def reverse(windows, window, shift, size):
    """`partition`'s inverse: windows -> tokens (B, D, H, W, C) of `size`
    (D, H, W)."""
    padded = [s + p for s, p in zip(size, _pads(size, window))]
    (p, q, r), c = window, windows.shape[-1]
    x = windows.view(-1, padded[0] // p, padded[1] // q, padded[2] // r, p, q, r, c)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(-1, *padded, c)
    if any(shift):
        x = torch.roll(x, list(shift), dims=(1, 2, 3))
    return x[:, :size[0], :size[1], :size[2]].contiguous()


class _Windows(torch.autograd.Function):
    """`partition`, whose backward is `reverse`; both in `swin.windows`."""

    @staticmethod
    def forward(ctx, x, window, shift):
        ctx.conf = (window, shift, tuple(x.shape[1:4]))
        with span("swin.windows", device=x.device):
            return partition(x, window, shift)

    @staticmethod
    def backward(ctx, dy):
        with span("swin.windows", device=dy.device):
            return reverse(dy, *ctx.conf), None, None


class _Unwindows(torch.autograd.Function):
    """`reverse`, whose backward is `partition`; both in `swin.windows`."""

    @staticmethod
    def forward(ctx, windows, window, shift, size):
        ctx.conf = (window, shift)
        with span("swin.windows", device=windows.device):
            return reverse(windows, window, shift, size)

    @staticmethod
    def backward(ctx, dy):
        with span("swin.windows", device=dy.device):
            return partition(dy, *ctx.conf), None, None, None


def merge_gather(x):
    """(B, D, H, W, C) -> (B, D, ceil(H/2), ceil(W/2), 4C): H and W padded
    to even, each 2x2 neighbourhood's tokens concatenated in the published
    order (rows then columns: (0,0), (1,0), (0,1), (1,1))."""
    b, d, h, w, c = x.shape
    if h % 2 or w % 2:
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
    x = x.view(b, d, (h + 1) // 2, 2, (w + 1) // 2, 2, c).permute(0, 1, 2, 4, 5, 3, 6)
    return x.reshape(b, d, (h + 1) // 2, (w + 1) // 2, 4 * c)


def merge_scatter(y, size):
    """`merge_gather`'s adjoint: (B, D, H', W', 4C) -> (B, D, H, W, C) of
    `size` (H, W), the padding dropped."""
    b, d, hh, ww, c4 = y.shape
    x = y.view(b, d, hh, ww, 2, 2, c4 // 4).permute(0, 1, 2, 5, 3, 4, 6)
    x = x.reshape(b, d, 2 * hh, 2 * ww, c4 // 4)
    return x[:, :, :size[0], :size[1]].contiguous()


class _Merge(torch.autograd.Function):
    """`merge_gather`, whose backward is `merge_scatter`; both in
    `swin.windows`."""

    @staticmethod
    def forward(ctx, x):
        ctx.size = tuple(x.shape[2:4])
        with span("swin.windows", device=x.device):
            return merge_gather(x)

    @staticmethod
    def backward(ctx, dy):
        with span("swin.windows", device=dy.device):
            return merge_scatter(dy, ctx.size)


def drop_path(x, p: float, training: bool, generator):
    """Stochastic depth of a residual branch (module docstring)."""
    if p == 0.0 or not training:
        return x
    keep = 1.0 - p
    draw = torch.rand((x.shape[0],), generator=generator, device=x.device, dtype=x.dtype)
    mask = (keep + draw).floor_().view(-1, *([1] * (x.dim() - 1)))
    return x.div(keep) * mask


class WindowAttention3D(nn.Module):
    """qkv (with bias), the attention core of `ops/attention`, proj; the
    relative-position bias table of its heads."""

    def __init__(self, dim: int, heads: int, window=WINDOW):
        super().__init__()
        self.heads, self.window = heads, tuple(window)
        rows = math.prod(2 * w - 1 for w in window)
        self.relative_position_bias_table = nn.Parameter(torch.zeros(rows, heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, windows, mask):
        n = windows.shape[1]
        index, rows = bias_indices(self.window, n, windows.device)
        table = self.relative_position_bias_table.to(windows.dtype)
        out = window_attention(self.qkv(windows), table, self.heads, index, rows, mask)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock3D(nn.Module):
    """A Swin block (module docstring); `shifted` blocks roll by half the
    window."""

    def __init__(self, dim: int, heads: int, window=WINDOW, shifted: bool = False,
                 drop_path: float = 0.0):
        super().__init__()
        self.window = tuple(window)
        self.shift = tuple(w // 2 for w in window) if shifted else (0, 0, 0)
        self.drop_path = drop_path
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention3D(dim, heads, window)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, MLP_RATIO * dim)

    def forward(self, x, generator=None):
        size = tuple(x.shape[1:4])
        window, shift = clipped(size, self.window, self.shift)
        mask = None
        if any(shift):
            padded = tuple(s + p for s, p in zip(size, _pads(size, window)))
            mask = shift_mask(padded, window, shift, x.device, x.dtype)
        windows = _Windows.apply(self.norm1(x), window, shift)
        y = _Unwindows.apply(self.attn(windows, mask), window, shift, size)
        x = x + drop_path(y, self.drop_path, self.training, generator)
        return x + drop_path(self.mlp(self.norm2(x)), self.drop_path, self.training, generator)


class PatchMerging(nn.Module):
    """2x2 spatial merging (module docstring)."""

    def __init__(self, dim: int):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(4 * dim)

    def forward(self, x):
        return self.reduction(self.norm(_Merge.apply(x)))


class BasicLayer(nn.Module):
    """One stage: its blocks (every other one shifted) and the merging
    after it (None after the last)."""

    def __init__(self, dim, depth, heads, window, drop_paths, downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock3D(dim, heads, window, shifted=i % 2 == 1, drop_path=drop_paths[i])
            for i in range(depth))
        self.downsample = PatchMerging(dim) if downsample else None


class PatchEmbed3D(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = Conv3d(3, dim, PATCH, PATCH)
        self.norm = nn.LayerNorm(dim)

    def forward(self, video):
        pads = _pads(video.shape[2:], PATCH)
        if any(pads):
            video = F.pad(video, (0, pads[2], 0, pads[1], 0, pads[0]))
        return self.norm(self.proj(video).permute(0, 2, 3, 4, 1))


class SwinBackbone3D(nn.Module):
    """Patch embedding, four stages, the final LayerNorm (+ the unused
    Kinetics head); `forward` returns the five taps (N, C, T, H, W), views
    of channels-last tokens. `depths`, `heads`, `embed_dim` and `window`
    are Swin-B's by default; the tests build smaller ones."""

    generator = None     # stochastic depth's draws (module docstring)

    def __init__(self, embed_dim: int = EMBED_DIM, depths=DEPTHS, heads=HEADS, window=WINDOW,
                 drop_path_rate: float = DROP_PATH_RATE):
        super().__init__()
        self.patch_embed = PatchEmbed3D(embed_dim)
        rates = np.linspace(0.0, drop_path_rate, sum(depths)).tolist()
        self.layers = nn.ModuleList()
        for i, (depth, h) in enumerate(zip(depths, heads)):
            start = sum(depths[:i])
            self.layers.append(BasicLayer(embed_dim * 2 ** i, depth, h, window,
                                          rates[start:start + depth], i < len(depths) - 1))
        width = embed_dim * 2 ** (len(depths) - 1)
        self.norm = nn.LayerNorm(width)
        self.tap_channels = (embed_dim, *(embed_dim * 2 ** i for i in range(len(depths))))
        self.fc = nn.Linear(width, 400)  # unused; checkpoint/param-count parity

    def forward(self, video):
        x = self.patch_embed(video)
        taps = [x]
        for i, layer in enumerate(self.layers):
            for block in layer.blocks:
                x = block(x, self.generator)
            if layer.downsample is None:
                x = self.norm(x)
            taps.append(x)
            if layer.downsample is not None:
                x = layer.downsample(x)
        return [tap.permute(0, 4, 1, 2, 3) for tap in taps]


def fold_pairs(state_dict) -> list:
    """[(conv prefix, its BatchNorm's prefix, eps)]: the decoder's comb1 and
    comb2, the network's only BatchNorms; every other entry passes through
    (`models/fold_bn.fold_state_dict`)."""
    return [("comb_1_layer", "comb_batch_norm_1", 1e-5),
            ("comb_2_layer", "comb_batch_norm_2", 1e-5)]


@torch.no_grad()
def init_backbone(backbone: SwinBackbone3D, generator: torch.Generator):
    """The published init, drawn from `generator` (a CPU generator) in
    module order: each Linear's weight and each bias table trunc-normal
    with std 0.02 (timm's `trunc_normal_`, cut at +-2: a normal in effect),
    Linear biases 0, LayerNorms the identity; the patch embedding's conv
    as `nn.Conv3d.reset_parameters` (uniform on +-1/sqrt(fan_in), its bias
    too); the Kinetics head 0 (unused)."""
    def trunc_normal_(p):
        p.copy_((torch.randn(p.shape, generator=generator) * 0.02).clamp_(-2.0, 2.0))

    for mod in backbone.modules():
        if isinstance(mod, nn.Conv3d):
            bound = 1.0 / math.sqrt(mod.weight[0].numel())
            for p in (mod.weight, mod.bias):
                p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * bound)
        elif isinstance(mod, WindowAttention3D):
            trunc_normal_(mod.relative_position_bias_table)
        elif isinstance(mod, nn.Linear):
            trunc_normal_(mod.weight)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.reset_parameters()
    backbone.fc.weight.zero_()
    backbone.fc.bias.zero_()


class SwinMotionSegNet(MotionSegNet):
    """CLAS-FV's decoder and heads over Video Swin-B (`MotionSegNet`):
    comb1 reads the taps' 2048 channels. `drop_path_rate` is the
    stochastic depth of the last block (the published 0.3 by default)."""

    name, backbone_attr, title, kinetics_init = "swin3d_b", "swin3d_model", "Video Swin-B", False
    sixteen_bit = False
    fold_pairs = staticmethod(fold_pairs)

    def __init__(self, folded: bool = False, embed_dim: int = EMBED_DIM, depths=DEPTHS,
                 heads=HEADS, window=WINDOW, drop_path_rate: float = DROP_PATH_RATE):
        super().__init__()
        self.swin3d_model = SwinBackbone3D(embed_dim, depths, heads, window, drop_path_rate)
        self._add_decoder(folded)

    @property
    def draws(self) -> bool:
        """Whether the training forward draws stochastic depth's masks."""
        return any(block.drop_path > 0 for layer in self.swin3d_model.layers
                   for block in layer.blocks)

    def init_backbone(self, generator: torch.Generator):
        init_backbone(self.swin3d_model, generator)

    @property
    def generator(self):
        return self.swin3d_model.generator

    @generator.setter
    def generator(self, generator):
        self.swin3d_model.generator = generator
