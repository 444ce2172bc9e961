"""R(2+1)D-18 MotionNet: joint segmentation + bidirectional motion heads
(port of `echoflow.models.r2plus1d`).

The reference architecture (src/model/R2plus1D_18_MotionNet.py:10-71): a
torchvision-topology r2plus1d_18 video backbone whose stem/layer1..4 feature
maps are upsampled to input resolution (trilinear, align_corners=True),
combined by two 1x1x1 conv+BN+ReLU blocks (1024->64->64), and split into a
2-channel segmentation head and a tanh-bounded 4-channel motion head.

Module and parameter names are the reference's own state-dict keys
(`r2plus1d_model.stem.0.weight`, `r2plus1d_model.layer1.0.conv1.0.0.weight`,
`comb_1_layer.weight`, ...), so a reference `.pth` loads once its
DataParallel `module.` prefix is stripped (`models/convert.py`). The unused
400-way Kinetics fc is carried, which makes the parameter count exactly the
reference's 31,575,731.

With `folded=True` every BatchNorm is an `nn.Identity` and the conv before
it has a bias (`models/fold_bn.py` writes both); the sequential indices
stay those of the reference, so a folded state dict keeps its key names.

Mixed precision is flax's rule, as echoflow's model applies it with
`dtype=bfloat16` (`compute_dtype` here): the parameters stay fp32; each
conv and projection casts its input, weight and bias to the compute dtype
and returns it, as do the interpolation matrices and the comb1 bias;
BatchNorm reduces and normalizes in fp32 and returns the compute dtype,
with fp32 running statistics; `tanh` runs on the compute-dtype motion; the
outputs are cast to `output_dtype` (fp32) at the end.

The decoder never materializes the 1024-channel concat: 1x1x1 convolution
and trilinear upsampling are both linear, so comb1(concat_i(up(f_i))) ==
sum_i up(f_i @ W_i) + b. Each tap is projected to 64 channels at its native
resolution, projections that share a resolution are summed first
(`fast_forward.merged_projections`), and only then upsampled.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from echoflow_torch.models.convert import _key_plan
from echoflow_torch.models.fast_forward import merged_projections
from echoflow_torch.ops import conv as conv_ops
from echoflow_torch.ops.resize import trilinear_resize

BN_EPS = 1e-5


def _stat_dtype(x: torch.Tensor) -> torch.dtype:
    """BatchNorm's reduction dtype: at least fp32 (flax's
    `force_float32_reductions`), float64 for a float64 input."""
    return torch.promote_types(x.dtype, torch.float32)


def midplanes(in_ch: int, out_ch: int) -> int:
    """torchvision's (2+1)D midplanes rule, computed once per block."""
    return (in_ch * out_ch * 3 * 3 * 3) // (in_ch * 3 * 3 + 3 * out_ch)


class _GlobalBatchNorm(torch.autograd.Function):
    """Training-mode BatchNorm over the global batch of a process group.

    Forward: each rank's per-channel count, mean and biased variance
    (`torch.var_mean`), gathered and combined in float64 (Chan's parallel
    formula), one collective; the output from those statistics. Backward:
    the fused BatchNorm gradient
    dx = w / sigma * (dy - sum(dy) / N - x_hat * sum(dy * x_hat) / N), the
    two sums accumulated in float64 and all-reduced, one collective; the
    weight and bias get this rank's part (`parallel.average_gradients`
    averages the ranks'). The sums in float64 keep the cancellation in dx
    accurate: the same step through autograd of the fp32 formula was 25x
    further from float64.
    A bf16 input is reduced and normalized in fp32 (`_stat_dtype`), as in
    one process, and its output and dx are bf16."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        import torch.distributed as dist

        dims, stat = (0, 2, 3, 4), _stat_dtype(x)
        var, mean = torch.var_mean(x.to(stat), dim=dims, unbiased=False)
        count = torch.full((1,), x.numel() // x.shape[1], dtype=torch.float64,
                           device=x.device)
        local = torch.cat([count, mean.double(), var.double()])
        parts = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, local, group=group)
        parts = torch.stack(parts)                        # (W, 1 + 2C)
        c = x.shape[1]
        counts, means, vars_ = parts[:, :1], parts[:, 1:1 + c], parts[:, 1 + c:]
        n = counts.sum()
        g_mean = (counts * means).sum(0) / n
        g_var = (counts * (vars_ + (means - g_mean) ** 2)).sum(0) / n
        mean, var = g_mean.to(stat), g_var.to(stat)
        invstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.group, ctx.count = group, n
        ctx.mark_non_differentiable(mean, var)
        return F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        import torch.distributed as dist

        x, weight, mean, invstd = ctx.saved_tensors
        dims, shape = (0, 2, 3, 4), (1, -1, 1, 1, 1)
        x_hat = (x - mean.reshape(shape)) * invstd.reshape(shape)
        local = torch.cat([dy.sum(dim=dims, dtype=torch.float64),
                           (dy * x_hat).sum(dim=dims, dtype=torch.float64)])
        sums = local.clone()
        dist.all_reduce(sums, group=ctx.group)
        c = x.shape[1]
        mean_dy = (sums[:c] / ctx.count).to(mean.dtype).reshape(shape)
        mean_dy_xhat = (sums[c:] / ctx.count).to(mean.dtype).reshape(shape)
        dx = (weight * invstd).reshape(shape) * (dy - mean_dy - x_hat * mean_dy_xhat)
        return (dx.to(x.dtype), local[c:].to(weight.dtype), local[:c].to(weight.dtype),
                None, None)


class BatchNorm3d(nn.BatchNorm3d):
    """`nn.BatchNorm3d` with flax's running-variance update, and global
    statistics under a process group.

    In training mode it normalizes with the batch mean and the biased batch
    variance, as both frameworks do, and moves the running statistics by
    `momentum` 0.1 (flax momentum 0.9) toward the batch mean and the
    *biased* batch variance, as flax does. torch's own module updates
    `running_var` with the unbiased variance, n/(n-1) larger, which at the
    deep layers' small n (8 values per channel at layer4 for a
    (2, 3, 8, 32, 32) batch) is 8/7. Eval mode is torch's.

    With `process_group` set (`sync_batchnorm`), training mode takes the
    mean and biased variance of the whole global batch, as echoflow's
    BatchNorm does on a `data` mesh, with the gradient of the global
    statistics (`_GlobalBatchNorm`). It runs at any group size, one
    included. (`nn.SyncBatchNorm` would update `running_var` with the
    unbiased variance and skip the reduction at world size 1.)

    A bf16 input is normalized in fp32 (`F.batch_norm` of a bf16 input
    with fp32 parameters computes in fp32 and rounds its output once) and
    its statistics are reduced in fp32, as flax's BatchNorm does with
    `dtype=bfloat16`. With `frozen` set (`frozen_running_stats`, during
    a rematerialized forward) the running statistics are not moved."""

    process_group = None
    frozen = False

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        mean = var = None
        if self.process_group is not None:
            y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps,
                                                  self.process_group)
        else:
            y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        if self.frozen:
            return y
        with torch.no_grad():
            if mean is None:
                var, mean = torch.var_mean(x.to(_stat_dtype(x)), dim=(0, 2, 3, 4),
                                           unbiased=False)
            self.running_mean.lerp_(mean.to(self.running_mean.dtype), self.momentum)
            self.running_var.lerp_(var.to(self.running_var.dtype), self.momentum)
            self.num_batches_tracked.add_(1)
        return y


def sync_batchnorm(model: nn.Module, group) -> nn.Module:
    """Set `group` (a torch.distributed process group, or None to go back to
    per-process statistics) on every `BatchNorm3d` of `model`."""
    for mod in model.modules():
        if isinstance(mod, BatchNorm3d):
            mod.process_group = group
    return model


@contextlib.contextmanager
def frozen_running_stats(model: nn.Module):
    """Inside the block no `BatchNorm3d` of `model` moves its running
    statistics or `num_batches_tracked`: the recompute of a rematerialized
    forward (`torch.utils.checkpoint`) sees the batch the first forward
    already counted. Train-mode outputs do not depend on the running
    statistics, so the recompute's values are the first forward's."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm3d)]
    for m in bns:
        m.frozen = True
    try:
        yield
    finally:
        for m in bns:
            m.frozen = False


class Conv3d(nn.Conv3d):
    """`nn.Conv3d` that computes in its input's dtype: the weight and bias
    are cast to it (flax's `promote_dtype` in `nn.Conv`), so fp32
    parameters run a bf16 forward and get fp32 gradients. Its backward
    repeats bit for bit on the card (`ops/conv.convolution`)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return conv_ops.convolution(x, self.weight.to(x.dtype), bias, self.stride, self.padding,
                                    groups=self.groups)


class TemporalConv3d(Conv3d):
    """A `Conv3d` whose kernel, stride and padding act on time alone
    ((k, 1, 1)), computed as a 2D conv over (T, H*W) of a free view of its
    input: the same products, summed over the same terms. The folded 16-bit
    engine backbone's (2+1)D temporal convs run so
    (`fold_bn.temporal_convs_as_2d`): cuDNN 9.2 runs a bf16 (3, 1, 1) conv3d
    at 32 x 56 x 56 on its fp32 fallback, the operands cast both ways, and
    this conv2d on bf16 tensor cores."""

    def forward(self, x):
        n, c, t, h, w = x.shape
        bias = None if self.bias is None else self.bias.to(x.dtype)
        y = conv_ops.convolution(x.reshape(n, c, t, h * w), self.weight.to(x.dtype).flatten(3),
                                 bias, self.stride[:2], self.padding[:2])
        return y.reshape(*y.shape[:3], h, w)


def _bn(ch: int, folded: bool, eps: float = BN_EPS, momentum: float = 0.1) -> nn.Module:
    # torch momentum 0.1 is flax momentum 0.9 (running-stat update weight).
    return nn.Identity() if folded else BatchNorm3d(ch, eps=eps, momentum=momentum)


def _conv2plus1d(cin, cout, mid, stride, folded):
    """spatial (1,3,3) -> BN -> ReLU -> temporal (3,1,1); indices 0, 1, 3
    as torchvision's Conv2Plus1D."""
    return nn.Sequential(
        Conv3d(cin, mid, (1, 3, 3), (1, stride, stride), (0, 1, 1), bias=folded),
        _bn(mid, folded),
        nn.ReLU(inplace=True),
        Conv3d(mid, cout, (3, 1, 1), (stride, 1, 1), (1, 0, 0), bias=folded),
    )


class BasicBlock(nn.Module):
    """Residual block of two (2+1)D convs (torchvision VideoResNet
    BasicBlock with the Conv2Plus1D builder)."""

    def __init__(self, cin: int, cout: int, stride: int = 1, folded: bool = False):
        super().__init__()
        mid = midplanes(cin, cout)
        self.conv1 = nn.Sequential(_conv2plus1d(cin, cout, mid, stride, folded),
                                   _bn(cout, folded), nn.ReLU(inplace=True))
        self.conv2 = nn.Sequential(_conv2plus1d(cout, cout, mid, 1, folded),
                                   _bn(cout, folded))
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                Conv3d(cin, cout, 1, (stride,) * 3, bias=folded), _bn(cout, folded))
        self.relu = nn.ReLU(inplace=True)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        return self.relu(self.conv2(self.conv1(x)) + identity)


class R2Plus1DBackbone(nn.Module):
    """Stem + 4 stages (+ the unused Kinetics fc); `forward` returns the
    five tap feature maps, each (N, C, T, H, W), of `tap_channels`."""

    tap_channels = (64, 64, 128, 256, 512)

    def __init__(self, folded: bool = False):
        super().__init__()
        self.stem = nn.Sequential(
            Conv3d(3, 45, (1, 7, 7), (1, 2, 2), (0, 3, 3), bias=folded),
            _bn(45, folded), nn.ReLU(inplace=True),
            Conv3d(45, 64, (3, 1, 1), 1, (1, 0, 0), bias=folded),
            _bn(64, folded), nn.ReLU(inplace=True),
        )
        plan = [(64, 64, 1), (64, 128, 2), (128, 256, 2), (256, 512, 2)]
        for i, (cin, cout, stride) in enumerate(plan, start=1):
            setattr(self, f"layer{i}", nn.Sequential(
                BasicBlock(cin, cout, stride, folded), BasicBlock(cout, cout, 1, folded)))
        self.fc = nn.Linear(512, 400)  # unused; checkpoint/param-count parity

    def forward(self, x):
        x = self.stem(x)
        taps = [x]
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
            taps.append(x)
        return taps


class MotionSegNet(nn.Module):
    """CLAS-FV's decoder and heads over a backbone's taps. Public contract
    matches the reference:

        seg, motion = model(video)
        video (N, 3, T, H, W) float; seg (N, 2, T, H, W) float32;
        motion (N, 4, T, H, W) float32, tanh-bounded.

    A subclass (an entry of `backbones()` by its `name`) holds its backbone
    (whose forward returns the taps, of widths `tap_channels`) as
    `backbone_attr`, which prefixes its keys in a state dict, then calls
    `_add_decoder`: comb1 reads the taps' widths summed. It also states its
    `title`, its (conv, BatchNorm) `fold_pairs(state_dict)`
    (`models/fold_bn.py`) and whether a torchvision Kinetics-400 checkpoint
    can initialise it (`kinetics_init`, `models/convert.py`). A backbone
    with its own init rule has an `init_backbone(generator)` method
    (`init_weights`); one that runs in fp32 alone (no 16-bit engine
    backbone, no bf16 train step) states `sixteen_bit = False`
    (`infer/model.inference_model`, `train/loop.create_train_state`), and one
    whose training forward draws random numbers reads them from
    `generator` (the train state's).

    The forward computes in `compute_dtype`, or, when that is None, in the
    dtype of the module's parameters. `compute_dtype=torch.bfloat16` on
    fp32 parameters is echoflow's `dtype=bfloat16` model (see the module
    docstring), the bf16 training forward. The outputs are `output_dtype`,
    float32 as the reference's and echoflow's; the parity tests of data
    parallelism set it to float64 on a float64 module, so its whole train
    step runs in float64. It is also the training forward (autograd,
    train-mode BatchNorm); the decoder-tail kernel has no backward and
    serves inference only, as in echoflow.
    """

    output_dtype = torch.float32
    compute_dtype = None
    sixteen_bit = True
    generator = None
    draws = False       # whether the training forward draws from `generator`

    @property
    def backbone(self):
        return getattr(self, self.backbone_attr)

    def _add_decoder(self, folded: bool):
        self.folded = folded
        self.comb_1_layer = Conv3d(sum(self.backbone.tap_channels), 64, 1)
        self.comb_batch_norm_1 = _bn(64, folded)
        self.comb_2_layer = Conv3d(64, 64, 1)
        self.comb_batch_norm_2 = _bn(64, folded)
        self.motion_head = Conv3d(64, 4, 1)
        self.segmentation_head = Conv3d(64, 2, 1)

    def forward(self, video):
        t, h, w = video.shape[2:]
        dtype = self.compute_dtype or self.comb_1_layer.weight.dtype
        taps = self.backbone(video.to(dtype))
        acc = None
        for proj in merged_projections(taps, self.comb_1_layer.weight, dtype):
            up = trilinear_resize(proj, (t, h, w), align_corners=True, axes=(1, 2, 3))
            acc = up if acc is None else acc + up
        # Channels-last (N, T, H, W, 64) -> (N, 64, T, H, W) for the BNs.
        y = (acc + self.comb_1_layer.bias.to(dtype)).permute(0, 4, 1, 2, 3)
        y = torch.relu(self.comb_batch_norm_1(y))
        y = torch.relu(self.comb_batch_norm_2(self.comb_2_layer(y)))
        seg = self.segmentation_head(y)
        motion = torch.tanh(self.motion_head(y))
        return seg.to(self.output_dtype), motion.to(self.output_dtype)


class R2Plus1DMotionSegNet(MotionSegNet):
    """CLAS-FV: the decoder and heads over R(2+1)D-18 (`MotionSegNet`)."""

    name, backbone_attr, title, kinetics_init = "r2plus1d_18", "r2plus1d_model", "R2+1D", True

    def __init__(self, folded: bool = False):
        super().__init__()
        self.r2plus1d_model = R2Plus1DBackbone(folded)
        self._add_decoder(folded)

    @staticmethod
    def fold_pairs(state_dict) -> list:
        """[(layer prefix, its BatchNorm's prefix or None, eps)] of every
        layer but the BatchNorms, in `convert._key_plan`'s order (the same
        for every state dict)."""
        plan = _key_plan()
        return [(prefix, nxt[0] if nxt[1] == "bn" else None, BN_EPS)
                for (prefix, kind, _), nxt in zip(plan, plan[1:] + [(None, None, None)])
                if kind != "bn"]


@torch.no_grad()
def init_weights(model: MotionSegNet, generator: torch.Generator) -> MotionSegNet:
    """The reference's initialization, drawn from `generator` (a CPU
    generator, so a seed gives the same weights on every machine):
    Kaiming-normal fan_out for every conv (out channels x kernel volume,
    as torch counts it for a grouped conv too), the motion head
    N(0, sqrt(1e-5)), comb1 uniform with variance 1/(3 fan_in) and zero
    bias, BNs identity, the unused fc zero. A net with `init_backbone`
    (Video Swin-B) draws its backbone by that rule first, and the rule
    above covers its decoder."""
    def normal_(p, std):
        p.copy_(torch.randn(p.shape, generator=generator) * std)

    own = getattr(model, "init_backbone", None)
    skip = set()
    if own is not None:
        own(generator)
        skip = set(model.backbone.modules())
    for mod in model.modules():
        if mod in skip:
            continue
        if isinstance(mod, nn.Conv3d):
            fan_out = mod.out_channels * math.prod(mod.kernel_size)
            normal_(mod.weight, math.sqrt(2.0 / fan_out))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.BatchNorm3d):
            mod.reset_parameters()
    bound = 1.0 / math.sqrt(model.comb_1_layer.in_channels)
    model.comb_1_layer.weight.copy_(
        (torch.rand(model.comb_1_layer.weight.shape, generator=generator) * 2 - 1) * bound)
    normal_(model.motion_head.weight, math.sqrt(1e-5))
    model.backbone.fc.weight.zero_()
    model.backbone.fc.bias.zero_()
    return model


def backbones() -> dict:
    """The backbones, by name: each one's net class (`MotionSegNet`), which
    states its facts. R(2+1)D-18 first, as CLAS-FV publishes it."""
    from echoflow_torch.models.csn import CSNMotionSegNet
    from echoflow_torch.models.swin3d import SwinMotionSegNet

    return {net.name: net for net in (R2Plus1DMotionSegNet, CSNMotionSegNet, SwinMotionSegNet)}


def backbone_of(state_dict) -> str:
    """The name in `backbones()` of a state dict of `motion_seg_net`'s
    network, folded or not, by its keys (`<backbone_attr>.*`). Raises
    ValueError for one that names no backbone."""
    attrs = {net.backbone_attr: name for name, net in backbones().items()}
    for key in state_dict:
        name = attrs.get(key.split(".", 1)[0])
        if name is not None:
            return name
    raise ValueError(f"state dict names no backbone (keys under one of {list(attrs)})")


def motion_seg_net(backbone: str = "r2plus1d_18", folded: bool = False) -> MotionSegNet:
    """CLAS-FV's network over `backbone` (a name in `backbones()`):
    R(2+1)D-18, as published, ir-CSN-152 (`models/csn.py`) or Video
    Swin-B (`models/swin3d.py`)."""
    nets = backbones()
    if backbone not in nets:
        raise ValueError(f"unknown backbone {backbone!r}; one of {tuple(nets)}")
    return nets[backbone](folded=folded)


def create_model(seed: int = 0, backbone: str = "r2plus1d_18") -> MotionSegNet:
    """A seeded, initialized (unfolded) MotionNet over `backbone` on the
    CPU, in eval mode."""
    gen = torch.Generator().manual_seed(seed)
    return init_weights(motion_seg_net(backbone), gen).eval()


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
