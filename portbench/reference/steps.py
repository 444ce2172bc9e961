"""Plain CLAS-FV train steps over any plain forward, and R(2+1)D-18
CLAS-FV's forward with the decoder of `reference/csn.py`.

`train_steps(forward, ...)` is `reference/train.train_steps` with the
model's forward as an argument: the same objective (`train.total_loss`)
through autograd, the same Adam (`train.Adam`).

`r2plus1d_forward` is `reference/model.forward` with the decoder written as
`reference/csn.decode` writes it: each tap's slice of comb1 at the tap's
own resolution, upsampled and summed, the same linear map as comb1 over
the concatenation of the upsampled taps. At a batch of 16 clips of 32 x
112^2 that concatenation (1024 channels at full resolution) and its
gradient would take 53 GB of one card's 80; this takes none of it.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import csn
from portbench.reference.model import Precision, _bn, _conv_specs
from portbench.reference.train import Adam, total_loss


def r2plus1d_taps(p, video, cfg, train=False, precision=None):
    """The five taps of R(2+1)D-18 (`reference/model.features`' backbone)."""
    prec = precision or Precision()
    eps = cfg["bn_eps"]

    def conv_bn(x, spec, relu):
        key, _, _, _, stride, padding, bn_key = spec
        x = _bn(p, bn_key, prec.conv(x, p[f"{key}.weight"], None, stride, padding), train, eps)
        return torch.relu(x) if relu else x

    specs = iter(_conv_specs(cfg))
    x = conv_bn(video, next(specs), True)
    x = conv_bn(x, next(specs), True)
    taps = [x]
    for stride in cfg["stage_strides"]:
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
    return taps


def r2plus1d_forward(p, video, cfg, train=False, precision=None, with_motion=True):
    """video (N, 3, T, H, W) float32 -> (seg logits, motion or None) of
    R(2+1)D-18 CLAS-FV (module docstring)."""
    taps = r2plus1d_taps(p, video, cfg, train, precision)
    return csn.decode(p, taps, tuple(video.shape[2:]), cfg, train, precision, with_motion)


def train_steps(forward, state, cfg, batches, lr=1e-4, precision=None, loss_fn=total_loss):
    """Run len(batches) steps of `loss_fn` over `forward(p, video, cfg,
    train=True, precision=...)` from `state` (the unfolded state dict, which
    is not changed). Returns (losses, first gradients, parameters after
    the steps), the last two as dicts of the trainable leaves."""
    device = state["comb_1_layer.weight"].device
    params = {k: v.detach().clone().float() for k, v in state.items()
              if v.is_floating_point() and "running" not in k}
    buffers = {k: v for k, v in state.items() if k not in params}
    adam = Adam(params, lr=lr)
    losses, first = [], None
    for host in batches:
        batch = {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in host.items()}
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        seg, motion = forward({**leaves, **buffers}, batch["video"], cfg, train=True,
                              precision=precision)
        loss = loss_fn(batch["video"], seg, motion, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), grads)}
        for v in params.values():
            v.requires_grad_(False)
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        adam.step(params, grads)
        losses.append(float(loss.detach()))
        del seg, motion, loss, grads
    return losses, first, params
