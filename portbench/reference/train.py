"""Plain CLAS-FV training step: the published objective (src/train_test.py
:33-88, src/clasfv_losses.py, src/loss_functions.py) through autograd of
plain PyTorch, and Adam written out (optax's adam: betas 0.9, 0.999, eps
1e-8 outside the square root).

    total = OTA + mean_n SGS_n + mean_n OTS_n + ED/ES BCE

- OTA: frame t warped by its forward flow against frame t+1, frame t+1 by
  its backward flow against frame t (mean squared error of each direction,
  times T-1), plus 0.005 x the huber smoothness of each direction's flows,
  all / 2 / (T-1).
- SGS/OTS, per sample, four chains of warps of one-hot labels: ED forward
  to the clip's end (its arrival at ES scored by soft Dice: OTS), ES
  forward, ES backward to the start (its arrival at ED: OTS), ED backward.
  Every other step's warped label is scored by BCE against the logits of
  the frame it arrives at (SGS). SGS / ((T-2) * 2), OTS / 2.
- ED/ES BCE of the logits at the labelled frames (an index past the clip
  takes its last frame).

Warps are `F.grid_sample` (bilinear, border, align_corners=False) at the
base grid linspace(-1, 1) plus the flow (channel 0 moves x, 1 moves y).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.model import forward


def warp(image, flow):
    """image (N, C, H, W), flow (N, 2, H, W) in normalized units."""
    n, _, h, w = image.shape
    gx = torch.linspace(-1.0, 1.0, w, device=image.device, dtype=torch.float64).float()
    gy = torch.linspace(-1.0, 1.0, h, device=image.device, dtype=torch.float64).float()
    grid = torch.stack([gx[None, None, :] + flow[:, 0], gy[None, :, None] + flow[:, 1]], dim=-1)
    return F.grid_sample(image, grid, mode="bilinear", padding_mode="border",
                         align_corners=False)


def _huber(flows):
    """flows (N, 2, H, W) of one frame pair."""
    n, _, h, w = flows.shape
    dx = flows[..., :, 1:] - flows[..., :, :-1]
    dy = flows[..., 1:, :] - flows[..., :-1, :]
    return torch.sqrt(0.01 + (torch.sum(dx * dx) / h + torch.sum(dy * dy) / w) / n)


def ota_loss(video, motion):
    t = video.shape[2]
    mse = smooth = 0.0
    for i in range(t - 1):
        fwd, bwd = motion[:, :2, i], motion[:, 2:, i + 1]
        mse = mse + F.mse_loss(warp(video[:, :, i], fwd), video[:, :, i + 1])
        mse = mse + F.mse_loss(warp(video[:, :, i + 1], bwd), video[:, :, i])
        smooth = smooth + _huber(fwd) + _huber(bwd)
    return (0.005 * smooth + mse) / 2.0 / (t - 1)


def _one_hot(label):
    return torch.stack([label == 0, label == 1]).float()[None]    # (1, 2, H, W)


def _dice_loss(x, y):
    return 1.0 - (2.0 * torch.sum(x * y) + 1.0) / (torch.sum(x) + torch.sum(y) + 1.0)


def chain_losses(label_ed, label_es, ed, es, motion, seg):
    """SGS and OTS of one sample: motion (4, T, H, W), seg (2, T, H, W)."""
    t = motion.shape[1]
    oh_ed, oh_es = _one_hot(label_ed), _one_hot(label_es)
    sgs = ots = 0.0
    for start, label, target in ((ed, oh_ed, oh_es), (es, oh_es, None)):   # forward chains
        for i in range(start, t - 1):
            label = warp(label, motion[None, :2, i])
            if target is not None and i + 1 == es:
                ots = ots + _dice_loss(label, target)
            else:
                sgs = sgs + F.binary_cross_entropy_with_logits(seg[None, :, i + 1], label)
    for start, label, target in ((es, oh_es, oh_ed), (ed, oh_ed, None)):   # backward chains
        for i in range(start, 0, -1):
            label = warp(label, motion[None, 2:, i])
            if target is not None and i - 1 == ed:
                ots = ots + _dice_loss(label, target)
            else:
                sgs = sgs + F.binary_cross_entropy_with_logits(seg[None, :, i - 1], label)
    return sgs / ((t - 2) * 2), ots / 2.0


def total_loss(video, seg, motion, batch):
    n, t = video.shape[0], video.shape[2]
    sgs = ots = 0.0
    for j in range(n):
        ed, es = int(batch["ed_idx"][j]), int(batch["es_idx"][j])
        s, o = chain_losses(batch["ed_label"][j], batch["es_label"][j], ed, es,
                            motion[j], seg[j])
        sgs, ots = sgs + s, ots + o
    edes = 0.0
    for key, idx in (("ed_label", "ed_idx"), ("es_label", "es_idx")):
        frames = [min(int(i), t - 1) for i in batch[idx]]
        logits = torch.stack([seg[j, :, f] for j, f in enumerate(frames)])
        target = torch.cat([_one_hot(batch[key][j]) for j in range(n)])
        edes = edes + F.binary_cross_entropy_with_logits(logits, target)
    return ota_loss(video, motion) + sgs / n + ots / n + edes / 2.0


class Adam:
    """optax.adam over a dict of leaves."""

    def __init__(self, params, lr=1e-4, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps, self.t = lr, b1, b2, eps, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params, grads):
        self.t += 1
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            m_hat = self.m[k] / (1 - self.b1 ** self.t)
            v_hat = self.v[k] / (1 - self.b2 ** self.t)
            p.sub_(self.lr * m_hat / (torch.sqrt(v_hat) + self.eps))


def train_steps(state, cfg, batches, lr=1e-4, precision=None, loss_fn=total_loss):
    """Run len(batches) steps of `loss_fn` from `state` (the unfolded state
    dict, which is not changed). Returns (losses, first gradients, parameters after the
    steps), the last two as dicts of the trainable leaves."""
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
