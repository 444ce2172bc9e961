"""Legacy CAMUS 4-class losses (Background / LV / Myo / LA) (port of
`echoflow.train.camus_losses`).

The reference's CAMUS-era predecessors of the EchoNet CLAS-FV losses
(src/loss_functions.py:24-297): windowed normalized cross correlation
appearance losses, per-class soft Dice, cross-entropy + Dice supervision at
ED/ES (frames 0 and 9 of 10-frame CAMUS clips), and the 4-class warp-chain
SGS/OTS. The warps go through `ops/warp.warp_image_with_offsets`: the CUDA
kernels K2-K4 on the card, their plain versions on the CPU.
"""

from __future__ import annotations

import torch

from echoflow_torch.ops.normalize import one_hot_channels
from echoflow_torch.ops.warp import warp_image_with_offsets

CAMUS_CLASSES = ("Background", "LV", "Myo", "LA")


def local_cross_correlation(template: torch.Tensor, source: torch.Tensor,
                            n: int = 4) -> torch.Tensor:
    """Windowed NCC: demean both images per n x n window grid, then global
    normalized correlation per (N, C) plane, meaned
    (reference loss_functions.py:24-49). H and W must be divisible by n."""
    nb, c, h, w = template.shape
    if h % n or w % n:
        raise ValueError("H/W must be divisible by the window grid")

    def demean(x):
        win = x.reshape(nb, c, n, h // n, n, w // n)
        # The reference subtracts the mean over the *whole batch+channels*
        # of each window block (torch.mean over the full slice).
        mu = win.mean(dim=(0, 1, 3, 5), keepdim=True)
        return (win - mu).reshape(nb, c, h, w)

    t = demean(template)
    s = demean(source)
    num = torch.sum(t * s, dim=(2, 3))
    den = torch.sqrt(torch.sum(t * t, dim=(2, 3))) * torch.sqrt(torch.sum(s * s, dim=(2, 3)))
    return torch.mean(num / den)


def cross_correlation(template: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """Global Pearson correlation per (N, C) plane (loss_functions.py:52-63)."""
    t = template - torch.mean(template)
    s = source - torch.mean(source)
    num = torch.sum(t * s, dim=(2, 3))
    den = torch.sqrt(torch.sum(s * s, dim=(2, 3))) * torch.sqrt(torch.sum(t * t, dim=(2, 3)))
    return num / den


def smoothness_loss(motion: torch.Tensor) -> torch.Tensor:
    """Mean squared first differences of a (N, 2, H, W) flow
    (loss_functions.py:80-90)."""
    dy = motion[:, 0, 1:, :-1] - motion[:, 0, :-1, :-1]
    dx = motion[:, 1, :-1, 1:] - motion[:, 1, :-1, :-1]
    return torch.mean(dx ** 2 + dy ** 2)


def ota_loss(source: torch.Tensor, motion: torch.Tensor,
             regulator_gamma: float = 10.0, n_windows: int = 4) -> torch.Tensor:
    """CAMUS appearance-level motion loss: -NCC + gamma * smoothness over
    adjacent frame pairs (loss_functions.py:93-120). source (N, C, T, H, W),
    motion (N, 4, T, H, W)."""
    t_len = source.shape[2]
    corre = 0.0
    smooth = 0.0
    for t in range(t_len - 1):
        fwd = motion[:, :2, t]
        bwd = motion[:, 2:, t + 1]
        pred_fwd = warp_image_with_offsets(source[:, :, t], fwd)
        pred_bwd = warp_image_with_offsets(source[:, :, t + 1], bwd)
        corre = corre + local_cross_correlation(source[:, :, t + 1], pred_fwd, n_windows)
        corre = corre + local_cross_correlation(source[:, :, t], pred_bwd, n_windows)
        smooth = smooth + smoothness_loss(fwd) + smoothness_loss(bwd)
    denom = 2 * (t_len - 1)
    return (-1.0 / denom) * corre + (regulator_gamma / denom) * smooth


def class_dice_loss(softmax_output: torch.Tensor, one_hot_label: torch.Tensor,
                    class_index: int, eps: float = 0.0) -> torch.Tensor:
    """Per-class soft Dice over (N, C, H, W) (loss_functions.py:137-156)."""
    p = softmax_output[:, class_index]
    y = one_hot_label[:, class_index]
    num = torch.sum(y * p, dim=(1, 2))
    den = torch.sum(p * p, dim=(1, 2)) + torch.sum(y * y, dim=(1, 2))
    return 1.0 - torch.mean((2.0 * num + eps) / (den + eps))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE of (N, C, H, W) logits vs (N, H, W) integer labels
    (torch nn.CrossEntropyLoss semantics)."""
    logp = torch.log_softmax(logits, dim=1)
    return -torch.mean(torch.gather(logp, 1, labels[:, None].long()))


def get_weights(labels: torch.Tensor, weighted: bool) -> dict:
    """Class-frequency weights (loss_functions.py:280-297)."""
    if not weighted:
        return {c: 1.0 for c in CAMUS_CLASSES}
    n = labels.numel()
    return {c: torch.sum(labels == i) / n for i, c in enumerate(CAMUS_CLASSES)}


def _class_weighted_dice(pred, one_hot, weights):
    total = 0.0
    for idx, cname in enumerate(CAMUS_CLASSES):
        total = total + class_dice_loss(pred, one_hot, idx) / weights[cname]
    return total


def sga_loss(labels_ed, labels_es, seg_logits, seg_softmax,
             ed_frame: int = 0, es_frame: int = 9,
             omega: float = 1.0, weighted: bool = False) -> torch.Tensor:
    """Appearance-level segmentation loss: CE + class-weighted multi-class
    Dice at the labeled ED/ES frames (loss_functions.py:159-192). labels_*
    (N, H, W) int; seg_logits/seg_softmax (N, C, T, H, W)."""
    total_ce = 0.0
    total_dice = 0.0
    for label, frame in ((labels_ed, ed_frame), (labels_es, es_frame)):
        one_hot = one_hot_channels(label[:, None], len(CAMUS_CLASSES))
        total_dice = total_dice + _class_weighted_dice(seg_softmax[:, :, frame], one_hot,
                                                       get_weights(label, weighted))
        total_ce = total_ce + cross_entropy(seg_logits[:, :, frame], label)
    return (1.0 / (2.0 * omega)) * (total_ce + total_dice / len(CAMUS_CLASSES))


def sgs_ots_loss(labels_ed, labels_es, motion, seg_softmax,
                 omega: float = 1.0, weighted: bool = False):
    """4-class warp-chain SGS/OTS for 10-frame CAMUS clips
    (loss_functions.py:208-277): ED label chained forward to the clip end
    (Dice vs ES at arrival), ES label chained backward to the start (Dice vs
    ED at arrival). A static loop: CAMUS clips are fixed 10 frames with
    ED/ES at the ends, so no masking is needed."""
    n_cls = len(CAMUS_CLASSES)
    t_len = motion.shape[2]
    oh_ed = one_hot_channels(labels_ed[:, None], n_cls)
    oh_es = one_hot_channels(labels_es[:, None], n_cls)

    w_ed = get_weights(labels_ed, weighted)
    loss_fwd = 0.0
    ots = 0.0
    src = oh_ed
    for t in range(0, t_len - 1):
        nxt = warp_image_with_offsets(src, motion[:, :2, t])
        if t == t_len - 2:
            ots = ots + _class_weighted_dice(nxt, oh_es, w_ed)
        else:
            loss_fwd = loss_fwd + _class_weighted_dice(nxt, seg_softmax[:, :, t + 1], w_ed)
        src = nxt

    w_es = get_weights(labels_es, weighted)
    loss_bwd = 0.0
    src = oh_es
    for t in range(t_len - 1, 0, -1):
        nxt = warp_image_with_offsets(src, motion[:, 2:, t])
        if t == 1:
            ots = ots + _class_weighted_dice(nxt, oh_ed, w_es)
        else:
            loss_bwd = loss_bwd + _class_weighted_dice(nxt, seg_softmax[:, :, t - 1], w_es)
        src = nxt

    sgs = (loss_fwd + loss_bwd) / (2.0 * (t_len - 2) * omega * n_cls)
    return sgs, ots / (2.0 * omega * n_cls)


# --------------------------------------------------------- reference names
# Thin aliases with the reference's exact names and calling conventions
# (loss_functions.py). `labels` is the reference's data dict carrying
# "label_ED"/"label_ES"; label images may be (N, H, W) or (N, 1, H, W).

def _squeeze_label(label):
    return label[:, 0] if label.ndim == 4 and label.shape[1] == 1 else label


def OTA_loss(source_image, motion_field, regulator_gamma=10):
    """loss_functions.py:93-120."""
    return ota_loss(source_image, motion_field, regulator_gamma=regulator_gamma)


def SGA_loss(labels, seg_out, seg_softmax, omega=1, weighted=False):
    """loss_functions.py:159-192."""
    return sga_loss(_squeeze_label(labels["label_ED"]), _squeeze_label(labels["label_ES"]),
                    seg_out, seg_softmax, omega=omega, weighted=weighted)


def SGS_OTS_loss(labels, motion_output, seg_softmax, omega=1, weighted=False):
    """loss_functions.py:208-277."""
    return sgs_ots_loss(_squeeze_label(labels["label_ED"]), _squeeze_label(labels["label_ES"]),
                        motion_output, seg_softmax, omega=omega, weighted=weighted)


def dice_loss(softmax_output, label, class_index=0, eps=0):
    """loss_functions.py:137-156 (label already one-hot, (N, C, H, W))."""
    return class_dice_loss(softmax_output, label, class_index, eps=eps)


def huber_loss(x):
    """loss_functions.py:66-77 (the TV-ish sqrt(0.01 + err) flow smoother)."""
    from echoflow_torch.train.losses import huber_smoothness

    return huber_smoothness(x)


def convert_to_1hot_tensor(label, n_class):
    """loss_functions.py:195-205: (N, 1, H, W) int -> (N, C, H, W) one-hot,
    on the label's device."""
    return one_hot_channels(label, n_class)
