"""CLAS-FV training losses (port of `echoflow.train.losses`).

    total = OTA + mean_i(SGS_i) + mean_i(OTS_i) + ED/ES supervised BCE

  - OTA (`deformation_motion_loss`): warp every frame t by its forward flow
    and frame t+1 by its backward flow, MSE against the real neighbour plus
    0.005 x the huber smoothness of each flow, total / 2 / (T-1); all
    frame pairs go through one batched warp per direction.
  - SGS/OTS (`motion_seg_loss`): chain-warp the one-hot ED label forward
    to the clip end and the ES label backward to the start (plus the
    ES-forward and ED-backward chains); at the arrival frame score Dice
    against the true label (OTS), at every other frame in range BCE of the
    frame's logits against the warped label (SGS), normalized by the
    constants (T-2)*2 and 2.
  - ED/ES BCE (`edes_supervised_loss`) at the labelled frames.

How the JAX forms carry over: `vmap` over samples is a batch dimension
written out (the 4 chains x N samples of a step are one (4N, 2, H, W)
warp; in the fused schedule one (2N, 4, H, W) label warp and one
(2N, 3, H, W) video warp at the same coordinates, one pair warp),
`lax.scan` is a Python loop of T-1 steps, and the per-sample ED/ES
indices stay masks (`torch.where`), so no step reads a value back to the
host.

Shapes: video (N, C, T, H, W), motion (N, 4, T, H, W), seg_logits
(N, 2, T, H, W), labels (N, H, W) int, ed_idx/es_idx (N,) int tensors.

Data parallelism (`train/loop.fit_on_mesh`): every term but OTA's
smoothness is a mean of per-sample values with equal weights, so on equal
shards the mean of the ranks' losses is the global batch's. The smoothness
sums over the whole batch inside a square root; the losses take the process
`group` for it (`_huber_flow_smoothness`).
"""

from __future__ import annotations

import torch

from echoflow_torch.ops.normalize import one_hot_channels
from echoflow_torch.ops.warp import offset_coords, warp_image_with_offsets
from echoflow_torch.ops.warp_kernel import warp_coords_pair


def soft_dice_loss(inputs, targets, smooth: float = 1.0):
    """Flat soft Dice loss (reference clasfv_losses.py:11-26)."""
    x = inputs.reshape(-1)
    y = targets.reshape(-1)
    dice = (2.0 * torch.sum(x * y) + smooth) / (torch.sum(x) + torch.sum(y) + smooth)
    return 1.0 - dice


def _soft_dice_each(inputs, targets, smooth: float = 1.0):
    """`soft_dice_loss` of each leading-axes entry of (..., 2, H, W)."""
    dims = (-3, -2, -1)
    inter = torch.sum(inputs * targets, dim=dims)
    return 1.0 - (2.0 * inter + smooth) / (
        torch.sum(inputs, dim=dims) + torch.sum(targets, dim=dims) + smooth)


def bce_with_logits(logits, targets):
    """Mean binary cross-entropy with logits (torch semantics)."""
    z, y = logits, targets
    return torch.mean(torch.clamp(z, min=0.0) - z * y + torch.log1p(torch.exp(-torch.abs(z))))


def _bce_each(logits, targets):
    """`bce_with_logits` of each leading-axes entry of (..., 2, H, W)."""
    z, y = logits, targets
    return torch.mean(torch.clamp(z, min=0.0) - z * y + torch.log1p(torch.exp(-torch.abs(z))),
                      dim=(-3, -2, -1))


def huber_smoothness(flow):
    """Smoothness penalty of a (N, 2, H, W) flow (reference
    loss_functions.py:66-77): sqrt(0.01 + (sum dx^2 / H + sum dy^2 / W) / N)."""
    n, _, h, w = flow.shape
    dx = flow[:, :, :, 1:] - flow[:, :, :, :-1]
    dy = flow[:, :, 1:, :] - flow[:, :, :-1, :]
    err = torch.sum(dx * dx) / h + torch.sum(dy * dy) / w
    return torch.sqrt(0.01 + err / n)


def _huber_flow_smoothness(flow_pairs, group=None):
    """Summed per-pair huber smoothness of (N, T-1, 2, H, W) flow pairs:
    sum_t sqrt(0.01 + (sum dx^2 / H + sum dy^2 / W) / N), the reduction
    shared by `deformation_motion_loss` and `_ota_smoothness`.

    The sums run over the whole batch, so the term couples the samples:
    under a process `group` (equal shards on every rank) the per-pair sums
    are all-reduced with autograd before the square root, N is the global
    batch, and every rank computes the global value. The reduction's
    backward sums the ranks' gradients, which the average of the ranks'
    gradients (`parallel.average_gradients`) divides back out."""
    n, _, _, h, w = flow_pairs.shape
    dx = flow_pairs[..., :, 1:] - flow_pairs[..., :, :-1]
    dy = flow_pairs[..., 1:, :] - flow_pairs[..., :-1, :]
    err = (torch.sum(dx * dx, dim=(0, 2, 3, 4)) / h
           + torch.sum(dy * dy, dim=(0, 2, 3, 4)) / w)
    if group is not None:
        from torch.distributed import get_world_size

        from echoflow_torch.parallel.mesh import all_reduce_sum

        err = all_reduce_sum(err, group)
        n = n * get_world_size(group)
    return torch.sum(torch.sqrt(0.01 + err / n))


def deformation_motion_loss(video, motion, group=None):
    """OTA loss. video (N, C, T, H, W), motion (N, 4, T, H, W) -> scalar.
    Both warps of all (T-1) frame pairs run as one (N*(T-1))-batch warp.
    Under a process `group` the smoothness is the global batch's (see
    `_huber_flow_smoothness`); the MSE is this rank's mean."""
    n, c, t, h, w = video.shape
    src_fwd = video[:, :, :-1].movedim(2, 1).reshape(n * (t - 1), c, h, w)
    src_bwd = video[:, :, 1:].movedim(2, 1).reshape(n * (t - 1), c, h, w)
    flow_fwd = motion[:, :2, :-1].movedim(2, 1).reshape(n * (t - 1), 2, h, w)
    flow_bwd = motion[:, 2:, 1:].movedim(2, 1).reshape(n * (t - 1), 2, h, w)

    pred_fwd = warp_image_with_offsets(src_fwd, flow_fwd)
    pred_bwd = warp_image_with_offsets(src_bwd, flow_bwd)

    # Sum over pairs of per-pair means == (T-1) * overall mean.
    mse = (t - 1) * (torch.mean((pred_fwd - src_bwd) ** 2) + torch.mean((pred_bwd - src_fwd) ** 2))
    smooth = (_huber_flow_smoothness(flow_fwd.reshape(n, t - 1, 2, h, w), group)
              + _huber_flow_smoothness(flow_bwd.reshape(n, t - 1, 2, h, w), group))
    return (0.005 * smooth + mse) / 2.0 / (t - 1)


def _edes_chain_table(label_ed, label_es, ed_idx, es_idx, motion):
    """The reference's four chained-warp loops (clasfv_losses.py:84-130) as
    one table, batched over samples: A fwd-from-ED (OTS at ES arrival),
    B fwd-from-ES, C bwd-from-ES (OTS at ED arrival), D bwd-from-ED. Both
    loss schedules consume it.

    Returns (fwd_flows, bwd_flows, table): step i of the forward chains
    uses flow i (`fwd_flows[i]`, (N, 2, H, W)) at frame id i, step i of
    the backward chains the backward flow of frame T-1-i
    (`bwd_flows[i]`) at frame id T-1-i. `table["fids"]` (T-1, 4) holds
    each step's frame id per chain and `table["frames"]` the frame each
    step scores; the other entries are (N, 4, ...) per sample and chain,
    and `ahead` marks the forward chains."""
    t = motion.shape[2]
    dev = motion.device
    oh_ed = one_hot_channels(label_ed[:, None], 2)   # (N, 2, H, W)
    oh_es = one_hot_channels(label_es[:, None], 2)
    ed_idx, es_idx = ed_idx.long(), es_idx.long()
    fwd_flows = motion[:, :2, :-1].movedim(2, 0)          # (T-1, N, 2, H, W)
    bwd_flows = motion[:, 2:, 1:].movedim(2, 0).flip(0)   # step i: frame T-1-i
    fwd_ids = torch.arange(t - 1, device=dev)
    bwd_ids = torch.arange(t - 1, 0, -1, device=dev)
    fids = torch.stack([fwd_ids, fwd_ids, bwd_ids, bwd_ids], dim=1)
    offsets = 1 - 2 * (torch.arange(4, device=dev) // 2)   # scored frame offset: 1, 1, -1, -1
    none = torch.full_like(ed_idx, -1)
    table = {
        "init_labels": torch.stack([oh_ed, oh_es, oh_es, oh_ed], dim=1),   # (N, 4, 2, H, W)
        "start_ids": torch.stack([ed_idx, es_idx, es_idx, ed_idx], dim=1),
        "ots_frames": torch.stack([es_idx - 1, none, ed_idx + 1, none], dim=1),
        "ots_targets": torch.stack([oh_es, oh_es, oh_ed, oh_ed], dim=1),
        "ahead": offsets > 0,
        "fids": fids,
        "frames": fids + offsets,
    }
    return fwd_flows, bwd_flows, table


def _chain_step_terms(tbl, labels, warped, step, seg_logits, criterion=_bce_each):
    """Step `step` of the 4-wide chains: activity masks, label carry, the
    OTS Dice at the arrival frame and the SGS criterion against the offset
    frame's logits. labels, warped (N, 4, 2, H, W). Returns (new_labels,
    sgs_terms, ots_terms), the terms (N, 4)."""
    fid = tbl["fids"][step]
    start = tbl["start_ids"]
    active = torch.where(tbl["ahead"], fid >= start, fid <= start)   # (N, 4)
    new_labels = torch.where(active[..., None, None, None], warped, labels)

    is_ots = active & (fid == tbl["ots_frames"])
    ots_terms = torch.where(is_ots, _soft_dice_each(warped, tbl["ots_targets"]), 0.0)
    frame_logits = seg_logits.index_select(2, tbl["frames"][step]).movedim(2, 1)
    sgs_terms = torch.where(active & ~is_ots, criterion(frame_logits, warped), 0.0)
    return new_labels, sgs_terms, ots_terms


def motion_seg_loss(label_ed, label_es, ed_idx, es_idx, motion, seg_logits,
                    criterion=_bce_each):
    """Batched SGS/OTS, mean over the batch (the reference sums per-sample
    losses and divides by batch size, train_test.py:39-63). All four
    chains of all samples advance together: one (4N, 2, H, W) warp per
    step, T-1 steps. Returns (sgs, ots)."""
    sgs, ots = motion_seg_loss_per_sample(label_ed, label_es, ed_idx, es_idx, motion,
                                          seg_logits, criterion)
    return torch.mean(sgs), torch.mean(ots)


def motion_seg_loss_per_sample(label_ed, label_es, ed_idx, es_idx, motion, seg_logits,
                               criterion=_bce_each):
    """(sgs, ots), each (N,): `motion_seg_loss_single` of every sample."""
    n, _, t, h, w = motion.shape
    fwd_flows, bwd_flows, tbl = _edes_chain_table(label_ed, label_es, ed_idx, es_idx, motion)
    labels = tbl["init_labels"]
    sgs_steps, ots_steps = [], []
    for i in range(t - 1):
        flow = torch.stack([fwd_flows[i], fwd_flows[i], bwd_flows[i], bwd_flows[i]], dim=1)
        warped = warp_image_with_offsets(labels.reshape(4 * n, 2, h, w),
                                         flow.reshape(4 * n, 2, h, w)).reshape(n, 4, 2, h, w)
        labels, sgs_terms, ots_terms = _chain_step_terms(tbl, labels, warped, i,
                                                         seg_logits, criterion)
        sgs_steps.append(sgs_terms)
        ots_steps.append(ots_terms)
    sgs = torch.stack(sgs_steps).sum(dim=(0, 2)) / ((t - 2) * 2)
    ots = torch.stack(ots_steps).sum(dim=(0, 2)) / 2.0
    return sgs, ots


def motion_seg_loss_single(label_ed, label_es, ed_idx, es_idx, motion, seg_logits,
                           criterion=_bce_each):
    """Per-sample SGS + OTS: label_* (H, W) int, motion (4, T, H, W),
    seg_logits (2, T, H, W), ed_idx/es_idx scalars. Returns (sgs, ots)."""
    dev = motion.device
    sgs, ots = motion_seg_loss_per_sample(
        label_ed[None], label_es[None], torch.as_tensor(ed_idx, device=dev).reshape(1),
        torch.as_tensor(es_idx, device=dev).reshape(1), motion[None], seg_logits[None],
        criterion)
    return sgs[0], ots[0]


def single_label_motion_seg_loss(label, label_idx, motion, seg_logits, criterion=_bce_each):
    """Single-label warp-chain loss of the ed-or-es-only recipe, per sample
    (N,): the one-hot label warped forward from `label_idx` to the clip end
    (scored against the next frame's logits) and backward to the start
    (against the previous frame's), no OTS term, divided by the constant
    T-1 steps. Both chains of all samples are one (2N, 2, H, W) warp per
    step."""
    n, _, t, h, w = motion.shape
    dev = motion.device
    oh = one_hot_channels(label[:, None], 2)
    label_idx = label_idx.long()[:, None]                   # (N, 1)
    fwd_flows = motion[:, :2, :-1].movedim(2, 0)
    bwd_flows = motion[:, 2:, 1:].movedim(2, 0).flip(0)
    # Made on the device: a host tensor here would be a synchronizing copy.
    chain = torch.arange(2, device=dev)
    ahead = chain == 0                                      # True, False
    steps = torch.arange(t - 1, device=dev)
    fids = torch.stack([steps, t - 1 - steps], dim=1)       # (T-1, 2)
    frames = fids + 1 - 2 * chain                           # offsets 1, -1
    labels = torch.stack([oh, oh], dim=1)                   # (N, 2, 2, H, W)
    terms = []
    for i in range(t - 1):
        flow = torch.stack([fwd_flows[i], bwd_flows[i]], dim=1)
        warped = warp_image_with_offsets(labels.reshape(2 * n, 2, h, w),
                                         flow.reshape(2 * n, 2, h, w)).reshape(n, 2, 2, h, w)
        active = torch.where(ahead, fids[i] >= label_idx, fids[i] <= label_idx)   # (N, 2)
        labels = torch.where(active[..., None, None, None], warped, labels)
        frame_logits = seg_logits.index_select(2, frames[i]).movedim(2, 1)
        terms.append(torch.where(active, criterion(frame_logits, warped), 0.0))
    return torch.stack(terms).sum(dim=(0, 2)) / (t - 1)


def single_label_motion_seg_loss_sample(label, label_idx, motion, seg_logits,
                                        criterion=_bce_each):
    """`single_label_motion_seg_loss` of one sample: label (H, W) int,
    motion (4, T, H, W), seg_logits (2, T, H, W), label_idx scalar."""
    idx = torch.as_tensor(label_idx, device=motion.device).reshape(1)
    return single_label_motion_seg_loss(label[None], idx, motion[None], seg_logits[None],
                                        criterion)[0]


def edes_supervised_loss(seg_logits, label_ed, label_es, ed_idx, es_idx):
    """Supervised BCE at the labelled ED/ES frames (train_test.py:65-88).
    Returns the averaged loss and the gathered (ed_logits, es_logits),
    each (N, 2, H, W). An index past the clip takes its last frame, as
    echoflow's `lax.dynamic_index_in_dim` clamps it (the dataset's window
    of a systole longer than the clip gives such an ES index)."""
    rows = torch.arange(seg_logits.shape[0], device=seg_logits.device)
    last = seg_logits.shape[2] - 1
    ed_logits = seg_logits[rows, :, ed_idx.long().clamp(0, last)]
    es_logits = seg_logits[rows, :, es_idx.long().clamp(0, last)]
    oh_ed = one_hot_channels(label_ed[:, None], 2)
    oh_es = one_hot_channels(label_es[:, None], 2)
    loss = (bce_with_logits(ed_logits, oh_ed) + bce_with_logits(es_logits, oh_es)) / 2.0
    return loss, (ed_logits, es_logits)


def ed_es_only_total_loss(ed_video, es_video, ed_seg, ed_motion, es_seg, es_motion,
                          label_ed, label_es, ed_idx, es_idx, group=None):
    """The ed-or-es-only objective (reference notebook cell 7 `train`):

      total = [OTA(ed clip) + OTA(es clip)]
            + sum_i[single(ed_i) + single(es_i)] / N / 2
            + [BCE(ed logits @ ed_idx) + BCE(es logits @ es_idx)] / 2

    Under a process `group` the OTA smoothness is the global batch's.
    Returns (total, aux dict)."""
    ota = (deformation_motion_loss(ed_video, ed_motion, group)
           + deformation_motion_loss(es_video, es_motion, group))
    flow = (torch.sum(single_label_motion_seg_loss(label_ed, ed_idx, ed_motion, ed_seg))
            + torch.sum(single_label_motion_seg_loss(label_es, es_idx, es_motion, es_seg)))
    flow = flow / ed_video.shape[0] / 2.0
    ed_sup, (ed_logits, _) = edes_supervised_loss(ed_seg, label_ed, label_ed, ed_idx, ed_idx)
    es_sup, (es_logits, _) = edes_supervised_loss(es_seg, label_es, label_es, es_idx, es_idx)
    edes = (ed_sup + es_sup) / 2.0
    total = ota + flow + edes
    return total, {"ota": ota, "flow": flow, "edes_bce": edes,
                   "ed_logits": ed_logits, "es_logits": es_logits}


def _ota_smoothness(motion, group=None):
    """The huber smoothness half of OTA (un-scaled), by the same reduction
    as `deformation_motion_loss`."""
    flow_fwd = motion[:, :2, :-1].movedim(2, 1)   # (N, T-1, 2, H, W)
    flow_bwd = motion[:, 2:, 1:].movedim(2, 1)
    return _huber_flow_smoothness(flow_fwd, group) + _huber_flow_smoothness(flow_bwd, group)


def _fused_chain_ota(video, label_ed, label_es, ed_idx, es_idx, motion, seg_logits,
                     criterion=_bce_each):
    """SGS/OTS chains with OTA's frame warps fused into the same loop,
    per sample: returns (sgs, ots, mse_sum), each (N,).

    OTA's forward warps use exactly the per-step forward flows of the A/B
    label chains, and its backward warps the backward flows of C/D, so each
    step computes the pixel coordinates of its two flows once and hands
    them to one (2N, 4, H, W) label warp (A|B on the forward flow, C|D on
    the backward) and one (2N, 3, H, W) video warp, both in one
    `warp_coords_pair` call (one K2 launch). The video is data: its warp
    needs no image gradient, so its backward runs no d_img kernel."""
    n, c, t, h, w = video.shape
    fwd_flows, bwd_flows, tbl = _edes_chain_table(label_ed, label_es, ed_idx, es_idx, motion)
    video = video.detach()
    labels = tbl["init_labels"]
    sgs_steps, ots_steps, mse_steps = [], [], []
    for i in range(t - 1):
        flows = torch.stack([fwd_flows[i], bwd_flows[i]], dim=1).reshape(2 * n, 2, h, w)
        px, py = offset_coords(flows)
        lab = torch.stack([torch.cat([labels[:, 0], labels[:, 1]], dim=1),
                           torch.cat([labels[:, 2], labels[:, 3]], dim=1)], dim=1)
        src = torch.stack([video[:, :, i], video[:, :, t - 1 - i]], dim=1)
        warped_lab, warped_vid = warp_coords_pair(lab.reshape(2 * n, 4, h, w),
                                                  src.reshape(2 * n, c, h, w), px, py)
        warped_lab = warped_lab.reshape(n, 2, 4, h, w)
        warped_vid = warped_vid.reshape(n, 2, c, h, w)
        warped = torch.stack([warped_lab[:, 0, :2], warped_lab[:, 0, 2:],
                              warped_lab[:, 1, :2], warped_lab[:, 1, 2:]], dim=1)

        mse_steps.append(torch.sum((warped_vid[:, 0] - video[:, :, i + 1]) ** 2, dim=(1, 2, 3))
                         + torch.sum((warped_vid[:, 1] - video[:, :, t - 2 - i]) ** 2,
                                     dim=(1, 2, 3)))
        labels, sgs_terms, ots_terms = _chain_step_terms(tbl, labels, warped, i,
                                                         seg_logits, criterion)
        sgs_steps.append(sgs_terms)
        ots_steps.append(ots_terms)
    sgs = torch.stack(sgs_steps).sum(dim=(0, 2)) / ((t - 2) * 2)
    ots = torch.stack(ots_steps).sum(dim=(0, 2)) / 2.0
    return sgs, ots, torch.stack(mse_steps).sum(dim=0)


def clasfv_total_loss_fused(video, seg_logits, motion, label_ed, label_es, ed_idx, es_idx,
                            group=None):
    """`clasfv_total_loss` with OTA's warps fused into the chain loop (see
    `_fused_chain_ota`): the same math up to fp summation order. Under a
    process `group` the OTA smoothness is the global batch's. Returns
    (total, aux dict)."""
    n, c, t, h, w = video.shape
    sgs, ots, mse_sums = _fused_chain_ota(video, label_ed, label_es, ed_idx, es_idx,
                                          motion, seg_logits)
    sgs, ots = torch.mean(sgs), torch.mean(ots)
    # (t-1) * (mean_fwd + mean_bwd) of deformation_motion_loss == sum_sq / (N C H W).
    mse = torch.sum(mse_sums) / (n * c * h * w)
    ota = (0.005 * _ota_smoothness(motion, group) + mse) / 2.0 / (t - 1)
    edes, (ed_logits, es_logits) = edes_supervised_loss(seg_logits, label_ed, label_es,
                                                        ed_idx, es_idx)
    total = ota + sgs + ots + edes
    return total, {"ota": ota, "sgs": sgs, "ots": ots, "edes_bce": edes,
                   "ed_logits": ed_logits, "es_logits": es_logits}


def clasfv_total_loss(video, seg_logits, motion, label_ed, label_es, ed_idx, es_idx,
                      group=None):
    """The full CLAS-FV objective (train_test.py:33-88), in the reference's
    compute schedule. Under a process `group` the OTA smoothness is the
    global batch's. Returns (total, aux dict)."""
    ota = deformation_motion_loss(video, motion, group)
    sgs, ots = motion_seg_loss(label_ed, label_es, ed_idx, es_idx, motion, seg_logits)
    edes, (ed_logits, es_logits) = edes_supervised_loss(seg_logits, label_ed, label_es,
                                                        ed_idx, es_idx)
    total = ota + sgs + ots + edes
    return total, {"ota": ota, "sgs": sgs, "ots": ots, "edes_bce": edes,
                   "ed_logits": ed_logits, "es_logits": es_logits}
