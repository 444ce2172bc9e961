"""Multi-rater label fusion: majority vote, SIMPLE, STAPLE-EM, softmax-mean
(port of `echoflow.ops.fusion`).

Every fuser takes a rater stack with any leading batch dimensions,
(..., R, H, W) binary labels or (..., R, C, H, W) probabilities, so a whole
video fuses with frames as the leading dimension instead of `vmap`.

  - majority: per-pixel plurality vote (ties -> background).
  - simple:   SIMPLE (Langerak et al., IEEE TMI 2010): iteratively score
              raters by Dice against the current estimate, drop raters
              below mean - alpha * std, re-vote the survivors.
  - staple:   binary STAPLE (Warfield et al., IEEE TMI 2004): EM over
              per-rater sensitivity/specificity with a fixed voxel prior.
  - softmax-mean: average the probabilities of the live raters, argmax.

Sums over the (at most ~10) raters run as a loop in rater order, so the
float32 statistics that SIMPLE thresholds are formed in a fixed order.
"""

from __future__ import annotations

import torch


def _rater_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over the rater axis in rater order (0 + x_0 + x_1 + ...)."""
    x = x.movedim(dim, 0)
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc


def majority_vote(raters: torch.Tensor, weights: torch.Tensor | None = None) -> torch.Tensor:
    """(..., R, H, W) binary stack -> (..., H, W) uint8 fused mask.

    Strict majority: mean > 0.5 is foreground, ties go to background.
    `weights` (..., R) weighs the raters (a 0/1 live mask in the engine)."""
    r = raters.float()
    if weights is None:
        mean = _rater_sum(r, -3) / r.shape[-3]
    else:
        w = weights.float()
        num = _rater_sum(w[..., None, None] * r, -3)
        mean = num / torch.clamp(_rater_sum(w, -1), min=1e-12)[..., None, None]
    return (mean > 0.5).to(torch.uint8)


def _pairwise_dice(raters: torch.Tensor, estimate: torch.Tensor, eps: float = 1e-7):
    """Dice of each rater (..., R, H, W) against an estimate (..., H, W)."""
    e = estimate.float()
    inter = (raters * e[..., None, :, :]).sum(dim=(-2, -1))
    sizes = raters.sum(dim=(-2, -1)) + e.sum(dim=(-2, -1))[..., None]
    return (2.0 * inter + eps) / (sizes + eps)


def simple_fuse(raters: torch.Tensor, num_iters: int = 5, alpha: float = 1.0,
                live: torch.Tensor | None = None) -> torch.Tensor:
    """SIMPLE fusion of a (..., R, H, W) binary stack -> (..., H, W) uint8.

    Each round scores every rater by Dice against the current estimate,
    deactivates raters scoring below mean - alpha * std of the active set
    (the best rater is never deactivated), and re-votes.

    The (num_iters=5, alpha=1.0) defaults are part of the output contract:
    on few-rater stacks the cut discretely changes which raters survive, so
    other settings give other masks (echoflow/ops/fusion.py:71-80).

    `live` (..., R) marks the raters that exist: dead raters start
    deactivated and carry zero weight in every statistic. At least one
    rater must be live (`fuse_frames` guards the zero-live case)."""
    raters = raters.float()
    if live is None:
        active = torch.ones(raters.shape[:-2], dtype=torch.float32, device=raters.device)
    else:
        active = live.float()
    est = majority_vote(raters, active)
    for _ in range(num_iters):
        dice = _pairwise_dice(raters, est)
        n_active = torch.clamp(_rater_sum(active, -1), min=1.0)
        mu = _rater_sum(dice * active, -1) / n_active
        var = _rater_sum(active * (dice - mu[..., None]) ** 2, -1) / n_active
        thresh = mu - alpha * torch.sqrt(var)
        new_active = active * (dice >= thresh[..., None]).float()
        # Never drop every rater: keep the best-scoring one unconditionally
        # (argmax takes the first maximal index, as jnp.argmax does).
        best = torch.argmax(torch.where(active > 0, dice, float("-inf")), dim=-1)
        active = new_active.scatter(-1, best[..., None], 1.0)
        est = majority_vote(raters, active)
    return est


def staple_fuse(raters: torch.Tensor, num_iters: int = 30, init_pq: float = 0.99999,
                undecided_label: int | None = None,
                live: torch.Tensor | None = None) -> torch.Tensor:
    """Binary STAPLE-EM fusion of a (..., R, H, W) stack -> (..., H, W) uint8.

    Per-rater sensitivity p and specificity q start at `init_pq`; the
    voxelwise prior is the stack's global foreground fraction and stays
    fixed (ITK's convention). `undecided_label` labels exact posterior ties
    as ITK's MultiLabelSTAPLE does; None keeps log_a >= log_b -> 1. `live`
    as in `simple_fuse`: dead raters add no log-likelihood and no prior."""
    d = raters.float()
    num_raters = d.shape[-3]
    batch = d.shape[:-3]
    if live is None:
        lv = torch.ones((*batch, num_raters), dtype=torch.float32, device=d.device)
    else:
        lv = live.float()
    lv3 = lv[..., None, None]
    n_live = torch.clamp(_rater_sum(lv, -1), min=1.0)
    per_pixel = d.shape[-2] * d.shape[-1]
    prior = torch.clamp((lv3 * d).sum(dim=(-3, -2, -1)) / (n_live * per_pixel),
                        1e-5, 1.0 - 1e-5)[..., None, None]
    p = torch.full((*batch, num_raters), init_pq, dtype=torch.float32, device=d.device)
    q = torch.full_like(p, init_pq)
    eps = 1e-7

    def log_ab(p, q):
        p3, q3 = p[..., None, None], q[..., None, None]
        log_a = torch.log(prior) + _rater_sum(
            lv3 * (d * torch.log(p3 + eps) + (1.0 - d) * torch.log(1.0 - p3 + eps)), -3)
        log_b = torch.log(1.0 - prior) + _rater_sum(
            lv3 * ((1.0 - d) * torch.log(q3 + eps) + d * torch.log(1.0 - q3 + eps)), -3)
        return log_a, log_b

    for _ in range(num_iters):
        log_a, log_b = log_ab(p, q)
        w = torch.sigmoid(log_a - log_b)[..., None, :, :]   # P(truth = 1)
        w_sum = w.sum(dim=(-3, -2, -1)) + eps
        not_w_sum = (1.0 - w).sum(dim=(-3, -2, -1)) + eps
        p = torch.clamp((w * d).sum(dim=(-2, -1)) / w_sum[..., None], eps, 1 - eps)
        q = torch.clamp(((1.0 - w) * (1.0 - d)).sum(dim=(-2, -1)) / not_w_sum[..., None],
                        eps, 1 - eps)
    log_a, log_b = log_ab(p, q)
    decision = (log_a >= log_b).to(torch.uint8)
    if undecided_label is not None:
        decision = torch.where(log_a == log_b,
                               torch.full_like(decision, undecided_label), decision)
    return decision


def softmax_mean_fuse(probs: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
    """(..., R, C, H, W) probability stack -> (..., H, W) uint8: mean over
    the live raters (`valid` (..., R) 0/1), then argmax over classes."""
    if valid is None:
        mean = _rater_sum(probs, -4) / probs.shape[-4]
    else:
        v = valid.to(probs.dtype)
        num = _rater_sum(v[..., None, None, None] * probs, -4)
        mean = num / torch.clamp(_rater_sum(v, -1), min=1e-12)[..., None, None, None]
    return torch.argmax(mean, dim=-3).to(torch.uint8)


def fuse_frames(rater_stack: torch.Tensor, valid: torch.Tensor, method: str = "simple",
                num_iters: int = 5) -> torch.Tensor:
    """Fuse every frame of a video at once.

    rater_stack (T, R, H, W) binary labels, already shift-aligned; valid
    (T, R) 0/1 liveness. Dead raters carry zero weight everywhere, a frame
    with one live rater copies it through unfused (reference
    fuse_utils.py:92-93), and a frame with none is all background."""
    live = valid.float()
    if method == "majority":
        fused = majority_vote(rater_stack, live)
    elif method == "simple":
        fused = simple_fuse(rater_stack, num_iters=num_iters, live=live)
    elif method == "staple":
        fused = staple_fuse(rater_stack, live=live)
    else:
        raise ValueError(f"unknown fuse method: {method}")
    n_live = _rater_sum(live, -1)[:, None, None]
    first_live = torch.argmax(live, dim=1)
    single = rater_stack[torch.arange(rater_stack.shape[0], device=rater_stack.device),
                         first_live].to(torch.uint8)
    out = torch.where(n_live <= 1.0, single, fused)
    return torch.where(n_live < 1.0, torch.zeros_like(out), out)
