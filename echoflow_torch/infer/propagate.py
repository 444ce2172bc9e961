"""Motion-field label and image propagation: warp rollouts (port of
`echoflow.infer.propagate`).

Chain the predicted forward and backward motion fields to carry a frame's
label, or the frame itself, through a clip (reference
src/visualization_utils.py:58-130). The warps are
`ops/warp.warp_image_with_offsets`: bilinear runs the warp-forward kernel
(`ops/warp_kernel.warp_forward`) on the card and its plain version on the
CPU; "nearest" is `warp_nearest_border`. echoflow's `lax.scan` chains are
Python loops over the chain steps, one warp launch a step for all N
samples; the single-step warps of every frame in `deform_images_forback`
are one warp over (T-1) N images.

On CUDA tensors each rollout runs as CUDA graphs, as echoflow compiles each
scan once (`utils/graphs.GraphedFunction`): one graph for each shape,
dtype, `mode` and index, made at the second call with them (the first runs
eagerly) and replayed after that, bitwise the eager rollout (K2 adds in a
fixed order). Each rollout keeps the graphs of its 8 most recently used
keys (`fn.clear()` drops them all). `fn.__wrapped__` is the eager rollout.
On the CPU each is its eager rollout.
"""

from __future__ import annotations

import torch

from echoflow_torch.ops.warp import warp_image_with_offsets
from echoflow_torch.utils.graphs import GraphedFunction


def _chain(carry: torch.Tensor, flows, mode: str) -> torch.Tensor:
    """Warp `carry` (N, C, H, W) by each (N, 2, H, W) flow in turn; returns
    the stack of every step's result, (S, N, C, H, W)."""
    steps = []
    for flow in flows:
        carry = warp_image_with_offsets(carry, flow, mode=mode)
        steps.append(carry)
    return torch.stack(steps) if steps else carry.new_empty((0, *carry.shape))


@GraphedFunction
def apply_sequence_deformation(source: torch.Tensor, motion: torch.Tensor,
                               start_index: int, end_index: int,
                               mode: str = "bilinear",
                               forward: bool = True) -> torch.Tensor:
    """Chain-warp `source` (N, C, H, W) from `start_index` to `end_index`
    using forward flows (motion[:, :2, t]) or backward flows
    (motion[:, 2:, t]), t over `range(start_index, end_index, ±1)`
    (reference visualization_utils.py:107-130). Returns the final warped
    frame."""
    flows = motion[:, :2] if forward else motion[:, 2:]
    out = source
    for t in range(start_index, end_index, 1 if forward else -1):
        out = warp_image_with_offsets(out, flows[:, :, t], mode=mode)
    return out


@GraphedFunction
def deform_forback(label_ed: torch.Tensor, label_es: torch.Tensor,
                   motion: torch.Tensor, mode: str = "nearest"):
    """Chained rollouts: ED carried forward through every frame, ES carried
    backward (reference get_deformed_label_forback,
    visualization_utils.py:58-80, generalized to any clip length).

    label_* (N, C, H, W); motion (N, 4, T, H, W). Returns
    (forwards (T-1, N, C, H, W), backwards (T-1, N, C, H, W)) where
    forwards[i] is the label at frame i+1 and backwards[i] at frame T-2-i.
    The backward chain takes the backward flows of frames T-1, ..., 1."""
    t_len = motion.shape[2]
    fwd_flows = (motion[:, :2, t] for t in range(t_len - 1))
    bwd_flows = (motion[:, 2:, t] for t in range(t_len - 1, 0, -1))
    return _chain(label_ed, fwd_flows, mode), _chain(label_es, bwd_flows, mode)


@GraphedFunction
def deform_images_forback(images: torch.Tensor, motion: torch.Tensor,
                          mode: str = "bilinear"):
    """Single-step warps of every frame (reference
    get_deformed_image_forback, visualization_utils.py:83-104: its forward
    path warps each *real* frame once, it does not chain). images
    (N, C, T, H, W).

    Returns (forwards, backwards), each (T-1, N, C, H, W): forwards[i] is
    frame i warped by forward flow i (a prediction of frame i+1), all in
    one warp; backwards follows the reference's chained backward variant,
    starting from the last frame."""
    n, c, t_len, h, w = images.shape
    frames = images[:, :, :-1].movedim(2, 0).reshape((t_len - 1) * n, c, h, w)
    flows = motion[:, :2, :-1].movedim(2, 0).reshape((t_len - 1) * n, 2, h, w)
    forwards = warp_image_with_offsets(frames, flows, mode=mode).reshape(t_len - 1, n, c, h, w)
    bwd_flows = (motion[:, 2:, t] for t in range(t_len - 1, 0, -1))
    return forwards, _chain(images[:, :, -1], bwd_flows, mode)


# Reference-named aliases (dict-based signatures normalized to arrays).
get_deformed_label_forback = deform_forback
get_deformed_image_forback = deform_images_forback
