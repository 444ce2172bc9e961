"""BatchNorm folding for inference (port of `echoflow.models.fold_bn`).

In eval mode every BatchNorm applies a per-channel affine map with running
statistics, which is absorbed exactly into the preceding convolution:

    BN(conv(x, W)) = conv(x, W * s) + (beta - mean * s),
    s = scale / sqrt(var + eps)

The arithmetic runs in float32 numpy in the same order as `echoflow`'s, so
a folded state dict is bitwise the conversion of `fold_variables`' tree.
An ir-CSN-152 state dict (`models/csn.py`) folds the same way, each
BatchNorm with its own eps, the depthwise convs included.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from echoflow_torch.models.convert import _key_plan
from echoflow_torch.models.r2plus1d import backbone_of

_EPS = 1e-5


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def is_folded(state_dict: Mapping) -> bool:
    return not any(k.endswith("running_var") for k in state_dict)


def _r2plus1d_pairs() -> list:
    """[(layer prefix, its BatchNorm's prefix or None, eps)] of R(2+1)D-18
    CLAS-FV, in `_key_plan`'s order."""
    plan = _key_plan()
    return [(prefix, nxt[0] if nxt[1] == "bn" else None, _EPS)
            for (prefix, kind, _), nxt in zip(plan, plan[1:] + [(None, None, None)])
            if kind != "bn"]


def fold_state_dict(state_dict: Mapping) -> dict:
    """Unfolded state dict -> state dict of the folded model over the same
    backbone (`models/r2plus1d.motion_seg_net(backbone_of(state_dict),
    folded=True)`): every (conv, BN) pair becomes a biased conv; heads and
    fc pass through."""
    if backbone_of(state_dict) == "ir_csn_152":
        from echoflow_torch.models.csn import fold_pairs

        pairs = fold_pairs(state_dict)
    else:
        pairs = _r2plus1d_pairs()
    out: dict = {}
    for prefix, bn_prefix, eps in pairs:
        weight = _np(state_dict[f"{prefix}.weight"]).astype(np.float32)
        bias = state_dict.get(f"{prefix}.bias")
        if bn_prefix is not None:
            bn = {part: _np(state_dict[f"{bn_prefix}.{part}"]).astype(np.float32)
                  for part in ("weight", "bias", "running_mean", "running_var")}
            s = bn["weight"] / np.sqrt(bn["running_var"] + eps)
            # O is axis 0 of a Conv3d weight (flax folds along its last axis).
            weight = weight * s.reshape(-1, *([1] * (weight.ndim - 1)))
            base = _np(bias).astype(np.float32) if bias is not None else 0.0
            bias = (base - bn["running_mean"]) * s + bn["bias"]
        out[f"{prefix}.weight"] = torch.from_numpy(np.ascontiguousarray(weight))
        if bias is not None:
            out[f"{prefix}.bias"] = torch.from_numpy(np.asarray(_np(bias), np.float32))
    return out
