"""BatchNorm folding for inference (port of `echoflow.models.fold_bn`).

In eval mode every BatchNorm applies a per-channel affine map with running
statistics, which is absorbed exactly into the preceding convolution:

    BN(conv(x, W)) = conv(x, W * s) + (beta - mean * s),
    s = scale / sqrt(var + eps)

The arithmetic runs in float32 numpy in the same order as `echoflow`'s, so
a folded state dict is bitwise the conversion of `fold_variables`' tree.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from echoflow_torch.models.convert import _key_plan

_EPS = 1e-5


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def is_folded(state_dict: Mapping) -> bool:
    return not any(k.endswith("running_var") for k in state_dict)


def fold_state_dict(state_dict: Mapping) -> dict:
    """Unfolded state dict -> state dict of `R2Plus1DMotionSegNet(folded=True)`:
    every (conv, BN) pair becomes a biased conv; heads and fc pass through."""
    plan = _key_plan()
    out: dict = {}
    for i, (prefix, kind, _) in enumerate(plan):
        if kind == "bn":
            continue
        weight = _np(state_dict[f"{prefix}.weight"]).astype(np.float32)
        bias = state_dict.get(f"{prefix}.bias")
        nxt = plan[i + 1] if i + 1 < len(plan) else None
        if nxt is not None and nxt[1] == "bn":
            bn = {part: _np(state_dict[f"{nxt[0]}.{part}"]).astype(np.float32)
                  for part in ("weight", "bias", "running_mean", "running_var")}
            s = bn["weight"] / np.sqrt(bn["running_var"] + _EPS)
            # O is axis 0 of a Conv3d weight (flax folds along its last axis).
            weight = weight * s.reshape(-1, *([1] * (weight.ndim - 1)))
            base = _np(bias).astype(np.float32) if bias is not None else 0.0
            bias = (base - bn["running_mean"]) * s + bn["bias"]
        out[f"{prefix}.weight"] = torch.from_numpy(np.ascontiguousarray(weight))
        if bias is not None:
            out[f"{prefix}.bias"] = torch.from_numpy(np.asarray(_np(bias), np.float32))
    return out
