"""Weights into the port: flax variables -> state dict, and reference `.pth`.

`state_dict_from_variables` is the exact inverse of
`echoflow.models.convert.convert_state_dict`: it maps an `echoflow`
`{'params', 'batch_stats'}` tree (numpy leaves) onto the reference key
names that `models/r2plus1d.py` uses. Layouts:

  - flax conv kernel (D, H, W, I, O) -> Conv3d weight (O, I, D, H, W)
    (inverts the transpose (2, 3, 4, 1, 0) of the forward converter);
    the (1, 1, 1, 1024, 64) comb1 kernel becomes the 1024 -> 64 conv;
  - flax fc kernel (I, O)            -> Linear weight (O, I);
  - params.{scale, bias} / batch_stats.{mean, var}
                                     -> BatchNorm weight/bias/running_mean/
                                        running_var.

A folded tree (`fold_variables` output: params only, biased convs) converts
to the folded model's state dict.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_BN_PARTS = (("weight", "params", "scale"), ("bias", "params", "bias"),
             ("running_mean", "batch_stats", "mean"),
             ("running_var", "batch_stats", "var"))


def _key_plan():
    """[(torch key prefix, kind, flax path)] for every layer, in state-dict
    order. kind: 'conv' (kernel + optional folded bias), 'bn', 'fc',
    'comb1' (top-level comb1_kernel / comb1_bias leaves)."""
    bb = "r2plus1d_model."
    plan = [(bb + "stem.0", "conv", ("backbone", "stem_conv_s")),
            (bb + "stem.1", "bn", ("backbone", "stem_bn_s")),
            (bb + "stem.3", "conv", ("backbone", "stem_conv_t")),
            (bb + "stem.4", "bn", ("backbone", "stem_bn_t"))]
    for layer in range(1, 5):
        for block in range(2):
            pre = f"{bb}layer{layer}.{block}."
            node = ("backbone", f"layer{layer}_block{block}")
            for ci in (1, 2):
                conv = node + (f"conv{ci}",)
                plan += [(f"{pre}conv{ci}.0.0", "conv", conv + ("spatial",)),
                         (f"{pre}conv{ci}.0.1", "bn", conv + ("bn_mid",)),
                         (f"{pre}conv{ci}.0.3", "conv", conv + ("temporal",)),
                         (f"{pre}conv{ci}.1", "bn", node + (f"bn{ci}",))]
            if layer > 1 and block == 0:
                plan += [(f"{pre}downsample.0", "conv", node + ("down_conv",)),
                         (f"{pre}downsample.1", "bn", node + ("down_bn",))]
    plan += [(bb + "fc", "fc", ()),
             ("comb_1_layer", "comb1", ()),
             ("comb_batch_norm_1", "bn", ("comb_bn1",)),
             ("comb_2_layer", "conv", ("comb2",)),
             ("comb_batch_norm_2", "bn", ("comb_bn2",)),
             ("motion_head", "conv", ("motion_head",)),
             ("segmentation_head", "conv", ("seg_head",))]
    return plan


def _node(tree: Mapping, path):
    for key in path:
        if key not in tree:
            return None
        tree = tree[key]
    return tree


def _conv_weight(kernel) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(kernel, np.float32), (4, 3, 0, 1, 2))))


def _vec(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, np.float32))


def state_dict_from_variables(variables: Mapping) -> dict:
    """`echoflow` flax variables (numpy or jax leaves) -> the port's state
    dict (float32 CPU tensors). Unfolded trees must carry `batch_stats`;
    a tree without them is taken as folded. Raises on a missing layer and
    on a leaf that nothing consumed, so drift cannot pass silently."""
    params = variables["params"]
    stats = variables.get("batch_stats")
    folded = stats is None
    used = set()
    out: dict = {}

    def take(coll, path):
        tree = params if coll == "params" else stats
        leaf = _node(tree, path)
        if leaf is None:
            raise KeyError(f"missing {coll}/{'/'.join(path)}")
        used.add((coll,) + tuple(path))
        return leaf

    for prefix, kind, path in _key_plan():
        if kind == "bn":
            if folded:
                continue
            for part, coll, leaf in _BN_PARTS:
                out[f"{prefix}.{part}"] = _vec(take(coll, path + (leaf,)))
            out[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
        elif kind == "conv":
            out[f"{prefix}.weight"] = _conv_weight(take("params", path + ("kernel",)))
            if _node(params, path + ("bias",)) is not None:
                out[f"{prefix}.bias"] = _vec(take("params", path + ("bias",)))
        elif kind == "fc":
            out[f"{prefix}.weight"] = _vec(np.asarray(take("params", ("fc_kernel",))).T)
            out[f"{prefix}.bias"] = _vec(take("params", ("fc_bias",)))
        else:  # comb1
            out[f"{prefix}.weight"] = _conv_weight(take("params", ("comb1_kernel",)))
            out[f"{prefix}.bias"] = _vec(take("params", ("comb1_bias",)))

    def leaves(tree, coll, pre=()):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                yield from leaves(v, coll, pre + (k,))
            else:
                yield (coll,) + pre + (k,)

    unused = [p for coll, tree in (("params", params), ("batch_stats", stats or {}))
              for p in leaves(tree, coll) if p not in used]
    if unused:
        raise KeyError(f"unconverted leaves: {['/'.join(p) for p in unused[:5]]}")
    return out


def strip_module_prefix(state_dict: Mapping) -> dict:
    """Drop the DataParallel `module.` prefix of reference checkpoints."""
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in state_dict.items()}


def load_reference_state_dict(path: str) -> dict:
    """A reference `.pth` ({'model': state_dict, ...} or a bare state dict)
    as the port's (unfolded) state dict."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state_dict = payload["model"] if "model" in payload else payload
    return strip_module_prefix(state_dict)
