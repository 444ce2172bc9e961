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
to the folded model's state dict. `variables_from_state_dict` is the
inverse (state dict -> flax tree), also for trees shaped like `params`
alone, such as Adam's moments. `load_kinetics_backbone` grafts a stock
torchvision `r2plus1d_18` state dict onto the backbone. `load_flax_params`
fills the CAMUS harness's small models (SegNet, ShapeAutoencoder) from
their flax variables.
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


def state_dict_from_variables(variables: Mapping, params_only: bool = False) -> dict:
    """`echoflow` flax variables (numpy or jax leaves) -> the port's state
    dict (float32 CPU tensors). Unfolded trees must carry `batch_stats`;
    a tree without them is taken as folded. With `params_only=True`,
    `variables` is an unfolded `params` tree alone (such as Adam's moments)
    and the result holds the parameters only. Raises on a missing layer
    and on a leaf that nothing consumed, so drift cannot pass silently."""
    if params_only:
        params, stats, folded = variables, {}, False
    else:
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
                if coll == "params" or not params_only:
                    out[f"{prefix}.{part}"] = _vec(take(coll, path + (leaf,)))
            if not params_only:
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


def _kernel(w) -> np.ndarray:
    """Conv3d weight (O, I, D, H, W) -> flax kernel (D, H, W, I, O)."""
    return np.ascontiguousarray(np.transpose(_np(w), (2, 3, 4, 1, 0)))


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy().astype(np.float32) if isinstance(v, torch.Tensor) \
        else np.asarray(v, np.float32)


def variables_from_state_dict(state_dict: Mapping, params_only: bool = False) -> dict:
    """The port's state dict -> `echoflow` flax variables with numpy
    leaves: the inverse of `state_dict_from_variables`. A state dict
    without BatchNorm keys is taken as folded. With `params_only=True` the
    state dict holds parameters alone (the tree of Adam's moments, keyed by
    parameter name) and the result is the `params` tree. Raises on a
    missing key and on a key that nothing consumed."""
    folded = not params_only and not any(k.endswith(".running_mean") for k in state_dict)
    stats_too = not (folded or params_only)
    used = set()
    tree: dict = {"params": {}, "batch_stats": {}}

    def take(key):
        if key not in state_dict:
            raise KeyError(f"missing {key}")
        used.add(key)
        return state_dict[key]

    def put(coll, path, value):
        node = tree[coll]
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value

    for prefix, kind, path in _key_plan():
        if kind == "bn":
            if folded:
                continue
            for part, coll, leaf in _BN_PARTS:
                if coll == "params" or stats_too:
                    put(coll, path + (leaf,), _np(take(f"{prefix}.{part}")))
            if stats_too and f"{prefix}.num_batches_tracked" in state_dict:
                used.add(f"{prefix}.num_batches_tracked")
        elif kind == "conv":
            put("params", path + ("kernel",), _kernel(take(f"{prefix}.weight")))
            if f"{prefix}.bias" in state_dict:
                put("params", path + ("bias",), _np(take(f"{prefix}.bias")))
        elif kind == "fc":
            put("params", ("fc_kernel",), np.ascontiguousarray(_np(take(f"{prefix}.weight")).T))
            put("params", ("fc_bias",), _np(take(f"{prefix}.bias")))
        else:  # comb1
            put("params", ("comb1_kernel",), _kernel(take(f"{prefix}.weight")))
            put("params", ("comb1_bias",), _np(take(f"{prefix}.bias")))
    unused = [k for k in state_dict if k not in used]
    if unused:
        raise KeyError(f"unconverted keys: {unused[:5]}")
    if params_only:
        return tree["params"]
    return tree if stats_too else {"params": tree["params"]}


BACKBONE_PREFIX = "r2plus1d_model."


def convert_kinetics_backbone(state_dict: Mapping, base_state_dict: Mapping) -> dict:
    """Backbone-only initialization from a stock torchvision `r2plus1d_18`
    Kinetics-400 state dict (keys `stem.*`, `layer{1-4}.*`, `fc.*`, maybe
    under a DataParallel `module.` prefix): the reference's recipe, which
    fine-tunes `r2plus1d_18(pretrained=True)` with fresh decoder and heads
    (src/model/R2plus1D_18_MotionNet.py:13). Returns a new state dict:
    `base_state_dict` with every `r2plus1d_model.*` entry replaced. Raises
    on a key outside the backbone, a shape mismatch, or a backbone entry
    the checkpoint does not cover."""
    out = dict(base_state_dict)
    given = set()
    for key, value in strip_module_prefix(state_dict).items():
        name = BACKBONE_PREFIX + key
        if name not in base_state_dict:
            raise KeyError(f"non-backbone key {key!r} in state dict: a full reference "
                           "checkpoint loads with load_reference_state_dict")
        value = torch.as_tensor(value)
        if tuple(value.shape) != tuple(base_state_dict[name].shape):
            raise ValueError(f"shape mismatch at {key}: checkpoint {tuple(value.shape)} "
                             f"vs model {tuple(base_state_dict[name].shape)}")
        out[name] = value.to(base_state_dict[name].dtype).clone()
        given.add(name)
    missing = [k for k in base_state_dict if k.startswith(BACKBONE_PREFIX) and k not in given
               and not k.endswith("num_batches_tracked")]
    if missing:
        raise ValueError(f"Kinetics state dict does not cover the full backbone; "
                         f"missing e.g. {missing[:5]}")
    return out


def load_kinetics_backbone(path: str, base_state_dict: Mapping) -> dict:
    """A stock torchvision r2plus1d_18 Kinetics `.pth` (a bare state dict,
    or one under 'state_dict' or 'model') grafted onto `base_state_dict`."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    for wrapper in ("state_dict", "model"):
        if isinstance(payload, dict) and wrapper in payload:
            payload = payload[wrapper]
    return convert_kinetics_backbone(payload, base_state_dict)


def load_flax_params(module: torch.nn.Module, variables: Mapping) -> torch.nn.Module:
    """Fill a port module that lists `FLAX_LAYERS`, pairs of (flax module
    name, torch submodule name), from flax variables (or their "params"):
    a Conv kernel (kh, kw, in, out) becomes (out, in, kh, kw), a
    ConvTranspose kernel (kh, kw, in, out) torch's (in, out, kh, kw) flipped
    in space (`models/flax_layers.py`), a Dense kernel (in, out) its
    transpose. Every parameter of the module must be listed."""
    from echoflow_torch.models.flax_layers import SameConvTranspose2d

    params = variables.get("params", variables)
    state = {}
    for flax_name, name in module.FLAX_LAYERS:
        layer, p = module.get_submodule(name), params[flax_name]
        kernel = np.asarray(p["kernel"], np.float32)
        if isinstance(layer, SameConvTranspose2d):
            weight = kernel.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
        elif isinstance(layer, torch.nn.Conv2d):
            weight = kernel.transpose(3, 2, 0, 1)
        elif isinstance(layer, torch.nn.Linear):
            weight = kernel.T
        else:
            raise TypeError(f"load_flax_params: no rule for {type(layer).__name__}")
        state[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(weight))
        state[f"{name}.bias"] = torch.from_numpy(np.asarray(p["bias"], np.float32).copy())
    module.load_state_dict(state)
    return module
