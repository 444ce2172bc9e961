"""Seeded weights of CLAS-FV over Video Swin-B, made on the device: the
published init of the backbone (each Linear's weight and each
relative-position bias table normal with std 0.02, cut at +-2 as timm's
`trunc_normal_` cuts it; Linear biases 0; LayerNorms the identity; the
patch embedding's conv weight and bias uniform on +-1/sqrt(its fan-in),
as `nn.Conv3d` inits itself; the unused Kinetics head 0) and CLAS-FV's
decoder as `portbench/weights.py` draws it (comb2 and the heads
Kaiming-normal with fan_out; the motion head N(0, sqrt(1e-5)); comb1
uniform on +-1/sqrt(its 2048 inputs); conv biases 0; BatchNorm the
identity), over the keys and shapes of `reference/swin3d.state_shapes`.
The normal leaves come from one `randn` and the uniform ones from one
`rand` of a generator on the device seeded with `seed`, so a seed gives
the same weights on every card.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.swin3d import BACKBONE, state_shapes

DECODER_NORMAL = ("comb_2_layer.weight", "segmentation_head.weight", "motion_head.weight")


def _kind(key, shape):
    """"trunc", "kaiming", "uniform" or None (a constant) of a leaf."""
    if key.startswith(f"{BACKBONE}.patch_embed.proj.") or key == "comb_1_layer.weight":
        return "uniform"
    if key.endswith("relative_position_bias_table"):
        return "trunc"
    if key.startswith(BACKBONE) and key.endswith(".weight") and len(shape) == 2 \
            and not key.startswith(f"{BACKBONE}.fc."):
        return "trunc"
    if key in DECODER_NORMAL:
        return "kaiming"
    return None


def make_state(cfg, seed: int, device) -> dict:
    """The unfolded state dict (fp32) of `cfg` on `device`."""
    shapes = state_shapes(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    normal_keys = [k for k, s in shapes.items() if _kind(k, s) in ("trunc", "kaiming")]
    uniform_keys = [k for k, s in shapes.items() if _kind(k, s) == "uniform"]
    sizes = [math.prod(shapes[k]) for k in normal_keys]
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    usizes = [math.prod(shapes[k]) for k in uniform_keys]
    uniform = torch.rand(sum(usizes), generator=gen, device=device)
    state = {}
    for key, part in zip(normal_keys, torch.split(normal, sizes)):
        shape = shapes[key]
        if _kind(key, shape) == "trunc":
            state[key] = (part * 0.02).clamp_(-2.0, 2.0).reshape(shape)
        else:
            std = (math.sqrt(1e-5) if key == "motion_head.weight"
                   else math.sqrt(2.0 / (shape[0] * math.prod(shape[2:]))))
            state[key] = (part * std).reshape(shape)
    embed_in = math.prod(shapes[f"{BACKBONE}.patch_embed.proj.weight"][1:])
    for key, part in zip(uniform_keys, torch.split(uniform, usizes)):
        fan_in = shapes[key][1] if key == "comb_1_layer.weight" else embed_in
        state[key] = ((part * 2 - 1) / math.sqrt(fan_in)).reshape(shapes[key])
    for key, shape in shapes.items():
        if key in state:
            continue
        if key.endswith("num_batches_tracked"):
            state[key] = torch.zeros((), dtype=torch.long, device=device)
        elif key.endswith(("running_var", ".weight")) and len(shape) == 1:
            state[key] = torch.ones(shape, device=device)   # LayerNorm, BatchNorm scale, variance
        else:
            state[key] = torch.zeros(shape, device=device)  # biases, means, the Kinetics head
    return {k: state[k] for k in shapes}
