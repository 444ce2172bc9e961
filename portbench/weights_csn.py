"""Seeded weights of CLAS-FV over ir-CSN-152, made on the device: the rule
and the draws of `portbench/weights.py` (every conv Kaiming-normal with
fan_out = out x kernel volume, a depthwise conv's too; conv biases 0; the
motion head N(0, sqrt(1e-5)); comb1 uniform on +-1/sqrt(its 3904 inputs);
BatchNorm the identity; the unused Kinetics fc 0), over the keys and
shapes of `reference/csn.state_shapes`. The normal leaves come from one
`randn` and comb1 from one `rand` of a generator on the device seeded with
`seed`, so a seed gives the same weights on every card.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.csn import state_shapes


def make_state(cfg, seed: int, device) -> dict:
    """The unfolded state dict (fp32) of `cfg` on `device`."""
    shapes = state_shapes(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    conv_keys = [k for k, s in shapes.items() if k.endswith(".weight") and len(s) == 5
                 and k != "comb_1_layer.weight"]
    sizes = [math.prod(shapes[k]) for k in conv_keys]
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    comb1 = torch.rand(shapes["comb_1_layer.weight"], generator=gen, device=device)
    state = {}
    for key, part in zip(conv_keys, torch.split(normal, sizes)):
        shape = shapes[key]
        std = (math.sqrt(1e-5) if key == "motion_head.weight"
               else math.sqrt(2.0 / (shape[0] * math.prod(shape[2:]))))
        state[key] = (part * std).reshape(shape)
    state["comb_1_layer.weight"] = (comb1 * 2 - 1) / math.sqrt(shapes["comb_1_layer.weight"][1])
    for key, shape in shapes.items():
        if key in state:
            continue
        if key.endswith("num_batches_tracked"):
            state[key] = torch.zeros((), dtype=torch.long, device=device)
        elif key.endswith(("running_var", ".weight")) and len(shape) == 1:
            state[key] = torch.ones(shape, device=device)        # BatchNorm scale, variance
        else:
            state[key] = torch.zeros(shape, device=device)       # biases, means, fc
    return {k: state[k] for k in shapes}
