"""The network of `VideoSegmenter` (infer/pipeline.py) and `ClipForward`
(infer/clips.py), over any backbone (`models/r2plus1d.backbone_of`): how it
is built (`inference_model`) and how it forwards a chunk of clips
(`forward`). With `kernel` it is folded (`models/fold_bn.py`) and runs
`models/fast_forward.folded_forward` with the decoder-tail kernel, its
backbone cast to `backbone_dtype` (in 16 bits on the card fitted to
cuDNN's tensor cores, `fold_bn.fit_tensor_cores`); without, the module's
forward computes in `dtype` on fp32 parameters (flax's rule), in the host
span `model_forward`. fp32 on CUDA turns TF32 off for cuDNN and matmuls,
process-wide (BASELINE.md:31-37).
"""

from __future__ import annotations

import torch

from echoflow_torch.models.fast_forward import folded_forward
from echoflow_torch.models.fold_bn import fit_tensor_cores, fold_state_dict, is_folded
from echoflow_torch.models.r2plus1d import backbone_of, motion_seg_net
from echoflow_torch.utils.profiling import span


def inference_model(variables: dict, device, dtype, backbone_dtype=None, fold_bn: bool = True,
                    kernel: bool = True):
    """The eval-mode, no-grad network of the state dict `variables` on
    `device` (module docstring). A state dict without BN statistics is
    taken as folded; `fold_bn` folds one that has them. `backbone_dtype`
    None is `dtype`."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (pass device='cpu' to run on the CPU)")
    backbone_dtype = dtype if backbone_dtype is None else backbone_dtype
    if device.type == "cuda" and torch.float32 in (dtype, backbone_dtype):
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    state = dict(variables)
    folded = is_folded(state)
    if fold_bn and not folded:
        state = fold_state_dict(state)
        folded = True
    if kernel and not folded:
        raise ValueError("the decoder-tail kernel needs a folded model; pass fold_bn=True "
                         "or forward with the module")
    model = motion_seg_net(backbone_of(state), folded=folded)
    model.load_state_dict(state)
    model.eval().requires_grad_(False)
    if kernel:
        model.backbone.to(backbone_dtype)
        fit_tensor_cores(model.backbone, device)
    else:
        model.compute_dtype = dtype
    return model.to(device)


def forward(model, xs: torch.Tensor, kernel: bool, dtype, with_motion: bool = True):
    """(seg, motion or None), float32, of the clips `xs` (N, 3, T, H, W):
    the folded forward with the decoder-tail kernel, its projections in
    `dtype`, or the module's forward."""
    if kernel:
        return folded_forward(model, xs, dtype=dtype, with_motion=with_motion)
    with span("model_forward"):
        seg, motion = model(xs)
    return seg, motion if with_motion else None
