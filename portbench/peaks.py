"""Peak rates of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the
700 W limit) and the least times of the port's hand-written kernels,
frozen copies of `chip_smoke.py`'s arithmetic (`k1_bound`, the warp
kernels' operand bytes) taking shapes instead of tensors.
"""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12     # outside the tensor cores (TF32 off)
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# The peak a configuration's model FLOPs are held to, by its compute dtype.
MODEL_PEAK = {"float32": PEAK_FP32_FLOPS, "bfloat16": PEAK_BF16_FLOPS}


def k1_bound_s(batch, frames, sources, channels=64, out_hw=(112, 112), with_motion=False):
    """The least time of one decoder-tail launch (K1): `sources` are the
    (height, width) of its projections, each (batch, frames, h, w,
    channels) float32. Per output pixel, on the CUDA cores 8 FLOP per
    source channel for the bilinear sum, 2 per channel for +b1/ReLU and
    2*64*2 for the seg head (+ 2*64*4 for the motion head); on the tensor
    cores comb2's 2*64*64 three times (3xTF32, the least-cost route to fp32
    accuracy); each input read once, each output written once. The larger
    of the operations' time and the bytes' time."""
    pixels = batch * frames * out_hw[0] * out_hw[1]
    c = channels
    core = pixels * (8 * c * len(sources) + 2 * c + 2 * c * 2 + (2 * c * 4 if with_motion else 0))
    comb2 = pixels * 2 * c * c
    nbytes = sum(batch * frames * h * w * c * 4 for h, w in sources)
    nbytes += (c + c * c + c + c * 2 + 2) * 4 + pixels * (2 + (4 if with_motion else 0)) * 4
    ops = max(core / PEAK_FP32_FLOPS, 3 * comb2 / PEAK_TF32_FLOPS)
    return max(ops, nbytes / PEAK_HBM_BYTES)


def warp_bound_s(kind, pixels, channels, channels_b=0):
    """The least time of one warp launch, by bytes: `pixels` = n*h*w of its
    coordinate arrays, float32 throughout. K2 reads each image and writes
    its warp (two images at one set of coordinates in a pair launch) and
    reads px, py; K3 reads the output gradient, writes the image gradient
    and reads px, py; K4 reads the image and the output gradient, reads
    px, py and writes their gradients."""
    img = pixels * channels * 4
    pix = pixels * 4
    if kind == "K2":
        return (2 * img + 2 * pixels * channels_b * 4 + 2 * pix) / PEAK_HBM_BYTES
    if kind == "K3":
        return (2 * img + 2 * pix) / PEAK_HBM_BYTES
    if kind == "K4":
        return (2 * img + 4 * pix) / PEAK_HBM_BYTES
    raise ValueError(f"unknown warp kernel {kind!r}")
