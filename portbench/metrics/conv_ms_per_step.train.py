"""Device milliseconds a train step of the convolution and GEMM kernels in
the traced window: every conv's forward, input gradient and weight
gradient on the routes of `ops/conv.py` (cuDNN, sub-pixel cuDNN forward
convs, cuBLAS GEMMs), and the other GEMMs of the step (the decoder's
projections and resizes), which share the names. cuDNN's BatchNorm and
layout (NCHW<->NHWC) and dtype-conversion kernels carry "cudnn" in their
names too; they are taken out first. Moves train_step_ms."""

import re
import sys

# BatchNorm, layout and dtype-conversion kernels, whichever library runs
# them: never convs.
NOT_CONV = r"(?i)(cudnn::bn_|bn_fw_|bn_bw_|batch_norm|nchwToNhwc|nhwcToNchw|convertTensor)"
# cuBLAS names its GEMMs "...gemm..." or, on Hopper, "nvjet...".
CONV = (r"(?i)(xmma|implicit_gemm|implicit_convolve|cudnn|cutlass|dgrad|wgrad|fprop|"
        r"conv(?!ert)|gemm|cublas|nvjet)")
OTHER = (r"(?i)(transpose|elementwise|reduce|copy|memcpy|memset|warp_|"
         r"softmax|cat|index|gather|scatter|argmax|sum|fill|arange|where|clamp|"
         r"upsample|interpolate|mean|pow|sqrt|mul|add|div|sub|max|min|cast|adam|foreach|"
         r"tanh|threshold|relu|sigmoid|exp|log|norm)")


def is_conv(name):
    return re.search(CONV, name) is not None and re.search(NOT_CONV, name) is None


def read(ctx):
    trace = ctx["trace"]
    if trace is None or not ctx["steps"]:
        return None
    left, took = {}, {}
    for name, s, e in trace.kernels:
        if is_conv(name):
            took[name[:90]] = took.get(name[:90], 0.0) + (e - s) / 1e3
        elif not re.search(NOT_CONV, name) and not re.search(OTHER, name):
            left[name[:90]] = left.get(name[:90], 0.0) + (e - s) / 1e3
    for what, kernels in (("unclassified", left), ("conv", took)):
        print(f"{what} kernels, ms (conv_ms_per_step.train): "
              f"{dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:15])}", file=sys.stderr)
    ms = sum(e - s for name, s, e in trace.kernels if is_conv(name)) / 1e3
    return ms / ctx["steps"] if ms > 0 else None
