"""Device milliseconds of the convolution kernels (cuDNN's and CUTLASS's
implicit GEMMs, by name) in the traced archive window, over the clips
forwarded (those of the chunks, padding included). The backbone's convs
are most of the forward. cuDNN's BatchNorm, layout (NCHW<->NHWC) and
dtype-conversion kernels carry "cudnn" in their names too; they are taken
out first. The kernels the class took, and those no class takes, are
printed with their time on standard error. Moves frames_per_s."""

import re
import sys

# BatchNorm, layout and dtype-conversion kernels, whichever library runs
# them: never convs.
NOT_CONV = r"(?i)(cudnn::bn_|bn_fw_|bn_bw_|batch_norm|nchwToNhwc|nhwcToNchw|convertTensor)"
CONV = r"(?i)(xmma|implicit_gemm|implicit_convolve|cudnn|cutlass|dgrad|wgrad|fprop|conv(?!ert))"
# Other classes, named so that what is left unclassified shows.
OTHER = (r"(?i)(gemm|nvjet|transpose|elementwise|reduce|copy|memcpy|memset|"
         r"decoder_heads|softmax|cat|index|gather|scatter|argmax|sum|fill|arange|where|clamp|"
         r"upsample|interpolate|mean|pow|sqrt|mul|add|div|sub|max|min|cast|convert)")


def is_conv(name):
    return re.search(CONV, name) is not None and re.search(NOT_CONV, name) is None


def read(ctx):
    trace = ctx["trace"]
    if trace is None or not ctx["videos"]:
        return None
    left, took = {}, {}
    for name, s, e in trace.kernels:
        if is_conv(name):
            took[name[:90]] = took.get(name[:90], 0.0) + (e - s) / 1e3
        elif not re.search(NOT_CONV, name) and not re.search(OTHER, name):
            left[name[:90]] = left.get(name[:90], 0.0) + (e - s) / 1e3
    for what, kernels in (("unclassified", left), ("conv", took)):
        print(f"{what} kernels, ms (conv_ms_per_clip.archive): "
              f"{dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:15])}", file=sys.stderr)
    clips = sum(sum(v["chunks"]) for v in ctx["videos"])
    ms = sum(e - s for name, s, e in trace.kernels if is_conv(name)) / 1e3
    return ms / clips if ms > 0 else None
