"""The depthwise convs' share of their roofline in the traced train window:
the least time of their traffic a step (`depthwise_bytes` in the context,
portbench/flops_csn.py: forward x, w, y; input gradient dy, w, dx; weight
gradient x, dy, dW; each once, fp32) at 3.35 TB/s, over the device time
a step of the program's `conv.depthwise` span, which holds those passes
(portbench/spans.py). Reads `depthwise_roofline_pct.csn` (moves
train_step_ms). Silent in a program without the span."""

from portbench import spans
from portbench.peaks import PEAK_HBM_BYTES


def read(ctx):
    snap = spans.program(ctx)
    if snap is None or not ctx["steps"] or "depthwise_bytes" not in ctx:
        return None
    ms = spans.device_ms(snap, "conv.depthwise")
    if ms <= 0:
        return None
    return 100.0 * ctx["steps"] * ctx["depthwise_bytes"] / PEAK_HBM_BYTES / (ms / 1e3)
