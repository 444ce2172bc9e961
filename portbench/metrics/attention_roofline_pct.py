"""The windowed attention core's share of its roofline in the traced train
window: its least time a step, the larger of its FLOPs at 67 TFLOP/s (fp32,
TF32 off) and its least bytes at 3.35 TB/s (`attention_flops`,
`attention_bytes` in the context, portbench/flops_swin.py: both products
forward, four backward; q, k, v, the output, their gradients and the bias
table, each once), over the device time a step of the program's
`swin.attention` span, which holds those passes (portbench/spans.py).
Reads `attention_roofline_pct.swin` (moves train_step_ms). Silent in a
program without the span."""

from portbench import spans
from portbench.peaks import PEAK_FP32_FLOPS, PEAK_HBM_BYTES


def read(ctx):
    snap = spans.program(ctx)
    if snap is None or not ctx["steps"] or "attention_flops" not in ctx:
        return None
    ms = spans.device_ms(snap, "swin.attention")
    if ms <= 0:
        return None
    least = max(ctx["attention_flops"] / PEAK_FP32_FLOPS, ctx["attention_bytes"] / PEAK_HBM_BYTES)
    return 100.0 * ctx["steps"] * least / (ms / 1e3)
