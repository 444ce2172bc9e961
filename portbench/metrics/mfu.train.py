"""The model FLOPs of the traced window's train steps (portbench/flops.py:
each conv's forward, input gradient and weight gradient, the stem's input
gradient left out), over the window's wall times the configuration's peak
(fp32 67 TFLOP/s with TF32 off, bf16 989). Moves train_step_ms."""


def read(ctx):
    if ctx["trace"] is None or not ctx["steps"]:
        return None
    return 100.0 * ctx["steps"] * ctx["step_flops"] / (ctx["window_s"] * ctx["peak_flops"])
