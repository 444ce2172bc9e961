"""Device milliseconds a step of the program's `conv.depthwise` span
(`ops/conv.py`: each depthwise conv's forward, and its input-gradient and
weight-gradient routes in the backward) in the traced train window: the
stamps around it inside the graphed step's replays (portbench/spans.py).
It covers the depthwise kernels whatever library runs them and whatever
their names. Reads `depthwise_span_ms_per_step.csn` (moves
train_step_ms). Silent in a program without the span."""

from portbench import spans


def read(ctx):
    snap = spans.program(ctx)
    if snap is None or not ctx["steps"]:
        return None
    ms = spans.device_ms(snap, "conv.depthwise")
    return ms / ctx["steps"] if ms > 0 else None
