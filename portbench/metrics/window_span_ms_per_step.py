"""Device milliseconds a step of the program's `swin.windows` span
(`models/swin3d.py`: each block's roll and window partition and its
window reverse and unroll, and each patch merging's pad and gather, with
their backwards) in the traced train window: the stamps around it inside
the graphed step's replays (portbench/spans.py). Reads
`window_span_ms_per_step.swin` (moves train_step_ms). Silent in a program
without the span."""

from portbench import spans


def read(ctx):
    snap = spans.program(ctx)
    if snap is None or not ctx["steps"]:
        return None
    ms = spans.device_ms(snap, "swin.windows")
    return ms / ctx["steps"] if ms > 0 else None
