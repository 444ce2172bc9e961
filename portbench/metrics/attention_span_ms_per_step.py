"""Device milliseconds a step of the program's `swin.attention` span
(`ops/attention.py`: the windowed attention core of every Swin block, its
forward and its backward) in the traced train window: the stamps around
it inside the graphed step's replays (portbench/spans.py). Reads
`attention_span_ms_per_step.swin` (moves train_step_ms). Silent in a
program without the span."""

from portbench import spans


def read(ctx):
    snap = spans.program(ctx)
    if snap is None or not ctx["steps"]:
        return None
    ms = spans.device_ms(snap, "swin.attention")
    return ms / ctx["steps"] if ms > 0 else None
