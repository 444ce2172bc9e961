"""Device milliseconds a step of the program's `dp.all_reduce` span
(`parallel/mesh.average_gradients`: the flat gradient buffer divided by
the world size and all-reduced over the ranks, after the backward) in
rank 0's traced train window: the stamps around it inside the graphed
step's replays (portbench/spans.py). Reads `allreduce_span_ms_per_step.dp4`
(moves train_step_ms). Silent in a program without the span."""

from portbench import spans


def read(ctx):
    snap = spans.program(ctx)
    if snap is None or not ctx["steps"]:
        return None
    ms = spans.device_ms(snap, "dp.all_reduce")
    return ms / ctx["steps"] if ms > 0 else None
