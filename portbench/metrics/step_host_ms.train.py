"""Host milliseconds a step of the train window's host path in the traced
train window: the program's `train.prefetch` (the next host batch and its
pinned upload, `train/loop.prefetch_to_device`), `graph.feed` (the
bindings check and the batch's copy into the graph's inputs),
`graph.replay` (the LR write and the launch) and `graph.outputs` (the
metrics' copies) spans (`utils/graphs.py`; portbench/spans.py). Reads
`step_host_ms.train` (moves train_step_ms) and `.train.bf16` (moves
train_step_ms.bf16)."""

from portbench import spans


def read(ctx):
    snap = spans.program(ctx)
    if snap is None or not ctx["steps"]:
        return None
    ms = spans.host_ms(snap, "train.prefetch", "graph.feed", "graph.replay", "graph.outputs")
    return ms / ctx["steps"] if ms > 0 else None
