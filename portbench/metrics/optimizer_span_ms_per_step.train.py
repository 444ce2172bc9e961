"""Device milliseconds a step of the program's `train.optimizer` span
(`train/loop.py`: Adam's update at the device LR) in the traced train
window: the stamps around it inside the graphed step's replays
(portbench/spans.py). Reads `optimizer_span_ms_per_step.train` (moves
train_step_ms) and `.train.bf16` (moves train_step_ms.bf16)."""

from portbench import spans


def read(ctx):
    snap = spans.program(ctx)
    if snap is None or not ctx["steps"]:
        return None
    ms = spans.device_ms(snap, "train.optimizer")
    return ms / ctx["steps"] if ms > 0 else None
