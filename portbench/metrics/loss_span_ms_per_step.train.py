"""Device milliseconds a step of the program's `train.ota_and_chains` span
(`train/loop.py`: the fused OTA loss with its warp chains on K2, and the
other loss terms) in the traced train window: the stamps around it
inside the graphed step's replays (portbench/spans.py). Reads
`loss_span_ms_per_step.train` (moves train_step_ms) and `.train.bf16`
(moves train_step_ms.bf16)."""

from portbench import spans


def read(ctx):
    snap = spans.program(ctx)
    if snap is None or not ctx["steps"]:
        return None
    ms = spans.device_ms(snap, "train.ota_and_chains")
    return ms / ctx["steps"] if ms > 0 else None
