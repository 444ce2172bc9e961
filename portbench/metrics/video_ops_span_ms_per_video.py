"""Device milliseconds a video of the program's `shift`, `reinterp` and
`fusion` spans (`infer/pipeline.py`: normalization, shift and
tail-stretch, the gather of clips; the softmax of each chunk, the
re-interpolation to each shift's length and the argmax; the shift-aligned
gather, the fusion and the bit-pack) in the traced archive window
(portbench/spans.py). Moves frames_per_s."""

from portbench import spans


def read(ctx):
    snap = spans.program(ctx)
    if snap is None or not ctx["videos"]:
        return None
    ms = spans.device_ms(snap, "shift", "reinterp", "fusion")
    return ms / len(ctx["videos"]) if ms > 0 else None
