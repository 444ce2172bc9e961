"""Device milliseconds of the program's `backbone` spans (the folded
R(2+1)D-18 backbone of every forward chunk, `models/fast_forward.py`) in
the traced archive window, over the clips forwarded (those of the chunks,
padding included, as conv_ms_per_clip.archive counts them): the stamps
around the backbone inside the engine's graph replays
(portbench/spans.py). Moves frames_per_s."""

from portbench import spans


def read(ctx):
    snap = spans.program(ctx)
    if snap is None or not ctx["videos"]:
        return None
    ms = spans.device_ms(snap, "backbone")
    return ms / sum(sum(v["chunks"]) for v in ctx["videos"]) if ms > 0 else None
