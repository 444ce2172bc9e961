"""Device milliseconds of the program's `projections` and `decoder_tail`
spans (the merged tap projections and their time resize, then K1 and the
layout of its output, `models/fast_forward.py`) in the traced archive
window, over the clips forwarded, padding included (portbench/spans.py).
Moves frames_per_s."""

from portbench import spans


def read(ctx):
    snap = spans.program(ctx)
    if snap is None or not ctx["videos"]:
        return None
    ms = spans.device_ms(snap, "projections", "decoder_tail")
    return ms / sum(sum(v["chunks"]) for v in ctx["videos"]) if ms > 0 else None
