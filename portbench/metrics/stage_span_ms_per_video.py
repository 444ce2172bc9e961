"""Host milliseconds a video of the engine's `engine.stage` span, on its
dispatch thread (`infer/pipeline.py`: the per-length operands, the mono
check, the pinned staging and upload, the graph's feed and replay, the
enqueued download), in the traced archive window (portbench/spans.py).
Moves frames_per_s."""

from portbench import spans


def read(ctx):
    snap = spans.program(ctx)
    if snap is None or not ctx["videos"]:
        return None
    ms = spans.host_ms(snap, "engine.stage")
    return ms / len(ctx["videos"]) if ms > 0 else None
