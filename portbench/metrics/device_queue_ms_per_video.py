"""The mean wait of a video for the card in the traced archive window:
from the end of its `engine.stage` span (its replay enqueued) to its
replay's first device stamp, joined by the engine's number for the
video, both on the host's clock (portbench/spans.py). Moves
video_p95_ms."""

from portbench import spans


def read(ctx):
    snap = spans.program(ctx)
    if snap is None or not ctx["videos"]:
        return None
    staged = {s["id"]: s["end_ns"] for s in snap["host"] if s["name"] == "engine.stage"}
    first = {}
    for s in snap["device"]:
        if s["id"] in staged:
            first[s["id"]] = min(first.get(s["id"], s["start_ns"]), s["start_ns"])
    waits = [first[i] - staged[i] for i in first]
    return sum(waits) / len(waits) / 1e6 if waits else None
