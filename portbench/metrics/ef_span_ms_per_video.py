"""Host milliseconds a video of the program's `ef` span
(`infer/ef.compute_ef_using_putative_clips`: the area curve, peaks, pairs
and Simpson's pucks) on the benchmark's EF workers, in the traced archive
window (portbench/spans.py). Moves video_p95_ms."""

from portbench import spans


def read(ctx):
    snap = spans.program(ctx)
    if snap is None or not ctx["videos"]:
        return None
    ms = spans.host_ms(snap, "ef")
    return ms / len(ctx["videos"]) if ms > 0 else None
