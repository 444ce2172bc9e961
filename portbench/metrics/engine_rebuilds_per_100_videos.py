"""Graph warm-ups and captures and per-length operand builds in the traced
archive window, per 100 videos: the growth of the program's counters
`graph.warm_ups`, `graph.captures` and `engine.operand_misses` over the
window's tracing session (portbench/spans.py). The set-up warms up every
length of the pool, so each is a stall the warm-up missed. Moves
video_p95_ms."""

from portbench import spans

REBUILDS = ("graph.warm_ups", "graph.captures", "engine.operand_misses")


def read(ctx):
    snap = spans.program(ctx)
    if snap is None or not ctx["videos"]:
        return None
    return 100.0 * sum(snap["counters"].get(k, 0) for k in REBUILDS) / len(ctx["videos"])
