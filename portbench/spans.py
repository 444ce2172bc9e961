"""The program's own spans and counters in a traced run, for the per-layer
readers of portbench/metrics/ that read them.

`program(ctx)` reads `echoflow_torch.utils.profiling.spans()` once a run
and keeps it in the context: the host spans and the device spans of the
program's last tracing session, which is the traced window's profiler
session, and the growth of its counters over that session. A program
without `spans()` (older than its tracer) gives None, as does a run
without a trace, and so does every reader of them: the metric is left out
of the line.

The program stamps its device spans on the card and reports them on the
host's clock (nanoseconds since the epoch, as `time.time_ns()` reads it);
the trace's times are microseconds from its own start. Once a run this
prints on standard error what the line cannot hold: how well the stamps
agree with their kernel records in the trace (`span_stamp_kernel`), once
a single offset between the two clocks is fitted; the share of the
device's busy time in the window that the device spans cover; and, for the
window's longest idle gaps, the program's host spans open at the gap's
middle on any thread (the breakdown's names come from the ranges of the
thread that runs the profiler only).
"""

from __future__ import annotations

import sys

STAMP = "span_stamp_kernel"


def program(ctx):
    """The program's spans of the traced window (see the module
    docstring), or None."""
    if ctx.get("trace") is None:
        return None
    if "program_spans" not in ctx:
        from echoflow_torch.utils import profiling

        read = getattr(profiling, "spans", None)
        snap = read() if read is not None else None
        if snap is not None and not (snap["host"] or snap["device"]):
            snap = None
        if snap is not None:
            report(ctx["trace"], snap)
        ctx["program_spans"] = snap
    return ctx["program_spans"]


def device_ms(snap, *names) -> float:
    """Summed milliseconds of the device spans named."""
    return sum(s["end_ns"] - s["start_ns"] for s in snap["device"] if s["name"] in names) / 1e6


def host_ms(snap, *names) -> float:
    """Summed milliseconds of the host spans named."""
    return sum(s["end_ns"] - s["start_ns"] for s in snap["host"] if s["name"] in names) / 1e6


def clock_fit(trace, snap):
    """(to_trace, pairs, drift_ppm): the line that takes a program time
    (ns since the epoch) to the trace's clock (us), least squares over
    the pairs (record start us, stamp ns) it was fitted to, and its rate
    less 1 in parts per million. The pairs: the stamps of the device spans
    and the trace's stamp kernels, both in time order, at the relative
    shift whose differences spread least (to 0.1 us; then the one that
    pairs more). None without stamps."""
    stamps = sorted(t for s in snap["device"] for t in (s["start_ns"], s["end_ns"]))
    records = sorted(s for name, s, _ in trace.kernels if name.startswith(STAMP))
    if not stamps or not records:
        return None
    base = stamps[0]      # integer ns: what is left fits a float to the nanosecond
    best = None
    for shift in range(-8, len(records) - len(stamps) + 9):
        pairs = [(records[i + shift], t) for i, t in enumerate(stamps)
                 if 0 <= i + shift < len(records)]
        if 2 * len(pairs) < len(stamps):
            continue
        diffs = sorted(r - (t - base) / 1e3 for r, t in pairs)
        rank = (round(diffs[3 * len(diffs) // 4] - diffs[len(diffs) // 4], 1), -len(pairs))
        if best is None or rank < best[0]:
            best = (rank, pairs)
    if best is None:
        return None
    pairs = best[1]
    xs = [(t - base) / 1e3 for _, t in pairs]
    ys = [r for r, _ in pairs]
    mx, my = sum(xs) / len(xs), sum(ys) / len(ys)
    var = sum((x - mx) ** 2 for x in xs)
    rate = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / var if var > 0 else 1.0
    return (lambda ns: my + rate * ((ns - base) / 1e3 - mx)), pairs, (rate - 1.0) * 1e6


def _union(intervals) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _overlap(a, b) -> float:
    """The length of the intersection of two merged interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def report(trace, snap):
    """The run's diagnostics of the spans, on standard error."""
    device = sorted({s["name"] for s in snap["device"]})
    host = sorted({s["name"] for s in snap["host"]})
    print("program spans: device ms " + ", ".join(f"{n} {device_ms(snap, n):.3f}" for n in device)
          + f"; busy ms {1e3 * trace.busy_s():.3f}; host spans (count, ms) "
          + ", ".join(f"{n} ({sum(1 for s in snap['host'] if s['name'] == n)}, "
                      f"{host_ms(snap, n):.3f})" for n in host)
          + f"; counters {snap['counters']}; stamps dropped {snap['dropped']}", file=sys.stderr)
    fit = clock_fit(trace, snap)
    if fit is None:
        return
    to_trace, pairs, drift = fit
    gaps = sorted(abs(r - to_trace(t)) for r, t in pairs)
    busy = trace.busy_intervals()
    spans = _union((to_trace(s["start_ns"]), to_trace(s["end_ns"])) for s in snap["device"])
    inside = _overlap(busy, spans)
    covered = inside / max(sum(e - s for s, e in busy), 1e-9)
    print(f"program spans: {len(pairs)} stamps against their kernel records (rate "
          f"{drift:+.1f} ppm), |gap| median {gaps[len(gaps) // 2]:.2f} us, 99th "
          f"{gaps[99 * len(gaps) // 100]:.2f} us, max {gaps[-1]:.2f} us; device spans cover "
          f"{100 * covered:.2f}% of the busy time; they last "
          f"{sum(e - s for s, e in spans) / 1e3:.3f} ms, busy {inside / 1e3:.3f} ms of it",
          file=sys.stderr)
    lo, hi = trace.window
    edges = [lo] + [t for iv in busy for t in iv] + [hi]
    idle = sorted(((edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                   if edges[i + 1] > edges[i]), key=lambda g: g[0] - g[1])[:10]
    named = []
    for s, e in idle:
        mid = (s + e) / 2
        open_ = sorted({f"{h['name']}@{h['thread']}" for h in snap["host"]
                        if to_trace(h["start_ns"]) <= mid < to_trace(h["end_ns"])})
        named.append([round((e - s) / 1e3, 4), trace.host_activity(mid), open_])
    print(f"program spans: idle gaps [ms, trace's range, program spans open] {named}",
          file=sys.stderr)
