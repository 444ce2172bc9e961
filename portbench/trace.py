"""The traced window: a torch.profiler session over a run's measured work,
reduced to device intervals by kernel name and the host ranges around
them.

`traced(segment)` runs `segment()` under the profiler (host and card) inside
the range "portbench.window" and returns a `Trace`. A session that records
no device event (the card's sandbox does this, sometimes three sessions in
a row) runs the segment again, up to SESSIONS sessions a second apart, as
`chip_smoke.device_ms` does; the segment then does new work.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass

SESSIONS = 6
WINDOW = "portbench.window"
# Host ranges that name what the host was doing: the benchmark's own, and
# the program's (which fire outside its CUDA graphs).
RANGE = re.compile(r"^(portbench|echoflow_torch)\.")


@dataclass
class Trace:
    """kernels: (name, start_us, end_us) of every device operation (kernels,
    copies, memsets); ranges: (name, thread, start_us, end_us) of the host
    ranges; window: (start_us, end_us) of the traced window on the trace's
    clock; wall_s: its length by the host clock."""

    kernels: list
    ranges: list
    window: tuple
    wall_s: float

    def device_s(self, pattern=None) -> float:
        """Summed device seconds of the operations whose name matches."""
        rx = re.compile(pattern) if pattern else None
        return sum(e - s for n, s, e in self.kernels if rx is None or rx.search(n)) / 1e6

    def launches(self, pattern) -> list:
        rx = re.compile(pattern)
        return [(n, (e - s) / 1e6) for n, s, e in self.kernels if rx.search(n)]

    def busy_intervals(self) -> list:
        """The union of the device intervals, merged, within the window."""
        lo, hi = self.window
        merged = []
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def window_s(self) -> float:
        """The window's length on the trace's clock."""
        return (self.window[1] - self.window[0]) / 1e6

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s() / self.window_s())

    def host_activity(self, at_us) -> str:
        """The innermost open range of each thread at a time, joined."""
        open_ = {}
        for name, thread, s, e in self.ranges:
            if s <= at_us < e and name != WINDOW:
                if thread not in open_ or s >= open_[thread][0]:
                    open_[thread] = (s, name)
        names = sorted({name for _, name in open_.values()})
        return "+".join(names) if names else "(no range open)"

    def idle_gaps(self, n=10) -> list:
        """The n longest idle gaps of the device in the window, each named by
        what the host was doing at its middle: [[name, seconds], ...]."""
        lo, hi = self.window
        edges = [lo] + [t for iv in self.busy_intervals() for t in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self.host_activity((s + e) / 2), (e - s) / 1e6] for s, e in gaps[:n]]

    def top_ops(self, n=10) -> list:
        by_name = {}
        for name, s, e in self.kernels:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
        return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]


def parse(prof, wall_s) -> Trace:
    """A `Trace` of a finished torch.profiler session."""
    import torch

    kernels, ranges, window = [], [], None
    for evt in prof.events():
        s, e = float(evt.time_range.start), float(evt.time_range.end)
        if evt.device_type == torch.autograd.DeviceType.CPU:
            if evt.name == WINDOW:
                window = (s, e)
            if RANGE.match(evt.name):
                ranges.append((evt.name, evt.thread, s, e))
        elif not RANGE.match(evt.name):   # a range's device mirror is no operation
            kernels.append((evt.name, s, e))
    if window is None:
        starts = [k[1] for k in kernels] or [0.0]
        window = (min(starts), min(starts) + wall_s * 1e6)
    return Trace(kernels, ranges, window, wall_s)


def traced(segment) -> tuple:
    """(Trace, what the last `segment()` returned)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    for attempt in range(SESSIONS):
        if attempt:
            time.sleep(1.0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                t0 = time.perf_counter()
                result = segment()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        trace = parse(prof, wall)
        if trace.kernels:
            return trace, result
    raise RuntimeError(f"torch.profiler recorded no device event in {SESSIONS} sessions")
