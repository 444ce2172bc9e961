"""Profiling and tracing of the port (port of `echoflow.utils.profiling`,
whose only instrumentation is wall-clock prints).

- `block_until_ready(result)` waits for the device work of a result, where
  echoflow calls `jax.block_until_ready`.
- `span(name, id=None, device=None)` is the port's one tracer. It always
  opens the `record_function` range `echoflow_torch.<name>`. With a CUDA
  `device` it also puts two device stamps on that device's current stream
  (`csrc/spans.cu`), which time the work between them on the card, also
  inside a CUDA graph: during a capture it always captures them, outside
  one it launches them only while tracing is live. While tracing is live
  it keeps a host record too: name, id, parent span, thread, start, end.
  A span without an `id` takes its parent's (the engine's spans of one
  video share its sequence number; a train step's graph spans its
  `state.step`).
- `record(name, id, start_ns, end_ns)` keeps a host span timed by its
  caller: a wait that starts on one thread and ends on another.
- `count(name, n=1)` adds to in-memory counters, always on; `counters()`
  reads them with the kernels' `.launches` (through
  `utils/graphs._COUNTERS`, never counted here a second time).
- `spans()` gives the last session's host and device spans and the
  counters' growth over it; `trace(log_dir)` records a torch.profiler
  session and writes its Chrome trace and `spans.json` beside it.

Tracing is live exactly while a torch.profiler session records (the
profiler's own process-wide flag, read at each span), so a profiled window
shows the program's layers with no switch of its own. When it goes live,
the host records and each device's ring are cleared and the ring's flag
is set on the stream; when it goes off, the flag is cleared. The graphs
are captured before any session starts, so their stamps are captured in
every graph and read the device flag: off, each is one near-empty kernel
node. A stamp in a graph reads its replay's id from a device slot that
the graph wrapper writes before each replay while tracing is live
(`replay_ids`), so the replays of one graph in flight together each fill
their own ring slots under their own ids.

Clocks: a host time is `time.time_ns()`, the clock of torch.profiler's
trace. A stamp reads the card's %globaltimer; when tracing goes live,
each ring pairs it with the host clock (`CALIBRATIONS` launches of a
one-thread clock kernel on an idle stream of high priority, the median
offset from the host clock just after each launch), and `spans()` reports
device times on the host clock.

One tracer a process, as there is one profiler.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import itertools
import json
import os
import tempfile
import threading
import time
from collections import Counter

import torch
from torch.profiler import record_function

PREFIX = "echoflow_torch."
# Stamps a device keeps in one session: 768 KiB, which the caching
# allocator serves from its small pool. Stamps past it are counted as dropped.
RING_CAPACITY = 1 << 15
CALIBRATIONS = 5


def _devices_of(result) -> set:
    """The CUDA devices of the tensors in a nested result."""
    if isinstance(result, torch.Tensor):
        return {result.device} if result.device.type == "cuda" else set()
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (list, tuple)):
        return set().union(*(_devices_of(r) for r in result))
    return set()


def block_until_ready(result):
    """Wait until the device work that produces `result` (a tensor or a
    nested dict/list/tuple of them) is done; returns `result`."""
    for device in _devices_of(result):
        torch.cuda.synchronize(device)
    return result


@functools.lru_cache(maxsize=1)
def _library():
    from echoflow_torch.ops import _build

    lib = _build.load("spans")
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.echoflow_span_stamp.argtypes = [ptr, ptr, ctypes.c_int, i64, ptr, i64, ptr]
    lib.echoflow_span_stamp.restype = ctypes.c_int
    lib.echoflow_span_clock.argtypes = [ptr, ptr]
    lib.echoflow_span_clock.restype = ctypes.c_int
    return lib


class _Ring:
    """One device's stamps: `state` (live flag, next slot) and `entries`
    (RING_CAPACITY rows of word, id, %globaltimer), made at the device's
    first span outside a capture (a graph's warm-up is one), so never in
    a graph's pool; `offset_ns` puts %globaltimer on the host's clock, as
    measured with `clock` and its pinned copy on `clock_stream`."""

    def __init__(self, device: torch.device):
        _library()      # built and loaded here, never inside a traced window
        self.device = device
        self.state = torch.zeros(2, dtype=torch.int64, device=device)
        self.entries = torch.zeros((RING_CAPACITY, 3), dtype=torch.int64, device=device)
        self.restart = torch.zeros(2, dtype=torch.int64, device=device)
        self.restart[:1].fill_(1)
        self.offset_ns = 0
        self.clock = torch.zeros(1, dtype=torch.int64, device=device)
        self.clock_host = torch.zeros(1, dtype=torch.int64, pin_memory=True)
        self.clock_stream = torch.cuda.Stream(device, priority=-1)

    def stamp(self, word: int, id, slot):
        stream = torch.cuda.current_stream(self.device).cuda_stream
        err = _library().echoflow_span_stamp(
            self.state.data_ptr(), self.entries.data_ptr(), RING_CAPACITY, word,
            None if slot is None else slot.data_ptr(), -1 if id is None else int(id), stream)
        if err != 0:
            raise RuntimeError(f"span stamp launch failed: CUDA error {err}")

    def start(self):
        """Tracing went live: the flag on and the ring empty, in the
        current stream's order; then the clock's offset."""
        self.state.copy_(self.restart)
        self.offset_ns = self._calibrate()

    def stop(self):
        self.state[:1].zero_()

    def _calibrate(self) -> int:
        stream = self.clock_stream
        offsets = []
        for _ in range(CALIBRATIONS):
            err = _library().echoflow_span_clock(self.clock.data_ptr(), stream.cuda_stream)
            launched = time.time_ns()
            if err != 0:
                raise RuntimeError(f"span clock launch failed: CUDA error {err}")
            with torch.cuda.stream(stream):
                self.clock_host.copy_(self.clock, non_blocking=True)
            stream.synchronize()
            offsets.append(launched - int(self.clock_host[0]))
        return sorted(offsets)[len(offsets) // 2]

    def read(self):
        """(the session's entries in slot order, the stamps dropped)."""
        torch.cuda.synchronize(self.device)
        taken = int(self.state[1])
        kept = min(taken, RING_CAPACITY)
        return self.entries[:kept].cpu().tolist(), taken - kept


class _Tracer:
    """The process's spans and counters (module docstring)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.is_live = False
        self.host: list = []
        self.counts: Counter = Counter()
        self.at_start: Counter = Counter()
        self.at_stop: Counter | None = None
        self.rings: dict = {}
        self.codes: dict = {}      # span name -> code in a stamp's word
        self.names: list = []
        self.local = threading.local()
        self.uids = itertools.count(1)

    def stack(self) -> list:
        """The open spans of this thread, (uid, id) innermost last."""
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def switch(self, on: bool):
        with self.lock:
            # Never inside a capture, which would capture the flag's write:
            # the next span outside it switches.
            if on == self.is_live or (self.rings and torch.cuda.is_current_stream_capturing()):
                return
            self.is_live = on
            if on:
                self.host = []
                self.at_start, self.at_stop = Counter(self.counts), None
            else:
                self.at_stop = Counter(self.counts)
            for ring in self.rings.values():
                with torch.cuda.device(ring.device):
                    if on:
                        ring.start()
                    else:
                        ring.stop()

    def ring(self, device: torch.device) -> _Ring | None:
        """The ring of a CUDA device, made here outside a capture (None if
        it is missing during one)."""
        index = device.index if device.index is not None else torch.cuda.current_device()
        ring = self.rings.get(index)
        if ring is None and not torch.cuda.is_current_stream_capturing():
            with self.lock:
                ring = self.rings.get(index)
                if ring is None:
                    with torch.cuda.device(index):
                        ring = _Ring(torch.device("cuda", index))
                        if self.is_live:
                            ring.start()
                    self.rings[index] = ring
        return ring

    def code(self, name: str) -> int:
        code = self.codes.get(name)
        if code is None:
            with self.lock:
                code = self.codes.setdefault(name, len(self.names))
                if code == len(self.names):
                    self.names.append(name)
        return code

    def add(self, name, id, uid, parent, start_ns, end_ns):
        rec = {"name": name, "id": id, "uid": uid, "parent": parent,
               "thread": threading.current_thread().name, "start_ns": start_ns,
               "end_ns": end_ns}
        with self.lock:
            self.host.append(rec)


_TRACER = _Tracer()


def live() -> bool:
    """Whether tracing is live: a torch.profiler session is recording."""
    on = bool(getattr(torch.autograd.profiler, "_is_profiler_enabled", False))
    if on != _TRACER.is_live:
        _TRACER.switch(on)
    return _TRACER.is_live


@contextlib.contextmanager
def span(name: str, id=None, device=None):
    """The range `echoflow_torch.<name>` around the block, with device
    stamps on a CUDA `device` and, while tracing is live, a host record
    (module docstring)."""
    tracer = _TRACER
    is_live = live()
    stack = tracer.stack()
    parent = stack[-1] if stack else None
    if id is None and parent is not None:
        id = parent[1]
    ring = slot = None
    if device is not None and device.type == "cuda":
        ring = tracer.ring(device)      # made at the first span, outside any capture
        if torch.cuda.is_current_stream_capturing():
            slot = getattr(tracer.local, "slot", None)
        elif not is_live:
            ring = None
    word = 2 * tracer.code(name) if ring is not None else 0
    uid = next(tracer.uids)
    stack.append((uid, id))
    try:
        with record_function(PREFIX + name):
            start = time.time_ns()
            if ring is not None:
                ring.stamp(word, id, slot)
            try:
                yield
            finally:
                if ring is not None:
                    ring.stamp(word + 1, id, slot)
                end = time.time_ns()
    finally:
        stack.pop()
    if is_live:
        tracer.add(name, id, uid, None if parent is None else parent[0], start, end)


def record(name: str, id, start_ns: int, end_ns: int):
    """A host span timed by the caller (`time.time_ns()`), kept while
    tracing is live; it opens no range."""
    if live():
        _TRACER.add(name, id, next(_TRACER.uids), None, start_ns, end_ns)


def current_id():
    """The id of this thread's innermost open span (None: none open)."""
    stack = _TRACER.stack()
    return stack[-1][1] if stack else None


@contextlib.contextmanager
def replay_ids(slot):
    """While a graph is captured in the block, its stamps read their id
    from `slot` (a one-element int64 tensor on the card), which the graph's
    wrapper writes before each replay."""
    local = _TRACER.local
    before, local.slot = getattr(local, "slot", None), slot
    try:
        yield
    finally:
        local.slot = before


def count(name: str, n: int = 1):
    with _TRACER.lock:
        _TRACER.counts[name] += n


def counters() -> dict:
    """The counters' totals, and each kernel wrapper's `.launches`."""
    from echoflow_torch.utils import graphs

    with _TRACER.lock:
        out = dict(_TRACER.counts)
    for mod, name in graphs._COUNTERS:
        out[f"{name}.launches"] = getattr(mod, name).launches
    return out


def _paired(entries, names, ring) -> list:
    """Device spans from a ring's entries: each close with the latest open
    of its span and id, times on the host's clock."""
    opened: dict = {}
    out = []
    for word, id, t in entries:
        key = (word >> 1, id)
        if word & 1 == 0:
            opened.setdefault(key, []).append(t)
        elif opened.get(key):
            start = opened[key].pop()
            out.append({"name": names[word >> 1], "id": None if id == -1 else id,
                        "device": ring.device.index, "start_ns": start + ring.offset_ns,
                        "end_ns": t + ring.offset_ns})
    return out


def spans() -> dict:
    """The last tracing session: {"host": host records, "device": device
    spans, "counters": each counter's growth from when tracing went live
    to when it went off (or now), "dropped": stamps past a ring's
    capacity}. Reads each device's ring, waiting for its device."""
    live()
    tracer = _TRACER
    with tracer.lock:
        host = list(tracer.host)
        end = tracer.at_stop if tracer.at_stop is not None else tracer.counts
        grown = {k: v - tracer.at_start.get(k, 0) for k, v in end.items()}
        rings, names = list(tracer.rings.values()), list(tracer.names)
    device, dropped = [], 0
    for ring in rings:
        entries, lost = ring.read()
        device += _paired(entries, names, ring)
        dropped += lost
    return {"host": host, "device": device, "counters": grown, "dropped": dropped}


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """torch.profiler trace of the block (host, and the card where there is
    one), written as a Chrome trace to `log_dir`/trace.json, and the
    program's spans and counters of the block to `log_dir`/spans.json
    (`spans()`, with the counters' totals under "totals"). Default
    `log_dir`: a directory under the system's temporary directory. Yields
    `log_dir`."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "echoflow_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump({**spans(), "totals": counters()}, f)
