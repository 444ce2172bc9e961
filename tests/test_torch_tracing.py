"""The port's tracer (`echoflow_torch/utils/profiling.py`) on the CPU:
spans' nesting, parents, threads and ids; tracing live exactly while a
torch.profiler session records, each session starting afresh; nothing kept
while it is off; the counters of the graph wrappers (warm-up, capture,
replay, eviction, with the capture stood in for as in
tests/test_torch_graph.py) and of the engine's operand cache; the engine's
and the train feed's spans; the stamp kernel's source
(`echoflow_torch/csrc/spans.cu`) compiled against the host emulation of
tests/cuda_host_emu; and the benchmark's readers of the spans
(portbench/metrics/, portbench/spans.py) on synthetic contexts. The card's
side (stamps inside replays, the shared clock, the flag off) is held by
tests/test_torch_cuda.py."""

import ctypes
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from echoflow_torch.data.synthetic import make_beating_video
from echoflow_torch.infer.pipeline import VideoSegmenter
from echoflow_torch.models.r2plus1d import create_model
from echoflow_torch.train.loop import prefetch_to_device
from echoflow_torch.utils import profiling
from echoflow_torch.utils.graphs import model_graphs
from echoflow_torch.utils.profiling import count, counters, record, span, spans
from portbench import harness
from portbench.trace import Trace
from tests.test_torch_graph import _CpuFunctionGraphs
from tests.test_torch_warp_emulated import SHIM, _for_emulation

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "echoflow_torch" / "csrc" / "spans.cu"


def _session():
    return profile(activities=[ProfilerActivity.CPU])


def _host(snap, name):
    return [r for r in snap["host"] if r["name"] == name]


# ------------------------------------------------------------------ spans

def test_spans_nest_with_parents_threads_and_ids():
    """A span records its parent (the innermost open span of its thread),
    its thread, and its id, or its parent's; a span on another thread has
    no parent there."""
    def other():
        with span("t.other"):
            pass

    with _session():
        with span("t.outer", id=7):
            with span("t.inner"):
                with span("t.leaf", id=3):
                    pass
            worker = threading.Thread(target=other, name="tracing-test-thread")
            worker.start()
            worker.join(timeout=30)
    assert not worker.is_alive()
    snap = spans()
    (outer,), (inner,), (leaf,), (elsewhere,) = (
        _host(snap, n) for n in ("t.outer", "t.inner", "t.leaf", "t.other"))
    assert (outer["id"], inner["id"], leaf["id"], elsewhere["id"]) == (7, 7, 3, None)
    assert outer["parent"] is None and inner["parent"] == outer["uid"]
    assert leaf["parent"] == inner["uid"] and elsewhere["parent"] is None
    assert elsewhere["thread"] == "tracing-test-thread" != outer["thread"]
    assert outer["start_ns"] <= inner["start_ns"] <= leaf["start_ns"] <= leaf["end_ns"] \
        <= inner["end_ns"] <= outer["end_ns"]


def test_a_host_span_agrees_with_its_profiler_range():
    """The record of a span lies inside its `record_function` range, on
    the profiler's clock (the trace's times are from its start)."""
    with _session() as prof:
        for i in range(3):
            with span("t.ranged", id=i):
                torch.ones(64).sum()
    snap = spans()
    start = prof.profiler.kineto_results.trace_start_ns()
    ranges = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                    if e.name == "echoflow_torch.t.ranged")
    records = _host(snap, "t.ranged")
    assert [r["id"] for r in records] == [0, 1, 2] and len(ranges) == 3
    for r, (lo, hi) in zip(records, ranges):
        # The profiler's clock converter and time.time_ns() may differ by a
        # few microseconds.
        assert start + lo * 1e3 - 5e3 <= r["start_ns"] <= r["end_ns"] <= start + hi * 1e3 + 5e3
        assert r["end_ns"] - r["start_ns"] < 5e6


def test_tracing_follows_the_profiler_and_each_session_starts_afresh():
    """Live exactly inside a session; a new session clears the last one's
    records and takes the counters' growth from its own start."""
    with span("t.before"):
        pass
    assert not profiling.live()
    with _session():
        assert profiling.live()
        with span("t.first"):
            count("t.things", 2)
    assert not profiling.live()
    with span("t.between"):
        count("t.things", 5)
    record("t.recorded", 1, 0, 10)
    snap = spans()
    assert [r["name"] for r in snap["host"]] == ["t.first"]
    assert snap["counters"]["t.things"] == 2
    with _session():
        with span("t.second"):
            count("t.things")
        record("t.recorded", 4, 10, 30)
    snap = spans()
    assert [r["name"] for r in snap["host"]] == ["t.second", "t.recorded"]
    assert _host(snap, "t.recorded")[0]["end_ns"] == 30
    assert snap["counters"]["t.things"] == 1
    assert counters()["t.things"] >= 8


def test_nothing_is_kept_while_tracing_is_off():
    with _session():
        with span("t.kept"):
            pass
    kept = spans()["host"]
    for i in range(3):
        with span("t.off", id=i):
            record("t.off_record", i, 0, 1)
    assert spans()["host"] == kept and profiling.current_id() is None


def test_counts_and_records_from_many_threads_are_all_kept():
    """16 threads (more than the cores) count and open spans at once, with
    the interpreter switching threads every microsecond: no count and no
    record is lost."""
    import sys

    def work(k):
        for i in range(200):
            count("t.stress")
            with span("t.stress", id=k):
                pass

    before = counters().get("t.stress", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _session():
            workers = [threading.Thread(target=work, args=(k,)) for k in range(16)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert counters()["t.stress"] - before == 16 * 200
    records = _host(spans(), "t.stress")
    assert len(records) == 16 * 200 and len({r["uid"] for r in records}) == 16 * 200
    assert all(r["parent"] is None for r in records)


# ------------------------------------------------------------------ counters

def test_graph_counters_and_the_replay_id_slot():
    """Warm-ups, captures, replays and evictions are counted where they
    happen; a replay writes the id of the span it runs in into its
    graph's slot while tracing is live, and the wrapper's spans carry
    that id."""
    g = _CpuFunctionGraphs(lambda x, scale: x * scale)
    g.max_graphs = 2
    before = counters()
    with _session():
        for i, n in enumerate((2, 2, 2, 3, 3, 4, 4, 2, 2)):
            with span("t.call", id=100 + i):
                g(torch.ones(n), scale=2.0)
    grown = {k: counters()[k] - before.get(k, 0)
             for k in ("graph.warm_ups", "graph.captures", "graph.replays", "graph.evictions")}
    # keys 2, 3, 4 warm up and capture; 4's capture evicts 2, which warms
    # up again at call 8 and captures at call 9 (evicting 3).
    assert grown == {"graph.warm_ups": 4, "graph.captures": 4, "graph.replays": 5,
                     "graph.evictions": 2}
    snap = spans()
    assert snap["counters"]["graph.replays"] == 5
    assert [r["id"] for r in _host(snap, "graph.replay")] == [101, 102, 104, 106, 108]
    assert [r["id"] for r in _host(snap, "graph.warm_up")] == [100, 103, 105, 107]
    assert [r["id"] for r in _host(snap, "graph.feed")] == [102]
    assert int(g.graphs[g.key(torch.ones(2), scale=2.0)].ids[0]) == 108


@pytest.fixture(scope="module")
def engine_state():
    return create_model(seed=1).state_dict()


def test_engine_spans_and_operand_counters(engine_state):
    """Through `segment_videos` on the CPU, the graph stood in for: every
    video's queue, stage and fetch spans carry the engine's number for it,
    the stage runs on the dispatch thread and holds the graph's spans; the
    operand cache counts a miss for each new length and a hit after."""
    engine = VideoSegmenter(engine_state, device="cpu", forward_chunk=4, bucket=32)
    engine._run = model_graphs(engine._run, engine._model, wrapper=_CpuFunctionGraphs)
    videos = [make_beating_video(num_frames=n, height=32, width=32, period=20.0,
                                 seed=1).video.astype(np.uint8) for n in (40, 44, 40)]
    before = counters()
    with _session():
        masks = list(engine.segment_videos(videos, num_clips=2, step=1, queue_depth=2))
    assert [m.shape[0] for m in masks] == [40, 44, 40]
    grown = {k: counters()[k] - before.get(k, 0)
             for k in ("engine.operand_misses", "engine.operand_hits")}
    assert grown == {"engine.operand_misses": 2, "engine.operand_hits": 1}
    snap = spans()
    for name in ("engine.queue", "engine.stage", "engine.fetch"):
        assert sorted(r["id"] for r in _host(snap, name)) == [0, 1, 2], name
    assert all(r["thread"].startswith("echoflow-dispatch") for r in _host(snap, "engine.stage"))
    stages = {r["id"]: r for r in _host(snap, "engine.stage")}
    inner = {r["name"]: r for r in snap["host"] if r["parent"] == stages[2]["uid"]}
    assert {"graph.feed", "graph.replay", "graph.outputs", "copies"} <= set(inner)
    assert {r["id"] for r in _host(snap, "shift")} <= {0, 1, 2}
    assert snap["device"] == []     # no card: no stamps


def test_prefetch_runs_each_next_in_a_span():
    """The same batches in the same order; each `next()` (its host batches
    and their uploads) is one `train.prefetch` span."""
    batches = [{"x": np.full((2,), float(i), np.float32)} for i in range(3)]
    with _session():
        got = [float(b["x"][0]) for b in prefetch_to_device(iter(batches), "cpu", depth=2)]
    assert got == [0.0, 1.0, 2.0]
    # three yields and the call that finds the iterator exhausted
    assert len(_host(spans(), "train.prefetch")) == 4


# ------------------------------------------------------------------ the stamp kernel

@pytest.fixture(scope="module")
def stamp_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the stamp kernel for host emulation")
    out = tmp_path_factory.mktemp("spans_emu")
    (out / "spans.cpp").write_text(_for_emulation(SOURCE.read_text()))
    proc = subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                           f"-I{SHIM}", "-o", str(out / "libspans.so"), str(out / "spans.cpp")],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lib = ctypes.CDLL(str(out / "libspans.so"))
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.echoflow_span_stamp.argtypes = [ptr, ptr, ctypes.c_int, i64, ptr, i64, ptr]
    lib.echoflow_span_stamp.restype = ctypes.c_int
    lib.echoflow_span_clock.argtypes = [ptr, ptr]
    lib.echoflow_span_clock.restype = ctypes.c_int
    return lib


def test_the_stamp_kernel_writes_only_while_live_and_counts_what_it_drops(stamp_lib):
    """Off: nothing written, no slot taken. On: one row a stamp (word, id
    from the launch or from the slot, the clock), slots in order; past the
    capacity (2 here) the slot counter goes on and nothing is written."""
    state = torch.zeros(2, dtype=torch.int64)
    ring = torch.full((3, 3), -7, dtype=torch.int64)    # capacity 2, and a guard row
    slot = torch.tensor([41], dtype=torch.int64)

    def stamp(word, id, slot_ptr=None):
        assert stamp_lib.echoflow_span_stamp(state.data_ptr(), ring.data_ptr(), 2, word,
                                             slot_ptr, id, None) == 0

    stamp(4, 5)
    assert state.tolist() == [0, 0] and (ring == -7).all()
    state[0] = 1
    t0 = time.time_ns()
    stamp(4, 5)
    stamp(5, 9, slot.data_ptr())
    stamp(6, 3)
    t1 = time.time_ns()
    assert state.tolist() == [1, 3]
    assert ring[0, :2].tolist() == [4, 5] and ring[1, :2].tolist() == [5, 41]
    assert t0 <= int(ring[0, 2]) <= int(ring[1, 2]) <= t1
    assert ring[2].tolist() == [-7, -7, -7]


def test_the_clock_kernel_reads_the_clock(stamp_lib):
    out = torch.zeros(1, dtype=torch.int64)
    t0 = time.time_ns()
    assert stamp_lib.echoflow_span_clock(out.data_ptr(), None) == 0
    assert t0 <= int(out[0]) <= time.time_ns()


def test_paired_device_spans_take_each_close_with_its_open():
    """Ring entries to device spans: a close pairs with the latest open of
    its span and id; an id of -1 is none; times move to the host clock."""
    ring = type("Ring", (), {"device": torch.device("cuda", 0), "offset_ns": 1000})()
    entries = [[0, 1, 10], [2, 1, 12], [0, 2, 13], [3, 1, 20], [1, 1, 25], [1, 2, 30],
               [4, -1, 31], [5, -1, 40], [1, 9, 50]]
    got = profiling._paired(entries, ["a", "b", "c"], ring)
    assert [(s["name"], s["id"], s["start_ns"], s["end_ns"]) for s in got] == [
        ("b", 1, 1012, 1020), ("a", 1, 1010, 1025), ("a", 2, 1013, 1030),
        ("c", None, 1031, 1040)]


# ------------------------------------------------------------------ the benchmark's readers

T0 = 1_790_000_000_000_000_000   # ns since the epoch
MS = 1_000_000


def _lay(parts, t):
    """Device spans laid back to back from `t`, 10 us apart."""
    out = []
    for name, id, ms in parts:
        out.append({"name": name, "id": id, "device": 0, "start_ns": t,
                    "end_ns": t + int(ms * MS)})
        t = out[-1]["end_ns"] + 10_000
    return out, t


def _host_span(name, id, start, ms):
    return {"name": name, "id": id, "uid": 0, "parent": None, "thread": "x",
            "start_ns": start, "end_ns": start + int(ms * MS)}


def _archive():
    """Two videos: 0 in chunks of 2 and 2 clips, 1 in one chunk of 3."""
    device, host, t = [], [], T0
    for vid, chunks in ((0, 2), (1, 1)):
        host.append(_host_span("engine.stage", vid, t - int((2 + 3 * vid) * MS),
                               (2 + 3 * vid) - 1.0))       # ends 1 ms before its replay
        parts = [("shift", vid, 1.0)]
        parts += [(n, vid, ms) for _ in range(chunks) for n, ms in
                  (("backbone", 4.0), ("projections", 0.5), ("decoder_tail", 1.0),
                   ("reinterp", 0.25))]
        parts += [("reinterp", vid, 0.5), ("fusion", vid, 0.75)]
        spans_, t = _lay(parts, t)
        device += spans_
        host.append(_host_span("ef", None, t, 12.0 + 2 * vid))
    videos = [{"length": 100, "valid_clips": 4, "chunks": [2, 2]},
              {"length": 60, "valid_clips": 3, "chunks": [3]}]
    counts = {"graph.warm_ups": 1, "graph.captures": 0, "engine.operand_misses": 1,
              "graph.replays": 2}
    return {"host": host, "device": device, "counters": counts, "dropped": 0}, {"videos": videos}


def _train():
    device, host, t = [], [], T0
    for step in (0, 1):
        for name, ms in (("train.prefetch", 1.0), ("graph.feed", 0.2), ("graph.replay", 0.3),
                         ("graph.outputs", 0.1), ("ef", 9.0)):
            host.append(_host_span(name, step, t, ms))
        spans_, t = _lay([("train.forward", step, 30.0), ("train.ota_and_chains", step, 20.0),
                          ("train.backward", step, 150.0), ("train.optimizer", step, 5.0),
                          ("conv.depthwise", step, 2.0), ("dp.all_reduce", step, 3.0),
                          ("swin.attention", step, 4.0), ("swin.windows", step, 1.0)], t)
        device += spans_
    # 3.35e9 bytes of depthwise traffic a step: 1 ms at 3.35 TB/s; 134 GFLOP
    # of attention a step: 2 ms at 67 TFLOP/s.
    return ({"host": host, "device": device, "counters": {}, "dropped": 0},
            {"steps": 2, "depthwise_bytes": 3.35e9, "attention_flops": 134e9,
             "attention_bytes": 1e6})


def _trace_of(snap):
    """A trace whose stamp kernels run at the stamps' times (the trace's
    clock 1 ms after T0 at 0), 2 us each, with one kernel of work inside
    each span."""
    def us(ns):
        return (ns - T0) / 1e3 + 1000.0
    kernels = []
    for s in snap["device"]:
        a, b = us(s["start_ns"]), us(s["end_ns"])
        kernels += [("span_stamp_kernel", a, a + 2.0), ("work", a + 2.0, b),
                    ("span_stamp_kernel", b, b + 2.0)]
    end = max(k[2] for k in kernels) + 10.0
    return Trace(kernels, [], (0.0, end), end / 1e6)


ARCHIVE = {"backbone_span_ms_per_clip": 12.0 / 7, "decoder_span_ms_per_clip": 4.5 / 7,
           "video_ops_span_ms_per_video": (2.0 + 1.75 + 1.5) / 2,
           "stage_span_ms_per_video": (1.0 + 4.0) / 2, "device_queue_ms_per_video": 1.0,
           "ef_span_ms_per_video": 13.0, "engine_rebuilds_per_100_videos": 100.0}
TRAIN = {"forward_span_ms_per_step": 30.0, "loss_span_ms_per_step": 20.0,
         "backward_span_ms_per_step": 150.0, "optimizer_span_ms_per_step": 5.0,
         "step_host_ms": 1.6}
READINGS = [(k, v) for k, v in ARCHIVE.items()] + [
    (f"{k}{part}", v)
    for part in (".train", ".train.bf16", ".train.csn", ".train.dp4", ".train.swin")
    for k, v in TRAIN.items()] + [
    ("depthwise_span_ms_per_step.csn", 2.0), ("depthwise_roofline_pct.csn", 50.0),
    ("allreduce_span_ms_per_step.dp4", 3.0), ("attention_span_ms_per_step.swin", 4.0),
    ("window_span_ms_per_step.swin", 1.0), ("attention_roofline_pct.swin", 50.0)]


def _reader(name):
    return harness.load_module(harness.reader_path(name), "reader_" + name.replace(".", "_"))


def test_every_span_metric_of_the_benchmark_has_a_reading_here():
    bench = harness.load_cell("fp32-archive")[0]
    ours = {m["name"] for m in bench["per_layer"]
            if harness.reader_path(m["name"]).read_text().count("portbench import spans")}
    assert ours == {name for name, _ in READINGS}


@pytest.mark.parametrize("name,want", READINGS, ids=[n for n, _ in READINGS])
def test_a_span_reader_on_a_synthetic_context(monkeypatch, capsys, name, want):
    snap, ctx = _archive() if name in ARCHIVE else _train()
    monkeypatch.setattr(profiling, "spans", lambda: snap)
    ctx["trace"] = _trace_of(snap)
    assert _reader(name).read(ctx) == pytest.approx(want, rel=1e-9)
    err = capsys.readouterr().err
    assert "max 0.00 us" in err
    cover = float(re.search(r"device spans cover ([\d.]+)%", err).group(1))
    assert 99.0 < cover <= 100.0


def test_the_span_readers_read_nothing_from_a_program_without_spans(monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    for name, _ in READINGS:
        snap, ctx = _archive() if name in ARCHIVE else _train()
        ctx["trace"] = _trace_of(snap)
        assert _reader(name).read(ctx) is None, name
