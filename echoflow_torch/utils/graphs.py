"""CUDA graphs of functions of tensors: the warm-up, capture and replay that
the graphed train steps (`train/graph.py`), the inference engine
(`infer/pipeline.py`), the clip forward (`infer/clips.py`), the motion
rollouts (`infer/propagate.py`) and the CAMUS trainer's step
(`train/generic.py`) share, the port's counterpart of `jax.jit`.

    rollout = GraphedFunction(deform_forback)   # a function of tensors
    forwards, backwards = rollout(label_ed, label_es, motion, mode="bilinear")

One graph for each key (a function's tensor signature and its other
arguments; a train step's batch signature), as `jit` traces once for each
shape:

- the first call with a key runs eagerly on a side stream, as that call's
  real work: the warm-up (cuDNN's plans, the device constants of
  `ops/warp.py` and `ops/resize.py`, the kernels' library, NCCL's
  communicators);
- the second call captures (`torch.cuda.graph`; the graphs of one model, or
  of one device's functions, share one memory pool) and replays once for
  itself;
- every later call copies its tensors into the graph's inputs and replays.

cuBLAS and cuDNN make their handles for each thread at its first call,
which a capture refuses: a key's capture must run on a thread that has
run the function eagerly, as its warm-up does (the engine dispatches all
its device work on one thread of its own).

A wrapper keeps the graphs of its `max_graphs` most recently used keys
(and the warm-ups of as many keys not captured yet): the graph of the key
used longest ago is dropped with its static tensors, so a pass over clips
of many lengths holds a bounded number of graphs; a dropped key warms up
and captures again. `clear()` drops them all.

What the captured code does in Python happens once, at capture, and never
at a replay: the counts it makes (`utils/profiling.count`; a kernel
wrapper's `<kernel>.launches`) are taken back after the capture and added
by the wrapper at each of the graph's replays. A capture that makes a
device constant (`utils/device.device_constant`) raises.
The wrapper's host work runs in the spans (`utils/profiling.span`)
`graph.warm_up`, `graph.capture`, `graph.feed` (the bindings check and the
input copies), `graph.replay` (the launch, and what a caller writes before
it) and `graph.outputs` (the output copies), and counts `graph.warm_ups`,
`graph.captures`, `graph.replays` and `graph.evictions`. The device spans
captured in a graph read their replay's id from the graph's `ids` slot,
which a replay writes while tracing is live: the id of the span the call
runs in, or the one its caller gives.
A graph reads and writes the tensors it was captured with; a caller's
`bindings` gives the addresses of those outside the graph's own inputs (a
model's parameters, an optimizer's state), and a call raises if any is no
longer the tensor the graph captured. What a call returns is a copy; the
next replay overwrites the graph's own outputs. A failed capture raises;
nothing falls back to the eager call.
"""

from __future__ import annotations

import functools
import inspect
import weakref
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable

import torch

from echoflow_torch.utils.profiling import count, current_id, live, replay_ids, span, uncounted


def module_bindings(model) -> tuple:
    """The addresses of a module's parameters and buffers: the `bindings`
    of a graph that reads the module."""
    return tuple(t.data_ptr() for t in (*model.parameters(), *model.buffers()))


def _signature(batch) -> tuple:
    return tuple((k, tuple(v.shape), v.dtype, v.device) for k, v in sorted(batch.items()))


def _copies(out):
    """`out` (a tensor, or tuples, lists and dicts of them) with each tensor
    cloned: what a replay returns, so the next replay overwrites nothing
    the caller holds."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, dict):
        return {k: _copies(v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(_copies(v) for v in out)
    return out


@dataclass
class _Graph:
    graph: object                # what `replay()` launches (a torch.cuda.CUDAGraph)
    inputs: dict                 # the graph's static input tensors
    outputs: object              # the graph's static outputs
    counts: dict                 # what its capture counted: added at each replay
    bindings: tuple
    ids: object                  # the slot its device spans read a replay's id from
    replays: int = field(default=0)


class _Memory:
    """The side stream of the warm-ups and captures and the memory pool of
    the graphs, made at first use and shared by the wrappers of one model
    (`model_memory`: a train and an eval step never run at once, and captures
    into one pool go through one stream), or by the function graphs of one
    device (`_device_memory`)."""

    def __init__(self, device):
        self.device = device
        self._stream = self._pool = None

    def stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool


_memories: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
_device_memories: dict = {}


def model_memory(model, device) -> _Memory:
    """The `_Memory` of `model`, made at its first wrapper."""
    memory = _memories.get(model)
    if memory is None:
        memory = _memories[model] = _Memory(device)
    return memory


def _device_memory(device) -> _Memory:
    """The `_Memory` of the function graphs on `device` that name no model."""
    if device not in _device_memories:
        _device_memories[device] = _Memory(device)
    return _device_memories[device]


class _Graphs:
    """The warm-up, capture and replay of one callable's graphs, one for
    each key (module docstring). `graphs` holds them by key, least recently
    used first; `memory` is the `_Memory` the next warm-up or capture uses.
    With `debug` set, a capture keeps its graph's nodes for
    `CUDAGraph.debug_dump` (`cudaGraphDebugDotPrint`). A capture refuses
    a call that is unsafe during it on its own thread only
    (`capture_error_mode="thread_local"`): the engine's fetch threads wait
    on events while its dispatch thread captures."""

    debug = False
    max_graphs = 8
    generators: tuple = ()     # CUDA generators a capture draws from, besides the default

    def __init__(self, memory: _Memory | None):
        self.memory = memory
        self.warmed: OrderedDict = OrderedDict()   # keys warmed up, not captured yet
        self.graphs: OrderedDict = OrderedDict()

    def clear(self):
        """Drop every graph and warm-up: the next call of a key warms up again."""
        self.graphs.clear()
        self.warmed.clear()

    # The CUDA primitives, apart so that a test can stand in for them.
    def _run_on_side_stream(self, fn):
        current = torch.cuda.current_stream(self.memory.device)
        side = self.memory.stream()
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = fn()
        current.wait_stream(side)
        return out

    def _capture(self, fn):
        """fn() recorded as a graph, not run: (its outputs, the graph)."""
        graph = torch.cuda.CUDAGraph(keep_graph=self.debug)
        if self.debug:
            graph.enable_debug_mode()
        for generator in self.generators:
            graph.register_generator_state(generator)
        with torch.cuda.graph(graph, pool=self.memory.pool(), stream=self.memory.stream(),
                              capture_error_mode="thread_local"):
            out = fn()
        return out, graph

    def _lookup(self, key) -> _Graph | None:
        entry = self.graphs.get(key)
        if entry is not None:
            self.graphs.move_to_end(key)
        return entry

    def _warm_up(self, key, fn):
        with span("graph.warm_up"):
            out = self._run_on_side_stream(fn)
        count("graph.warm_ups")
        self.warmed[key] = None
        while len(self.warmed) > self.max_graphs:
            self.warmed.popitem(last=False)
        return out

    def _record(self, key, fn, inputs: dict, bindings: Callable[[], tuple]) -> _Graph:
        """Capture fn(static inputs) at this key. The counts of the capture
        are taken back: the replay that follows adds them."""
        with span("graph.capture"):
            static = {k: v.clone() for k, v in inputs.items()}
            ids = torch.full((1,), -1, dtype=torch.int64, device=self.memory.device)
            with replay_ids(ids):
                (out, graph), captured = uncounted(lambda: self._capture(lambda: fn(static)))
            if "device.constants" in captured:
                raise RuntimeError("graphed: a device constant was first made during the "
                                   "capture; the warm-up should have made it")
            entry = _Graph(graph, static, out, captured, bindings(), ids)
        count("graph.captures")
        self.warmed.pop(key, None)
        self.graphs[key] = entry
        while len(self.graphs) > self.max_graphs:
            self.graphs.popitem(last=False)
            count("graph.evictions")
        return entry

    @staticmethod
    def _feed(entry: _Graph, inputs: dict, bindings: Callable[[], tuple], id=None):
        """Check the bindings and copy `inputs` into the graph's own."""
        with span("graph.feed", id=id):
            if bindings() != entry.bindings:
                raise RuntimeError("graphed: a parameter, gradient, buffer or optimizer "
                                   "tensor was replaced since the capture (a restore?); make "
                                   "a new graphed step")
            for k, v in inputs.items():
                entry.inputs[k].copy_(v, non_blocking=True)

    @staticmethod
    def _launch(entry: _Graph, id=None, before: Callable[[], None] = lambda: None):
        """`before()`, then the replay, under the id `id` (default: the
        id of the span the call runs in)."""
        with span("graph.replay", id=id):
            before()
            if live():
                rid = current_id()
                entry.ids.fill_(-1 if rid is None else rid)
            entry.graph.replay()
        entry.replays += 1
        count("graph.replays")
        for k, n in entry.counts.items():
            count(k, n)

    @staticmethod
    def _outputs(entry: _Graph, id=None):
        """Copies of the graph's outputs."""
        with span("graph.outputs", id=id):
            return _copies(entry.outputs)


class GraphedFunction(_Graphs):
    """`fn(*args, **kwargs)` on CUDA tensors as CUDA graphs, one for each
    key: the shapes, dtypes and devices of its tensor arguments and the
    values of the others (a mode, an index), as `jit` with static
    arguments. It returns copies of the graph's outputs (a tensor, or
    tuples, lists and dicts of them). A call whose tensors lie on the CPU
    is `fn` itself.

    `fn` may read and write tensors besides its arguments (a model, an
    optimizer's state): `bindings(**others)`, given the arguments that are
    not tensors, then returns their addresses, checked before every replay
    of the graph of those arguments, and `memory` is the pool of that
    model's graphs (default: the device's pool for functions of their
    arguments alone). What `fn` does in Python besides its tensor work
    happens at the warm-up and the capture only."""

    def __init__(self, fn, memory: _Memory | None = None,
                 bindings: Callable[..., tuple] = lambda **others: ()):
        super().__init__(memory)
        self.fn, self.bindings, self.shared = fn, bindings, memory
        self.signature = inspect.signature(fn)
        functools.update_wrapper(self, fn)

    def _on_card(self, tensors: dict) -> bool:
        return any(t.is_cuda for t in tensors.values())

    def _bind(self, args, kwargs):
        """(the key, the tensor arguments, the others) of a call."""
        bound = self.signature.bind(*args, **kwargs)
        bound.apply_defaults()
        tensors = {k: v for k, v in bound.arguments.items() if isinstance(v, torch.Tensor)}
        others = {k: v for k, v in bound.arguments.items() if k not in tensors}
        return (_signature(tensors), tuple(others.items())), tensors, others

    def key(self, *args, **kwargs) -> tuple:
        """The key in `graphs` of a call with these arguments."""
        return self._bind(args, kwargs)[0]

    def __call__(self, *args, **kwargs):
        key, tensors, others = self._bind(args, kwargs)
        if not self._on_card(tensors):
            return self.fn(*args, **kwargs)

        def call(inputs):
            return self.fn(**others, **inputs)

        def bindings():
            return self.bindings(**others)

        entry = self._lookup(key)
        if entry is None:
            self.memory = self.shared or _device_memory(
                next(t.device for t in tensors.values() if t.is_cuda))
            if key not in self.warmed:
                return self._warm_up(key, lambda: call(tensors))
            entry = self._record(key, call, tensors, bindings)
        else:
            self._feed(entry, tensors, bindings)
        self._launch(entry)
        return self._outputs(entry)


def model_graphs(fn, model, wrapper=GraphedFunction):
    """`fn` as CUDA graphs of `model` (a `GraphedFunction`, or a `wrapper`
    of its signature): the model's parameters and buffers are the graphs'
    bindings, its pool their memory."""
    device = next(model.parameters()).device
    return wrapper(fn, memory=model_memory(model, device),
                   bindings=lambda **others: module_bindings(model))
