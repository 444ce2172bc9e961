"""CUDA graphs of the train and eval steps: the port's counterpart of
echoflow's `jax.jit` over them (`echoflow/train/loop.py`, `fit`).

    step = graphed(make_train_step(), state)
    state, metrics = step(state, batch)        # the eager step's signature
    metrics = graphed(make_eval_step(), state)(state, batch)

An eager train step issues some 3,000 kernels from Python (about 90 ops in
each of the 31 chain steps, the model's forward and backward, Adam), and
in bf16 the card waits for the host most of the step. `graphed` records the
whole step once as a CUDA graph and then launches it as one.

One graph for each batch signature (keys, shapes, dtypes), as `jit`
traces once for each shape:

- the first call with a signature runs the step eagerly on a side stream,
  as that call's real step: the warm-up (cuDNN's plans, the device
  constants of `ops/warp.py` and `ops/resize.py`, the kernels' library);
- the second call captures the step (`torch.cuda.graph`; all graphs of
  the wrappers of one model use one memory pool) and replays it once for
  itself;
- every later call copies the batch into the graph's inputs and replays.

What the step does in Python happens once, at capture, and never at a
replay, so the wrapper does it for every replay: the update count
(`state.step += 1`), the LR of the update (the optimizer's LR is a 0-d
tensor on the card, `loop.make_optimizer`; the wrapper writes
`state.schedule(state.step)` into it before each replay, and a captured
step leaves it alone), and the kernels' launch counters (the counts made
while capturing a graph are added at each of its replays).

A graph reads and writes the tensors it was captured with: the
parameters, their gradients (zeroed in place on the card, never set to
None: `loop._apply_update`), Adam's state, the LR and BatchNorm's buffers.
A call raises if any of them is no longer the tensor the graph captured
(`Optimizer.load_state_dict` replaces Adam's state): make a new wrapper
after a restore. The metrics a call returns are copies; the next replay
overwrites the graph's own.

Refused with ValueError: a state on the CPU, or under data parallelism
(`state.replica`, `state.group`); the caller runs the eager step there.
A failed capture raises; nothing falls back to the eager step.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Callable

import torch

from echoflow_torch.ops import decoder_heads as dh
from echoflow_torch.ops import resize, warp
from echoflow_torch.ops import warp_kernel as wk

# The kernel wrappers whose `.launches` a replay advances, by module and
# name (looked up at each call: a caller may swap a wrapper for a while).
_COUNTERS = ((wk, "warp_forward"), (wk, "warp_image_grad"), (wk, "warp_coord_grad"),
             (dh, "decoder_heads"))
# The caches of device constants a step reads. An entry made while
# capturing would be a host-to-device copy replayed from a host buffer.
_CONSTANT_CACHES = (warp._base_grids, resize._device_matrix, dh._tables)


def _launches() -> tuple:
    return tuple(getattr(mod, name).launches for mod, name in _COUNTERS)


def _constant_misses() -> int:
    return sum(cache.cache_info().misses for cache in _CONSTANT_CACHES)


def _signature(batch) -> tuple:
    return tuple((k, tuple(v.shape), v.dtype, v.device) for k, v in sorted(batch.items()))


def _refuse_data_parallel(state):
    if state.replica is not None or state.group is not None:
        raise ValueError("graphed: the state is data-parallel; its collectives are not "
                         "captured (run the eager step)")


def _graph_device(state) -> torch.device:
    """The state's device, or ValueError where no graph may be made."""
    _refuse_data_parallel(state)
    device = next(state.model.parameters()).device
    if device.type != "cuda":
        raise ValueError(f"graphed: the state is on {device}; CUDA graphs need the card "
                         "(run the eager step)")
    if not all(isinstance(g["lr"], torch.Tensor) and g["lr"].device == device
               for g in state.optimizer.param_groups):
        raise ValueError("graphed: the optimizer's LR must be a tensor on the card "
                         "(loop.make_optimizer), or a graph would keep the LR of its capture")
    return device


def _bindings(state, train: bool) -> tuple:
    """The address of every tensor outside its pool that a graph of the
    step reads or writes: parameters and BatchNorm's buffers, and for a
    train step the gradients, Adam's state and the LR."""
    model, opt = state.model, state.optimizer
    ptrs = [t.data_ptr() for t in (*model.parameters(), *model.buffers())]
    if train:
        for group in opt.param_groups:
            ptrs.append(group["lr"].data_ptr())
            for p in group["params"]:
                ptrs.append(-1 if p.grad is None else p.grad.data_ptr())
                ptrs += [v.data_ptr() for v in opt.state.get(p, {}).values()
                         if isinstance(v, torch.Tensor)]
    return tuple(ptrs)


@dataclass
class _Graph:
    replay: Callable[[], None]
    inputs: dict                 # the graph's static batch
    metrics: dict                # the graph's static metrics
    launches: tuple              # kernel launches of one replay
    bindings: tuple
    replays: int = field(default=0)


class _Memory:
    """The side stream of the warm-ups and captures and the memory pool of
    the graphs, made at first use and shared by the wrappers of one model
    (`_memory`: a train and an eval step never run at once, and captures
    into one pool go through one stream)."""

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


def _memory(state, device) -> _Memory:
    """The `_Memory` of the state's model, made at its first wrapper."""
    memory = _memories.get(state.model)
    if memory is None:
        memory = _memories[state.model] = _Memory(device)
    return memory


class GraphedStep:
    """`graphed`'s callable: the step `step_fn` of `state` as CUDA graphs,
    one for each batch signature (see the module docstring). `graphs`
    holds them by signature."""

    def __init__(self, step_fn, state, device):
        self.step_fn, self.state = step_fn, state
        self.memory = _memory(state, device)
        self.train: bool | None = None     # a train step returns (state, metrics)
        self.warmed: set = set()
        self.graphs: dict = {}

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
        """fn() recorded as a graph, not run: (its outputs, replay)."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.memory.pool(), stream=self.memory.stream()):
            out = fn()
        return out, graph.replay

    def __call__(self, state, batch):
        if state is not self.state:
            raise ValueError("graphed: called with another state than the one it was made for")
        _refuse_data_parallel(state)
        key = _signature(batch)
        entry = self.graphs.get(key)
        if entry is not None:
            if _bindings(state, self.train) != entry.bindings:
                raise RuntimeError("graphed: a parameter, gradient, buffer or optimizer "
                                   "tensor was replaced since the capture (a restore?); "
                                   "make a new graphed step")
            for k, v in batch.items():
                entry.inputs[k].copy_(v, non_blocking=True)
            return self._replay(entry)
        if key not in self.warmed:
            out = self._run_on_side_stream(lambda: self.step_fn(state, batch))
            self.train = isinstance(out, tuple)
            self.warmed.add(key)
            return out
        return self._replay(self._record(key, batch))

    def _record(self, key, batch) -> _Graph:
        """Capture the step at this batch's signature. The Python side
        effects of the capture are undone: the replay that follows does
        them."""
        state = self.state
        inputs = {k: v.clone() for k, v in batch.items()}
        step, launches, misses = state.step, _launches(), _constant_misses()
        out, replay = self._capture(lambda: self.step_fn(state, inputs))
        captured = tuple(b - a for a, b in zip(launches, _launches()))
        if _constant_misses() != misses:
            raise RuntimeError("graphed: a device constant was first made during the capture; "
                               "the warm-up should have made it")
        state.step = step
        for (mod, name), count in zip(_COUNTERS, captured):
            getattr(mod, name).launches -= count
        metrics = out[1] if self.train else out
        entry = _Graph(replay, inputs, metrics, captured, _bindings(state, self.train))
        self.graphs[key] = entry
        return entry

    def _replay(self, entry: _Graph):
        state = self.state
        if self.train:
            lr = state.schedule(state.step)
            for group in state.optimizer.param_groups:
                group["lr"].fill_(lr)
        entry.replay()
        entry.replays += 1
        for (mod, name), count in zip(_COUNTERS, entry.launches):
            getattr(mod, name).launches += count
        metrics = {k: v.clone() for k, v in entry.metrics.items()}
        if not self.train:
            return metrics
        state.step += 1
        return state, metrics


def graphed(step_fn, state) -> GraphedStep:
    """`step_fn` (a train step `(state, batch) -> (state, metrics)` or an
    eval step `(state, batch) -> metrics` of `train/loop.py`) of `state`
    as CUDA graphs, with the step's own signature: echoflow's `jax.jit` of
    the step. The wrappers of one model share one memory pool. Raises
    ValueError for a state on the CPU, a data-parallel state, or an
    optimizer whose LR is not a tensor on the card."""
    return GraphedStep(step_fn, state, _graph_device(state))
