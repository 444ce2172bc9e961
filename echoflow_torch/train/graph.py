"""The train and eval steps as CUDA graphs: the port's counterpart of
`jax.jit` over echoflow's steps (`echoflow/train/loop.py`, `fit`,
`fit_on_mesh`).

    step = graphed(make_train_step(), state)
    state, metrics = step(state, batch)        # the eager step's signature
    metrics = graphed(make_eval_step(), state)(state, batch)

An eager train step issues some 3,000 kernels from Python (about 90 ops in
each of the 31 chain steps, the model's forward and backward, Adam), and
in bf16 the card waits for the host most of the step. `graphed` records
the step once as a CUDA graph and then launches it as one, with the
warm-up, capture and replay of `utils/graphs.py`: one graph for each batch
signature (keys, shapes, dtypes), made at the second call with it.

What the captured code does in Python happens once, at capture, and never
at a replay, so the wrapper does it for every replay: the update count
(`state.step += 1`), the LR of the update (the optimizer's LR is a 0-d
tensor on the card, `loop.make_optimizer`; the wrapper writes
`state.schedule(state.step)` into it before each replay, and a captured
step leaves it alone), and the kernels' launch counters (the counts made
while capturing a graph are added at each of its replays). The wrapper's
spans of one call (`graph.feed`, `graph.replay`, `graph.outputs`) and the
device spans of its replay carry the call's `state.step`, before it is
advanced.

A graph reads and writes the tensors it was captured with: for a step the
parameters, their gradients (zeroed in place on the card, never set to
None: `loop._apply_update`; under data parallelism views of one flat
buffer, `loop.data_parallel`), Adam's state, the LR and BatchNorm's
buffers. A call raises if any of them is no longer the tensor the graph
captured (`Optimizer.load_state_dict` replaces Adam's state): make a new
wrapper after a restore. What a call returns is a copy; the next replay
overwrites the graph's own outputs.

Data parallelism (`loop.data_parallel`, one process a card): the step's
collectives (global BatchNorm, the coupled smoothness, the gradient
all-reduce, the metrics) are captured as graph nodes. Every rank warms
up, captures and replays at the same calls, because each decision
(warm-up, capture, replay, which graph to drop) depends only on the
sequence of batch signatures, equal on every rank (`parallel.shard_batch`
requires the global batch to divide by the world size); so the collectives of one replay meet those of the other
ranks' replays. The communicators are made by `data_parallel`'s broadcast,
before any warm-up.

Refused with ValueError: a state on the CPU (the caller runs the eager step
there, as it does for a data-parallel state on gloo, which cannot be
captured). A failed capture raises; nothing falls back to the eager call.
"""

from __future__ import annotations

import weakref

import torch

from echoflow_torch.utils.graphs import _Graphs, _signature, model_memory


def _graph_device(state) -> torch.device:
    """The state's device, or ValueError where no graph may be made."""
    device = next(state.model.parameters()).device
    if device.type != "cuda":
        raise ValueError(f"graphed: the state is on {device}; CUDA graphs need the card "
                         "(run the eager step)")
    if not all(isinstance(g["lr"], torch.Tensor) and g["lr"].device == device
               for g in state.optimizer.param_groups):
        raise ValueError("graphed: the optimizer's LR must be a tensor on the card "
                         "(loop.make_optimizer), or a graph would keep the LR of its capture")
    return device


def optimizer_bindings(optimizer) -> list:
    """The addresses of an optimizer's LR tensors, its parameters'
    gradients (-1 for None) and its state tensors."""
    ptrs = []
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            ptrs.append(group["lr"].data_ptr())
        for p in group["params"]:
            ptrs.append(-1 if p.grad is None else p.grad.data_ptr())
            ptrs += [v.data_ptr() for v in optimizer.state.get(p, {}).values()
                     if isinstance(v, torch.Tensor)]
    return ptrs


def _bindings(state, train: bool) -> tuple:
    """The address of every tensor outside its pool that a graph of the
    step reads or writes: parameters and BatchNorm's buffers, and for a
    train step the gradients, Adam's state and the LR."""
    model = state.model
    ptrs = [t.data_ptr() for t in (*model.parameters(), *model.buffers())]
    if train:
        ptrs += optimizer_bindings(state.optimizer)
    return tuple(ptrs)


_blas_remade: weakref.WeakSet = weakref.WeakSet()   # the `_Memory`s done


def _remake_blas_workspaces(memory):
    """Before the first capture into `memory`'s pool: cuBLAS's workspaces
    dropped (as torch's own graph trees do before a capture,
    `torch._inductor.cudagraph_trees.clear_cublass_cache`), the cache
    emptied, and the workspaces made again on the side stream, on this
    thread and on autograd's device thread (a GEMM and its backward on 1x1
    matrices). cuBLAS keeps a workspace (32 MiB on an H100) for each
    thread's handle and stream from its first GEMM there until the process
    ends. The warm-up made them in blocks of segments that the step had
    freed, and kept those segments reserved beside the graph's pool: 196
    MiB at the fp32 CLAS-FV step, whose backward starts with GEMMs
    (`ops/conv.pointwise_weight_grad`). Made now, they take segments of
    their own, outside the pool."""
    if memory in _blas_remade:
        return
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.synchronize(memory.device)
    torch.cuda.empty_cache()
    current = torch.cuda.current_stream(memory.device)
    side = memory.stream()
    side.wait_stream(current)
    with torch.cuda.stream(side):
        a = torch.ones((1, 1), device=memory.device, requires_grad=True)
        torch.mm(a, a).sum().backward()
    current.wait_stream(side)
    _blas_remade.add(memory)


class GraphedStep(_Graphs):
    """`graphed`'s callable: the step `step_fn` of `state` as CUDA graphs,
    one for each batch signature (see the module docstring). `graphs`
    holds them by signature."""

    def __init__(self, step_fn, state, device):
        super().__init__(model_memory(state.model, device))
        self.step_fn, self.state = step_fn, state
        self.train: bool | None = None     # a train step returns (state, metrics)

    def __call__(self, state, batch):
        if state is not self.state:
            raise ValueError("graphed: called with another state than the one it was made for")
        key = _signature(batch)
        entry = self._lookup(key)
        if entry is None and key not in self.warmed:
            out = self._warm_up(key, lambda: self.step_fn(state, batch))
            self.train = isinstance(out, tuple)
            return out
        step = state.step
        if entry is None:
            entry = self._record(key, self._metrics_of, batch,
                                 lambda: _bindings(state, self.train))
            state.step = step
        else:
            self._feed(entry, batch, lambda: _bindings(state, self.train), id=step)
        self._launch(entry, id=step, before=lambda: self._write_lr(state))
        metrics = self._outputs(entry, id=step)
        if not self.train:
            return metrics
        state.step += 1
        return state, metrics

    def _capture(self, fn):
        _remake_blas_workspaces(self.memory)
        return super()._capture(fn)

    def _write_lr(self, state):
        """The LR of the update this replay makes, into the optimizer's LR
        tensors (a train step's)."""
        if self.train:
            lr = state.schedule(state.step)
            for group in state.optimizer.param_groups:
                group["lr"].fill_(lr)

    def _metrics_of(self, batch):
        out = self.step_fn(self.state, batch)
        return out[1] if self.train else out


def graphed(step_fn, state) -> GraphedStep:
    """`step_fn` (a train step `(state, batch) -> (state, metrics)` or an
    eval step `(state, batch) -> metrics` of `train/loop.py`) of `state`
    as CUDA graphs, with the step's own signature: echoflow's `jax.jit` of
    the step, in one process or under `loop.data_parallel`. The wrappers of
    one model share one memory pool. Raises ValueError for a state on the
    CPU or an optimizer whose LR is not a tensor on the card."""
    return GraphedStep(step_fn, state, _graph_device(state))
