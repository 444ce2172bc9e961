"""The graphed train and eval steps (`echoflow_torch/train/graph.py`) on the
CPU, where no CUDA graph can be made: the refusals, the LR that each Adam
update applies against echoflow's optax schedule, `fit`'s eager path, and
the wrapper's bookkeeping with the capture primitives stood in for.

The stand-in (`_CpuGraphs`) runs the warm-up on the CPU and "captures" by
running the step's Python once, as a capture does, with a replay that
recomputes the static metrics from the static inputs and does nothing
else; so whatever a replay must do in Python (the update count, the LR,
the launch counters), only the wrapper can have done. The card runs the
real capture: `tests/test_torch_cuda.py` and `chip_smoke.py` phase 12.
"""

import gc
import weakref
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from echoflow.train.loop import TrainConfig as JaxConfig
from echoflow.train.loop import lr_schedule as jax_lr_schedule
from echoflow_torch.ops import warp
from echoflow_torch.train import graph
from echoflow_torch.train.loop import (TrainConfig, TrainState, _apply_update,
                                       compiled_steps, create_train_state, fit, lr_schedule,
                                       make_eval_step, make_train_step)
from echoflow_torch.utils import graphs
from echoflow_torch.utils.profiling import count, counters, uncounted

LR, DROP, LR_AFTER = 1e-3, 2, 1e-4


def _tiny_state(lr=None):
    """A TrainState of a small model with a BatchNorm (parameters and
    buffers) and Adam at the schedule LR -> LR_AFTER from update DROP."""
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.BatchNorm1d(2))
    opt = torch.optim.Adam(model.parameters(), lr=LR if lr is None else lr, foreach=False)
    cfg = TrainConfig(lr=LR, lr_drop_step=DROP, lr_after_drop=LR_AFTER)
    return TrainState(model=model, optimizer=opt, schedule=lr_schedule(cfg))


# ------------------------------------------------------------------ refusals

@pytest.mark.parametrize("case", ["cpu"])
def test_graphed_refuses_a_cpu_or_data_parallel_state(case):
    """No graph for a state on the CPU: a ValueError, never the eager step
    in its place. (A data-parallel state on the card is graphed; on gloo it
    lies on the CPU and is refused as here,
    `test_graphed_refuses_a_data_parallel_state_on_the_cpu`.)"""
    state = _tiny_state(lr=torch.tensor(LR))
    with pytest.raises(ValueError, match="cpu"):
        graph.graphed(make_train_step(), state)


def test_compiled_steps_on_the_cpu_are_the_eager_steps():
    state = _tiny_state()
    steps = compiled_steps(state)
    assert not any(isinstance(s, graph.GraphedStep) for s in steps)
    assert [s.__qualname__ for s in steps] == ["make_train_step.<locals>.train_step",
                                               "make_eval_step.<locals>.eval_step"]


# ------------------------------------------------------------------ the LR

@pytest.mark.parametrize("lr_kind", ["float", "tensor"])
def test_each_update_applies_the_scheduled_lr(lr_kind):
    """`_apply_update` moves a parameter whose gradient is a constant c by
    lr_k * c / (|c| + eps) at update k (Adam's bias-corrected moments are c
    and c^2): the move reads the LR each update applied. It follows the
    port's schedule and optax's `piecewise_constant_schedule` as echoflow
    builds it across the drop, for a float LR (the CPU's) and for a 0-d
    tensor LR (the card's, written in place; a CPU Adam with foreach=False
    takes one)."""
    lr = LR if lr_kind == "float" else torch.tensor(LR, dtype=torch.float64)
    state = _tiny_state(lr=lr)
    state.model.double()   # float64: the move is read to 1e-6 of the LR
    jsched = jax_lr_schedule(JaxConfig(lr=LR, lr_drop_step=DROP, lr_after_drop=LR_AFTER))
    c = torch.tensor([[0.5, -2.0, 1.5], [-1.0, 0.25, 3.0]], dtype=torch.float64)
    weight = state.model[0].weight
    for k in range(4):
        before = weight.detach().clone()
        _apply_update(state, (weight * c).sum() + 0.0 * sum(p.sum() for p in
                                                           state.model.parameters()))
        applied = (before - weight.detach()) / (c / (c.abs() + 1e-8))
        want = LR if k < DROP else LR_AFTER
        np.testing.assert_allclose(applied.numpy(), want, rtol=1e-6)
        np.testing.assert_allclose(float(jsched(k)), want, rtol=1e-6)
        assert state.schedule(k) == pytest.approx(want, rel=1e-12) and state.step == k + 1
    group_lr = state.optimizer.param_groups[0]["lr"]
    assert (group_lr is lr) == (lr_kind == "tensor")   # a tensor LR is written in place


# ------------------------------------------------------------------ fit on the CPU

def test_fit_on_the_cpu_runs_the_eager_step_bitwise():
    """`fit` on the CPU runs the eager steps: its history, eval pass and
    parameters are bitwise those of `make_train_step` and `make_eval_step`
    called by hand on the same batches."""
    from train_clasfv_torch import synthetic_batches

    cfg = TrainConfig(lr=1e-3, clip_length=8, image_size=(32, 32), batch_size=2)
    host = list(synthetic_batches(2, 8, 32, 3, seed=0))
    state, history = fit(create_train_state(0, cfg, device="cpu"), iter(host[:2]),
                         eval_batches=iter(host[2:]), log_every=1, log_fn=lambda line: None)
    ref = create_train_state(0, cfg, device="cpu")
    step, eval_step = make_train_step(), make_eval_step()
    want = []
    for b in host[:2]:
        ref, m = step(ref, {k: torch.as_tensor(np.asarray(v)) for k, v in b.items()})
        want.append({k: float(v) for k, v in m.items()})
    m = eval_step(ref, {k: torch.as_tensor(np.asarray(v)) for k, v in host[2].items()})
    want.append({f"eval_{k}": float(v) for k, v in m.items()})
    assert history == want and state.step == ref.step == 2
    for (name, p), q in zip(state.model.named_parameters(), ref.model.parameters()):
        assert torch.equal(p, q), name


# ------------------------------------------------------------------ the wrapper's bookkeeping

class _Step:
    """A train step's Python side effects (the update count, two K2
    launches) and a metric of its batch; `runs` counts its Python runs."""

    def __init__(self, train=True, new_constant_at=None):
        self.train, self.new_constant_at = train, new_constant_at
        self.runs, self.batch = 0, None

    def __call__(self, state, batch):
        self.runs += 1
        self.batch = batch
        if self.runs == self.new_constant_at:
            warp._base_grids(100 + self.runs, 7, torch.device("cpu"), torch.float32)
        count("warp_forward.launches", 2)
        metrics = {"loss": batch["x"].sum()}
        if not self.train:
            return metrics
        state.step += 1
        return state, metrics


class _CpuGraphs(graph.GraphedStep):
    """The wrapper with the CUDA primitives stood in for (module docstring)."""

    def __init__(self, step_fn, state):
        super().__init__(step_fn, state, torch.device("cpu"))
        self.captures = 0

    def _run_on_side_stream(self, fn):
        return fn()

    def _capture(self, fn):
        self.captures += 1
        out = fn()
        metrics = out[1] if isinstance(out, tuple) else out
        inputs = self.step_fn.batch

        def replay():
            metrics["loss"].copy_(inputs["x"].sum())
        return out, SimpleNamespace(replay=replay)


def _x(n=2, dtype=torch.float32, seed=0):
    return {"x": torch.from_numpy(np.random.RandomState(seed).rand(n, 3)).to(dtype)}


def _with_adam_state(state):
    """One real update, so that Adam's state tensors exist."""
    state.model(torch.ones(4, 3)).sum().backward()
    state.optimizer.step()
    return state


def test_warm_up_then_capture_then_replays():
    """Call 1 runs the step (the warm-up), call 2 captures and replays it,
    later calls only replay. Every call advances the update count by one,
    writes the schedule's LR before its replay, adds one step's launches
    and returns the metric of its own batch."""
    state = _with_adam_state(_tiny_state(lr=torch.tensor(LR)))
    step = _Step()
    g = _CpuGraphs(step, state)
    lr = state.optimizer.param_groups[0]["lr"]
    before = counters().get("warp_forward.launches", 0)
    for k in range(5):
        batch = _x(seed=k)
        state, m = g(state, batch)
        assert state.step == k + 1
        assert counters()["warp_forward.launches"] - before == 2 * (k + 1)
        assert float(m["loss"]) == pytest.approx(float(batch["x"].sum()))
        if k >= 1:   # a replay: the LR of update k
            assert float(lr) == pytest.approx(LR if k < DROP else LR_AFTER, rel=1e-6)
    assert (step.runs, g.captures, len(g.graphs)) == (2, 1, 1)
    assert next(iter(g.graphs.values())).replays == 4
    assert state.optimizer.param_groups[0]["lr"] is lr


def test_one_graph_for_each_batch_signature():
    """A new shape or dtype is a new signature: a warm-up, then a capture.
    The signature is the keys, shapes and dtypes of the batch."""
    state = _tiny_state(lr=torch.tensor(LR))
    step = _Step()
    g = _CpuGraphs(step, state)
    calls = [_x(2), _x(2, seed=1), _x(2, seed=2), _x(5), _x(5), _x(5),
             _x(2, dtype=torch.float64), _x(2, dtype=torch.float64), _x(2, seed=3)]
    for i, batch in enumerate(calls):
        state, m = g(state, batch)
        assert float(m["loss"]) == pytest.approx(float(batch["x"].sum()))
    assert len(g.graphs) == g.captures == 3 and step.runs == 6 and state.step == len(calls)
    assert graphs._signature(_x(2)) == graphs._signature(_x(2, seed=9))
    assert graphs._signature(_x(2)) != graphs._signature({"y": _x(2)["x"]})


def test_returned_metrics_are_copies():
    state = _tiny_state(lr=torch.tensor(LR))
    g = _CpuGraphs(_Step(), state)
    for seed in range(3):
        g(state, _x(seed=seed))
    _, m3 = g(state, _x(seed=3))
    _, m4 = g(state, _x(seed=4))
    static = next(iter(g.graphs.values())).outputs["loss"]
    assert float(m3["loss"]) == pytest.approx(float(_x(seed=3)["x"].sum()))
    assert m3["loss"].data_ptr() not in (m4["loss"].data_ptr(), static.data_ptr())


@pytest.mark.parametrize("replace", ["optimizer_state", "gradient", "parameter", "buffer"])
def test_a_replaced_tensor_after_capture_is_refused(replace):
    """A graph keeps the addresses it captured: after a restore
    (`Optimizer.load_state_dict` makes new state tensors), a gradient set
    to None, or a parameter or buffer replaced, a call raises instead of
    replaying on tensors nothing reads any more."""
    state = _with_adam_state(_tiny_state(lr=torch.tensor(LR)))
    g = _CpuGraphs(_Step(), state)
    for seed in range(3):
        g(state, _x(seed=seed))
    model, opt = state.model, state.optimizer
    if replace == "optimizer_state":
        opt.load_state_dict(opt.state_dict())
    elif replace == "gradient":
        opt.zero_grad(set_to_none=True)
    elif replace == "parameter":
        model[0].weight.data = model[0].weight.data.clone()
    else:
        model[1].running_mean = model[1].running_mean.clone()
    with pytest.raises(RuntimeError, match="replaced"):
        g(state, _x(seed=3))
    assert state.step == 3


def test_eval_graphs_leave_the_update_count_and_the_lr():
    state = _tiny_state(lr=torch.tensor(0.5))
    g = _CpuGraphs(_Step(train=False), state)
    for seed in range(4):
        m = g(state, _x(seed=seed))
        assert float(m["loss"]) == pytest.approx(float(_x(seed=seed)["x"].sum()))
    assert state.step == 0 and float(state.optimizer.param_groups[0]["lr"]) == 0.5


def test_a_device_constant_first_made_during_capture_raises():
    """The warm-up makes every device constant the step reads; one made
    while capturing would be a copy replayed from a host buffer."""
    state = _tiny_state(lr=torch.tensor(LR))
    g = _CpuGraphs(_Step(new_constant_at=2), state)
    g(state, _x())
    with pytest.raises(RuntimeError, match="device constant"):
        g(state, _x(seed=1))


def test_a_failed_capture_raises_and_runs_nothing_eagerly():
    class Failing(_CpuGraphs):
        def _capture(self, fn):
            raise RuntimeError("operation not permitted when stream is capturing")

    state = _tiny_state(lr=torch.tensor(LR))
    step = _Step()
    g = Failing(step, state)
    g(state, _x())
    with pytest.raises(RuntimeError, match="capturing"):
        g(state, _x(seed=1))
    assert step.runs == 1 and state.step == 1 and not g.graphs


def test_the_wrappers_of_one_model_share_one_pool():
    """A train and an eval wrapper of one state share their memory pool and
    capture stream without being told; another model's wrapper has its
    own, and a model's pool goes with the model."""
    state = _tiny_state(lr=torch.tensor(LR))
    train, evaluate = _CpuGraphs(_Step(), state), _CpuGraphs(_Step(train=False), state)
    other = _CpuGraphs(_Step(), _tiny_state(lr=torch.tensor(LR)))
    assert train.memory is evaluate.memory and other.memory is not train.memory
    gc.collect()
    held, model = len(graphs._memories), weakref.ref(state.model)
    del state, train, evaluate
    gc.collect()
    assert model() is None and len(graphs._memories) == held - 1
    assert any(m is other.memory for m in graphs._memories.values())


def test_a_wrapper_runs_only_its_own_state():
    state = _tiny_state(lr=torch.tensor(LR))
    g = _CpuGraphs(_Step(), state)
    with pytest.raises(ValueError, match="another state"):
        g(_tiny_state(lr=torch.tensor(LR)), _x())


# ------------------------------------------------------------------ data parallelism

def test_graphed_refuses_a_data_parallel_state_on_the_cpu():
    """A data-parallel state on gloo lies on the CPU: `compiled_steps`
    gives it the eager steps and `graphed` refuses it."""
    state = _tiny_state(lr=torch.tensor(LR))
    state.group, state.grads = object(), torch.zeros(8)
    steps = compiled_steps(state)
    assert not any(isinstance(s, graph.GraphedStep) for s in steps)
    with pytest.raises(ValueError, match="cpu"):
        graph.graphed(make_train_step(), state)


def test_data_parallel_graphs_keep_lockstep_on_two_gloo_ranks():
    """The wrapper on a data-parallel state, 2 gloo ranks, its capture
    stood in for (`parallel/dryrun.StandInGraphs`: a capture computes
    nothing, a replay reruns the step with its update count and launch
    counters taken back): both ranks warm up at call 1, capture at call 2
    and replay from then on, the one warm-up a signature that the card
    needs; the wrapper writes the schedule's LR before each replay (1e-4,
    then 1e-5 from update 2) and advances the update count; the metrics of
    every train and eval call and the final parameters are bitwise those
    of the eager data-parallel steps on a twin state, and the ranks agree."""
    from echoflow_torch.parallel.dryrun import _dryrun_batch, dp_graphed_calls
    from echoflow_torch.parallel.launch import run_ranks

    rng = np.random.RandomState(0)
    batches = [_dryrun_batch(2, 8, 32, 32, rng) for _ in range(5)]
    ranks = run_ranks(dp_graphed_calls, 2, batches, DROP, threads=2)
    lrs = [float(torch.tensor(x)) for x in (1e-4, 1e-5, 1e-5)]
    for r in ranks:
        assert r["calls"] == ["warm-up", "capture", "replay", "replay", "replay"]
        assert r["eval_calls"] == ["warm-up", "capture", "replay", "replay"]
        assert r["lrs"] == lrs and r["steps"] == [1, 2, 3, 4]
        assert r["same_metrics"] and r["same_eval"] and r["same_params"]
    assert ranks[0]["loss"] == ranks[1]["loss"]


# ------------------------------------------------------------------ function graphs

class _CpuFunctionGraphs(graphs.GraphedFunction):
    """`GraphedFunction` taking CPU tensors for CUDA ones, its capture stood
    in for: the capture runs the function's Python once and puts the
    `held()` tensors back (a capture computes nothing); a replay runs it
    again with its counts taken back (`utils/profiling.uncounted`), so the
    wrapper must add them."""

    def __init__(self, fn, memory=None, bindings=lambda **others: (), held=list):
        super().__init__(fn, memory=graphs._Memory(torch.device("cpu")), bindings=bindings)
        self.held, self.captures, self.warm_ups = held, 0, 0

    def _on_card(self, tensors):
        return True

    def _run_on_side_stream(self, fn):
        self.warm_ups += 1
        return fn()

    def _capture(self, fn):
        from echoflow_torch.parallel.dryrun import _fill

        self.captures += 1
        saved = [(t, t.clone()) for t in self.held()]
        out = fn()
        with torch.no_grad():
            for t, v in saved:
                t.copy_(v)

        def replay():
            _fill(out, uncounted(fn)[0])
        return out, SimpleNamespace(replay=replay)


def _rollout_inputs(seed, n=2, t=6, h=12, w=10):
    rng = np.random.RandomState(seed)
    labels = (rng.rand(2, n, 1, h, w) > 0.5).astype(np.float32)
    one_hot = [torch.from_numpy(np.concatenate([1 - m, m], axis=1)) for m in labels]
    motion = torch.from_numpy((0.1 * rng.randn(n, 4, t, h, w)).astype(np.float32))
    return one_hot[0], one_hot[1], motion


@pytest.mark.parametrize("name", ["deform_forback", "deform_images_forback",
                                  "apply_sequence_deformation"])
def test_graphed_rollouts_equal_the_eager_rollouts(name):
    """Each rollout of `infer/propagate.py` through the function wrapper,
    its capture stood in for: one graph for each shapes, `mode` and
    indices (a warm-up, then a capture), every call's result bitwise the
    eager rollout's (`fn.__wrapped__`) on its own inputs, and the returned
    tensors copies that a later replay leaves alone. On CPU tensors the
    public rollout is the eager one and makes no graph."""
    from echoflow_torch.infer import propagate

    fn = getattr(propagate, name)
    eager = fn.__wrapped__

    def args(seed, n=2):
        ed, es, motion = _rollout_inputs(seed, n=n)
        if name == "deform_forback":
            return (ed, es, motion), {"mode": "bilinear"}
        if name == "deform_images_forback":
            return (torch.rand(n, 3, 6, 12, 10, generator=torch.Generator().manual_seed(seed)),
                    motion), {}
        return (ed, motion, 4, 0), {"mode": "bilinear", "forward": False}

    g = _CpuFunctionGraphs(eager)
    calls = [args(0), args(1), args(2), args(3, n=3), args(4, n=3), args(5)]
    results = []
    for a, kw in calls:
        got = g(*a, **kw)
        want = eager(*a, **kw)
        for x, y in zip(*(([o] if torch.is_tensor(o) else o) for o in (got, want))):
            assert torch.equal(x, y)
        results.append((got, want))
    a, kw = args(6)
    g(*a, **{**kw, "mode": "nearest"})
    g(*a, **{**kw, "mode": "nearest"})
    assert (len(g.graphs), g.captures, g.warm_ups) == (3, 3, 3)
    for got, want in results:   # replays after them overwrote nothing returned
        for x, y in zip(*(([o] if torch.is_tensor(o) else o) for o in (got, want))):
            assert torch.equal(x, y)
    a, kw = args(0)
    before = len(fn.graphs)
    fn(*a, **kw)
    assert len(fn.graphs) == before == 0 and fn.signature == g.signature


@pytest.mark.parametrize("counter", ["warp_forward.launches", "t.unnamed_kernel.launches"])
def test_a_function_graph_advances_the_launch_counters(counter):
    """A replay adds the counts its capture made (here 3 launches a call,
    of K2 or of a kernel that `utils/graphs` never names), and the result
    is a copy of the graph's output, not the output."""
    def fn(x, scale):
        count(counter, 3)
        return x * scale

    g = _CpuFunctionGraphs(fn)
    before = counters().get(counter, 0)
    outs = []
    for k in range(4):
        outs.append(g(torch.full((2,), float(k)), scale=2.0))
        assert counters()[counter] - before == 3 * (k + 1)
    static = next(iter(g.graphs.values())).outputs
    assert [float(o[0]) for o in outs] == [0.0, 2.0, 4.0, 6.0]
    assert all(o.data_ptr() != static.data_ptr() for o in outs)


def _scaled(x, scale):
    return x * scale


def test_a_function_wrapper_keeps_its_most_recently_used_graphs():
    """With room for 2 graphs: a third key's capture drops the graph used
    longest ago, with its static tensors; a replay counts as a use; a
    dropped key warms up and captures again; every result is the
    function's."""
    g = _CpuFunctionGraphs(_scaled)
    g.max_graphs = 2
    a, b, c = (torch.full((n,), 1.0) for n in (1, 2, 3))
    for x in (a, a, b, b, a):
        assert torch.equal(g(x, 2.0), x * 2.0)
    static_b = weakref.ref(g.graphs[g.key(b, 2.0)].inputs["x"])
    for x in (c, c):
        assert torch.equal(g(x, 2.0), x * 2.0)
    assert list(g.graphs) == [g.key(a, 2.0), g.key(c, 2.0)] and (g.warm_ups, g.captures) == (3, 3)
    gc.collect()
    assert static_b() is None
    for x in (b, b):
        assert torch.equal(g(x, 2.0), x * 2.0)
    assert list(g.graphs) == [g.key(c, 2.0), g.key(b, 2.0)] and (g.warm_ups, g.captures) == (4, 4)


@pytest.mark.parametrize("wrapper", ["function", "step"])
def test_clear_and_the_warm_up_bound_drop_what_a_wrapper_holds(wrapper):
    """Keys called once are held for their capture up to `max_graphs` (the
    oldest forgotten first: it warms up again); `clear()` drops every graph
    and warm-up, so the next call of a captured key warms up again. For a
    function wrapper and a step wrapper alike."""
    if wrapper == "function":
        g = _CpuFunctionGraphs(_scaled)
        call = lambda n: float(g(torch.full((n,), 1.0), 3.0).sum())    # noqa: E731
    else:
        state = _tiny_state(lr=torch.tensor(LR))
        g = _CpuGraphs(_Step(), state)
        call = lambda n: float(g(state, _x(n))[1]["loss"])              # noqa: E731
    g.max_graphs = 2
    for n in (1, 2, 3, 1):
        call(n)
    assert not g.graphs and len(g.warmed) == 2            # 1 was forgotten before its second call
    call(1)
    assert len(g.graphs) == 1
    g.clear()
    assert not g.graphs and not g.warmed
    call(1)
    assert not g.graphs and len(g.warmed) == 1


def test_camus_multisteps_on_its_fold_and_update_graphs_equals_the_eager_one(monkeypatch):
    """`generic.run_training` at k = 3 over 7 mini-steps, then 4 more with
    the returned optimizer, through the function wrapper with its capture
    stood in for, against the eager run from the same init: the "fold"
    graph (warm-up, capture at mini-step 2) and the "fold + update" graph
    (warm-up at 3, capture at 6) of one wrapper made once for both calls;
    the losses, the outputs, the parameters, the accumulated mean and the
    mini-step count bitwise the eager run's (which
    `tests/test_torch_camus.py` holds against optax's MultiSteps(adamw))."""
    import train_camus_torch
    from echoflow_torch.train import generic

    rng = np.random.RandomState(0)
    batches = [{"images": rng.rand(2, 1, 16, 16).astype(np.float32),
                "labels": rng.randint(0, 4, (2, 16, 16)).astype(np.int32)} for _ in range(7)]

    def run(stand_in):
        model = train_camus_torch.build_model(seed=0)
        opt = generic.MultiSteps(model.parameters(), 3, 2e-3, 1e-5)
        if stand_in:
            # As on the card: the gradients exist from the start and stay put.
            opt.on_card = True
            for p in opt.params:
                p.grad = torch.zeros_like(p)
            held = lambda: [*model.parameters(), *opt.acc, opt.count,   # noqa: E731
                            *[v for s in opt.inner.state.values() for v in s.values()]]
            monkeypatch.setattr(generic, "GraphedFunction",
                                lambda fn, memory, bindings: _CpuFunctionGraphs(
                                    fn, bindings=bindings, held=held))
        losses, examples = [], []
        for part in (batches, batches[:4]):
            model, opt, avg, example = generic.run_training(
                model, iter(part), optimizer=opt, keys=("images", "labels"))
            losses.append(avg)
            examples.append(example[0])
        monkeypatch.undo()
        return model, opt, losses, examples

    model, opt, losses, examples = run(False)
    g_model, g_opt, g_losses, g_examples = run(True)
    (wrapper,) = g_opt.steps.values()
    assert len(wrapper.graphs) == 2 and (wrapper.warm_ups, wrapper.captures) == (2, 2)
    assert g_losses == losses and g_opt.mini_step == opt.mini_step == 2
    assert all(np.array_equal(a, b) for a, b in zip(g_examples, examples))
    for a, b in zip((*g_model.parameters(), *g_opt.acc, g_opt.count),
                    (*model.parameters(), *opt.acc, opt.count)):
        assert torch.equal(a, b)
