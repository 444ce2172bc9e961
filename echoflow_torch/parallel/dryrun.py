"""Data-parallel checks that run on the ranks of a process group (port of
`__graft_entry__.dryrun_multichip`).

`dryrun_multigpu(n, backend)` spawns n ranks (`parallel/launch.run_ranks`)
and runs echoflow's six multichip cases, one printed line each:

  1. the CLAS-FV train step, data-parallel over the n ranks;
  2. the ed-or-es-only recipe's train step on the same group;
  3. SIMPLE fusion on an engine sharded over n devices against the
     single-device engine;
  4. the softmax fast path, likewise;
  5. the uneven case: a 33-frame video has 1 valid clip, padded up to a
     multiple of the n devices;
  6. SIMPLE fusion sharded over 2 devices.

Rank r works on `cuda:r` under NCCL and on the CPU under gloo. Cases 3-6
run on rank 0, whose engine holds one replica a device (under gloo, the
CPU n times). The functions each rank runs live here, not in a test
module: a spawned rank re-imports the module of its function.

`dp_train_steps`, `batchnorm_on_shard` and `dp_graphed_calls` are what
the parity tests run on each rank.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from echoflow_torch.parallel.launch import run_ranks
from echoflow_torch.parallel.mesh import shard_batch
from echoflow_torch.train.graph import GraphedStep
from echoflow_torch.utils.profiling import uncounted


def _rank_device(rank: int) -> torch.device:
    import torch.distributed as dist

    return torch.device(f"cuda:{rank}" if dist.get_backend() == "nccl" else "cpu")


def _to_torch(batch: dict, device, dtype) -> dict:
    """Host arrays on `device`, the videos in `dtype`."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}
    return {k: v.to(dtype) if "video" in k else v for k, v in out.items()}


def _leaf_sums(model) -> dict:
    return {k: float(v.double().sum()) for k, v in model.state_dict().items()}


def dp_train_steps(rank: int, world: int, state_dict: dict, batches: list,
                   recipe: str = "clasfv", dtype: str = "float32",
                   log_path: str | None = None, remat: bool = False,
                   compute_dtype: str = "float32") -> dict:
    """`fit_on_mesh` over the global host batches `batches` with the
    recipe's train step ("clasfv", fused, or "ed_es_only"; rematerialized
    with `remat`), from the model `state_dict` (numpy arrays) in `dtype`
    (float64 runs the whole step in float64, outputs included), computing
    in `TrainConfig.compute_dtype` `compute_dtype`, at the optimizer's
    defaults (lr 1e-4), the metrics logged every step (to a
    `MetricsLogger` at `log_path` on rank 0), through `compiled_steps`:
    the eager steps under gloo, CUDA graphs under NCCL. Returns the
    history, the log lines and the replays of the train step's graphs (0
    for the eager step), and on rank 0 each step's gradients, read after
    the step returns, and the final state dict (numpy); every rank returns
    the sums of its final state's leaves, which must agree."""
    from echoflow_torch.train.loop import (TrainConfig, compiled_steps, create_train_state,
                                           data_parallel, fit_on_mesh,
                                           make_ed_es_only_train_step, make_train_step)
    from echoflow_torch.utils.metrics_log import MetricsLogger

    device = _rank_device(rank)
    n, _, t, h, w = next(v for k, v in batches[0].items() if "video" in k).shape
    state = create_train_state(0, TrainConfig(clip_length=t, image_size=(h, w), batch_size=n,
                                              compute_dtype=getattr(torch, compute_dtype)),
                               device=device)
    state.model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                                 for k, v in state_dict.items()})
    torch_dtype = getattr(torch, dtype)
    state.model.to(torch_dtype).output_dtype = torch.promote_types(torch_dtype, torch.float32)
    inner = (make_train_step(remat=remat) if recipe == "clasfv"
             else make_ed_es_only_train_step(remat=remat))
    grads = []
    host = [{k: v.astype(dtype) if "video" in k else v for k, v in b.items()} for b in batches]
    lines = []
    state = data_parallel(state)
    train, evaluate = compiled_steps(state, lambda: inner)

    def recording_step(state, batch):
        # After the step, outside any graph: a capture may not copy to the host.
        state, metrics = train(state, batch)
        if rank == 0:
            # Copies: the gradients are views of a buffer the next step zeroes.
            grads.append({k: p.grad.detach().to("cpu", copy=True).numpy()
                          for k, p in state.model.named_parameters()})
        return state, metrics

    state, history = fit_on_mesh(state, host, log_every=1, log_fn=lines.append,
                                 metrics_logger=MetricsLogger(log_path) if log_path else None,
                                 steps=(recording_step, evaluate))
    replays = sum(e.replays for e in getattr(train, "graphs", {}).values())
    out = {"history": history, "lines": lines, "grads": grads, "step": state.step,
           "leaf_sums": _leaf_sums(state.model), "replays": replays}
    if rank == 0:
        out["state"] = {k: v.cpu().numpy() for k, v in state.model.state_dict().items()}
    return out


def batchnorm_on_shard(rank: int, world: int, x: np.ndarray, grad_y: np.ndarray,
                       params: dict) -> dict:
    """The port's `BatchNorm3d` (float64, training mode) on this rank's shard
    of the global batch `x` under the default group: the output and, for
    the objective sum(grad_y * y) over the whole batch, d_input of the
    shard and this rank's parts of d_weight and d_bias (they sum over the
    ranks); the running statistics after the update. `params` holds
    weight, bias, running_mean and running_var."""
    import torch.distributed as dist

    from echoflow_torch.models.r2plus1d import BatchNorm3d, sync_batchnorm

    bn = BatchNorm3d(x.shape[1], eps=1e-5, momentum=0.1).double().train()
    with torch.no_grad():
        for k, v in params.items():
            getattr(bn, k).copy_(torch.from_numpy(v))
    sync_batchnorm(bn, dist.group.WORLD)
    xs = torch.from_numpy(shard_batch({"x": x}, rank, world)["x"].copy()).requires_grad_()
    y = bn(xs)
    y.backward(torch.from_numpy(shard_batch({"g": grad_y}, rank, world)["g"].copy()))
    return {"y": y.detach().numpy(), "dx": xs.grad.numpy(), "dweight": bn.weight.grad.numpy(),
            "dbias": bn.bias.grad.numpy(), "running_mean": bn.running_mean.numpy(),
            "running_var": bn.running_var.numpy()}


class StandInGraphs(GraphedStep):
    """A `train/graph.GraphedStep` with its CUDA primitives stood in for on
    the CPU, for a data-parallel state on gloo (which no CUDA graph holds):
    the warm-up runs the step; the capture runs the step's Python once, as
    a capture does, and puts every tensor of the state back (a capture
    computes nothing); a replay runs the step again with the effects a
    replay does not have taken back (the update count, the counts), so the
    wrapper must do those. `calls` logs "warm-up",
    "capture" and "replay" in order; `lrs` the LR each replay found, which
    the wrapper wrote."""

    def __init__(self, step_fn, state):
        super().__init__(step_fn, state, torch.device("cpu"))
        self.calls, self.lrs = [], []

    def _run_on_side_stream(self, fn):
        self.calls.append("warm-up")
        return fn()

    def _capture(self, fn):
        self.calls.append("capture")
        saved = [(t, t.clone()) for t in _state_tensors(self.state)]
        out = fn()
        with torch.no_grad():
            for t, v in saved:
                t.copy_(v)

        def replay():
            self.calls.append("replay")
            self.lrs.append(float(self.state.optimizer.param_groups[0]["lr"]))
            step = self.state.step
            _fill(out, uncounted(fn)[0])
            self.state.step = step
        return out, SimpleNamespace(replay=replay)


def _state_tensors(state) -> list:
    """Every tensor a train step of `state` writes: parameters, buffers,
    the gradient buffer, the optimizer's LR and state."""
    out = [*state.model.parameters(), *state.model.buffers()]
    out += [] if state.grads is None else [state.grads]
    for group in state.optimizer.param_groups:
        out += [group["lr"]] if isinstance(group["lr"], torch.Tensor) else []
    out += [v for st in state.optimizer.state.values() for v in st.values()
            if isinstance(v, torch.Tensor)]
    return out


def _fill(static, fresh):
    """Copy the tensors of `fresh` into those of `static` (same structure)."""
    if isinstance(static, torch.Tensor):
        static.copy_(fresh)
    elif isinstance(static, dict):
        for k in static:
            _fill(static[k], fresh[k])
    else:
        for a, b in zip(static, fresh):
            _fill(a, b)


def dp_graphed_calls(rank: int, world: int, batches: list, lr_drop_step: int) -> dict:
    """The fused train step and the eval step of a data-parallel state on
    this rank through `StandInGraphs`, against the eager steps of a twin
    state from the same init, over the global host `batches` (the last one
    for the eval step, three calls), Adam's LR a tensor that drops at
    update `lr_drop_step`: each wrapper's calls, the LR of each replay, the
    update count after each call, and whether the metrics and the final
    parameters are bitwise the eager ones."""
    from echoflow_torch.train.loop import (TrainConfig, create_train_state, data_parallel,
                                           make_eval_step, make_train_step)

    n, _, t, h, w = batches[0]["video"].shape
    cfg = TrainConfig(clip_length=t, image_size=(h, w), batch_size=n, lr_drop_step=lr_drop_step)

    def dp_state():
        state = create_train_state(0, cfg, device="cpu")
        state.optimizer = torch.optim.Adam(state.model.parameters(), lr=torch.tensor(cfg.lr),
                                           betas=(0.9, 0.999), eps=1e-8, foreach=False)
        return data_parallel(state)

    local = [_to_torch(shard_batch(b, rank, world), "cpu", torch.float32) for b in batches]
    eager, state = dp_state(), dp_state()
    train, evaluate = StandInGraphs(make_train_step(), state), StandInGraphs(
        make_eval_step(), state)
    step, eval_step = make_train_step(), make_eval_step()
    same, steps = True, []
    for batch in local[:-1]:
        eager, want = step(eager, batch)
        state, got = train(state, batch)
        same &= all(torch.equal(got[k], want[k]) for k in want)
        steps.append(state.step)
    evals = [evaluate(state, local[-1]) for _ in range(3)]
    want = eval_step(eager, local[-1])
    return {"calls": train.calls, "eval_calls": evaluate.calls, "lrs": train.lrs,
            "steps": steps, "same_metrics": same,
            "same_eval": all(torch.equal(m[k], want[k]) for m in evals for k in want),
            "same_params": all(torch.equal(p, q) for p, q in zip(state.model.parameters(),
                                                                  eager.model.parameters())),
            "loss": float(want["loss"])}


def _dryrun_batch(n: int, t: int, h: int, w: int, rng) -> dict:
    """echoflow's dry-run batch, drawn in its order."""
    return {
        "video": rng.rand(n, 3, t, h, w).astype(np.float32),
        "ed_label": (rng.rand(n, h, w) > 0.7).astype(np.int32),
        "es_label": (rng.rand(n, h, w) > 0.85).astype(np.int32),
        "ed_idx": rng.randint(0, 2, size=(n,)),
        "es_idx": rng.randint(t - 3, t - 1, size=(n,)),
    }


def _dryrun_rank(rank: int, world: int) -> list:
    """The six cases on this rank; the lines rank 0 prints."""
    import torch.distributed as dist

    from echoflow_torch.infer.pipeline import VideoSegmenter
    from echoflow_torch.train.loop import (TrainConfig, create_train_state, data_parallel,
                                           make_ed_es_only_train_step, make_train_step)

    device = _rank_device(rank)
    tag = f"dryrun_multigpu({world})"
    t, h, w = 8, 32, 32
    cfg = TrainConfig(clip_length=t, image_size=(h, w), batch_size=world)
    rng = np.random.RandomState(0)
    batch = _dryrun_batch(world, t, h, w, rng)
    local = _to_torch(shard_batch(batch, rank, world), device, torch.float32)
    lines = []

    # Case 1: the CLAS-FV step (forward, OTA/SGS/OTS, backward, Adam).
    state = data_parallel(create_train_state(0, cfg, device=device))
    state, metrics = make_train_step()(state, local)
    loss = float(metrics["loss"])
    if not np.isfinite(loss) or state.step != 1:
        raise AssertionError(f"{tag}: clasfv step gave loss {loss}, step {state.step}")
    lines.append(f"{tag}: clasfv train ok, loss={loss:.4f}")

    # Case 2: the ed-or-es-only step (two clips a sample) from the initial state.
    edes = data_parallel(create_train_state(0, cfg, device=device))
    edes_local = {"ed_video": local["video"], "es_video": local["video"],
                  **{k: local[k] for k in ("ed_label", "es_label", "ed_idx", "es_idx")}}
    _, edes_metrics = make_ed_es_only_train_step()(edes, edes_local)
    edes_loss = float(edes_metrics["loss"])
    if not np.isfinite(edes_loss):
        raise AssertionError(f"{tag}: non-finite ed_es_only loss {edes_loss}")
    lines.append(f"{tag}: ed_es_only train ok, loss={edes_loss:.4f}")

    # Cases 3-6: the engine sharded over the ranks' devices, on rank 0.
    video = np.asarray(rng.rand(3, 45, h, w) * 255, np.uint8)
    short = np.asarray(rng.rand(3, 33, h, w) * 255, np.uint8)
    if rank == 0:
        devices = ([f"cuda:{r}" for r in range(world)] if device.type == "cuda"
                   else ["cpu"] * world)
        weights = {k: v.detach().float().cpu() for k, v in state.model.state_dict().items()}
        kw = dict(device=device, dtype=torch.float32, bucket=32)
        single = VideoSegmenter(dict(weights), forward_chunk=4, **kw)
        sharded = VideoSegmenter(dict(weights), devices=devices, forward_chunk=1, **kw)
        sharded2 = VideoSegmenter(dict(weights), devices=(devices * 2)[:2], forward_chunk=2,
                                  **kw)

        def check(name, engine, vid, fuse="simple"):
            want = single.segment_video(vid, num_clips=2, step=1, fuse_method=fuse)
            got = engine.segment_video(vid, num_clips=2, step=1, fuse_method=fuse)
            if not want.shape == got.shape == (vid.shape[1], h, w):
                raise AssertionError(f"{tag}: {name}: shapes {got.shape} {want.shape}")
            mismatch = float((got != want).mean())
            if mismatch > 1e-3:
                raise AssertionError(f"{tag}: {name}: sharded masks diverge from "
                                     f"single-device: {mismatch}")
            lines.append(f"{tag}: {name} ok, mask mismatch={mismatch:.5f}")

        check("sharded simple fusion", sharded, video)
        check("sharded softmax fast path", sharded, video, fuse="softmax")
        check("uneven clips-vs-devices (1 clip, padded shards)", sharded, short)
        check("sharded simple fusion (2 devices)", sharded2, video)
    dist.barrier()
    return lines


def dryrun_multigpu(n: int, backend: str | None = None, timeout: float = 900.0) -> list:
    """Run the six cases on n spawned ranks (`backend`: "nccl" with a card
    for every rank, else "gloo"); prints rank 0's lines and returns them.
    Any failing case, rank or hang (past `timeout` seconds) raises."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl" and torch.cuda.device_count() < n:
        raise RuntimeError(f"dryrun_multigpu: {n} NCCL ranks need {n} cards, "
                           f"{torch.cuda.device_count()} present")
    lines = run_ranks(_dryrun_rank, n, backend=backend, timeout=timeout)[0]
    for line in lines:
        print(line, flush=True)
    return lines
